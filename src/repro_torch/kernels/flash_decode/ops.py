"""Entry points of the flash-decode kernel.

``flash_decode_at`` takes the position ``t`` as a one-element int32 tensor
on the caches' device, so the decode loop never reads it on the host.
``flash_decode`` takes a Python int: it passes ``t`` to the kernel by
value, with the arc of live slots that ``live_slots`` computes from it, so
the kernel walks only those slots; it makes no device tensor of ``t`` and
copies nothing to the device.  A CUDA tensor launches the kernel in
``csrc/flash_decode.cu`` (two entries over one device body), one clustered
launch per call with nothing allocated but the output (or the call
raises); a CPU tensor takes the plain version, ``decode_ref``.
"""
from __future__ import annotations

import ctypes
import math
import operator

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import decode_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (q, k, v, o), then the position: a pointer to t on the device (dynamic)
# or t, the arc's first slot and its length by value (static)
_TAIL = [_I] * 6 + [_L] * 10 + [ctypes.c_float] + [_I] * 2 + [_P]
_ARGTYPES = {"repro_flash_decode_fwd": [_P] * 5 + _TAIL,
             "repro_flash_decode_static_fwd": [_P] * 4 + [_I] * 3 + _TAIL}
_INT_MAX = 2**31 - 1


def live_slots(s: int, t: int, window=None, local_block=None) -> tuple:
    """``(first_slot, n_live)``: the cache slots that the decode mask at
    position ``t >= 0`` admits, as an arc of ``n_live`` slots from
    ``first_slot`` (wrapping past slot ``s - 1`` to 0 on a ring cache).

    Linear cache (no window, no local block): slots 0 .. min(t, s - 1).
    Ring cache: slot i holds position p_i = t - ((t - i) mod s), so the
    slot j back from slot t mod s holds t - j, and the window and chunk
    tests admit j < min(s, t + 1, window, (t mod local_block) + 1): the
    arc ends at slot t mod s and runs backwards."""
    if window is None and local_block is None:
        return 0, min(t, s - 1) + 1
    n_live = min(s, t + 1)
    if window is not None:
        n_live = min(n_live, window)
    if local_block is not None:
        n_live = min(n_live, t % local_block + 1)
    return (t % s - n_live + 1) % s, n_live


def rows_aligned(x: torch.Tensor) -> bool:
    """Whether every row of ``x`` (the last dim) starts on a 16-byte
    boundary, as the kernel's 16-byte copies of the caches need."""
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or st * x.element_size() % 16 == 0
        for n, st in zip(x.shape[:-1], x.stride()[:-1]))


def _check(q, k_cache, v_cache, t, window, local_block):
    """Shapes, dtypes and devices; ``t`` is the position tensor of
    ``flash_decode_at``, or None for ``flash_decode``'s int."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q (B,H,D), caches (B,S,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, h, d = q.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != d
            or h % k_cache.shape[2]):
        raise ValueError(f"q {tuple(q.shape)} does not match the caches "
                         f"{tuple(k_cache.shape)} (GQA needs H % KV == 0)")
    if (not (q.dtype == k_cache.dtype == v_cache.dtype)
            or q.dtype not in _DTYPES):
        raise TypeError(f"want one dtype of {list(_DTYPES)}; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must lie on one device")
    if t is not None and t.device != q.device:
        raise ValueError("t must lie on the caches' device")
    if t is not None and (t.dtype != torch.int32 or t.numel() != 1):
        raise TypeError(f"t must be one int32; got {t.dtype} {tuple(t.shape)}")
    for name, val in (("window", window), ("local_block", local_block)):
        if val is not None and val <= 0:
            raise ValueError(f"{name} must be None or positive, got {val}")


def _launch(entry, position, q, k_cache, v_cache, window, local_block):
    """One launch of the C entry ``entry`` with ``position``: (t's device
    pointer,) or (t, first slot, live count)."""
    b, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if any(x.stride(-1) != 1 for x in (q, k_cache, v_cache)):
        raise ValueError("the last dim of q and the caches must be "
                         "contiguous")
    if not (rows_aligned(k_cache) and rows_aligned(v_cache)):
        raise ValueError("the kernel copies 16-byte pieces: every row of "
                         "the caches must start on a 16-byte boundary")
    lib = _build.load("flash_decode")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = _ARGTYPES[entry], ctypes.c_int
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             out.data_ptr(), *position, _DTYPES[q.dtype],
             b, s, h, kvh, d, *q.stride()[:2], *k_cache.stride()[:3],
             *v_cache.stride()[:3], *out.stride()[:2], 1.0 / math.sqrt(d),
             window or 0, local_block or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "repro_flash_decode", err)
    return out


def flash_decode_at(q, k_cache, v_cache, t, *, window=None,
                    local_block=None):
    """q: (B, H, D); caches: (B, S, KV, D); t: int32 tensor of one element
    on the caches' device.  Returns (B, H, D)."""
    _check(q, k_cache, v_cache, t, window, local_block)
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, t=t, window=window,
                          local_block=local_block)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not t.is_contiguous():
        raise ValueError("t must be contiguous")
    out = _launch("repro_flash_decode_fwd", (t.data_ptr(),), q, k_cache,
                  v_cache, window, local_block)
    flash_decode_at.launches += 1
    return out


def flash_decode(q, k_cache, v_cache, *, t, window=None, local_block=None):
    """``flash_decode_at`` with ``t`` a Python int >= 0, passed to the
    kernel by value with the arc of live slots (``live_slots``); nothing
    but the output is allocated.  Returns (B, H, D)."""
    t = operator.index(t)
    if not 0 <= t <= _INT_MAX:
        raise ValueError(f"t must be a position in [0, 2**31); got {t}")
    _check(q, k_cache, v_cache, None, window, local_block)
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, t=t, window=window,
                          local_block=local_block)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    first, n_live = live_slots(k_cache.shape[1], t, window, local_block)
    out = _launch("repro_flash_decode_static_fwd", (t, first, n_live), q,
                  k_cache, v_cache, window, local_block)
    flash_decode.launches += 1
    return out


flash_decode_at.launches = 0
flash_decode.launches = 0
