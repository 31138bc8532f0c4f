"""Entry points of the flash-decode kernel.

``flash_decode_at`` takes the position ``t`` as a one-element int32 tensor
on the caches' device, so the decode loop never reads it on the host;
``flash_decode`` takes a Python int and is a thin wrapper over the same
kernel.  A CUDA tensor launches the kernel in ``csrc/flash_decode.cu`` (or
the call raises); a CPU tensor takes the plain version, ``decode_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import decode_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 8 + [_I] * 6 + [_L] * 10
             + [ctypes.c_float] + [_I] * 2 + [_P])


def _check(q, k_cache, v_cache, t, window, local_block):
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
    if not (q.device == k_cache.device == v_cache.device == t.device):
        raise ValueError("q, the caches and t must lie on one device")
    if t.dtype != torch.int32 or t.numel() != 1:
        raise TypeError(f"t must be one int32; got {t.dtype} {tuple(t.shape)}")
    for name, val in (("window", window), ("local_block", local_block)):
        if val is not None and val <= 0:
            raise ValueError(f"{name} must be None or positive, got {val}")


def _launch(q, k_cache, v_cache, t, window, local_block):
    b, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if (any(x.stride(-1) != 1 for x in (q, k_cache, v_cache))
            or not t.is_contiguous()):
        raise ValueError("the last dim of q and the caches, and t, must be "
                         "contiguous")
    lib = _build.load("flash_decode")
    lib.repro_flash_decode_num_splits.argtypes = [_I]
    ns = lib.repro_flash_decode_num_splits(s)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    part_m = torch.empty((b, h, ns), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, ns, d), dtype=torch.float32,
                           device=q.device)
    fn = lib.repro_flash_decode_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             out.data_ptr(), t.data_ptr(), part_m.data_ptr(),
             part_l.data_ptr(), part_acc.data_ptr(), _DTYPES[q.dtype],
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
    out = _launch(q, k_cache, v_cache, t, window, local_block)
    flash_decode_at.launches += 1
    return out


def flash_decode(q, k_cache, v_cache, *, t, window=None, local_block=None):
    """``flash_decode_at`` with ``t`` a Python int (the position is copied
    into a one-element device tensor).  Returns (B, H, D)."""
    t_dev = torch.tensor([t], dtype=torch.int32, device=q.device)
    _check(q, k_cache, v_cache, t_dev, window, local_block)
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, t=t, window=window,
                          local_block=local_block)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = _launch(q, k_cache, v_cache, t_dev, window, local_block)
    flash_decode.launches += 1
    return out


flash_decode_at.launches = 0
flash_decode.launches = 0
