"""Model-layout entry point of the flash-attention kernel.

The model passes (B, S, H, D) activations; the CUDA kernel reads them
through their strides, so no transposed copy is made.  A CUDA tensor
launches the kernel in ``csrc/flash_attention.cu`` (or the call raises):
bfloat16 takes its tensor-core route, with its tiles chosen by
:func:`choose_tiles`, and float32 its FMA route.  A CPU tensor takes the
plain version, :func:`flash_attention_oracle`.  A fake CUDA tensor (the
dry-run's, ``launch/dryrun.py``) holds no data: the call returns an
output of the kernel's shape and launches nothing.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
Q_TILES = (64, 32, 16)      # query rows per block of the bf16 route
KV_TILES = (32, 64)         # K / V rows per tile of the bf16 route
SHORT_KV = 256              # up to this many keys, 32-row K / V tiles
FMA_TILES = (64, 64)        # the float32 route's fixed tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 4 + [_I] * 9 + [_L] * 12
             + [ctypes.c_float] + [_I] * 4 + [_P])


def choose_tiles(batch: int, heads: int, sq: int, skv: int,
                 n_sm: int) -> tuple[int, int]:
    """(query rows per block, K / V rows per tile) of the bf16 route.

    The query tile is the largest of ``Q_TILES`` whose grid (batch x heads
    x ceil(sq / tile) blocks) gives every one of ``n_sm`` SMs a block, else
    the smallest, which gives the most blocks.  K / V tiles are 32 rows, in
    a ring of 4, up to ``SHORT_KV`` keys, where a tile's latency sets the
    pace, and 64 rows in a ring of 2 beyond (measured on the H100; PERF.md).
    """
    q_tile = Q_TILES[-1]
    for tile in Q_TILES:
        if batch * heads * -(-sq // tile) >= n_sm:
            q_tile = tile
            break
    return q_tile, KV_TILES[0] if skv <= SHORT_KV else KV_TILES[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rows_aligned(x: torch.Tensor) -> bool:
    """Whether every row of ``x`` (the last dim) starts on a 16-byte
    boundary, as the kernel's 16-byte copies need."""
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or st * x.element_size() % 16 == 0
        for n, st in zip(x.shape[:-1], x.stride()[:-1]))


def flash_attention_oracle(q, k, v, **kw):
    """The plain version on the model layout: (B, S, H, D) in and out."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw)
    return out.transpose(1, 2)


def _check(q, k, v, window, local_block):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,D), k/v (B,S,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (GQA needs H % KV == 0)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"want one dtype of {list(_DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    for name, val in (("window", window), ("local_block", local_block)):
        if val is not None and val <= 0:
            raise ValueError(f"{name} must be None or positive, got {val}")


def flash_attention(q, k, v, *, causal=True, window=None, local_block=None,
                    q_offset=0):
    """q: (B, S, H, D); k/v: (B, S, KV, D) -> (B, S, H, D)."""
    _check(q, k, v, window, local_block)
    kw = dict(causal=causal, window=window, local_block=local_block,
              q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_oracle(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, sq, h, d = q.shape
    if is_fake(q):
        return torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    skv, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the last dim of q, k and v must be contiguous")
    if q.dtype == torch.bfloat16:
        if not all(rows_aligned(x) for x in (q, k, v)):
            raise ValueError("the bf16 route copies 16-byte pieces: every "
                             "row of q, k and v must start on a 16-byte "
                             "boundary")
        dev = q.device.index
        if dev is None:
            dev = torch.cuda.current_device()
        tiles = choose_tiles(b, h, sq, skv, _sm_count(dev))
    else:
        tiles = FMA_TILES
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], b, sq, skv, h, kvh, d, *tiles,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], 1.0 / math.sqrt(d), int(causal),
             window or 0, local_block or 0, int(q_offset),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "repro_flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
