"""Model-layout entry point of the WKV6 kernel.

``wkv6`` takes the model's (B, T, H, K) layout, as the reference's
``ops.wkv6`` does.  The CUDA kernel in ``csrc/rwkv6.cu`` runs the per-token
recurrence with each state column in registers; it reads that layout through
its strides and stops at T itself, so neither a transposed nor a padded copy
is made.  A CUDA tensor launches the kernel, in the (state columns per block,
threads per column) shape :func:`launch_shape` picks, or the call raises; a
CPU tensor takes the plain version, :func:`wkv6_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import rows_aligned
from repro_torch.kernels.rwkv6.ref import wkv6_ref

HEAD_DIMS = (8, 16, 32, 64, 128)
COLS = (2, 4)               # CPT: state columns a lane keeps, <= P
COL_WIDTHS = (128, 64, 32, 16, 8)   # VB: 8 and up, 16-byte bf16 v copies
MAX_THREADS = 256           # VB / CPT * P consumer threads a block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 8 + [_I] * 8 + [_L] * 15 + [_P]


def lanes_per_column(kd: int) -> int:
    """P: the lanes that share a state column, each holding K / P rows of
    it, 8 (4 at K = 8)."""
    return kd // (8 if kd >= 16 else 4)


def routes(kd: int) -> list[tuple[int, int, int]]:
    """Every (VB, P, CPT) the kernel takes at head dim ``kd``: VB state
    columns per block, P lanes per group of CPT columns."""
    p = lanes_per_column(kd)
    return [(vb, p, cols) for cols in COLS for vb in COL_WIDTHS
            if cols <= p and cols <= vb <= kd
            and vb // cols * p <= MAX_THREADS]


def launch_shape(b: int, h: int, kd: int,
                 n_sms: int) -> tuple[int, int, int]:
    """(VB, P, CPT) for a launch on a card of ``n_sms`` SMs.

    A lane's columns are CPT = 4 when that still leaves a block 4 consumer
    warps (128 lanes), else 2.  VB is the widest group whose grid (V / VB
    x H x B blocks) gives at least 7/8 of the SMs a block, else the
    narrowest: every block converts each chunk's r, k and w for all K rows,
    so more blocks than SMs repeat that work.  On the H100 this picks the
    fastest route at every serving bucket, B = 1, 2, 4, 8 at H = 32,
    K = 64 (the route sweep of ``chip_smoke.py``; PERF.md)."""
    p = lanes_per_column(kd)
    shapes = [(vb, p, 4 if vb // 4 * p >= 128 else 2) for vb in COL_WIDTHS]
    shapes = [sh for sh in shapes if sh in routes(kd)]
    return next((sh for sh in shapes if kd // sh[0] * h * b * 8 >= 7 * n_sms),
                shapes[-1])


def _check(r, k, v, lw, u, s0):
    if (any(x.dim() != 4 for x in (r, k, v, lw))
            or not (r.shape == k.shape == lw.shape)
            or v.shape[:3] != r.shape[:3]):
        raise ValueError(f"want r/k/lw (B,T,H,K) and v (B,T,H,V); got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(lw.shape)}")
    b, t, h, kd = r.shape
    if t < 1:
        raise ValueError("want at least one token")
    if (tuple(u.shape) != (h, kd)
            or tuple(s0.shape) != (b, h, kd, v.shape[3])):
        raise ValueError(f"want u (H,K) = {(h, kd)} and s0 (B,H,K,V) = "
                         f"{(b, h, kd, v.shape[3])}; got {tuple(u.shape)}, "
                         f"{tuple(s0.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise TypeError(f"want r, k, v in one dtype of {list(_DTYPES)}; "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if s0.dtype != torch.float32 or not (lw.is_floating_point()
                                         and u.is_floating_point()):
        raise TypeError(f"want float32 s0 and floating lw, u; got "
                        f"{s0.dtype}, {lw.dtype}, {u.dtype}")
    if not (r.device == k.device == v.device == lw.device == u.device
            == s0.device):
        raise ValueError("r, k, v, lw, u and s0 must lie on one device")


def _launch(r, k, v, lw, u, s0, shape=None):
    """Run the kernel; ``shape`` = (VB, P, CPT) overrides
    :func:`launch_shape`."""
    b, t, h, kd = r.shape
    vd = v.shape[3]
    if kd not in HEAD_DIMS or vd != kd:
        raise ValueError(f"want K == V in {HEAD_DIMS}; got K={kd}, V={vd}")
    lw = lw.float()
    u = u.float().contiguous()
    s0 = s0.contiguous()
    if any(x.stride(-1) != 1 for x in (r, k, v, lw)):
        raise ValueError("the last dim of r, k, v and lw must be contiguous")
    if not all(rows_aligned(x) for x in (r, k, v, lw)):
        raise ValueError("the kernel copies 16-byte pieces: every row of r, "
                         "k, v and lw must start on a 16-byte boundary")
    if shape is None:
        dev = r.device.index
        if dev is None:
            dev = torch.cuda.current_device()
        shape = launch_shape(
            b, h, kd, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
    if shape not in routes(kd):
        raise ValueError(f"(VB, P, CPT) = {shape} not in {routes(kd)}")
    y = torch.empty((b, t, h, vd), dtype=r.dtype, device=r.device)
    s_fin = torch.empty((b, h, kd, vd), dtype=torch.float32,
                        device=r.device)
    lib = _build.load("rwkv6")
    fn = lib.repro_rwkv6_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
             u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
             _DTYPES[r.dtype], b, t, h, kd, *shape,
             *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *lw.stride()[:3], *y.stride()[:3],
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, "repro_rwkv6", err)
    return y, s_fin


def wkv6(r, k, v, lw, u, s0):
    """r/k/lw: (B, T, H, K); v: (B, T, H, V); u: (H, K); s0: (B, H, K, V)
    float32.  Returns (y (B, T, H, V) in r's dtype, s_fin (B, H, K, V)
    float32)."""
    _check(r, k, v, lw, u, s0)
    if r.device.type == "cpu":
        y, s_fin = wkv6_ref(*(x.transpose(1, 2) for x in (r, k, v, lw)),
                            u, s0)
        return y.transpose(1, 2), s_fin
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    out = _launch(r, k, v, lw, u, s0)
    wkv6.launches += 1
    return out


wkv6.launches = 0
