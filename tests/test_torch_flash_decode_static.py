"""Static-position flash-decode: ``flash_decode`` with ``t`` a Python int.

On the CPU the wrapper takes its plain version, held here to the
reference's own static kernel (the Pallas ``_fd_kernel`` in interpret mode,
as the reference's tests run it) at 2e-5 in float32.  The arc of live slots
that the wrapper hands the CUDA kernel (``live_slots``) is held exactly to
the slots that the decode mask admits, in both packages' ``decode_ref``,
and the ctypes signatures to the C entries in the source.  The ``cuda``
tests hold the kernel to the plain version on the card (f32 2e-5, bf16
2e-2) and show that one call is one launch with no host-to-device copy
and no allocation but the output.
"""
from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode import ops as fd_ops

ATOL = RTOL = 2e-5


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---- the reference's static kernel ------------------------------------------

@pytest.mark.parametrize("kw,t", [
    ({}, 17),                                  # linear cache, mid-fill
    ({}, 63),                                  # linear cache, last slot
    ({}, 200),                                 # linear cache, t past S
    ({"window": 16}, 40),                      # sliding-window ring
    ({"window": 16}, 70),                      # ... wrapping past slot 0
    ({"local_block": 8}, 29),                  # chunked-local ring
    ({"local_block": 8}, 64),                  # ... t mod L = 0: one slot
    ({"window": 100, "local_block": 48}, 300),  # both, window wider than S
])
def test_flash_decode_matches_reference_static_kernel(kw, t):
    import jax.numpy as jnp
    from repro.kernels.flash_decode.ops import flash_decode as ref_decode
    rng = np.random.default_rng(5)
    b, s, h, kvh, d = 2, 64, 4, 2, 16
    q = _rand(rng, (b, h, d))
    kc = _rand(rng, (b, s, kvh, d))
    vc = _rand(rng, (b, s, kvh, d))
    ref = ref_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), t=t,
                     **kw)
    out = fd_ops.flash_decode(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), t=t, **kw)
    assert out.shape == (b, h, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               atol=ATOL, rtol=RTOL)


# ---- the arc of live slots -----------------------------------------------------

def _admitted(decode_ref, s, t, window, local_block, wrap):
    """The slots ``decode_ref``'s mask admits at position t: with q = 0
    every admitted slot scores 0 and every masked one -1e30, so with V the
    identity over slots the output is 1 / n on the admitted slots, 0
    elsewhere."""
    q = np.zeros((1, 1, s), np.float32)
    k = np.zeros((1, s, 1, s), np.float32)
    v = np.eye(s, dtype=np.float32)[None, :, None, :]
    w = np.asarray(decode_ref(*(wrap(x) for x in (q, k, v)), t=t,
                              window=window, local_block=local_block),
                   np.float64)[0, 0]
    admitted = np.flatnonzero(w > 0)
    np.testing.assert_allclose(w[admitted], 1.0 / len(admitted), rtol=1e-6)
    return set(admitted.tolist())


# (S, window, local_block) x a sweep of t: t < S, t = S - 1, t >> S, t on
# a chunk boundary (t mod L = 0) and a window wider than S
_ARC_CASES = [
    (64, None, None), (1, None, None), (40, 16, None), (40, 64, None),
    (32, None, 8), (32, None, 32), (48, None, 64), (30, 20, 16),
    (64, 100, 48), (17, 5, None),
]


@pytest.mark.parametrize("s,window,local", _ARC_CASES)
def test_live_slots_are_the_slots_the_mask_admits(s, window, local):
    import jax.numpy as jnp
    from repro.kernels.flash_decode.ref import decode_ref as ref_oracle
    from repro_torch.kernels.flash_decode.ref import decode_ref
    ts = sorted({0, 1, s // 2, s - 1, s, s + 1, 3 * s + 7, 10 * s}
                | {m * b for b in (window, local) if b for m in (1, 2, 5)})
    for t in ts:
        first, n_live = fd_ops.live_slots(s, t, window, local)
        assert 0 <= first < s and 1 <= n_live <= s
        arc = [(first + j) % s for j in range(n_live)]
        assert len(set(arc)) == n_live
        if window is not None or local is not None:
            assert arc[-1] == t % s        # the arc ends at slot t mod S
        want = _admitted(decode_ref, s, t, window, local, torch.from_numpy)
        assert set(arc) == want, (t, first, n_live, sorted(want))
        assert _admitted(ref_oracle, s, t, window, local, jnp.asarray) == want


def test_live_slots_of_the_chunked_local_timing_shape():
    """Llama-4 Maverick's chunked-local layer (chunk 8192) on a ring of
    8192 slots at t = 8292: 101 live slots, from slot 0."""
    assert fd_ops.live_slots(8192, 8292, None, 8192) == (0, 101)
    assert fd_ops.live_slots(144, 143, None, None) == (0, 144)
    assert fd_ops.live_slots(4096, 9000, None, None) == (0, 4096)


# ---- the wrapper ---------------------------------------------------------------

@pytest.mark.parametrize("t,exc", [(-1, ValueError), (2**31, ValueError),
                                   (3.0, TypeError), ("3", TypeError)])
def test_flash_decode_refuses_a_bad_position(t, exc):
    q, kc = torch.zeros((1, 2, 16)), torch.zeros((1, 8, 1, 16))
    with pytest.raises(exc):
        fd_ops.flash_decode(q, kc, kc, t=t)


def test_flash_decode_on_the_cpu_takes_the_plain_version():
    rng = np.random.default_rng(6)
    q, kc, vc = (torch.from_numpy(_rand(rng, sh))
                 for sh in ((2, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    fd_ops.flash_decode.launches = 0
    out = fd_ops.flash_decode(q, kc, vc, t=np.int64(40), window=8)
    assert fd_ops.flash_decode.launches == 0
    torch.testing.assert_close(
        out, fd_ops.decode_ref(q, kc, vc, t=40, window=8), atol=0, rtol=0)


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


@pytest.mark.parametrize("entry", sorted(fd_ops._ARGTYPES))
def test_ctypes_signatures_match_the_c_entries(entry):
    """The wrapper's argtypes, one by one, are the C entry's parameters in
    ``csrc/flash_decode.cu`` (no compiler here checks the pair)."""
    from repro_torch.kernels import _build
    src = _build.sources()["flash_decode"].read_text()
    m = re.search(rf"int {entry}\(([^)]*)\)", src)
    assert m, entry
    params = [re.sub(r"\s+", " ", p).strip() for p in m.group(1).split(",")]
    types = [_CTYPES[p.rsplit(" ", 1)[0].replace(" *", "*")] for p in params]
    assert types == fd_ops._ARGTYPES[entry]


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the nine shapes of test_torch_kernels.py's cuda decode test, a ring that
# wraps past slot 0, and Llama-4 Maverick's chunked-local layer
_CARD_SHAPES = [
    (8, 144, 16, 8, 128, 143, {}),
    (1, 144, 16, 8, 128, 0, {}),
    (2, 40, 16, 8, 128, 39, {}),
    (1, 144, 16, 8, 128, 20, {}),
    (2, 4096, 16, 8, 128, 4095, {}),
    (2, 700, 4, 2, 64, 350, {}),
    (1, 512, 4, 2, 64, 2000, {"window": 512}),
    (2, 1024, 16, 8, 128, 3000, {"window": 300}),
    (2, 1024, 8, 2, 64, 2500, {"local_block": 256}),
    (2, 1024, 16, 8, 128, 1100, {"window": 300}),
    (8, 8192, 40, 8, 128, 8292, {"local_block": 8192}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_decode_static_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(4)
    for b, s, h, kvh, d, t, kw in _CARD_SHAPES:
        q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
        kc = torch.randn((b, s, kvh, d), generator=g, device=cuda).to(dtype)
        vc = torch.randn((b, s, kvh, d), generator=g, device=cuda).to(dtype)
        out = fd_ops.flash_decode(q, kc, vc, t=t, **kw)
        ref = fd_ops.decode_ref(q, kc, vc, t=t, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_decode_static_is_one_launch_and_no_copy(cuda):
    """Under the profiler one call is one kernel on the device, with no
    host-to-device copy, and allocates one tensor: the output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((8, 16, 128), generator=g, device=cuda).bfloat16()
    kc, vc = (torch.randn((8, 144, 8, 128), generator=g,
                          device=cuda).bfloat16() for _ in range(2))
    fd_ops.flash_decode(q, kc, vc, t=143)        # build and load
    torch.cuda.synchronize()
    launches = fd_ops.flash_decode.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        before = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
        fd_ops.flash_decode(q, kc, vc, t=143)
        allocated = (torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
                     - before)
        torch.cuda.synchronize()
    on_device = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    assert fd_ops.flash_decode.launches == launches + 1
    assert allocated == 1
    assert not [n for n in on_device if "Memcpy" in n]
    assert len(on_device) == 1 and "fd_cluster_kernel" in on_device[0], \
        on_device
