"""Port kernels vs the reference package, on the CPU.

The port's kernel wrappers take their plain PyTorch version for CPU
tensors; here the same numpy inputs (from a seed) go through the port and
through the reference's ops (Pallas interpret mode) or its jnp oracles.
The CUDA kernels themselves are checked against the same plain versions
on the card by the ``cuda``-marked tests below and by ``chip_smoke.py``.

Tolerance: 2e-5 (float32), the reference's own kernel tolerance — both
sides compute an fp32 softmax over the same products.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops

ATOL = RTOL = 2e-5


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref,
                               np.float32), atol=ATOL, rtol=RTOL)


# ---- flash_attention: the ops grid of tests/test_realcompute.py -----------

@pytest.mark.parametrize("kw", [
    {"causal": True},
    {"causal": True, "window": 16},
    {"causal": True, "local_block": 8},
])
def test_flash_attention_matches_reference_ops(kw):
    from repro.kernels.flash_attention.ops import flash_attention
    rng = np.random.default_rng(0)
    b, s, h, kvh, d = 2, 64, 4, 2, 16
    q, k, v = (_rand(rng, (b, s, n, d)) for n in (h, kvh, kvh))
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **kw)
    out = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw)
    assert out.shape == (b, s, h, d) and out.dtype == torch.float32
    _close(out, ref)


# ---- flash_attention: the oracle grid of tests/test_kernels.py ------------

@pytest.mark.parametrize(
    "b,h,kvh,sq,skv,d,window,local",
    [(2, 4, 2, 256, 256, 64, None, None),
     (1, 8, 8, 128, 128, 128, None, None),
     (2, 4, 1, 256, 256, 64, 64, None),
     (1, 4, 2, 384, 384, 64, None, 128),
     (2, 2, 2, 200, 200, 64, None, None),
     (1, 4, 4, 128, 384, 64, None, None),
     (2, 4, 2, 40, 40, 16, None, None)])       # S shorter than a tile
def test_flash_attention_matches_reference_oracle(b, h, kvh, sq, skv, d,
                                                  window, local):
    from repro.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(1)
    q = _rand(rng, (b, h, sq, d))
    k = _rand(rng, (b, kvh, skv, d))
    v = _rand(rng, (b, kvh, skv, d))
    kw = dict(causal=True, window=window, local_block=local,
              q_offset=skv - sq)
    ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    # the port's entry point takes the model layout (B, S, H, D)
    out = fa_ops.flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                                   for x in (q, k, v)), **kw)
    _close(out.transpose(1, 2), ref)


# ---- flash_decode ----------------------------------------------------------

@pytest.mark.parametrize("kw,t", [
    ({}, 17),                                  # linear cache, mid-fill
    ({}, 63),                                  # linear cache, last slot
    ({"window": 16}, 40),                      # sliding-window ring
    ({"local_block": 8}, 29),                  # chunked-local ring
])
def test_flash_decode_at_matches_reference_ops(kw, t):
    from repro.kernels.flash_decode.ops import flash_decode_at
    rng = np.random.default_rng(2)
    b, s, h, kvh, d = 2, 64, 4, 2, 16
    q = _rand(rng, (b, h, d))
    kc = _rand(rng, (b, s, kvh, d))
    vc = _rand(rng, (b, s, kvh, d))
    ref = flash_decode_at(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                          t, **kw)
    t_dev = torch.tensor([t], dtype=torch.int32)
    out = fd_ops.flash_decode_at(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), t_dev, **kw)
    _close(out, ref)


@pytest.mark.parametrize(
    "b,h,kvh,s,d,t,window,local",
    [(2, 8, 2, 1024, 64, 1023, None, None),
     (2, 8, 8, 1024, 128, 700, None, None),
     (1, 4, 2, 512, 64, 2000, 512, None),
     (1, 4, 4, 256, 64, 900, None, 128),
     (2, 4, 2, 700, 64, 699, None, None)])
def test_flash_decode_matches_reference_oracle(b, h, kvh, s, d, t, window,
                                               local):
    from repro.kernels.flash_decode.ref import decode_ref
    rng = np.random.default_rng(3)
    q = _rand(rng, (b, h, d))
    kc = _rand(rng, (b, s, kvh, d))
    vc = _rand(rng, (b, s, kvh, d))
    ref = decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), t=t,
                     window=window, local_block=local)
    args = [torch.from_numpy(x) for x in (q, kc, vc)]
    static = fd_ops.flash_decode(*args, t=t, window=window,
                                 local_block=local)
    dyn = fd_ops.flash_decode_at(*args, torch.tensor([t], dtype=torch.int32),
                                 window=window, local_block=local)
    _close(static, ref)
    _close(dyn, ref)


def test_flash_decode_at_one_setup_many_positions():
    """One input set and one position tensor serve every step: only the
    tensor's value changes between calls."""
    from repro.kernels.flash_decode.ref import decode_ref
    rng = np.random.default_rng(4)
    b, s, h, kvh, d = 1, 32, 2, 1, 8
    q, kc, vc = (_rand(rng, sh) for sh in ((b, h, d), (b, s, kvh, d),
                                           (b, s, kvh, d)))
    args = [torch.from_numpy(x) for x in (q, kc, vc)]
    t_dev = torch.zeros(1, dtype=torch.int32)
    for t in (0, 1, 7, 31):
        t_dev.fill_(t)
        out = fd_ops.flash_decode_at(*args, t_dev)
        _close(out, decode_ref(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), t=t))


# ---- wrapper contract ------------------------------------------------------

def test_wrappers_check_their_inputs():
    x = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError):             # H % KV != 0
        fa_ops.flash_attention(torch.zeros((1, 4, 3, 16)), x, x)
    with pytest.raises(TypeError):              # mixed dtypes
        fa_ops.flash_attention(x.double(), x, x)
    with pytest.raises(ValueError):             # window must be positive
        fa_ops.flash_attention(x, x, x, window=0)
    q, kc = torch.zeros((1, 2, 16)), torch.zeros((1, 8, 1, 16))
    with pytest.raises(TypeError):              # t must be one int32
        fd_ops.flash_decode_at(q, kc, kc, torch.tensor([3]))
    with pytest.raises(ValueError):             # q / cache mismatch
        fd_ops.flash_decode_at(torch.zeros((2, 2, 16)), kc, kc,
                               torch.tensor([3], dtype=torch.int32))


def test_cpu_tensors_take_the_plain_version_without_launching():
    fa_ops.flash_attention.launches = 0
    fd_ops.flash_decode_at.launches = 0
    x = torch.randn((1, 8, 2, 16))
    fa_ops.flash_attention(x, x, x)
    fd_ops.flash_decode_at(x[:, 0], x, x, torch.tensor([3], dtype=torch.int32))
    assert fa_ops.flash_attention.launches == 0
    assert fd_ops.flash_decode_at.launches == 0


def test_kernel_sources_are_found_and_hashed():
    from repro_torch.kernels import _build
    srcs = _build.sources()
    assert set(srcs) == {"flash_attention", "flash_decode"}
    for name in srcs:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, sq, skv, h, kvh, d, kw in [
            (8, 128, 128, 16, 8, 128, {}),
            (2, 40, 40, 4, 2, 16, {"window": 16}),
            (1, 50, 90, 4, 2, 64, {"local_block": 16})]:
        q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
        k = torch.randn((b, skv, kvh, d), generator=g, device=cuda).to(dtype)
        v = torch.randn((b, skv, kvh, d), generator=g, device=cuda).to(dtype)
        kw = dict(q_offset=skv - sq, **kw)
        out = fa_ops.flash_attention(q, k, v, **kw)
        ref = fa_ops.flash_attention_oracle(q, k, v, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_decode_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    for b, s, h, kvh, d, t, kw in [
            (8, 144, 16, 8, 128, 143, {}),
            (2, 700, 4, 2, 64, 350, {}),
            (1, 512, 4, 2, 64, 2000, {"window": 512})]:
        q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
        kc = torch.randn((b, s, kvh, d), generator=g, device=cuda).to(dtype)
        vc = torch.randn((b, s, kvh, d), generator=g, device=cuda).to(dtype)
        t_dev = torch.tensor([t], dtype=torch.int32, device=cuda)
        out = fd_ops.flash_decode_at(q, kc, vc, t_dev, **kw)
        ref = fd_ops.decode_ref(q, kc, vc, t=t, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
