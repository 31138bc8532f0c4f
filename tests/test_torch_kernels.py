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


_T3 = torch.tensor([3], dtype=torch.int32)


@pytest.mark.parametrize("args,kw,exc", [
    (((1, 2, 16), (1, 8, 1, 16), _T3.long()), {}, TypeError),   # t int64
    (((1, 2, 16), (1, 8, 1, 16),
      torch.tensor([3, 4], dtype=torch.int32)), {}, TypeError),  # t of two
    (((2, 2, 16), (1, 8, 1, 16), _T3), {}, ValueError),  # batch mismatch
    (((1, 3, 16), (1, 8, 2, 16), _T3), {}, ValueError),  # H % KV != 0
    (((1, 2, 8), (1, 8, 1, 16), _T3), {}, ValueError),   # head dim mismatch
    (((1, 2, 16), (1, 8, 16), _T3), {}, ValueError),     # cache not 4-D
    (((1, 2, 16), (1, 8, 1, 16), _T3), {"window": 0}, ValueError),
    (((1, 2, 16), (1, 8, 1, 16), _T3), {"local_block": -2}, ValueError),
    (((1, 2, 16), (1, 8, 1, 16),
      torch.zeros(1, dtype=torch.int32, device="meta")), {}, ValueError),
])
def test_flash_decode_at_refuses_bad_inputs(args, kw, exc):
    """Shape, dtype and device checks of the decode wrapper, made before
    the device decides between the kernel and the plain version."""
    qs, cs, t = args
    q, kc = torch.zeros(qs), torch.zeros(cs)
    with pytest.raises(exc):
        fd_ops.flash_decode_at(q, kc, kc, t, **kw)


@pytest.mark.parametrize("make,exc", [
    (lambda: (torch.zeros((1, 2, 16)).double(), torch.zeros((1, 8, 1, 16))),
     TypeError),                                         # mixed dtypes
    (lambda: (torch.zeros((1, 2, 16), dtype=torch.float16),
              torch.zeros((1, 8, 1, 16), dtype=torch.float16)),
     TypeError),                                         # no fp16 kernel
    (lambda: (torch.zeros((1, 2, 16), device="meta"),
              torch.zeros((1, 8, 1, 16), device="meta")),
     ValueError),                                        # q off the CPU, t on it
])
def test_flash_decode_refuses_bad_dtypes_and_devices(make, exc):
    q, kc = make()
    with pytest.raises(exc):
        fd_ops.flash_decode(q, kc, kc, t=3)
    with pytest.raises(exc):
        fd_ops.flash_decode_at(q, kc, kc, _T3)


def test_flash_decode_raises_on_a_device_without_a_kernel():
    q = torch.zeros((1, 2, 16), device="meta")
    kc = torch.zeros((1, 8, 1, 16), device="meta")
    t = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fd_ops.flash_decode_at(q, kc, kc, t)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("sq", [1, 40, 128, 2048])
def test_flash_attention_tiles_cover_sq_and_fill_the_card(b, sq):
    """The bf16 route's tile choice at InternLM2's 16 q heads on a
    132-SM card: one of the kernel's q tiles, enough tiles to cover Sq, at
    least one block per SM wherever 16-row tiles give that many, and the
    largest tile that does; 32-row K / V tiles up to 256 keys, 64 above."""
    h, n_sm = 16, 132
    tile, kv_tile = fa_ops.choose_tiles(b, h, sq, sq, n_sm)
    assert tile in fa_ops.Q_TILES == (64, 32, 16)
    n_tiles = -(-sq // tile)
    assert n_tiles * tile >= sq > (n_tiles - 1) * tile
    if b * h * -(-sq // 16) >= n_sm:
        assert b * h * n_tiles >= n_sm
    larger = [x for x in fa_ops.Q_TILES if x > tile]
    assert all(b * h * -(-sq // x) < n_sm for x in larger)
    assert kv_tile == (32 if sq <= fa_ops.SHORT_KV else 64)


def test_flash_attention_serving_buckets_take_every_q_tile():
    """At the serving prompt (S = 128) the batch lattice (1, 2, 4, 8) on a
    132-SM card reaches all three q tiles, with 32-row K / V tiles."""
    got = {b: fa_ops.choose_tiles(b, 16, 128, 128, 132) for b in (1, 2, 4, 8)}
    assert got == {1: (16, 32), 2: (16, 32), 4: (32, 32), 8: (64, 32)}


@pytest.mark.parametrize("ops", [fa_ops, fd_ops])
@pytest.mark.parametrize("make,ok", [
    (lambda: torch.zeros((2, 8, 2, 16), dtype=torch.bfloat16), True),
    (lambda: torch.zeros((2, 9, 2, 16), dtype=torch.bfloat16)[:, 1:], True),
    (lambda: torch.zeros((2, 8, 2, 24), dtype=torch.bfloat16)[..., 8:], True),
    (lambda: torch.zeros((2, 8, 2, 24), dtype=torch.bfloat16)[..., 4:20],
     False),                                             # 8-byte row offset
    (lambda: torch.zeros((2, 8, 2, 20), dtype=torch.bfloat16)[..., :16],
     False),                                             # 40-byte row stride
    (lambda: torch.zeros((1, 8, 2, 20))[..., :16], True),  # 80-byte stride
    (lambda: torch.zeros((1, 8, 2, 18))[..., :16], False),
])
def test_rows_aligned_for_16_byte_copies(ops, make, ok):
    assert ops.rows_aligned(make()) is ok


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
    assert set(srcs) == {"flash_attention", "flash_decode", "rwkv6"}
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
    """Every (q tile, kv tile) route of the bf16 kernel on a 132-SM card,
    Sq not a multiple of 16, and the masks; float32 takes the FMA route at
    the same shapes."""
    g = torch.Generator(device=cuda).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    tiles = set()
    for b, sq, skv, h, kvh, d, kw in [
            (8, 128, 128, 16, 8, 128, {}),
            (1, 128, 128, 16, 8, 128, {}),
            (2, 256, 256, 16, 8, 128, {}),
            (1, 512, 512, 16, 8, 128, {}),
            (1, 2048, 2048, 16, 8, 128, {}),
            (1, 384, 384, 4, 2, 64, {"local_block": 128}),
            (2, 40, 40, 4, 2, 16, {"window": 16}),
            (1, 50, 90, 4, 2, 64, {"local_block": 16}),
            (1, 100, 100, 8, 2, 32, {"window": 30, "local_block": 64})]:
        q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
        k = torch.randn((b, skv, kvh, d), generator=g, device=cuda).to(dtype)
        v = torch.randn((b, skv, kvh, d), generator=g, device=cuda).to(dtype)
        kw = dict(q_offset=skv - sq, **kw)
        out = fa_ops.flash_attention(q, k, v, **kw)
        ref = fa_ops.flash_attention_oracle(q, k, v, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        tiles.add(fa_ops.choose_tiles(b, h, sq, skv, n_sm))
    if n_sm == 132:
        assert tiles == {(q, kv) for q in fa_ops.Q_TILES
                         for kv in fa_ops.KV_TILES}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_decode_matches_plain(cuda, dtype, tol):
    """The serving shape; t = 0; a cache shorter than one cluster's chunks
    and a t that leaves most blocks empty; S = 4096 with every block
    walking several chunks; the ring masks over a cluster."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for b, s, h, kvh, d, t, kw in [
            (8, 144, 16, 8, 128, 143, {}),
            (1, 144, 16, 8, 128, 0, {}),
            (2, 40, 16, 8, 128, 39, {}),
            (1, 144, 16, 8, 128, 20, {}),
            (2, 4096, 16, 8, 128, 4095, {}),
            (2, 700, 4, 2, 64, 350, {}),
            (1, 512, 4, 2, 64, 2000, {"window": 512}),
            (2, 1024, 16, 8, 128, 3000, {"window": 300}),
            (2, 1024, 8, 2, 64, 2500, {"local_block": 256})]:
        q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
        kc = torch.randn((b, s, kvh, d), generator=g, device=cuda).to(dtype)
        vc = torch.randn((b, s, kvh, d), generator=g, device=cuda).to(dtype)
        t_dev = torch.tensor([t], dtype=torch.int32, device=cuda)
        out = fd_ops.flash_decode_at(q, kc, vc, t_dev, **kw)
        ref = fd_ops.decode_ref(q, kc, vc, t=t, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_decode_at_200_steps_with_t_on_the_device(cuda, dtype,
                                                              tol):
    """200 back-to-back launches on the same tensors, t advanced on the
    device between them with no host read: each step matches the plain
    version at its own position."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, s, h, kvh, d = 2, 256, 16, 8, 128
    q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
    kc = torch.randn((b, s, kvh, d), generator=g, device=cuda).to(dtype)
    vc = torch.randn((b, s, kvh, d), generator=g, device=cuda).to(dtype)
    t_dev = torch.full((1,), 40, dtype=torch.int32, device=cuda)
    outs = []
    for _ in range(200):
        outs.append(fd_ops.flash_decode_at(q, kc, vc, t_dev))
        t_dev.add_(1)
    torch.cuda.synchronize()
    assert int(t_dev) == 240
    for step, out in enumerate(outs):
        ref = fd_ops.decode_ref(q, kc, vc, t=40 + step)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
