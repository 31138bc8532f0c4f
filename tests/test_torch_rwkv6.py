"""RWKV6 slice of the port vs the reference package, on the CPU.

The same numpy inputs, drawn from a seed, go through the reference (its
``ops.wkv6`` in Pallas interpret mode, its jnp ``models/rwkv6.py``) and
through the port (``kernels/rwkv6/ops.py``, whose CPU branch is the plain
``wkv6_ref``, and ``models/rwkv6.py``).  The model tests run on the
reference's own ``init`` tree, carried into the port by
``params_from_reference``, in float32.

Tolerances:
  * 5e-3 where a chunked evaluation of the recurrence meets a sequential
    one, and for states (the reference's ``WKV_TOL``,
    tests/test_realcompute.py: the chunked scan reassociates the state
    recurrence);
  * 1e-4 for y of two evaluations that associate the same way, and for the
    model's logits and caches (float32 on both sides; the reference's own
    kernel-vs-plain gap on the reduced model is ~1e-6).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import reduced as ref_reduced
from repro.models.model import RunOptions as RefRunOptions
from repro.models.model import get_model as ref_get_model
from repro_torch.configs.registry import get_config, reduced
from repro_torch.kernels.rwkv6 import ops as rw_ops
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models import rwkv6
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import RunOptions, get_model

WKV_TOL = 5e-3
TIGHT = 1e-4
ARCH = "rwkv6_1_6b"
REF_F32 = RefRunOptions(remat="none", param_dtype=jnp.float32,
                        act_dtype=jnp.float32)


def _wkv_inputs(seed, b, t, h, kd):
    """r, k, v, lw (B, T, H, K), u (H, K), s0 (B, H, K, K) as numpy f32:
    lw = -exp(N(0, 1)), u = 0.5 N(0, 1), s0 ~ N(0, 1) (nonzero)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = n(b, t, h, kd), n(b, t, h, kd), n(b, t, h, kd)
    lw = -np.exp(n(b, t, h, kd))
    u = 0.5 * n(h, kd)
    return r, k, v, lw, u, n(b, h, kd, kd)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


# ---- (a) ops.wkv6 against the reference's ops (Pallas interpret) ----------

@pytest.mark.parametrize("b,h,t,kd", [
    (2, 4, 64, 64), (1, 2, 96, 64), (2, 2, 70, 64), (1, 1, 32, 128),
    (2, 2, 48, 8)])
def test_wkv6_ops_match_reference_ops(b, h, t, kd):
    from repro.kernels.rwkv6.ops import wkv6 as ref_wkv6
    args = _wkv_inputs(0, b, t, h, kd)
    y_ref, s_ref = ref_wkv6(*(jnp.asarray(a) for a in args))
    y, s_fin = rw_ops.wkv6(*(torch.from_numpy(a) for a in args))
    assert y.shape == (b, t, h, kd) and y.dtype == torch.float32
    assert s_fin.shape == (b, h, kd, kd) and s_fin.dtype == torch.float32
    _close(y, y_ref, WKV_TOL)
    _close(s_fin, s_ref, WKV_TOL)


def test_wkv6_ref_matches_reference_oracle():
    """The plain version is the reference's sequential oracle."""
    from repro.kernels.rwkv6.ref import wkv6_ref as ref_oracle
    r, k, v, lw, u, s0 = _wkv_inputs(1, 2, 40, 3, 16)
    args = [np.moveaxis(x, 1, 2) for x in (r, k, v, lw)] + [u, s0]
    y_ref, s_ref = ref_oracle(*(jnp.asarray(a) for a in args))
    y, s_fin = wkv6_ref(*(torch.from_numpy(a) for a in args))
    _close(y, y_ref, TIGHT)
    _close(s_fin, s_ref, TIGHT)


def test_wkv6_bf16_inputs_return_bf16():
    args = [torch.from_numpy(a) for a in _wkv_inputs(2, 1, 33, 2, 8)]
    r, k, v = (x.bfloat16() for x in args[:3])
    y, s_fin = rw_ops.wkv6(r, k, v, *args[3:])
    y32, s32 = rw_ops.wkv6(r.float(), k.float(), v.float(), *args[3:])
    assert y.dtype == torch.bfloat16 and s_fin.dtype == torch.float32
    torch.testing.assert_close(y.float(), y32, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(s_fin, s32, atol=TIGHT, rtol=TIGHT)


# ---- (b) the model's plain recurrences against the reference's ------------

@pytest.mark.parametrize("t", [64, 70, 20])     # 70: a remainder chunk
def test_wkv6_chunked_matches_reference(t):
    from repro.models.rwkv6 import wkv6_chunked as ref_chunked
    args = _wkv_inputs(3, 2, t, 2, 16)
    y_ref, s_ref = ref_chunked(*(jnp.asarray(a) for a in args))
    y, s_fin = rwkv6.wkv6_chunked(*(torch.from_numpy(a) for a in args))
    _close(y, y_ref, TIGHT)
    _close(s_fin, s_ref, WKV_TOL)


@pytest.mark.parametrize("t", [32, 70])
def test_wkv6_chunked_matches_sequential_plain_version(t):
    args = [torch.from_numpy(a) for a in _wkv_inputs(4, 2, t, 2, 16)]
    y, s_fin = rwkv6.wkv6_chunked(*args)
    y_seq, s_seq = rw_ops.wkv6(*args)
    torch.testing.assert_close(y, y_seq, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(s_fin, s_seq, atol=WKV_TOL, rtol=WKV_TOL)


def test_wkv6_step_matches_reference():
    from repro.models.rwkv6 import wkv6_step as ref_step
    args = _wkv_inputs(5, 3, 1, 2, 16)
    y_ref, s_ref = ref_step(*(jnp.asarray(a) for a in args))
    y, s_fin = rwkv6.wkv6_step(*(torch.from_numpy(a) for a in args))
    _close(y, y_ref, TIGHT)
    _close(s_fin, s_ref, WKV_TOL)


# ---- (c) the reduced model against the reference's plain path -------------

def _perturbed_reference_params(seed=0):
    """The reference's init tree with seeded noise on u, mu_* and w0 (at
    init u = 0 and mu = 0 would hide a wrong bonus term or ddlerp)."""
    ref = ref_get_model(ref_reduced(ref_get_config(ARCH)), REF_F32)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    layers = dict(tree["layers"])
    for name, arr in layers.items():
        if name == "u" or name.startswith("mu") or name == "w0":
            layers[name] = (arr + 0.5 * rng.standard_normal(arr.shape)
                            ).astype(np.float32)
    tree = dict(tree, layers=layers)
    return ref, jax.tree.map(jnp.asarray, tree), params_from_reference(tree)


def _port(use_kernels=True):
    return get_model(reduced(get_config(ARCH)),
                     RunOptions(param_dtype=torch.float32,
                                act_dtype=torch.float32,
                                use_kernels=use_kernels), device="cpu")


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_cache_and_decode_match_reference(use_kernels):
    ref, ref_params, params = _perturbed_reference_params()
    port = _port(use_kernels)
    s, extra = 40, 4
    toks = np.random.default_rng(0).integers(0, port.cfg.vocab,
                                             (2, s + extra))
    lg, cache = ref.prefill(ref_params,
                            {"tokens": jnp.asarray(toks[:, :s], jnp.int32)})
    plg, pcache = port.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :s])}, max_len=s + extra)

    def same_caches():
        for name in ("wkv", "tm", "cm"):
            _close(pcache[name], cache[name], TIGHT)
        assert int(pcache["t"]) == int(cache["t"])

    _close(plg, lg, TIGHT)
    same_caches()
    assert int(pcache["t"]) == s
    for i in range(extra):
        nxt = toks[:, s + i:s + i + 1]
        lg, cache = ref.decode(ref_params, cache, jnp.asarray(nxt, jnp.int32))
        plg, pcache = port.decode(params, pcache, torch.from_numpy(nxt))
        _close(plg, lg, TIGHT)
    same_caches()
    assert int(pcache["t"]) == s + extra


# ---- (d), (e) the port's own consistency ----------------------------------

def test_prefill_decode_matches_hidden_forward():
    """Prefill then decode gives the logits of one full-sequence forward
    at every position."""
    _, _, params = _perturbed_reference_params(1)
    m = _port()
    S, extra = 37, 4
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, m.cfg.vocab, (2, S + extra)))
    full = m.hidden(params, {"tokens": toks}) @ params["lm_head"].T
    lg, cache = m.prefill(params, {"tokens": toks[:, :S]})
    torch.testing.assert_close(lg, full[:, S - 1], atol=TIGHT, rtol=TIGHT)
    for i in range(extra):
        lg, cache = m.decode(params, cache, toks[:, S + i:S + i + 1])
        torch.testing.assert_close(lg, full[:, S + i], atol=TIGHT,
                                   rtol=TIGHT)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_into_a_dirty_cache_equals_a_fresh_one(use_kernels):
    """An executor reuses one cache per bucket: prefill must start from a
    zero state whatever the cache holds."""
    _, _, params = _perturbed_reference_params(2)
    m = _port(use_kernels)
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.integers(0, m.cfg.vocab, (2, 20)))
            for _ in range(2))
    fresh_lg, fresh = m.prefill(params, {"tokens": b},
                                cache=m.init_cache(2, 24))
    dirty = m.init_cache(2, 24)
    m.prefill(params, {"tokens": a}, cache=dirty)
    m.decode(params, dirty, a[:, :1])
    lg, out = m.prefill(params, {"tokens": b}, cache=dirty)
    assert out is dirty
    torch.testing.assert_close(lg, fresh_lg, atol=0, rtol=0)
    for name in ("t", "wkv", "tm", "cm"):
        torch.testing.assert_close(dirty[name], fresh[name], atol=0, rtol=0)


# ---- (f) parameters ---------------------------------------------------------

def test_param_names_shapes_and_init_rules_match_reference():
    ref, ref_params, flat = _perturbed_reference_params()
    m = _port()
    p0, p1, p2 = m.init(0), m.init(0), m.init(1)
    assert set(p0) == set(flat)
    assert all(tuple(flat[k].shape) == tuple(p0[k].shape) for k in flat)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert not torch.equal(p0["layers/wr"], p2["layers/wr"])
    raw = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    for path, val in params_from_reference(raw).items():
        name = path.rsplit("/", 1)[-1]
        if "scale" in name or name == "w0" or name == "u" or \
                "bias" in name or name.startswith("mu"):
            # constant-initialised leaves: identical on both sides
            torch.testing.assert_close(p0[path], val, atol=0, rtol=0)
    assert torch.all(p0["layers/w0"] == -1)
    cfg = m.cfg
    # dense_init: std 1/sqrt(fan_in), fan_in the second-to-last dim
    assert abs(float(p0["layers/wr"].std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert abs(float(p0["layers/wmix_b"].std()) * rwkv6.LORA_MIX ** 0.5
               - 1) < 0.1


def test_cache_specs_match_reference():
    ref = ref_get_model(ref_reduced(ref_get_config(ARCH)), REF_F32)
    m = _port()
    ref_specs = ref.cache_specs(3, 99)
    specs = m.cache_specs(3, 99)
    assert set(specs) == set(ref_specs)
    for name, (shape, dtype) in specs.items():
        assert tuple(shape) == tuple(ref_specs[name].shape)
        assert str(dtype).replace("torch.", "") == str(ref_specs[name].dtype)


def test_train_mode_raises():
    """Train mode writes no cache: handed one it raises, as an unknown
    mode does (tests/test_torch_train.py trains through it)."""
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="writes no cache"):
        rwkv6.forward(reduced(get_config(ARCH)), {}, toks, mode="train",
                      cache={})
    with pytest.raises(ValueError, match="unknown mode"):
        rwkv6.forward(reduced(get_config(ARCH)), {}, toks, mode="trian")


# ---- the wrapper's contract -------------------------------------------------

def test_wkv6_checks_its_inputs():
    r, k, v, lw, u, s0 = (torch.from_numpy(a)
                          for a in _wkv_inputs(6, 1, 8, 2, 8))
    with pytest.raises(ValueError):                 # u of the wrong shape
        rw_ops.wkv6(r, k, v, lw, u[:1], s0)
    with pytest.raises(ValueError):                 # s0 of the wrong shape
        rw_ops.wkv6(r, k, v, lw, u, s0[:, :1])
    with pytest.raises(ValueError):                 # 3-d input
        rw_ops.wkv6(r[0], k, v, lw, u, s0)
    with pytest.raises(TypeError):                  # mixed dtypes
        rw_ops.wkv6(r.double(), k, v, lw, u, s0)
    with pytest.raises(TypeError):                  # s0 must be float32
        rw_ops.wkv6(r, k, v, lw, u, s0.bfloat16())


def test_cpu_tensors_take_the_plain_version_without_launching():
    rw_ops.wkv6.launches = 0
    args = [torch.from_numpy(a) for a in _wkv_inputs(7, 1, 8, 2, 8)]
    rw_ops.wkv6(*args)
    m = _port()
    m.prefill(m.init(0), {"tokens": torch.zeros((1, 5), dtype=torch.long)})
    assert rw_ops.wkv6.launches == 0


# ---- the kernel's launch shape --------------------------------------------

LATTICE = (1, 2, 4, 8)      # the serving batch buckets
HEADS = (1, 4, 32)          # RWKV6-1.6B has 32 heads of 64


@pytest.mark.parametrize("kd", rw_ops.HEAD_DIMS)
@pytest.mark.parametrize("n_sms", [132, 16])
def test_launch_shape_fits_the_kernel_and_fills_the_card(kd, n_sms):
    for b in LATTICE:
        for h in HEADS:
            vb, p, cols = rw_ops.launch_shape(b, h, kd, n_sms)
            assert (vb, p, cols) in rw_ops.routes(kd)
            assert kd % vb == 0 and kd % p == 0 and vb % cols == 0
            assert vb // cols * p <= 1024
            assert kd // p <= 64
            # the grid gives 7/8 of the SMs a block wherever VB = 8 would
            if b * h * kd // min(rw_ops.COL_WIDTHS) * 8 >= 7 * n_sms:
                assert kd // vb * h * b * 8 >= 7 * n_sms, (b, h, kd, vb)


def test_launch_shape_picks_the_measured_best_routes():
    """RWKV6-1.6B (H = 32, K = 64) on the H100's 132 SMs: the fastest
    route of the sweep at each serving bucket (PERF.md)."""
    got = [rw_ops.launch_shape(b, 32, 64, 132) for b in LATTICE]
    assert got == [(16, 8, 2), (32, 8, 2), (64, 8, 4), (64, 8, 4)]


@pytest.mark.parametrize("kd", rw_ops.HEAD_DIMS)
def test_routes_are_what_the_kernel_takes(kd):
    """Each (VB, P, CPT): VB a power of two dividing V with 16-byte bf16 v
    copies; P lanes per column group, each with 8 state rows (4 at K = 8);
    CPT <= P columns a lane, at most 32 state registers; a thread per
    (group, lane) within the launch bound."""
    got = rw_ops.routes(kd)
    assert len(set(got)) == len(got) > 0
    for vb, p, cols in got:
        assert vb & (vb - 1) == 0 and kd % vb == 0 and vb * 2 % 16 == 0
        assert p == rw_ops.lanes_per_column(kd) and kd // p in (4, 8)
        assert vb % cols == 0 and cols <= p and kd // p * cols <= 32
        assert vb // cols * p <= rw_ops.MAX_THREADS


def test_launch_refuses_what_the_kernel_does_not_take():
    r, k, v, lw, u, s0 = (torch.from_numpy(a)
                          for a in _wkv_inputs(9, 1, 8, 2, 16))
    with pytest.raises(ValueError, match="not in"):     # 2 rows a lane
        rw_ops._launch(r, k, v, lw, u, s0, shape=(8, 8, 2))
    with pytest.raises(ValueError, match="16-byte"):    # rows off by 4 B
        wide = torch.from_numpy(_wkv_inputs(9, 1, 8, 2, 17)[0])
        rw_ops._launch(wide[..., 1:], k, v, lw, u, s0, shape=(16, 2, 2))


# ---- (g) on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, WKV_TOL),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_wkv6_matches_plain(cuda, dtype, tol):
    """The kernel against the plain recurrence, nonzero s0 throughout: at
    the shapes :func:`launch_shape` routes (the serving shapes, K = 128,
    ragged tails), then on every (VB, P, CPT) route the kernel takes at every
    head dim, at T = 1, 31, 33 and 200 (one token, inside one staged
    chunk, one past it, several chunks with a ragged tail), then with
    strided heads."""
    def check(r, k, v, lw, u, s0, shape=None):
        r, k, v = (x.to(dtype) for x in (r, k, v))
        if shape is None:
            y, s_fin = rw_ops.wkv6(r, k, v, lw, u, s0)
        else:
            y, s_fin = rw_ops._launch(r, k, v, lw, u, s0, shape)
        y_ref, s_ref = wkv6_ref(*(x.transpose(1, 2) for x in (r, k, v, lw)),
                                u, s0)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), y_ref.transpose(1, 2).float(),
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(s_fin, s_ref, atol=tol, rtol=tol)

    def inputs(seed, b, t, h, kd):
        return [torch.from_numpy(a).to(cuda)
                for a in _wkv_inputs(seed, b, t, h, kd)]

    for b, t, h, kd in [(8, 128, 32, 64), (1, 128, 32, 64), (2, 70, 2, 16),
                        (1, 32, 1, 128), (4, 200, 8, 128), (2, 48, 2, 8)]:
        check(*inputs(8, b, t, h, kd))
    # routes() holds every shape launch_shape can return (the CPU tests)
    for kd in rw_ops.HEAD_DIMS:
        for shape in rw_ops.routes(kd):
            for t in (1, 31, 33, 200):
                check(*inputs(10 + t, 2, t, 2, kd), shape=shape)
    for kd, shape in [(16, (8, 2, 2)), (64, (16, 8, 4)), (128, (16, 16, 2))]:
        r, k, v, lw, u, s0 = inputs(11, 2, 70, 4, kd)
        check(*(x[:, :, ::2] for x in (r, k, v, lw)), u[::2], s0[:, ::2],
              shape=shape)
