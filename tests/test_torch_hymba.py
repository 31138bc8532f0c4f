"""Hymba (hybrid family) slice of the port vs the reference package, on
the CPU.

The same numpy inputs, drawn from a seed, go through the reference's jnp
``models/hymba.py`` and ``layers.decode_ring_attention`` (no Pallas kernel
runs on its Hymba path) and through the port's ``models/hymba.py`` and
``models/layers.py``.  The model tests run on the reference's own ``init``
tree with seeded noise on the constant-initialised leaves, carried into
the port by ``params_from_reference``, in float32.

Tolerances: 2e-5 for the SSM scan, step and ring attention (the float32
tolerance of tests/test_kernels.py; the doubling scan associates the
products differently from ``associative_scan``); 1e-4 for the model's
logits and caches, as in tests/test_torch_rwkv6.py.
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
from repro_torch.models import hymba, kvcache
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import RunOptions, get_model

F32_TOL = 2e-5
TIGHT = 1e-4
ARCH = "hymba_1_5b"
REF_F32 = RefRunOptions(remat="none", param_dtype=jnp.float32,
                        act_dtype=jnp.float32)
PERTURBED = ("d_skip", "b_dt", "a_log", "ln1_scale", "ln2_scale",
             "fuse_attn_scale", "fuse_ssm_scale")


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def _ssm_inputs(seed, b, t, d, n):
    """xm (B, T, D), dt > 0 (softplus of a normal), b_in / c_in (B, T, N),
    a_log (D, N) = log(1..N) + noise, d_skip (D,), h0 (B, D, N), numpy
    float32."""
    rng = np.random.default_rng(seed)

    def n_(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt = np.log1p(np.exp(n_(b, t, d))).astype(np.float32)
    a_log = (np.log(np.arange(1, n + 1, dtype=np.float32))[None]
             + 0.3 * n_(d, n)).astype(np.float32)
    return (n_(b, t, d), dt, n_(b, t, n), n_(b, t, n), a_log, n_(d),
            n_(b, d, n))


# ---- the SSM against the reference's --------------------------------------

@pytest.mark.parametrize("t,chunk,h0", [
    (32, 16, False),     # T a multiple of the chunk: two chunks
    (40, 16, False),     # a remainder chunk of 8
    (37, 16, True),      # a remainder chunk of 5, nonzero h0
    (20, 256, True),     # one chunk shorter than SSM_CHUNK
    (1, 256, True)])
def test_ssm_scan_matches_reference(t, chunk, h0):
    from repro.models.hymba import ssm_scan as ref_scan
    args = list(_ssm_inputs(0, 2, t, 12, 8))
    if not h0:
        args[-1] = np.zeros_like(args[-1])
    y_ref, h_ref = ref_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    y, h_fin = hymba.ssm_scan(*(torch.from_numpy(a) for a in args),
                              chunk=chunk)
    assert y.shape == (2, t, 12) and h_fin.shape == (2, 12, 8)
    _close(y, y_ref, F32_TOL)
    _close(h_fin, h_ref, F32_TOL)


def test_ssm_scan_equals_its_steps():
    """The chunked doubling scan is the per-token recurrence."""
    args = [torch.from_numpy(a) for a in _ssm_inputs(1, 2, 23, 6, 4)]
    y, h_fin = hymba.ssm_scan(*args, chunk=8)
    xm, dt, b_in, c_in, a_log, d_skip, h = args
    ys = []
    for i in range(xm.shape[1]):
        sl = slice(i, i + 1)
        yi, h = hymba.ssm_step(xm[:, sl], dt[:, sl], b_in[:, sl],
                               c_in[:, sl], a_log, d_skip, h)
        ys.append(yi)
    torch.testing.assert_close(y, torch.cat(ys, 1), atol=F32_TOL,
                               rtol=F32_TOL)
    torch.testing.assert_close(h_fin, h, atol=F32_TOL, rtol=F32_TOL)


def test_ssm_step_matches_reference():
    from repro.models.hymba import ssm_step as ref_step
    args = _ssm_inputs(2, 3, 1, 12, 8)
    y_ref, h_ref = ref_step(*(jnp.asarray(a) for a in args))
    y, h_fin = hymba.ssm_step(*(torch.from_numpy(a) for a in args))
    assert y.shape == (3, 1, 12)
    _close(y, y_ref, F32_TOL)
    _close(h_fin, h_ref, F32_TOL)


# ---- ring attention against the reference's --------------------------------

@pytest.mark.parametrize("w,t,masks", [
    (16, 5, {}),                                  # before the ring wraps
    (16, 15, {}),                                 # the last unwrapped slot
    (16, 16, {}),                                 # the first wrap
    (16, 41, {}),                                 # wrapped twice
    (16, 41, {"window": 10}),
    (16, 9, {"window": 4}),
    (16, 41, {"local_block": 8}),
    (32, 70, {"window": 20, "local_block": 16})])
def test_decode_ring_attention_matches_reference(w, t, masks):
    from repro.models.layers import decode_ring_attention as ref_ring
    rng = np.random.default_rng(w + t)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((2, w, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, w, 2, 16)).astype(np.float32)
    ref = ref_ring(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                   t=jnp.asarray(t, jnp.int32), **masks)
    out = L.decode_ring_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc),
                                  t=torch.tensor(t, dtype=torch.int32),
                                  **masks)
    assert out.shape == (2, 1, 8, 16)
    _close(out, ref, F32_TOL)


# ---- the reduced model against the reference -------------------------------

def _perturbed_reference_params(seed=0):
    """The reference's init tree with seeded noise on d_skip, b_dt, a_log
    and the four norm scales (at init d_skip = b_dt = 0 and the scales 1
    would hide a wrong skip, dt or fusion term)."""
    ref = ref_get_model(ref_reduced(ref_get_config(ARCH)), REF_F32)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    layers = dict(tree["layers"])
    for name in PERTURBED:
        arr = layers[name]
        layers[name] = (arr + 0.5 * rng.standard_normal(arr.shape)
                        ).astype(np.float32)
    tree = dict(tree, layers=layers)
    return ref, jax.tree.map(jnp.asarray, tree), params_from_reference(tree)


def _port():
    return get_model(reduced(get_config(ARCH)),
                     RunOptions(param_dtype=torch.float32,
                                act_dtype=torch.float32), device="cpu")


def _ref_full_logits(ref, ref_params, toks):
    from repro.models import hymba as ref_hymba
    x, _ = ref_hymba.forward(ref.cfg, ref_params, jnp.asarray(toks, jnp.int32),
                             None, REF_F32, "hidden")
    return np.asarray(jnp.einsum("bsd,vd->bsv", x, ref_params["lm_head"]))


@pytest.mark.parametrize("s", [48, 16])    # wider and narrower than W = 32
def test_prefill_cache_and_decode_match_reference(s):
    """At S = 16 the reference packs a ring of 16 slots, so its decode
    evicts positions still inside the window; the port does the same."""
    ref, ref_params, params = _perturbed_reference_params()
    port = _port()
    extra = 4
    toks = np.random.default_rng(s).integers(0, port.cfg.vocab,
                                             (2, s + extra))
    lg, cache = ref.prefill(ref_params,
                            {"tokens": jnp.asarray(toks[:, :s], jnp.int32)})
    plg, pcache = port.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :s])}, max_len=s + extra)

    def same_caches():
        for name in ("k", "v", "ssm"):
            assert tuple(pcache[name].shape) == tuple(cache[name].shape)
            _close(pcache[name], cache[name], TIGHT)
        assert int(pcache["t"]) == int(cache["t"])

    _close(plg, lg, TIGHT)
    same_caches()
    assert pcache["k"].shape[2] == min(s, port.cfg.window)
    for i in range(extra):
        nxt = toks[:, s + i:s + i + 1]
        lg, cache = ref.decode(ref_params, cache, jnp.asarray(nxt, jnp.int32))
        plg, pcache = port.decode(params, pcache, torch.from_numpy(nxt))
        _close(plg, lg, TIGHT)
    same_caches()
    assert int(pcache["t"]) == s + extra


def test_short_prompt_ring_is_the_prompt_wide_as_in_the_reference():
    """The reference's defect, reproduced: a 16-token prompt packs a ring
    of 16 slots where ``cache_specs`` would give 20, and the first decode
    step overwrites position 0 while it is still inside the 32-token
    window, so decode departs from the full forward.  Both packages agree
    on the departure."""
    ref, ref_params, params = _perturbed_reference_params(3)
    port = _port()
    s, extra = 16, 4
    assert port.cache_specs(2, s + extra)["k"][0][2] == s + extra
    toks = np.random.default_rng(3).integers(0, port.cfg.vocab,
                                             (2, s + extra))
    full = _ref_full_logits(ref, ref_params, toks)
    lg, cache = port.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :s])}, max_len=s + extra)
    assert cache["k"].shape[2] == s
    for i in range(extra):
        lg, cache = port.decode(params, cache,
                                torch.from_numpy(toks[:, s + i:s + i + 1]))
        want = full[:, s + i]
        rel = float(np.abs(lg.numpy() - want).max() / np.abs(want).max())
        assert rel > 1e-2, (i, rel)


# ---- the port's own consistency ---------------------------------------------

def test_prefill_decode_matches_hidden_forward():
    """At S >= W the ring holds the whole window: prefill then decode gives
    the logits of one full-sequence forward at every position."""
    _, _, params = _perturbed_reference_params(1)
    m = _port()
    s, extra = 40, 6
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, m.cfg.vocab, (2, s + extra)))
    full = m.hidden(params, {"tokens": toks}) @ params["lm_head"].T
    lg, cache = m.prefill(params, {"tokens": toks[:, :s]})
    torch.testing.assert_close(lg, full[:, s - 1], atol=TIGHT, rtol=TIGHT)
    for i in range(extra):
        lg, cache = m.decode(params, cache, toks[:, s + i:s + i + 1])
        torch.testing.assert_close(lg, full[:, s + i], atol=TIGHT,
                                   rtol=TIGHT)


def test_hidden_matches_reference():
    ref, ref_params, params = _perturbed_reference_params(4)
    m = _port()
    toks = np.random.default_rng(4).integers(0, m.cfg.vocab, (2, 45))
    full = _ref_full_logits(ref, ref_params, toks)
    x = m.hidden(params, {"tokens": torch.from_numpy(toks)})
    _close(x @ params["lm_head"].T, full, TIGHT)


@pytest.mark.parametrize("s", [20, 40])
def test_prefill_into_a_dirty_cache_equals_a_fresh_one(s):
    """An executor reuses one cache per bucket: prefill must start from a
    zero SSM state and rewrite the whole ring, whatever the cache holds."""
    _, _, params = _perturbed_reference_params(2)
    m = _port()
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.integers(0, m.cfg.vocab, (2, s)))
            for _ in range(2))
    fresh_lg, fresh = m.prefill(params, {"tokens": b},
                                cache=m.init_cache(2, s))
    dirty = m.init_cache(2, s)
    m.prefill(params, {"tokens": a}, cache=dirty)
    m.decode(params, dirty, a[:, :1])
    lg, out = m.prefill(params, {"tokens": b}, cache=dirty)
    assert out is dirty
    torch.testing.assert_close(lg, fresh_lg, atol=0, rtol=0)
    for name in ("t", "k", "v", "ssm"):
        torch.testing.assert_close(dirty[name], fresh[name], atol=0, rtol=0)


def test_prefill_refuses_a_ring_of_another_width():
    m = _port()
    params = m.init(0)
    toks = torch.zeros((1, 20), dtype=torch.long)
    with pytest.raises(ValueError, match="ring"):
        m.prefill(params, {"tokens": toks}, cache=m.init_cache(1, 24))


# ---- parameters and caches ---------------------------------------------------

def test_param_names_shapes_and_init_rules_match_reference():
    ref, _, flat = _perturbed_reference_params()
    m = _port()
    p0, p1, p2 = m.init(0), m.init(0), m.init(1)
    assert set(p0) == set(flat)
    assert all(tuple(flat[k].shape) == tuple(p0[k].shape) for k in flat)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert not torch.equal(p0["layers/wq"], p2["layers/wq"])
    raw = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    for path, val in params_from_reference(raw).items():
        name = path.rsplit("/", 1)[-1]
        if "scale" in name or name in ("b_dt", "d_skip", "a_log"):
            # constant-initialised leaves: the same on both sides, up to
            # the last bit of a library's log
            torch.testing.assert_close(p0[path], val, atol=0, rtol=2e-7)
    assert torch.all(p0["layers/d_skip"] == 0)
    n = m.cfg.ssm_state
    torch.testing.assert_close(p0["layers/a_log"][0, 3],
                               torch.log(torch.arange(1.0, n + 1)))
    # dense_init: std 1/sqrt(fan_in), fan_in the second-to-last dim
    assert abs(float(p0["layers/w_in"].std()) * m.cfg.d_model ** 0.5
               - 1) < 0.1


@pytest.mark.parametrize("batch,max_len", [(3, 99), (2, 16), (1, 32)])
def test_cache_specs_match_reference(batch, max_len):
    ref = ref_get_model(ref_reduced(ref_get_config(ARCH)), REF_F32)
    m = _port()
    ref_specs = ref.cache_specs(batch, max_len)
    specs = m.cache_specs(batch, max_len)
    assert set(specs) == set(ref_specs)
    for name, (shape, dtype) in specs.items():
        assert tuple(shape) == tuple(ref_specs[name].shape)
        assert str(dtype).replace("torch.", "") == str(ref_specs[name].dtype)
    assert specs["k"][0][2] == kvcache.cache_len(m.cfg, max_len, "window")


def test_full_width_cache_specs_match_reference():
    ref = ref_get_model(ref_get_config(ARCH))
    m = get_model(get_config(ARCH), device="cpu")
    for name, (shape, _) in m.cache_specs(8, 128).items():
        assert tuple(shape) == tuple(ref.cache_specs(8, 128)[name].shape)
    assert m.cache_specs(8, 128)["k"][0] == (32, 8, 128, 5, 64)


def test_train_mode_raises():
    """Train mode writes no cache: handed one it raises, as an unknown
    mode does (tests/test_torch_train.py trains through it)."""
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="writes no cache"):
        hymba.forward(reduced(get_config(ARCH)), {}, toks, mode="train",
                      cache={})
    with pytest.raises(ValueError, match="unknown mode"):
        hymba.forward(reduced(get_config(ARCH)), {}, toks, mode="trian")


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(get_config(ARCH))
    assert get_model(get_config(ARCH), device="cpu").device.type == "cpu"


def test_executor_cell_holds_the_prompt_wide_ring():
    """A served cell's ring has the width the reference's prefill packs,
    min(window, prompt_len), not max_len; decode reuses it in place."""
    from repro_torch.serving.executor import TorchExecutor
    for prompt_len, want in ((8, 8), (40, 32)):
        ex = TorchExecutor(ARCH, batch_lattice=(2,), quotas=(1.0,),
                           prompt_len=prompt_len, gen_len=3, reduced=True,
                           dtype=torch.float32, device="cpu")
        ex.warmup()
        cache = ex._cell("prefill", 2, 1.0)[0].cache
        assert cache["k"].shape[2] == want
        assert int(cache["t"]) == prompt_len + 3
        assert ex.stats()["nonfinite_passes"] == 0
        ex.shutdown()
