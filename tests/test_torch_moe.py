"""The port's MoE layer and the transformer's ring caches against the
reference package, on the CPU, at reduced size, in float32.

Inputs are numpy arrays (from a seed, or the reference's own ``init``)
handed to both sides.  Tolerances:

* ``route``: ``idx`` and ``valid`` exactly; gates within 1e-6 (the two
  softmaxes round differently in the last bit);
* ``moe_ffn``: 2e-5 (float32 sums reassociated: the port's batched expert
  GEMMs and its gather combine against the reference's einsums and
  scatter-add);
* prefill plus decode: logits and caches within 2e-5;
* training: loss within rel 1e-5, each gradient leaf within 1e-4 x its
  max |g_ref|, as in ``tests/test_torch_train.py``.

``reduced(llama4_maverick_400b_a17b)`` keeps the registry's 2 layers,
which at ``global_every = 4`` stack no macro block at all, on either
side; the tests below take 4 layers (three chunked-local, one global),
the least depth that holds a global layer.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ShapeSpec
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import reduced as ref_reduced
from repro.models import moe as ref_moe
from repro.models.model import RunOptions as RefRunOptions
from repro.models.model import get_model as ref_get_model
from repro_torch.configs.registry import get_config, reduced
from repro_torch.models import moe
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import RunOptions, get_model

MOE_ARCHS = ["mixtral_8x22b", "llama4_maverick_400b_a17b"]
GATE_TOL, FFN_TOL, MODEL_TOL = 1e-6, 2e-5, 2e-5
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
REF_F32 = RefRunOptions(attn_chunk=16, remat="none", param_dtype=jnp.float32,
                        act_dtype=jnp.float32)
F32 = RunOptions(param_dtype=torch.float32, act_dtype=torch.float32,
                 use_kernels=True, remat="none")
# training takes the plain path: the kernels have no backward
F32_TRAIN = RunOptions(attn_chunk=16, remat="none",
                       param_dtype=torch.float32, act_dtype=torch.float32)


def _depth(cfg):
    """Four layers for a config with a global layer every four."""
    return dataclasses.replace(cfg, n_layers=cfg.global_every) \
        if cfg.global_every else cfg


def _pair(arch, seed=0):
    ref = ref_get_model(_depth(ref_reduced(ref_get_config(arch))), REF_F32)
    ref_params = ref.init(jax.random.PRNGKey(seed))
    port = get_model(_depth(reduced(get_config(arch))), F32, device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, ref_params))
    return ref, ref_params, port, params


def _weights(rng, r, t, d, e, f, router_scale=0.5):
    x = rng.normal(size=(r, t, d)).astype(np.float32)
    router = (rng.normal(size=(d, e)) * router_scale).astype(np.float32)
    w1, w2 = ((rng.normal(size=(e, d, f)) * 0.3).astype(np.float32)
              for _ in range(2))
    w3 = (rng.normal(size=(e, f, d)) * 0.3).astype(np.float32)
    return x, router, w1, w2, w3


def _both_route(x, router, e, k, cap):
    a = ref_moe.route(jnp.asarray(x), jnp.asarray(router), e, k, cap)
    b = moe.route(torch.from_numpy(x), torch.from_numpy(router), e, k, cap)
    return [np.asarray(v) for v in a], [v.numpy() for v in b]


# ---- the layer ----------------------------------------------------------------

def test_moe_routing_flop_exact():
    """Port of the reference's test: capacity + gather MoE computes at most
    cf x active-expert slots; its output is the reference's."""
    cfg = reduced(get_config("mixtral_8x22b"))
    key = jax.random.PRNGKey(1)
    r, t, d, e, f = 2, 32, cfg.d_model, cfg.n_experts, cfg.d_ff
    x = jax.random.normal(key, (r, t, d), jnp.float32)
    router = jax.random.normal(key, (d, e), jnp.float32) * 0.1
    w1 = jax.random.normal(key, (e, d, f), jnp.float32) * 0.05
    w2 = jax.random.normal(key, (e, d, f), jnp.float32) * 0.05
    w3 = jax.random.normal(key, (e, f, d), jnp.float32) * 0.05
    ref_out, ref_aux = ref_moe.moe_ffn(x, router, w1, w2, w3, n_experts=e,
                                       top_k=2, capacity_factor=4.0)
    out, aux = moe.moe_ffn(*(torch.from_numpy(np.array(v))
                             for v in (x, router, w1, w2, w3)),
                           n_experts=e, top_k=2, capacity_factor=4.0)
    assert out.shape == x.shape
    assert torch.isfinite(out).all() and torch.isfinite(aux)
    cap = moe.capacity(t, e, 2, 4.0)
    assert cap <= t * 2 and cap == ref_moe.capacity(t, e, 2, 4.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               atol=FFN_TOL, rtol=FFN_TOL)
    assert float(aux) == pytest.approx(float(ref_aux), abs=GATE_TOL)


def test_moe_matches_dense_mixture():
    """Port of the reference's test: with capacity ample, gather-MoE ==
    the explicit dense top-k mixture (on the reference's inputs)."""
    key = jax.random.PRNGKey(2)
    r, t, d, e, f, k = 1, 16, 8, 4, 12, 2
    x = jax.random.normal(key, (r, t, d), jnp.float32)
    ks = jax.random.split(key, 4)
    router = jax.random.normal(ks[0], (d, e), jnp.float32)
    w1 = jax.random.normal(ks[1], (e, d, f), jnp.float32) * 0.3
    w2 = jax.random.normal(ks[2], (e, d, f), jnp.float32) * 0.3
    w3 = jax.random.normal(ks[3], (e, f, d), jnp.float32) * 0.3
    xt, rt, w1t, w2t, w3t = (torch.from_numpy(np.array(v))
                             for v in (x, router, w1, w2, w3))
    out, _ = moe.moe_ffn(xt, rt, w1t, w2t, w3t, n_experts=e, top_k=k,
                         capacity_factor=e * 2.0)
    probs = torch.softmax(xt @ rt, dim=-1)
    gv, gi = torch.topk(probs, k)
    gv = gv / gv.sum(-1, keepdim=True)
    h = torch.einsum("rtd,edf->rtef", xt, w1t) * torch.nn.functional.silu(
        torch.einsum("rtd,edf->rtef", xt, w2t))
    ye = torch.einsum("rtef,efd->rted", h, w3t)
    comb = torch.zeros((r, t, e))
    for j in range(k):
        comb = comb + torch.nn.functional.one_hot(gi[..., j], e) \
            * gv[..., j:j + 1]
    ref = torch.einsum("rted,rte->rtd", ye, comb)
    assert float((out - ref).abs().max()) < 1e-4 * float(ref.abs().max() + 1)


@pytest.mark.parametrize("r,t,d,e,f,k,cf", [
    (2, 32, 16, 4, 24, 2, 4.0),     # reduced Mixtral's routing
    (1, 16, 8, 8, 12, 2, 1.25),     # full Mixtral's experts and factor
    (3, 20, 16, 4, 12, 1, 1.25),    # reduced Llama-4's top-1
    (1, 9, 8, 128, 4, 1, 1.25),     # full Llama-4's 128 experts
])
def test_route_and_moe_ffn_match_reference(r, t, d, e, f, k, cf):
    rng = np.random.default_rng(t * e + k)
    x, router, w1, w2, w3 = _weights(rng, r, t, d, e, f)
    cap = moe.capacity(t, e, k, cf)
    (ri, rv, rg, raux), (pi, pv, pg, paux) = _both_route(x, router, e, k,
                                                         cap)
    assert pi.shape == (r, e, cap)
    assert np.array_equal(pi, ri) and np.array_equal(pv, rv)
    np.testing.assert_allclose(pg, rg, atol=GATE_TOL, rtol=0)
    assert float(paux) == pytest.approx(float(raux), abs=GATE_TOL)
    ref_out, _ = ref_moe.moe_ffn(*(jnp.asarray(v)
                                   for v in (x, router, w1, w2, w3)),
                                 n_experts=e, top_k=k, capacity_factor=cf)
    out, _ = moe.moe_ffn(*(torch.from_numpy(v)
                           for v in (x, router, w1, w2, w3)),
                         n_experts=e, top_k=k, capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               atol=FFN_TOL, rtol=FFN_TOL)


def test_router_tie_goes_to_the_lower_expert():
    """A zero router gives every expert the same probability: top-2 picks
    experts 0 and 1 for every token, as jax.lax.top_k does."""
    x = np.random.default_rng(3).normal(size=(2, 6, 8)).astype(np.float32)
    router = np.zeros((8, 4), np.float32)
    (ri, rv, rg, _), (pi, pv, pg, _) = _both_route(x, router, 4, 2, 12)
    assert np.array_equal(pi, ri) and np.array_equal(pv, rv)
    assert pv[:, :2, :6].all() and not pv[:, 2:].any()
    np.testing.assert_allclose(pg[pv], 0.5, atol=GATE_TOL)


def test_overflowing_capacity_drops_the_same_assignments():
    """Tokens all prefer expert 0, which takes only C of them: the first C
    in token order stay, the rest are dropped on both sides, and the
    dropped tokens' outputs are the same (their other expert only)."""
    rng = np.random.default_rng(4)
    r, t, d, e, f, k = 2, 24, 8, 4, 12, 2
    x, _, w1, w2, w3 = _weights(rng, r, t, d, e, f)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    router = np.zeros((d, e), np.float32)
    router[0, 0] = 8.0
    router[1:] = rng.normal(size=(d - 1, e)) * 0.1
    cap = moe.capacity(t, e, k, 1.0)
    (ri, rv, _, _), (pi, pv, _, _) = _both_route(x, router, e, k, cap)
    assert np.array_equal(pi, ri) and np.array_equal(pv, rv)
    assert pv[:, 0].sum() == r * cap < r * t         # expert 0 overflowed
    assert np.array_equal(pi[:, 0], np.broadcast_to(np.arange(cap),
                                                    (r, cap)))
    ref_out, _ = ref_moe.moe_ffn(*(jnp.asarray(v)
                                   for v in (x, router, w1, w2, w3)),
                                 n_experts=e, top_k=k, capacity_factor=1.0)
    out, _ = moe.moe_ffn(*(torch.from_numpy(v)
                           for v in (x, router, w1, w2, w3)),
                         n_experts=e, top_k=k, capacity_factor=1.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               atol=FFN_TOL, rtol=FFN_TOL)


# ---- the model ----------------------------------------------------------------

@pytest.mark.parametrize("s", [16, 48])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch, s):
    """Prompts shorter (16) and longer (48) than the ring of 32: the ring
    padded out to max_len's width, and the ring rolled."""
    ref, ref_params, port, params = _pair(arch)
    extra = 4
    toks = np.random.default_rng(s).integers(0, port.cfg.vocab,
                                             (2, s + extra))
    lg, cache = ref.prefill(ref_params, {"tokens": jnp.asarray(
        toks[:, :s], jnp.int32)}, max_len=s + extra)
    plg, pcache = port.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :s])}, max_len=s + extra)
    names = sorted(n for n in cache if n != "t")
    assert names == sorted(n for n in pcache if n != "t")
    assert names == (["k_global", "k_local", "v_global", "v_local"]
                     if port.cfg.global_every else ["k", "v"])

    def check():
        np.testing.assert_allclose(plg.numpy(), np.asarray(lg),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        for n in names:
            np.testing.assert_allclose(pcache[n].numpy(),
                                       np.asarray(cache[n]), atol=MODEL_TOL,
                                       rtol=MODEL_TOL)
        assert int(pcache["t"]) == int(cache["t"])

    check()
    for i in range(extra):
        nxt = toks[:, s + i:s + i + 1]
        lg, cache = ref.decode(ref_params, cache, jnp.asarray(nxt, jnp.int32))
        plg, pcache = port.decode(params, pcache, torch.from_numpy(nxt))
        check()
    assert int(pcache["t"]) == s + extra


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Port of the reference's test of the same name (which its registry's
    2-layer Llama-4 passes with no layer at all): prefill then decode past
    the ring's width gives the logits of one full forward.  Capacity
    factor 4 drops no assignment at either length."""
    cfg = _depth(reduced(get_config(arch)))
    m = get_model(cfg, F32, device="cpu")
    params = m.init(0)
    S, extra = 48, 3
    tokens = torch.randint(0, cfg.vocab, (2, S + extra),
                           generator=torch.Generator().manual_seed(0))
    full, _ = m.forward(params, {"tokens": tokens})
    lg, cache = m.prefill(params, {"tokens": tokens[:, :S]},
                          max_len=S + extra + 1)
    scale = float(full.abs().max())
    assert (lg - full[:, S - 1]).abs().max() < 1e-3 * scale
    for i in range(extra):
        lg, cache = m.decode(params, cache, tokens[:, S + i:S + i + 1])
        assert (lg - full[:, S + i]).abs().max() < 1e-3 * scale


def test_ring_slot_holds_position_mod_width_and_decode_writes_one_slot():
    """Mixtral's window ring (32 slots) after a 40-token prompt: slot i
    holds the keys of position i mod 32 (the last 32 positions, rolled);
    each decode step writes slot t mod 32 only."""
    cfg = reduced(get_config("mixtral_8x22b"))
    m = get_model(cfg, F32, device="cpu")
    params = m.init(0)
    s, w = 40, cfg.window
    toks = torch.randint(0, cfg.vocab, (1, s + 2),
                         generator=torch.Generator().manual_seed(5))
    _, cache = m.prefill(params, {"tokens": toks[:, :s]}, max_len=s + 2)
    assert cache["k"].shape[3] == w
    # the first layer's keys depend on the tokens alone: recompute them
    from repro_torch.models import transformer as T
    layer0 = T.unstack_layers(params, 2)[0]
    x = T._norm(cfg, layer0, "ln1", T._embed(cfg, params, toks[:, :s], None,
                                             F32))
    _, k, _ = T._qkv(cfg, layer0, x, torch.arange(s))
    for i in range(w):
        pos = max(p for p in range(s) if p % w == i)
        torch.testing.assert_close(cache["k"][0, 0, 0, i], k[0, pos],
                                   atol=1e-6, rtol=1e-6)
    for step in range(2):
        before = cache["k"].clone()
        t = int(cache["t"])
        _, cache = m.decode(params, cache, toks[:, s + step:s + step + 1])
        changed = (cache["k"] != before).flatten(0, 2).any(-1).any(-1) \
            .any(0).nonzero().flatten().tolist()
        assert changed == [t % w]


# ---- training -------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The reference's test_smoke_train_step inputs, held to its values:
    the loss (with 0.01 x the load-balancing loss) and every gradient,
    router and experts included."""
    key = jax.random.PRNGKey(0)
    ref = ref_get_model(_depth(ref_reduced(ref_get_config(arch))), REF_F32)
    ref_params = ref.init(key)
    batch = ref.dummy_inputs(ShapeSpec("t", 64, 2, "train"), key)
    loss, grads = jax.value_and_grad(ref.loss)(ref_params, batch)

    port = get_model(_depth(reduced(get_config(arch))), F32_TRAIN,
                     device="cpu")
    params = {k: v.requires_grad_(True) for k, v in params_from_reference(
        jax.tree.map(np.asarray, ref_params)).items()}
    pbatch = {k: torch.from_numpy(np.array(v)).long()
              for k, v in batch.items()}
    ploss = port.loss(params, pbatch)
    ploss.backward()
    assert float(ploss.detach()) == pytest.approx(float(loss),
                                                rel=LOSS_RTOL)
    g_ref = params_from_reference(jax.tree.map(np.asarray, grads))
    assert {"layers/router", "layers/moe_w1"} <= set(g_ref) == set(params)
    for name, g in g_ref.items():
        scale = float(g.abs().max())
        err = float((params[name].grad - g).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
    assert float(params["layers/router"].grad.abs().max()) > 0


def test_train_forward_returns_the_aux_loss():
    """Train and hidden modes return the layers' summed load-balancing
    loss; lm_loss adds 0.01 of it."""
    cfg = reduced(get_config("mixtral_8x22b"))
    m = get_model(cfg, F32, device="cpu")
    params = m.init(0)
    toks = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(0))
    logits, aux = m.forward(params, {"tokens": toks[:, :-1]})
    assert logits.shape == (2, 16, cfg.vocab) and aux.shape == ()
    # one layer's Switch loss is E * sum_e f_e p_e >= 1 (equal at balance)
    assert float(aux) >= cfg.n_layers * (1 - 1e-6)
    from repro_torch.models import transformer as T
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    x, _ = T.forward(cfg, params, batch["tokens"], opts=F32, mode="hidden")
    ce = T.chunked_lm_loss(x, params["lm_head"], batch["labels"], F32)
    assert float(m.loss(params, batch)) == pytest.approx(
        float(ce + 0.01 * aux), rel=1e-6)


# ---- serving --------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_executor_serves_moe_at_a_depth_cut(arch):
    """The executor builds the config at the depth it is given and serves
    it: every bucket prefills and decodes with finite logits, and the
    cache is the ring layout of that depth."""
    from repro_torch.serving.executor import TorchExecutor
    ex = TorchExecutor(arch, batch_lattice=(1, 2), quotas=(1.0,),
                       prompt_len=12, gen_len=2, reduced=True, n_layers=4,
                       dtype=torch.float32, device="cpu")
    try:
        assert ex.cfg.n_layers == 4 and ex.stats()["n_layers"] == 4
        ex.warmup()
        rec = ex.measure(2, 1.0, reps=1)
        assert rec.wall_ms > 0 and ex.nonfinite == 0
        cell, _ = ex._cell("prefill", 2, 1.0)
        want = ["k_global", "k_local", "t", "v_global", "v_local"] \
            if arch.startswith("llama4") else ["k", "t", "v"]
        assert sorted(cell.cache) == want
    finally:
        ex.shutdown()
    with pytest.raises(ValueError, match="layers"):
        TorchExecutor(arch, reduced=True, n_layers=3 if arch.startswith(
            "llama4") else 0, dtype=torch.float32, device="cpu")
