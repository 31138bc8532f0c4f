"""Port model vs the reference package, on the CPU, at reduced size.

Both sides run on the same parameters: the reference's ``Model.init`` tree,
carried into the port by ``params_from_reference``.  The port runs with
``use_kernels=True`` (its wrappers take the plain versions for CPU tensors)
against the reference's ``use_kernels=False`` jnp path, in float32.

Logits tolerance 1e-4: the two sides reassociate the fp32 sums (the
port's plain attention materialises the softmax where the reference's
chunked attention runs it online); observed differences are ~1e-6, and
1e-4 leaves room for BLAS differences across hosts.
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
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import RunOptions, get_model

LOGITS_TOL = 1e-4
F32 = RunOptions(param_dtype=torch.float32, act_dtype=torch.float32,
                 use_kernels=True)
REF_F32 = RefRunOptions(attn_chunk=16, remat="none", param_dtype=jnp.float32,
                        act_dtype=jnp.float32)
# transformer archs without MoE or ring caches: the ones this slice ports
PORTED = ["internlm2_1_8b", "qwen1_5_110b", "starcoder2_7b"]


def _pair(arch, seed=0):
    ref = ref_get_model(ref_reduced(ref_get_config(arch)), REF_F32)
    ref_params = ref.init(jax.random.PRNGKey(seed))
    port = get_model(reduced(get_config(arch)), F32, device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, ref_params))
    return ref, ref_params, port, params


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_cache_and_decode_match_reference(arch):
    ref, ref_params, port, params = _pair(arch)
    vocab = port.cfg.vocab
    s, extra = 40, 4
    toks = np.random.default_rng(0).integers(0, vocab, (2, s + extra))
    lg, cache = ref.prefill(ref_params, {"tokens": jnp.asarray(toks[:, :s],
                                                               jnp.int32)},
                            max_len=s + extra)
    plg, pcache = port.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :s])}, max_len=s + extra)
    np.testing.assert_allclose(plg.numpy(), np.asarray(lg), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pcache[name].numpy(),
                                   np.asarray(cache[name]), atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)
    assert int(pcache["t"]) == int(cache["t"]) == s
    for i in range(extra):
        nxt = toks[:, s + i:s + i + 1]
        lg, cache = ref.decode(ref_params, cache, jnp.asarray(nxt, jnp.int32))
        plg, pcache = port.decode(params, pcache, torch.from_numpy(nxt))
        np.testing.assert_allclose(plg.numpy(), np.asarray(lg),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(cache["k"]),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    assert int(pcache["t"]) == int(cache["t"]) == s + extra


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_decode_matches_forward(arch):
    """Port of the reference's test of the same name: prefill then decode
    gives the logits of one full-sequence forward at every position."""
    cfg = reduced(get_config(arch))
    m = get_model(cfg, F32, device="cpu")
    params = m.init(0)
    S, extra = 48, 3
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, S + extra), generator=g)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    full = m.hidden(params, {"tokens": tokens}) @ head.T
    lg, cache = m.prefill(params, {"tokens": tokens[:, :S]},
                          max_len=S + extra + 1)
    scale = float(full.abs().max())
    assert (lg - full[:, S - 1]).abs().max() < 1e-3 * scale
    for i in range(extra):
        lg, cache = m.decode(params, cache, tokens[:, S + i:S + i + 1])
        assert (lg - full[:, S + i]).abs().max() < 1e-3 * scale


def test_kernel_switch_and_plain_path_agree():
    """use_kernels=True (plain versions on CPU) and the chunked / masked
    plain path of the layers give the same logits."""
    cfg = reduced(get_config("internlm2_1_8b"))
    plain = get_model(cfg, RunOptions(param_dtype=torch.float32,
                                      act_dtype=torch.float32,
                                      attn_chunk=16), device="cpu")
    kern = get_model(cfg, F32, device="cpu")
    params = plain.init(1)
    toks = torch.randint(0, cfg.vocab, (2, 37),
                         generator=torch.Generator().manual_seed(1))
    a, ca = plain.prefill(params, {"tokens": toks[:, :33]}, max_len=37)
    b, cb = kern.prefill(params, {"tokens": toks[:, :33]}, max_len=37)
    torch.testing.assert_close(a, b, atol=LOGITS_TOL, rtol=LOGITS_TOL)
    for i in range(33, 37):
        a, ca = plain.decode(params, ca, toks[:, i:i + 1])
        b, cb = kern.decode(params, cb, toks[:, i:i + 1])
        torch.testing.assert_close(a, b, atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_init_is_seeded_and_shaped_like_the_reference():
    cfg = reduced(get_config("internlm2_1_8b"))
    m = get_model(cfg, F32, device="cpu")
    p0, p1, p2 = m.init(0), m.init(0), m.init(1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert not torch.equal(p0["layers/wq"], p2["layers/wq"])
    _, ref_params, _, _ = _pair("internlm2_1_8b")
    flat = params_from_reference(jax.tree.map(np.asarray, ref_params))
    assert set(flat) == set(p0)
    assert all(tuple(flat[k].shape) == tuple(p0[k].shape) for k in flat)
    assert torch.all(p0["layers/ln1_scale"] == 1)
    # dense_init: std 1/sqrt(fan_in)
    assert abs(float(p0["layers/wq"].std()) * cfg.d_model ** 0.5 - 1) < 0.1


def test_params_from_reference_keeps_bf16():
    tree = {"layers": {"wq": jnp.ones((1, 1, 2, 2), jnp.bfloat16)},
            "embed": np.zeros((3, 2), np.float32)}
    out = params_from_reference(jax.tree.map(np.asarray, tree))
    assert out["layers/wq"].dtype == torch.bfloat16
    assert out["embed"].dtype == torch.float32
    assert out["layers/wq"].shape == (1, 1, 2, 2)


def test_train_mode_raises():
    """Train mode writes no cache (handed one it raises) and refuses the
    CUDA kernels under autograd (they have no backward);
    tests/test_torch_train.py and tests/test_torch_moe.py train through
    it."""
    from repro_torch.models import transformer
    cfg = reduced(get_config("internlm2_1_8b"))
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="writes no cache"):
        transformer.forward(cfg, {}, toks, mode="train", cache={})
    m = get_model(cfg, F32, device="cpu")
    params = {k: v.requires_grad_(True) for k, v in m.init(0).items()}
    with pytest.raises(ValueError, match="no backward"):
        transformer.forward(cfg, params, toks, opts=F32, mode="train")


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(reduced(get_config("internlm2_1_8b")))
