"""The port's training path against the reference's, on the CPU.

Losses and gradients: the reference's ``jax.value_and_grad(Model.loss)``
and the port's autograd on the same parameters and batch, in float32, for
every arch that is not MoE, at reduced size (the inputs of
``tests/test_models.py::test_smoke_train_step``: one key for the
parameters and the batch).  Loss within rel 1e-5; each gradient leaf
within 1e-4 x its max |g_ref|.  Observed: loss within 2e-7 and gradients
within 1.3e-5 of that bound's scale.  The float32 noise of both sides is of
that order: against a float64 evaluation of the port, Hymba's gradients
on other inputs are off by up to ~4e-5 (reference) and ~8e-5 (port).

AdamW: the same numpy parameters and gradients through both ``update``s,
three steps, with and without int8 compression, within rel 1e-6 (both in
float32; ``pow`` and ``sqrt`` may round differently in the last bit).

Checkpoints: the port's files are the reference's format leaf for leaf,
bf16 leaves byte for byte; the continuation of a reference checkpoint by
the port tracks the reference's own continuation within rel 1e-5 per loss.
"""
from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as ref_ckpt
from repro.configs.registry import ShapeSpec
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import reduced as ref_reduced
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenStream as RefTokenStream
from repro.models import transformer as ref_transformer
from repro.models.model import RunOptions as RefRunOptions
from repro.models.model import get_model as ref_get_model
from repro.optim import adamw as ref_adamw
from repro.runtime.trainer import Trainer as RefTrainer
from repro.runtime.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import RunOptions, get_model
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import (SimulatedFailure, Trainer,
                                         TrainerConfig)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # x max |g_ref| of the leaf
ADAMW_RTOL = 1e-6
CONTINUE_RTOL = 1e-5
REF_F32 = RefRunOptions(attn_chunk=16, remat="none", param_dtype=jnp.float32,
                        act_dtype=jnp.float32)
F32 = RunOptions(attn_chunk=16, remat="none", param_dtype=torch.float32,
                 act_dtype=torch.float32)
NON_MOE = [a for a in ARCH_IDS if not get_config(a).n_experts]
QUIET = dict(log_fn=lambda *_: None)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype == jnp.int32
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---- loss and gradients ----------------------------------------------------

def test_every_non_moe_arch_is_covered():
    assert len(NON_MOE) == 8
    assert {"rwkv6_1_6b", "hymba_1_5b", "internvl2_76b",
            "musicgen_medium"} <= set(NON_MOE)


@pytest.mark.parametrize("arch", NON_MOE)
def test_loss_and_grads_match_reference(arch):
    """Port of the reference's test_smoke_train_step, held to its values."""
    key = jax.random.PRNGKey(0)
    ref = ref_get_model(ref_reduced(ref_get_config(arch)), REF_F32)
    ref_params = ref.init(key)
    batch = ref.dummy_inputs(ShapeSpec("t", 64, 2, "train"), key)
    loss, grads = jax.value_and_grad(ref.loss)(ref_params, batch)

    port = get_model(reduced(get_config(arch)), F32, device="cpu")
    params = {k: v.requires_grad_(True)
              for k, v in params_from_reference(_np(ref_params)).items()}
    ploss = port.loss(params, _torch_batch(batch))
    ploss.backward()
    assert ploss.shape == () and torch.isfinite(ploss)
    assert float(ploss.detach()) == pytest.approx(float(loss),
                                                rel=LOSS_RTOL)
    g_ref = params_from_reference(_np(grads))
    assert set(g_ref) == set(params)
    for name, g in g_ref.items():
        scale = float(g.abs().max())
        err = float((params[name].grad - g).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
    assert sum(float(p.grad.square().sum()) for p in params.values()) > 0


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "rwkv6_1_6b",
                                  "hymba_1_5b"])
def test_remat_recomputes_the_same_gradients(arch):
    cfg = reduced(get_config(arch))
    toks = torch.randint(0, cfg.vocab, (2, 33),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads = []
    for remat in ("none", "full"):
        m = get_model(cfg, RunOptions(param_dtype=torch.float32,
                                      act_dtype=torch.float32, remat=remat),
                      device="cpu")
        params = {k: v.requires_grad_(True) for k, v in m.init(0).items()}
        m.loss(params, batch).backward()
        grads.append({k: v.grad for k, v in params.items()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6,
                                   atol=1e-7)


def test_train_forward_gives_full_sequence_logits_and_no_cache():
    cfg = reduced(get_config("internlm2_1_8b"))
    m = get_model(cfg, F32, device="cpu")
    params = m.init(0)
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(2))
    logits, aux = m.forward(params, {"tokens": toks})
    assert logits.shape == (2, 20, cfg.vocab) and logits.dtype == torch.float32
    assert aux == 0.0
    # the last position's logits are prefill's
    last, _ = m.prefill(params, {"tokens": toks})
    torch.testing.assert_close(logits[:, -1], last, rtol=1e-5, atol=1e-5)


def test_chunked_lm_loss_with_a_tail_chunk():
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 37, 16, 50
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    head = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s))
    ref = ref_transformer.chunked_lm_loss(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(labels, jnp.int32),
        RefRunOptions(logit_chunk=16))
    port = transformer.chunked_lm_loss(
        torch.from_numpy(x), torch.from_numpy(head),
        torch.from_numpy(labels), RunOptions(logit_chunk=16))
    assert float(port) == pytest.approx(float(ref), rel=1e-6)
    plain = torch.nn.functional.cross_entropy(
        torch.from_numpy(x @ head.T).reshape(b * s, v),
        torch.from_numpy(labels).reshape(-1))
    assert float(port) == pytest.approx(float(plain), rel=1e-6)


# ---- AdamW -------------------------------------------------------------------

def _adamw_case(seed: int = 0):
    rng = np.random.default_rng(seed)
    params = {"embed": rng.normal(size=(16, 8)).astype(np.float32),
              "layers": {"wq": rng.normal(size=(2, 1, 8, 8)).astype(
                  np.float32)},
              "lm_head": rng.normal(size=(16, 8)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.5)
                          .astype(np.float32), params) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_reference(compress):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0,
                  compress_grads=compress)
    params, grads = _adamw_case()
    r_params = jax.tree.map(jnp.asarray, params)
    r_state = ref_adamw.init(r_params)
    r_err = ref_adamw.init_error_feedback(r_params) if compress else None
    p_params = params_from_reference(params)
    p_state = adamw.init(p_params)
    p_err = adamw.init_error_feedback(p_params) if compress else None
    for g in grads:
        r_params, r_state, r_err, r_m = ref_adamw.update(
            ref_adamw.AdamWConfig(**cfg_kw), r_params,
            jax.tree.map(jnp.asarray, g), r_state, r_err)
        before = p_params["embed"]
        p_params, p_state, p_err, p_m = adamw.update(
            adamw.AdamWConfig(**cfg_kw), p_params, params_from_reference(g),
            p_state, p_err)
        assert p_params["embed"] is before      # updated in place
        for key in ("grad_norm", "lr"):
            assert float(p_m[key]) == pytest.approx(float(r_m[key]),
                                                    rel=ADAMW_RTOL)
    assert int(p_state["step"]) == int(r_state["step"]) == 3
    for mine, theirs in ((p_params, r_params), (p_state["m"], r_state["m"]),
                         (p_state["v"], r_state["v"])) + \
            (((p_err, r_err),) if compress else ()):
        theirs = params_from_reference(_np(theirs))
        for k in theirs:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(),
                                       rtol=ADAMW_RTOL, atol=1e-9)


def test_int8_codes_match_reference_and_round_half_to_even():
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.49, -126.6],
                 np.float32)
    q, scale = adamw.compress_int8(torch.from_numpy(g))
    rq, rscale = ref_adamw.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 3, -127]
    assert float(scale) == float(rscale) == 1.0
    rng = np.random.default_rng(3)
    g, err = (rng.normal(size=(64, 64)).astype(np.float32) * 0.01
              for _ in range(2))
    g_hat, new_err = adamw.compress_residual(torch.from_numpy(g),
                                             torch.from_numpy(err))
    r_hat, r_err = ref_adamw.compress_residual(jnp.asarray(g),
                                               jnp.asarray(err))
    q, _ = adamw.compress_int8(torch.from_numpy(g + err))
    rq, _ = ref_adamw.compress_int8(jnp.asarray(g) + jnp.asarray(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(g_hat.numpy(), np.asarray(r_hat), rtol=1e-6)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(r_err),
                               rtol=1e-5, atol=1e-9)


def test_grad_compression_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64))
                         .astype(np.float32) * 0.01)
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    truth = torch.zeros_like(g)
    for _ in range(20):
        g_hat, err = adamw.compress_residual(g, err)
        total = total + g_hat
        truth = truth + g
    # error feedback keeps the long-run average unbiased
    rel = float((total - truth).abs().max() / truth.abs().max())
    assert rel < 0.02


def test_compressed_training_still_learns(tmp_path):
    """Port of the reference's test of the same name.  The loss is read on
    all 15 training batches before and after training: the stream's motif
    rows are random tokens no model learns in 15 steps, so one batch's
    loss (the reference's first-vs-last check) says little about the
    port's numpy stream."""
    cfg = reduced(get_config("internlm2_1_8b"))
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    t = Trainer(cfg, dc, TrainerConfig(steps=15, ckpt_every=100,
                                       ckpt_dir=str(tmp_path / "c"),
                                       log_every=100), F32,
                opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup_steps=2,
                                          total_steps=15,
                                          compress_grads=True),
                device="cpu", **QUIET)
    before = t.init_state()
    r = t.run()
    after, step = ckpt.restore(tmp_path / "c", before)
    assert step == 15 and len(r["losses"]) == 15
    assert after["err_fb"] is not None

    def mean_loss(params):
        with torch.no_grad():
            return sum(float(t.model.loss(params, t.data.batch(s)))
                       for s in range(15)) / 15

    assert mean_loss(after["params"]) < mean_loss(before["params"]) - 0.05


def test_compressed_training_still_learns_first_vs_last_batch(tmp_path):
    """The reference's own check (tests/test_checkpoint.py), restored now
    that the port trains on the reference's token stream: the last step's
    loss is below the first's."""
    cfg = reduced(get_config("internlm2_1_8b"))
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    t = Trainer(cfg, dc, TrainerConfig(steps=15, ckpt_every=100,
                                       ckpt_dir=str(tmp_path / "c"),
                                       log_every=100), F32,
                opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup_steps=2,
                                          total_steps=15,
                                          compress_grads=True),
                device="cpu", **QUIET)
    r = t.run()
    assert r["losses"][-1] < r["losses"][0]


# ---- data ------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,vocab", [(0, 0, 256), (0, 7, 256),
                                             (5, 3, 1000), (123, 1000, 300),
                                             (1, 2, 92544)])
def test_token_stream_is_the_references(seed, step, vocab):
    """TokenStream.batch draws the reference's jax.random tokens, whole
    and by host slice."""
    kw = dict(vocab=vocab, seq_len=32 if vocab < 10000 else 8,
              global_batch=4, seed=seed)
    ref = RefTokenStream(RefDataConfig(**kw))
    port = TokenStream(DataConfig(**kw))
    want, got = ref.batch(step), port.batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    sl = port.host_slice(1, 2)
    assert np.array_equal(port.batch(step, sl)["tokens"].numpy(),
                          np.asarray(ref.batch(step, sl)["tokens"]))


@pytest.mark.parametrize("seed", [0, 1, 123])
def test_threefry_samplers_match_jax_random(seed):
    """PRNGKey, fold_in, split, uniform, bernoulli and randint bit for bit;
    randint at spans below and above 2**16 (where jax's multiplier wraps)."""
    from repro_torch.data import pipeline as P
    key, pkey = jax.random.PRNGKey(seed), P.prng_key(seed)
    assert np.array_equal(np.asarray(key).astype(np.int64), pkey.numpy())
    key, pkey = jax.random.fold_in(key, 17), P.fold_in(pkey, 17)
    assert np.array_equal(np.asarray(key).astype(np.int64), pkey.numpy())
    ks, pks = jax.random.split(key, 3), P.split(pkey, 3)
    assert np.array_equal(np.asarray(ks).astype(np.int64), pks.numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(ks[0], (5, 7))),
                          P.uniform(pks[0], (5, 7)).numpy())
    assert np.array_equal(np.asarray(jax.random.bernoulli(ks[1], 0.5,
                                                          (64, 1))),
                          P.bernoulli(pks[1], 0.5, (64, 1)).numpy())
    for vocab in (256, 65535, 70000, 92544, 1 << 20):
        assert np.array_equal(
            np.asarray(jax.random.randint(ks[2], (4, 8), 0, vocab,
                                          jnp.int32)),
            P.randint(pks[2], (4, 8), 0, vocab).numpy()), vocab
    logits = jnp.asarray(np.random.default_rng(seed).normal(size=50)
                         .astype(np.float32))
    assert np.array_equal(
        np.asarray(jax.random.categorical(ks[0], logits, shape=(3, 20))),
        P.categorical(pks[0], torch.from_numpy(np.array(logits)),
                      (3, 20)).numpy())


def test_data_pipeline_deterministic():
    dc = DataConfig(vocab=128, seq_len=16, global_batch=4, seed=5)
    s1, s2 = TokenStream(dc), TokenStream(dc)
    for step in (0, 3, 17):
        b1, b2 = s1.batch(step), s2.batch(step)
        assert torch.equal(b1["tokens"], b2["tokens"])
        assert torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(s1.batch(0)["tokens"], s1.batch(1)["tokens"])
    other = TokenStream(DataConfig(vocab=128, seq_len=16, global_batch=4,
                                   seed=6))
    assert not torch.equal(s1.batch(0)["tokens"], other.batch(0)["tokens"])


def test_host_slicing_partitions_batch():
    ts = TokenStream(DataConfig(vocab=128, seq_len=8, global_batch=8))
    full = ts.batch(2)["tokens"]
    parts = [ts.batch(2, ts.host_slice(i, 4))["tokens"] for i in range(4)]
    assert torch.equal(torch.cat(parts), full)


def test_tokens_in_range_labels_shifted_and_motif_rows_periodic():
    dc = DataConfig(vocab=300, seq_len=40, global_batch=64, seed=1)
    b = TokenStream(dc).batch(0)
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (64, 40)
    assert toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < dc.vocab
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    full = torch.cat([toks, labels[:, -1:]], dim=1)
    periodic = (full[:, dc.motif_len:] == full[:, :-dc.motif_len]).all(1)
    # motif_prob 0.5 of 64 rows; a Zipf row repeating itself is unlikely
    assert 16 < int(periodic.sum()) < 48
    # Zipf unigrams: the rank-0 token is the commonest of the others
    counts = torch.bincount(full[~periodic].reshape(-1), minlength=dc.vocab)
    assert int(counts.argmax()) == 0


# ---- checkpoints ------------------------------------------------------------

def _state(dtype=torch.float32):
    return {"params": {"layers/wq": torch.arange(12.0).reshape(1, 3, 4)
                       .to(dtype), "embed": torch.ones(5, 2, dtype=dtype)},
            "opt": {"m": {"embed": torch.full((5, 2), 0.5)},
                    "step": torch.tensor(7, dtype=torch.int32)},
            "err_fb": None}


def test_save_restore_roundtrip(tmp_path):
    for dtype in (torch.float32, torch.bfloat16):
        tree = _state(dtype)
        tree["params"]["embed"][0, 0] = 1.0 + 2 ** -7      # a bf16 ulp
        ckpt.save(tmp_path / str(dtype), 3, tree)
        out, step = ckpt.restore(tmp_path / str(dtype), _state())
        assert step == 3 and out["err_fb"] is None
        for a, b in zip(ckpt._flatten(tree), ckpt._flatten(out)):
            assert a[0] == b[0] and a[1].dtype == b[1].dtype
            assert torch.equal(a[1], b[1])


def test_gc_keeps_latest(tmp_path):
    tree = {"a": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, tree, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000005"]
    _, step = ckpt.restore(tmp_path, tree)
    assert step == 5
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, tree, step=1)
    assert ckpt.latest_step(tmp_path / "none") is None


def _ref_tree(dtype):
    return {"params": {"layers": {"wq": jnp.arange(12.0, dtype=dtype)
                                  .reshape(1, 3, 4) / 7},
                       "embed": jnp.ones((5, 2), dtype)},
            "opt": {"m": {"embed": jnp.full((5, 2), 0.5, jnp.float32)},
                    "step": jnp.asarray(7, jnp.int32)},
            "err_fb": None}


def test_port_reads_reference_checkpoints(tmp_path):
    for dtype in (jnp.float32, jnp.bfloat16):
        tree = _ref_tree(dtype)
        ref_ckpt.save(tmp_path / dtype.__name__, 4, tree)
        out, step = ckpt.restore(tmp_path / dtype.__name__, _state())
        assert step == 4
        want = params_from_reference(_np(tree["params"]))
        for k, v in want.items():
            assert out["params"][k].dtype == v.dtype
            assert torch.equal(out["params"][k], v)
        assert torch.equal(out["opt"]["m"]["embed"], torch.full((5, 2), 0.5))
        assert out["opt"]["step"].dtype == torch.int32
        assert int(out["opt"]["step"]) == 7


def test_reference_reads_the_port_f32_checkpoints(tmp_path):
    tree = _state()
    ckpt.save(tmp_path, 2, tree)
    out, step = ref_ckpt.restore(tmp_path, _ref_tree(jnp.float32))
    assert step == 2
    np.testing.assert_array_equal(np.asarray(out["params"]["layers"]["wq"]),
                                  tree["params"]["layers/wq"].numpy())
    np.testing.assert_array_equal(np.asarray(out["opt"]["step"]), 7)


def test_reference_restore_leaves_bf16_as_void_bytes(tmp_path):
    """The reference's restore ignores the manifest's dtype: a bf16 leaf
    comes back as raw 2-byte voids (ROADMAP §3).  The port restores the
    same files to exact bf16, and writes bf16 leaves byte for byte as the
    reference does."""
    tree = _ref_tree(jnp.bfloat16)
    ref_ckpt.save(tmp_path / "ref", 1, tree)
    out, _ = ref_ckpt.restore(tmp_path / "ref", tree)
    voids = np.asarray(out["params"]["layers"]["wq"])
    assert voids.dtype.kind == "V" and voids.dtype.itemsize == 2
    mine, _ = ckpt.restore(tmp_path / "ref", _state())
    wq = mine["params"]["layers/wq"]
    assert wq.dtype == torch.bfloat16
    want = np.asarray(tree["params"]["layers"]["wq"])
    assert np.array_equal(wq.view(torch.int16).numpy(),
                          want.view(np.int16))
    assert np.array_equal(voids.view(np.int16), want.view(np.int16))
    ckpt.save(tmp_path / "port", 1, mine)
    for leaf in ("params__layers__wq.npy", "params__embed.npy"):
        assert (tmp_path / "port" / "step_00000001" / leaf).read_bytes() == \
            (tmp_path / "ref" / "step_00000001" / leaf).read_bytes()
    back = np.load(tmp_path / "port" / "step_00000001" / leaf)
    assert back.view(ml_dtypes.bfloat16).astype(np.float32).tolist() == \
        np.ones((5, 2), np.float32).tolist()


# ---- the trainer --------------------------------------------------------------

class _RefBatches:
    """The reference's data stream, handed to the port's trainer."""

    def __init__(self, cfg: RefDataConfig):
        self._ts = RefTokenStream(cfg)

    def batch(self, step: int) -> dict:
        return _torch_batch(self._ts.batch(step))


def test_continuation_from_reference_checkpoint(tmp_path):
    cfg = ref_reduced(ref_get_config("internlm2_1_8b"))
    dc = RefDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    opt_kw = dict(lr=3e-3, warmup_steps=2, total_steps=8)
    ref = RefTrainer(cfg, dc, RefTrainerConfig(
        steps=4, ckpt_every=4, ckpt_dir=str(tmp_path / "ref"),
        log_every=100), REF_F32, opt_cfg=ref_adamw.AdamWConfig(**opt_kw),
        **QUIET)
    ref.run()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref.tcfg.steps = 8            # the same trainer (and compile) resumes
    ref_losses = ref.run()["losses"][-4:]

    port = Trainer(reduced(get_config("internlm2_1_8b")),
                   DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2),
                   TrainerConfig(steps=8, ckpt_every=4,
                                 ckpt_dir=str(tmp_path / "port"),
                                 log_every=100),
                   F32, opt_cfg=adamw.AdamWConfig(**opt_kw), device="cpu",
                   **QUIET)
    port.data = _RefBatches(dc)
    out = port.run()
    assert out["steps_run"] == 4
    assert out["losses"] == pytest.approx(ref_losses, rel=CONTINUE_RTOL)
    assert ckpt.latest_step(tmp_path / "port") == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_restart_equivalence(tmp_path, dtype):
    cfg = reduced(get_config("internlm2_1_8b"))
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    opts = RunOptions(attn_chunk=32, remat="none", param_dtype=dtype,
                      act_dtype=dtype)

    def trainer(name, **kw):
        return Trainer(cfg, dc, TrainerConfig(
            steps=12, ckpt_every=4, ckpt_dir=str(tmp_path / name),
            log_every=100, **kw), opts, device="cpu", **QUIET)

    ra = trainer("a").run()
    with pytest.raises(SimulatedFailure):
        trainer("b", fail_at_step=6).run()
    rb = trainer("b").run()
    assert rb["steps_run"] == 8
    assert ra["final_loss"] == pytest.approx(rb["final_loss"], abs=1e-6)
    restored, step = ckpt.restore(tmp_path / "b", trainer("b").init_state())
    assert step == 12 and restored["params"]["embed"].dtype == dtype


def test_train_cli_trains_and_checkpoints(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--reduced", "--device", "cpu", "--steps", "4",
                      "--ckpt-every", "2", "--ckpt-dir",
                      str(tmp_path / "ck")])
    assert out["steps_run"] == 4 and len(out["losses"]) == 4
    assert ckpt.latest_step(tmp_path / "ck") == 4
    assert "[train] done: 4 steps" in capsys.readouterr().out


def test_train_cli_resumed_at_its_last_step_runs_no_step(tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--reduced", "--device", "cpu", "--steps", "2", "--ckpt-dir",
            str(tmp_path / "ck")]
    train.main(argv)
    out = train.main(argv)
    assert out["steps_run"] == 0 and out["final_loss"] is None
    assert "[train] done: 0 steps, final loss none" in \
        capsys.readouterr().out


def test_trainer_and_cli_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from repro_torch.launch import train
    cfg = reduced(get_config("internlm2_1_8b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2),
                TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
