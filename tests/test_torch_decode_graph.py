"""``Model.decode`` replayed from CUDA graphs (``models/decode_graph.py``).

On the CPU: ``Model.decode`` is the eager ``decode_step`` bit for bit (the
path rule keeps every CPU step eager); the rule's reasons for an eager
step; and the graph bookkeeping (keys, the tokens buffer, the logits
copy, recapture) with a recorder that stands in for the CUDA capture by
running the step on each replay.  On the card (``cuda``-marked): replay
against the eager step over 32 steps, the launch counters, recapture on
new weights and the executor's ``graph_steps``.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.models import decode_graph
from repro_torch.models.model import RunOptions, get_model

ARCHS = ["internlm2_1_8b", "mixtral_8x22b", "rwkv6_1_6b", "hymba_1_5b"]
F32 = RunOptions(param_dtype=torch.float32, act_dtype=torch.float32,
                 use_kernels=True)
PROMPT, STEPS = 40, 6


def _model(arch, device="cpu", opts=F32):
    return get_model(reduced(get_config(arch)), opts, device=device)


def _prefilled(model, params, b, seed=0, prompt=PROMPT, extra=STEPS):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, model.cfg.vocab, (b, prompt), generator=g)
    logits, cache = model.prefill(
        params, {"tokens": toks.to(model.device)}, max_len=prompt + extra)
    return logits, cache


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _next(logits):
    return torch.argmax(logits, -1, keepdim=True)


def _equal_caches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---- the CPU: eager, as before ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_decode_is_the_eager_step_bit_for_bit(arch):
    model = _model(arch)
    params = model.init(0)
    logits, cache = _prefilled(model, params, 2)
    other = _clone(cache)
    tok = tok_o = _next(logits)
    for _ in range(STEPS):
        lg, cache = model.decode(params, cache, tok)
        lo, other = model.decode_step(params, other, tok_o)
        assert torch.equal(lg, lo)
        tok, tok_o = _next(lg), _next(lo)
    _equal_caches(cache, other)
    assert model.graphs.captures == model.graphs.replays == 0


@pytest.mark.parametrize("mesh,grad,requires_grad,want", [
    (None, False, False, "device"),
    (object(), False, False, "mesh"),
    (None, True, True, "autograd"),
    (None, False, True, "device"),
    (None, True, False, "device"),
], ids=["cpu", "mesh", "autograd", "no-grad", "grad-mode-only"])
def test_path_rule_keeps_these_steps_eager(mesh, grad, requires_grad, want):
    opts = dataclasses.replace(F32, mesh=mesh)
    model = _model("internlm2_1_8b", opts=opts)
    params = model.init(0)
    cache = model.init_cache(1, 8)
    tokens = torch.zeros((1, 1), dtype=torch.long)
    if requires_grad:
        params = {k: v.requires_grad_() for k, v in params.items()}
    with torch.set_grad_enabled(grad):
        got = decode_graph.why_eager(opts, params, cache, tokens)
    assert got == want


def test_cpu_logits_of_consecutive_steps_do_not_alias():
    model = _model("internlm2_1_8b")
    params = model.init(0)
    logits, cache = _prefilled(model, params, 2)
    kept = [logits]
    for _ in range(3):
        logits, cache = model.decode(params, cache, _next(logits))
        kept.append(logits)
    ptrs = {x.untyped_storage().data_ptr() for x in kept}
    assert len(ptrs) == len(kept)


# ---- the graph bookkeeping, with a stand-in recorder ------------------------

class _Recorded:
    """Stands in for a captured graph: a replay runs the step again into
    the static output, leaving the launch counters as they were (a real
    replay runs no wrapper)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        counters = decode_graph.launch_counters()
        before = [fn.launches for fn in counters]
        self.out.copy_(self.fn())
        for fn, n in zip(counters, before):
            fn.launches = n


class _StandIn(decode_graph.DecodeGraphs):
    """``DecodeGraphs`` with :class:`_Recorded` in place of the capture;
    like a capture, recording leaves the caches and ``t`` as they were."""

    def __init__(self, cache):
        super().__init__()
        self.cache = cache

    def _record(self, fn, device):
        saved = _clone(self.cache)
        out = fn().clone()
        for k, v in self.cache.items():
            v.copy_(saved[k])
        return _Recorded(fn, out), out


@pytest.mark.parametrize("arch", ARCHS)
def test_replays_match_the_eager_steps(arch):
    model = _model(arch)
    params = model.init(0)
    logits, cache = _prefilled(model, params, 2)
    other = _clone(cache)
    graphs = _StandIn(cache)
    tok = tok_o = _next(logits)
    kept = []
    for i in range(STEPS):
        lg, cache = graphs(model.decode_step, params, cache, tok)
        lo, other = model.decode_step(params, other, tok_o)
        assert torch.equal(lg, lo), i
        kept.append(lg)
        tok, tok_o = _next(lg), _next(lo)       # a new tensor every step
    _equal_caches(cache, other)
    assert (graphs.captures, graphs.replays) == (1, STEPS - 1)
    static = graphs._graphs[next(iter(graphs._graphs))].logits
    ptrs = {x.untyped_storage().data_ptr() for x in kept + [static]}
    assert len(ptrs) == STEPS + 1
    assert int(cache["t"]) == PROMPT + STEPS


def test_new_buffers_are_captured_again_and_tokens_are_not_written():
    model = _model("internlm2_1_8b")
    params = model.init(0)
    logits, cache = _prefilled(model, params, 2)
    graphs = _StandIn(cache)
    tok = _next(logits)
    fed = tok.clone()
    graphs(model.decode_step, params, cache, tok)
    graphs(model.decode_step, params, cache, tok + 1)
    assert torch.equal(tok, fed)
    assert (graphs.captures, graphs.replays) == (1, 1)
    moved = {k: v.clone() for k, v in params.items()}
    graphs(model.decode_step, moved, cache, tok)
    assert (graphs.captures, graphs.replays) == (2, 1)
    graphs(model.decode_step, params, cache, tok.int())  # another dtype
    assert (graphs.captures, graphs.replays) == (3, 1)
    graphs(model.decode_step, params, cache, tok)
    assert (graphs.captures, graphs.replays) == (3, 2)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


BF16 = RunOptions(use_kernels=True, attn_chunk=64)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b"])
@pytest.mark.parametrize("b", [1, 8])
@torch.inference_mode()
def test_cuda_replay_matches_eager_over_32_steps(cuda, arch, b):
    steps = 32
    model = _model(arch, cuda, BF16)
    params = model.init(0)
    logits, cache = _prefilled(model, params, b, extra=steps)
    other = _clone(cache)
    tok = _next(logits)
    tok_o = tok.clone()
    for i in range(steps):
        lg, cache = model.decode(params, cache, tok)
        lo, other = model.decode_step(params, other, tok_o)
        torch.argmax(lg, -1, keepdim=True, out=tok)   # as the executor
        tok_o = _next(lo)
        assert torch.equal(tok, tok_o), i
        assert torch.equal(lg, lo), i
    _equal_caches(cache, other)
    assert (model.graphs.captures, model.graphs.replays) == (1, steps - 1)


@pytest.mark.cuda
@torch.inference_mode()
def test_cuda_launch_counters_count_replays(cuda):
    from repro_torch.kernels.flash_decode import ops as fd_ops
    model = _model("internlm2_1_8b", cuda, BF16)
    params = model.init(0)
    logits, cache = _prefilled(model, params, 2)
    fd_ops.flash_decode_at.launches = 0
    tok = _next(logits)
    for _ in range(STEPS):
        logits, cache = model.decode(params, cache, tok)
        tok = _next(logits)
    assert model.graphs.replays == STEPS - 1
    assert fd_ops.flash_decode_at.launches == model.cfg.n_layers * STEPS


@pytest.mark.cuda
@torch.inference_mode()
def test_cuda_new_params_pointer_is_captured_again(cuda):
    model = _model("internlm2_1_8b", cuda, BF16)
    params = model.init(0)
    logits, cache = _prefilled(model, params, 2)
    tok = _next(logits)
    model.decode(params, cache, tok)
    model.decode(params, cache, tok)
    assert (model.graphs.captures, model.graphs.replays) == (1, 1)
    moved = {k: v.clone() for k, v in params.items()}
    moved["embed"].mul_(2.0)
    other = _clone(cache)
    got, _ = model.decode(moved, cache, tok)
    want, _ = model.decode_step(moved, other, tok)
    assert (model.graphs.captures, model.graphs.replays) == (2, 1)
    assert torch.equal(got, want)
    got, _ = model.decode(moved, cache, tok)
    want, _ = model.decode_step(moved, other, tok)
    assert (model.graphs.captures, model.graphs.replays) == (2, 2)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_executor_replays_every_step_after_warmup(cuda):
    from repro_torch.serving.executor import TorchExecutor
    ex = TorchExecutor("internlm2_1_8b", batch_lattice=(1, 2), quotas=(1.0,),
                       prompt_len=16, gen_len=4, reduced=True, device=cuda)
    ex.warmup()
    for b in (1, 2, 2):
        ex.measure(b, 1.0, reps=1)
    s = ex.stats()
    ex.shutdown()
    assert s["graph_captures"] == 2
    assert s["warmup_decode_steps"] == 2 * 4
    assert s["graph_steps"] == s["decode_steps"] - 8 == 3 * 4
