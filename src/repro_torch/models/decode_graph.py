"""The decode step replayed from CUDA graphs.

A decode step of a served bucket is the same work on the same buffers
every time: the weights, the cache written in place at the position ``t``
it holds on the device, and a (B, 1) tensor of fed tokens.  Launched
eagerly it is ~1500 kernel launches, so the host sets its pace.
``DecodeGraphs`` runs such a step eagerly the first time it sees its
buffers, captures it in a CUDA graph right after (capture executes
nothing, so ``t`` and the cache advance once), and replays that graph on
every later step over the same buffers.

The key of a graph is every tensor the step reads: the data pointer,
shape, stride and dtype of each parameter and cache tensor, and the shape
and dtype of the tokens.  The graph reads its tokens from a buffer of its
own, which each replay fills from the caller's; it returns a copy of its
logits, so logits kept across steps are never overwritten.  All graphs of
one ``DecodeGraphs`` share one memory pool: the steps run one at a time.

The kernel wrappers count their launches on the host (``fn.launches``);
a replay adds what the captured step launched, so the counters count
launches on the device with or without graphs.

:func:`why_eager` is the path rule: a step is graphed only where every
tensor is on CUDA, ``opts`` runs on no mesh (collectives stay eager) and
autograd would record nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def launch_counters() -> tuple:
    """The kernel wrappers that count their launches (``fn.launches``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.rwkv6 import ops as rw_ops
    return (fa_ops.flash_attention, fd_ops.flash_decode_at,
            fd_ops.flash_decode, rw_ops.wkv6)


def _leaves(tree) -> list:
    """The tensors of a (nested) dict, list or tuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [x for sub in tree for x in _leaves(sub)]


def why_eager(opts, params, cache, tokens) -> Optional[str]:
    """Why this decode step runs eagerly, or None where it is graphed:
    "mesh" (a sharded step: its collectives stay eager), "autograd" (a
    tensor requires grad and grad mode is on) or "device" (a tensor off
    CUDA)."""
    if opts.mesh is not None:
        return "mesh"
    leaves = _leaves(params) + _leaves(cache) + [tokens]
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        return "autograd"
    if not all(x.is_cuda for x in leaves):
        return "device"
    return None


def _key(params, cache, tokens) -> tuple:
    return (tuple((x.data_ptr(), x.shape, x.stride(), x.dtype)
                  for x in _leaves(params) + _leaves(cache)),
            tuple(params), tuple(cache), tokens.shape, tokens.dtype,
            tokens.device)


@dataclasses.dataclass
class _Graph:
    graph: object                # torch.cuda.CUDAGraph
    tokens: torch.Tensor         # the static input the graph reads
    logits: torch.Tensor         # the static output it writes
    launches: tuple              # (counted wrapper, launches a replay)


class DecodeGraphs:
    """One CUDA graph of a decode step per set of buffers it reads."""

    def __init__(self):
        self._graphs: dict[tuple, _Graph] = {}
        self._pool = None        # shared by every graph, made at first use
        self.captures = 0        # graphs captured
        self.replays = 0         # steps served by a replay

    def __call__(self, step: Callable, params, cache, tokens):
        """``step(params, cache, tokens)`` -> (logits, cache), the cache
        written in place: run eagerly and captured the first time its
        buffers are seen, replayed from then on."""
        key = _key(params, cache, tokens)
        g = self._graphs.get(key)
        if g is None:
            out = step(params, cache, tokens)
            self._graphs[key] = self._capture(step, params, cache, tokens)
            return out
        g.tokens.copy_(tokens)
        g.graph.replay()
        for fn, n in g.launches:
            fn.launches += n
        self.replays += 1
        return g.logits.clone(), cache

    def _capture(self, step, params, cache, tokens) -> _Graph:
        device = tokens.device
        with torch.inference_mode(False):   # filled outside it too
            static = tokens.clone(memory_format=torch.contiguous_format)
        counters = launch_counters()
        before = [fn.launches for fn in counters]
        graph, logits = self._record(
            lambda: step(params, cache, static)[0], device)
        # the capture ran the wrappers but launched nothing
        launches = tuple((fn, fn.launches - n)
                         for fn, n in zip(counters, before)
                         if fn.launches != n)
        for fn, n in zip(counters, before):
            fn.launches = n
        self.captures += 1
        return _Graph(graph, static, logits, launches)

    def _record(self, fn: Callable, device) -> tuple:
        """(graph, its static output): ``fn()`` captured on ``device``, in
        the pool shared by this object's graphs; nothing runs."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(
                graph, pool=self._pool, capture_error_mode="thread_local"):
            out = fn()
        return graph, out
