"""Capacity + gather Mixture-of-Experts FFN, as the reference routes it.

Per row of tokens:

  1. router logits and softmax in fp32 (fp64 for a float64 model),
     top-k experts per token, ties to the lower expert index (as
     ``jax.lax.top_k``), the k gates renormalised to sum 1 (floor 1e-9);
  2. the (token, expert) assignments stable-sorted by expert;
  3. each assignment's slot in its expert's group: its rank in the sorted
     order minus the group's start; a slot at or past the capacity C is
     dropped;
  4. tokens gathered into a dense (R, E, C, D) buffer;
  5. the SwiGLU expert GEMMs batched over experts, (E, C, D) x (E, D, F),
     plain ``einsum`` as in the reference (no kernel);
  6. a combine by gather: each token reads the outputs of its k slots
     (zero where dropped), weighted by their gates, summed over k in a
     fixed order.  The reference scatter-adds instead; a scatter-add on
     the card accumulates with atomics in no fixed order, the gather does
     not.

Routing granularity is a "row": a batch element for train and prefill,
and the whole flattened batch for decode (``models/transformer.py``).

On a tensor-parallel split (``split``, a ``dist.Split`` of 'model') every
rank routes its tokens, which are the same on every rank of the axis, so
routing, capacity and ties come out identical; each rank then runs its
share of the expert GEMMs and the combined outputs are summed over
'model': its experts on all its tokens where the rules make the experts
parallel (``expert_parallel``, the weights (E_loc, ...), slots of other
experts reading the zero row), else its slice of every expert's hidden
dim (column- then row-parallel, the weights (E, D, F_loc) and (E, F_loc,
D)).  The gates feed split products, so their gradient is summed over
'model' (``copy_to``); the router runs whole on every rank.
Every step is a gather, a sort or a dense product, so autograd runs
through it; the routing indices are piecewise constant.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import wide
from repro_torch.obs import tracer as obs_tracer


def capacity(tokens_per_row: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    c = int(math.ceil(tokens_per_row * top_k / n_experts * capacity_factor))
    return max(1, min(c, tokens_per_row * top_k))


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index: a stable descending sort keeps equal values in index
    order, where ``torch.topk`` promises no order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router_w, n_experts: int, top_k: int, cap: int):
    """:func:`route`'s four results and ``slot`` (R, T*K): each assignment's
    slot ``e * cap + position`` in token-major order, or ``E * cap`` (the
    overflow bin) where it is dropped."""
    r, t, _ = x.shape
    n_assign = t * top_k
    logits = torch.einsum("rtd,de->rte", wide(x), wide(router_w))
    probs = torch.softmax(logits, dim=-1)
    g_vals, e_idx = _top_k(probs, top_k)                  # (R, T, K)
    g_vals = g_vals / torch.clamp(g_vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = e_idx.reshape(r, n_assign)
    flat_g = g_vals.reshape(r, n_assign)

    # stable sort by expert; position within a group = rank - group start
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    counts = F.one_hot(flat_e, n_experts).sum(1)          # (R, E)
    starts = torch.cumsum(counts, -1) - counts            # exclusive
    pos_sorted = torch.arange(n_assign, device=x.device) - starts.gather(
        -1, flat_e.gather(-1, order))
    # back to assignment order through the sort's inverse permutation
    pos = pos_sorted.gather(-1, torch.argsort(order, dim=-1))
    slot = torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))

    # slot (e, c) holds sorted assignment starts[e] + c when c is below
    # both the capacity and the expert's count
    c = torch.arange(cap, device=x.device)
    valid = (c < counts[:, :, None]).reshape(r, -1)       # (R, E*C)
    src = torch.clamp(starts[:, :, None] + c, max=n_assign - 1)
    src = order.gather(-1, src.reshape(r, -1))            # assignment index
    idx = torch.where(valid, src // top_k, torch.zeros_like(src))
    gate = torch.where(valid, flat_g.gather(-1, src),
                       torch.zeros_like(flat_g[:, :1]))
    shape = (r, n_experts, cap)
    aux = _aux_loss(probs, counts, n_experts, n_assign)
    return (idx.reshape(shape), valid.reshape(shape), gate.reshape(shape),
            aux, slot)


def route(x, router_w, n_experts: int, top_k: int, cap: int):
    """x: (R, T, D) rows of tokens.  Returns (idx, valid, gate, aux_loss).

    idx:   (R, E, C) int64 -- token index (within the row) feeding each
           expert slot (0 where the slot is empty)
    valid: (R, E, C) bool  -- slot occupied
    gate:  (R, E, C) f32   -- combine weight for that slot
    """
    return _route(x, router_w, n_experts, top_k, cap)[:4]


def _aux_loss(probs, counts, n_experts: int, n_assign: int):
    """Switch load-balancing loss: E * mean over rows of sum_e f_e p_e."""
    frac = counts.to(probs.dtype) / n_assign
    mean_p = probs.mean(dim=1)
    return n_experts * torch.mean(torch.sum(frac * mean_p, dim=-1))


def moe_ffn(x, router_w, w1, w2, w3, *, n_experts: int, top_k: int,
            capacity_factor: float, split=None,
            expert_parallel: bool = False):
    """x: (R, T, D); w1/w2: (E, D, F); w3: (E, F, D) (this rank's blocks
    on a ``split``).  Returns (out, aux_loss), out (R, T, D) in x's
    dtype.  Inside a traced decode step the routing and the experts are
    the profiler ranges ``repro.moe.route`` and ``repro.moe.experts``
    (``obs.tracer.ranges``)."""
    r, t, d = x.shape
    rng = obs_tracer.ranges()
    with rng("repro.moe.route"):
        cap = capacity(t, n_experts, top_k, capacity_factor)
        idx, valid, gate, aux, slot = _route(x, router_w, n_experts, top_k,
                                             cap)
        n_loc = n_experts
        if split is not None:
            x, gate = split.copy_to(x), split.copy_to(gate)
            if expert_parallel:
                lo, hi = split.part(n_experts)
                n_loc = hi - lo
                idx, valid, gate = (a[:, lo:hi] for a in (idx, valid, gate))
                # this rank's slots first, every other expert's the zero row
                mine = (slot >= lo * cap) & (slot < hi * cap)
                slot = torch.where(mine, slot - lo * cap,
                                   torch.full_like(slot, n_loc * cap))

    with rng("repro.moe.experts"):
        # gather tokens into expert slots: (R, E, C, D)
        xe = x.gather(1, idx.reshape(r, -1, 1).expand(-1, -1, d))
        xe = torch.where(valid.reshape(r, -1, 1), xe, torch.zeros_like(xe))
        xe = xe.reshape(r, n_loc, cap, d)
        h = torch.einsum("recd,edf->recf", xe, w1) * F.silu(
            torch.einsum("recd,edf->recf", xe, w2))
        ye = torch.einsum("recf,efd->recd", h, w3)        # (R, E, C, D)
        ye = ye * gate[..., None].to(ye.dtype)

        # combine by gather: token t reads slots slot[t * K + j], j < K,
        # with a zero row appended for the overflow bin
        ye = torch.cat([ye.reshape(r, n_loc * cap, d),
                        ye.new_zeros(r, 1, d)], dim=1)
        picked = ye.gather(1, slot.reshape(r, -1, 1).expand(-1, -1, d))
        picked = picked.reshape(r, t, top_k, d)
        out = picked[:, :, 0]
        for j in range(1, top_k):
            out = out + picked[:, :, j]
        if split is not None:
            out = split.reduce_from(out)
    return out.to(x.dtype), aux
