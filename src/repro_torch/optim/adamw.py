"""AdamW with cosine schedule, global-norm clipping and optional int8
gradient compression (error feedback) for the data-parallel all-reduce.

Functional over the port's flat parameter dicts: ``init`` builds the
(fp32) moment state; ``update`` writes the new values into the tensors it
is given (as the reference's step donates its buffers to XLA), so a step
holds one copy of the optimizer state, and returns them.  The compression
path quantises gradients to int8 with a per-tensor scale *before* they
would cross the DP axis and keeps the residual locally (error feedback),
the standard bandwidth/quality trade [1-bit Adam, arXiv:2102.02888-style].

The arithmetic follows the reference in its order and in fp32: fp32
grads, global norm, clip, bias correction with the step as fp32,
decoupled weight decay on the fp32 copy of each parameter, cast back to
its dtype.  The step, the learning rate and the norm stay tensors on the
parameters' device, so an update never syncs with the host.

Sharded state (``launch/steps.py``): parameters, gradients, moments and
error feedback may be DTensors of one layout, and the step a replicated
one.  The update then runs on each rank's blocks, and a leaf's sum of
squares in the global norm is summed over the mesh dims along which the
leaf is *sharded* (a dim along which it is replicated holds copies,
which a sum would count again).  Int8 compression quantises each block
with the scale of the whole leaf, as the reference's does under pjit:
its max |g| is a MAX over those same dims; each rank keeps its block's
residual.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False      # int8 + error feedback across DP


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor), in fp32: linear
    warmup, then a cosine decay to 0.1 x ``lr``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(params: dict) -> dict:
    device = next(iter(params.values())).device
    return {
        "m": init_error_feedback(params),
        "v": init_error_feedback(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _acc_dtype(p: torch.Tensor) -> torch.dtype:
    """The update's arithmetic type: float64 for float64 parameters,
    float32 for the rest (the reference's)."""
    return torch.float64 if p.dtype == torch.float64 else torch.float32


def init_error_feedback(params: dict) -> dict:
    """Zeros shaped like each parameter, in its update's type."""
    return {k: torch.zeros_like(p, dtype=_acc_dtype(p))
            for k, p in params.items()}


def compress_int8(g: torch.Tensor, amax=None) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Per-tensor symmetric int8 quantisation; ``amax`` is the max |g| of
    the whole tensor when ``g`` is a block of it (by default g's own).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = g.abs().max() if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_residual(g, err):
    """Quantise (g + err); return (dequantised g_hat, new residual).  A
    sharded leaf (DTensors) is quantised with the whole leaf's scale, and
    both results are laid out as its blocks."""
    g32 = _local(g).float() + _local(err)
    q, scale = compress_int8(g32, _over_shards(g32.abs().max(), g,
                                               dist.ReduceOp.MAX))
    g_hat = decompress_int8(q, scale)
    return _like(g_hat, g), _like(g32 - g_hat, err)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _over_shards(value: torch.Tensor, leaf, op=dist.ReduceOp.SUM):
    """``value``, computed on this rank's block of ``leaf``, reduced by
    ``op`` over the mesh dims along which the leaf is sharded (none for a
    plain tensor)."""
    if isinstance(leaf, DTensor):
        for dim, placement in enumerate(leaf.placements):
            # a strided shard (two mesh dims on one tensor dim) is no
            # Shard, but it splits the leaf as one does
            if not placement.is_replicate() and leaf.device_mesh.size(dim) > 1:
                dist.all_reduce(value, op=op,
                                group=leaf.device_mesh.get_group(dim))
    return value


def _like(local: torch.Tensor, ref):
    """``local`` as a DTensor laid out like ``ref``, when ``ref`` is one."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False)


def _sum_squares(g) -> torch.Tensor:
    """A leaf's sum of squares, over the whole leaf when it is sharded."""
    local = _local(g)
    return _over_shards(torch.sum(torch.square(local.to(_acc_dtype(local)))),
                        g)


@torch.no_grad()
def update(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
           error_feedback: Optional[dict] = None):
    """Returns (params', state', error_feedback', metrics), updated in
    place: the dicts hold the tensors that were passed in, and
    ``state["step"]`` is a new 0-d tensor.  ``metrics`` holds the global
    grad norm and the learning rate as 0-d tensors."""
    names = sorted(params)          # the reference's leaf order
    if cfg.compress_grads:
        if error_feedback is None:
            raise ValueError("compress_grads needs an error-feedback state "
                             "(init_error_feedback)")
        grads = dict(grads)
        for k in names:
            grads[k], err = compress_residual(grads[k], error_feedback[k])
            _local(error_feedback[k]).copy_(_local(err))

    gnorm = torch.sqrt(sum(_sum_squares(grads[k]) for k in names))
    scale_clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                             max=1.0)

    step = _local(state["step"]) + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=step.device),
                          step.float())
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=step.device),
                          step.float())

    for k in names:
        p, m, v = (_local(t) for t in (params[k], state["m"][k],
                                        state["v"][k]))
        g = _local(grads[k]).to(m.dtype) * scale_clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p.to(m.dtype)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + \
            cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    new_state = {"m": state["m"], "v": state["v"],
                 "step": _like(step, state["step"])}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, new_state, error_feedback, metrics
