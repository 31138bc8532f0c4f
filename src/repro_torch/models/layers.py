"""Shared neural-net layers, on tensors (parameters passed explicitly).

Layouts follow the reference package: activations (B, S, H, D), KV caches
(B, S, KV, D), projections ``x @ W`` with ``W`` of shape (d_in, d_out).

Attention:
  * ``chunked_attention`` — blockwise (flash-style) causal attention, the
    plain path for prefill shapes.
  * ``decode_attention``  — one token against a linear KV cache, with the
    valid length given as a tensor so the decode loop never syncs.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32)
                            / d_head))


@functools.lru_cache(maxsize=None)
def _rope_frequencies_on(d_head: int, theta: float, device: torch.device):
    # copied to the device once: a host-to-device copy from pageable
    # memory would synchronise the stream on every layer of every step
    return torch.from_numpy(
        rope_frequencies(d_head, theta).astype(np.float32)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: tensor broadcastable to (..., S).

    Half-split rotation with fp32 angles, as in the reference."""
    freqs = _rope_frequencies_on(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs       # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _expand_kv(k, n_rep: int):
    """(B, S, KV, D) -> (B, S, KV * n_rep, D) by head repetition (GQA)."""
    if n_rep == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def _mask(q_pos, kv_pos, causal, window, local_block):
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    if local_block is not None:
        mask &= (torch.div(q_pos[:, None], local_block, rounding_mode="floor")
                 == torch.div(kv_pos[None, :], local_block,
                              rounding_mode="floor"))
    return mask


def chunked_attention(q, k, v, *, causal: bool = True, window=None,
                      local_block=None, chunk: int = 1024,
                      q_offset: int = 0):
    """Blockwise (flash-style) attention with an online softmax.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D) with H % KV == 0.
    Memory: O(Sq * chunk) per head."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    n_rep = h // k.shape[2]
    k = _expand_kv(k, n_rep)
    v = _expand_kv(v, n_rep)
    scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, skv)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    qf = (q * scale).to(q.dtype)

    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for start in range(0, skv, chunk):
        k_blk = k[:, start:start + chunk]
        v_blk = v[:, start:start + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf.float(), k_blk.float())
        kv_pos = start + torch.arange(k_blk.shape[1], device=q.device)
        mask = _mask(q_pos, kv_pos, causal, window, local_block)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_blk.dtype).float(),
                          v_blk.float())
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)              # (B, Sq, H, D)


def decode_attention(q, k_cache, v_cache, *, length):
    """One-token attention.  q: (B, 1, H, D); caches: (B, S, KV, D).

    ``length`` (an int or a tensor on the caches' device) is the number of
    valid cache entries."""
    b, _, h, d = q.shape
    s = k_cache.shape[1]
    n_rep = h // k_cache.shape[2]
    k = _expand_kv(k_cache, n_rep)
    v = _expand_kv(v_cache, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(d))
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1, 1)
    valid = torch.arange(s, device=q.device)[None, None, None, :] < length
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLP blocks
# ---------------------------------------------------------------------------
def swiglu_mlp(x, w1, w2, w3):
    """LLaMA-style gated MLP.  w1/w2: (D, F); w3: (F, D)."""
    return (x @ w1 * F.silu(x @ w2)) @ w3


def gelu_mlp(x, w1, b1, w3, b3):
    # the reference's jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w1 + b1, approximate="tanh") @ w3 + b3


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape: tuple, dtype=torch.bfloat16,
               scale: float | None = None, device=None):
    """Normal(0, 1/sqrt(fan_in)) in fp32, cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=device)
    return out.mul_(scale).to(dtype)
