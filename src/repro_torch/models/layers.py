"""Shared neural-net layers, on tensors (parameters passed explicitly).

Layouts follow the reference package: activations (B, S, H, D), KV caches
(B, S, KV, D), projections ``x @ W`` with ``W`` of shape (d_in, d_out).
Norm statistics, RoPE, attention scores and softmax run in float32, as in
the reference, or in float64 when their inputs are float64 (:func:`wide`):
a float64 model then rounds nowhere in float32.

Attention:
  * ``chunked_attention`` — blockwise (flash-style) causal attention, the
    plain path for prefill shapes.
  * ``decode_attention``  — one token against a linear KV cache, with the
    valid length given as a tensor so the decode loop never syncs.
  * ``decode_ring_attention`` — one token against a ring KV cache
    (sliding-window layers), the position ``t`` a tensor likewise.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

NEG_INF = -1e30


def wide(x):
    """``x`` in its accumulation type: float64 stays float64, every other
    floating type widens to float32."""
    return x if x.dtype == torch.float64 else x.float()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-5):
    dtype = x.dtype
    x = wide(x)
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * wide(scale)).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = wide(x)
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps)
    return (out * wide(scale) + wide(bias)).to(dtype)


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


def _rope_frequencies(d_head: int, theta: float, device: torch.device,
                      fake: bool = False):
    """The frequencies on ``device``: cached on a card; made afresh on the
    CPU, where a copy costs no synchronisation, and for a fake tensor (the
    dry-run's ``FakeTensorMode``), so that no fake tensor enters the cache
    and no real one meets the fake mode."""
    if device.type == "cpu":
        return torch.from_numpy(rope_frequencies(d_head, theta))
    if fake:
        return torch.from_numpy(rope_frequencies(d_head, theta)).to(device)
    return _rope_frequencies_on(d_head, theta, device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: tensor broadcastable to (..., S).

    Half-split rotation with fp32 angles, as in the reference (fp64 for
    a float64 ``x``)."""
    x1, x2 = wide(x).chunk(2, dim=-1)
    freqs = _rope_frequencies(x.shape[-1], theta, x.device,
                              is_fake(x)).to(x1.dtype)
    angles = positions.to(x1.dtype)[..., None] * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
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

    ft = wide(q[:0]).dtype
    acc = torch.zeros((b, h, sq, d), dtype=ft, device=q.device)
    m_run = torch.full((b, h, sq), NEG_INF, dtype=ft, device=q.device)
    l_run = torch.zeros((b, h, sq), dtype=ft, device=q.device)
    for start in range(0, skv, chunk):
        k_blk = k[:, start:start + chunk]
        v_blk = v[:, start:start + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", wide(qf), wide(k_blk))
        kv_pos = start + torch.arange(k_blk.shape[1], device=q.device)
        mask = _mask(q_pos, kv_pos, causal, window, local_block)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", wide(p.to(v_blk.dtype)),
                          wide(v_blk))
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
    scores = torch.einsum("bqhd,bkhd->bhqk", wide(q), wide(k))
    scores = scores * (1.0 / math.sqrt(d))
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1, 1)
    valid = torch.arange(s, device=q.device)[None, None, None, :] < length
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", wide(p.to(v.dtype)), wide(v))
    return out.to(q.dtype)


def decode_ring_attention(q, k_cache, v_cache, *, t, window=None,
                          local_block=None):
    """One-token attention over a ring cache.

    q: (B, 1, H, D); caches: (B, W, KV, D).  ``t`` (a 0-d tensor on the
    caches' device) is the new token's position; the cache holds positions
    <= t, ring slot i the absolute position p_i = t - ((t - i) mod W)
    (negative: not yet written)."""
    b, _, h, d = q.shape
    w = k_cache.shape[1]
    n_rep = h // k_cache.shape[2]
    k = _expand_kv(k_cache, n_rep)
    v = _expand_kv(v_cache, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", wide(q), wide(k))
    scores = scores * (1.0 / math.sqrt(d))
    i = torch.arange(w, device=q.device)
    kv_pos = t - torch.remainder(t - i, w)      # (W,) absolute positions
    mask = kv_pos >= 0
    if window is not None:
        mask &= (t - kv_pos) < window
    if local_block is not None:
        mask &= kv_pos >= torch.div(t, local_block,
                                    rounding_mode="floor") * local_block
    scores = torch.where(mask[None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", wide(p.to(v.dtype)), wide(v))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLP blocks
# ---------------------------------------------------------------------------
def swiglu_mlp(x, w1, w2, w3):
    """LLaMA-style gated MLP.  w1/w2: (D, F); w3: (F, D)."""
    return (x @ w1 * F.silu(x @ w2)) @ w3


def _dp_axes(opts) -> tuple:
    return tuple(opts.dp_spec or ())


def explicit_tp_swiglu(x, w1, w2, w3, opts):
    """SwiGLU with explicit tensor-parallel collectives, per rank.

    x: this rank's batch block (B/|dp|, S, D), the same on every 'model'
    rank; w1 / w2: blocks (D/|data|, F/|model|), w3: (F/|model|, D/|data|)
    (the reference's shard_map in_specs).  The weight blocks are
    all-gathered over 'data' in the activation dtype, the product runs on
    this rank's F slice, and the partial outputs are summed over 'model'
    in the activation dtype.  Returns (B/|dp|, S, D), the same on every
    'model' rank.  Differentiable (``models/dist.py``)."""
    from repro_torch.models import dist
    mesh, tp, dp = opts.mesh, opts.tp_name, _dp_axes(opts)
    w1 = dist.unshard(w1.to(x.dtype), ("data", None), mesh, dp)
    w2 = dist.unshard(w2.to(x.dtype), ("data", None), mesh, dp)
    w3 = dist.unshard(w3.to(x.dtype), (None, "data"), mesh, dp)
    x = dist.copy_to(x, mesh, tp)
    h = (x @ w1) * F.silu(x @ w2)
    return dist.reduce_from(h @ w3, mesh, tp)


def explicit_tp_matmul(x, w, opts, *, row: bool):
    """Column- / row-parallel projection with explicit collectives, per
    rank; the *flattened* feature dim is sharded (always divisible by
    |model|, unlike head counts).

    row: x (B/|dp|, S, K/|model|), w block (K/|model|, N/|data|); returns
    the (B/|dp|, S, N) sum over 'model' of the partial products.
    column: x (B/|dp|, S, K), the same on every 'model' rank, w block
    (K/|data|, N/|model|); returns this rank's (B/|dp|, S, N/|model|).
    The weight block is all-gathered over 'data' in the activation
    dtype."""
    from repro_torch.models import dist
    mesh, tp, dp = opts.mesh, opts.tp_name, _dp_axes(opts)
    if row:
        w = dist.unshard(w.to(x.dtype), (None, "data"), mesh, dp)
        return dist.reduce_from(x @ w, mesh, tp)
    w = dist.unshard(w.to(x.dtype), ("data", None), mesh, dp)
    return dist.copy_to(x, mesh, tp) @ w


def gelu_mlp(x, w1, b1, w3, b3=None):
    # the reference's jax.nn.gelu defaults to the tanh approximation; a
    # tensor-parallel caller adds b3 itself, once, after its sum
    out = F.gelu(x @ w1 + b1, approximate="tanh") @ w3
    return out if b3 is None else out + b3


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape: tuple, dtype=torch.bfloat16,
               scale: float | None = None, device=None):
    """Normal(0, 1/sqrt(fan_in)) in fp32, cast to ``dtype``.  A stacked
    leaf (3 or more dims) is drawn one leading slice at a time, so the
    fp32 draw never holds more than one macro block of it (Mixtral's
    stacked experts are 4.5 GiB a layer in bf16, twice that in fp32)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if len(shape) < 3:
        out = torch.randn(shape, generator=generator, dtype=torch.float32,
                          device=device)
        return out.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for block in out:
        block.copy_(torch.randn(block.shape, generator=generator,
                                dtype=torch.float32, device=device)
                    .mul_(scale))
    return out
