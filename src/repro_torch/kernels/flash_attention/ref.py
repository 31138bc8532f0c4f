"""Plain PyTorch version of the flash-attention kernel (naive, materialised)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, local_block=None,
                  q_offset=0):
    """q: (B, H, Sq, D); k/v: (B, KV, Skv, D).  fp32 softmax, full scores."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    n_rep = h // kvh
    k = torch.repeat_interleave(k, n_rep, dim=1)
    v = torch.repeat_interleave(v, n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    if local_block is not None:
        mask &= (torch.div(q_pos[:, None], local_block, rounding_mode="floor")
                 == torch.div(kv_pos[None, :], local_block,
                              rounding_mode="floor"))
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
