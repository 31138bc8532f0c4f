"""Plain PyTorch version of the flash-decode kernel."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q, k_cache, v_cache, *, t, window=None, local_block=None):
    """q: (B, H, D); caches: (B, S, KV, D) -> (B, H, D).

    ``t`` is the current position: a Python int or an int tensor of one
    element (on the caches' device, so no host read is needed)."""
    b, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // kvh
    k = torch.repeat_interleave(k_cache, n_rep, dim=2)
    v = torch.repeat_interleave(v_cache, n_rep, dim=2)
    sc = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) / math.sqrt(d)
    slots = torch.arange(s, device=q.device)
    t = torch.as_tensor(t, device=q.device).reshape(())
    if window is None and local_block is None:
        kv_pos = slots
        valid = kv_pos <= t
    else:
        kv_pos = t - torch.remainder(t - slots, s)
        valid = kv_pos >= 0
        if window is not None:
            valid &= (t - kv_pos) < window
        if local_block is not None:
            valid &= kv_pos >= torch.div(
                t, local_block, rounding_mode="floor") * local_block
    sc = torch.where(valid[None, None, :], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v.float())
    return out.to(q.dtype)
