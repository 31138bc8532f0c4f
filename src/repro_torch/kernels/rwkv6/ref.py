"""Plain PyTorch version of the WKV6 kernel: the literal per-token
recurrence, in float32."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, lw, u, s0):
    """r/k/v/lw: (B, H, T, K); u: (H, K); s0: (B, H, K, V) f32.

    Returns (y (B, H, T, V) in r's dtype, s_fin (B, H, K, V) f32), from

        y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T

    one token at a time: slow but unambiguous."""
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(lw.float())                    # per-step decay in (0, 1]
    uf = u.float()[None, :, :, None]             # (1, H, K, 1)
    s = s0.float()
    ys = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]     # (B, H, K, V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], s + uf * kv))
        s = s * w[:, :, t, :, None] + kv
    return torch.stack(ys, dim=2).to(r.dtype), s
