"""KV-cache geometry.

A full-attention layer keeps a ring-less cache (B, S_max, KV, DH),
stacked on the leading layer axes.  A sliding-window or chunked-local
layer keeps a ring of ``cache_len`` slots, position p at slot p mod W:
the transformer's rings are ``cache_len(cfg, max_len, kind)`` wide
(``models/transformer.py``), Hymba's ``cache_len(cfg, S, "window")``, S
the prompt (``models/hymba.py``).  RWKV6 keeps a fixed-size state instead.
"""
from __future__ import annotations

import torch


def cache_len(cfg, shape_kind_max_len: int, kind: str) -> int:
    """Physical cache length for a layer kind given logical max context."""
    if kind == "local" and cfg.chunk_attn:
        return min(cfg.chunk_attn, shape_kind_max_len)
    if cfg.window is not None:
        return min(cfg.window, shape_kind_max_len)
    return shape_kind_max_len


def write_prompt(layer, new) -> None:
    """Write a prompt's fresh keys or values ``new`` (B, S, KV, DH) into a
    layer's cache ``layer`` (B, W, KV, DH) in place: at slots [0, S), the
    slots after them zeroed, when S <= W; else the last W positions,
    position p at ring slot p mod W."""
    s, w = new.shape[1], layer.shape[1]
    if s <= w:
        layer[:, :s].copy_(new)
        layer[:, s:].zero_()
    else:
        layer.copy_(torch.roll(new[:, s - w:], (s - w) % w, dims=1))
