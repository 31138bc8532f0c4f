"""KV-cache geometry.

The dense family keeps a full, ring-less cache (B, S_max, KV, DH) per
layer, stacked on the leading layer axes.  Hymba's sliding-window layers
keep a ring of ``cache_len(cfg, S, "window")`` slots, position p at slot
p mod W (``models/hymba.py``); RWKV6 keeps a fixed-size state instead.
The transformer family's window and chunked-local rings arrive with the
MoE configs that use them (ROADMAP item 3).
"""
from __future__ import annotations


def cache_len(cfg, shape_kind_max_len: int, kind: str) -> int:
    """Physical cache length for a layer kind given logical max context."""
    if kind == "local" and cfg.chunk_attn:
        return min(cfg.chunk_attn, shape_kind_max_len)
    if cfg.window is not None:
        return min(cfg.window, shape_kind_max_len)
    return shape_kind_max_len
