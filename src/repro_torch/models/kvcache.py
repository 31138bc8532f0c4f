"""KV-cache geometry.

The dense family keeps a full, ring-less cache (B, S_max, KV, DH) per
layer, stacked on the leading layer axes.  Ring caches (sliding-window and
chunked-local layers) and SSM state caches arrive with the families that
use them (ROADMAP, items 2 and 3).
"""
from __future__ import annotations


def cache_len(cfg, shape_kind_max_len: int, kind: str) -> int:
    """Physical cache length for a layer kind given logical max context."""
    if kind == "local" and cfg.chunk_attn:
        return min(cfg.chunk_attn, shape_kind_max_len)
    if cfg.window is not None:
        return min(cfg.window, shape_kind_max_len)
    return shape_kind_max_len
