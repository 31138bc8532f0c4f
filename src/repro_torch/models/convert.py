"""Carry the reference package's parameters into the port.

The reference keeps parameters as a nested dict of arrays; its checkpoints
key each leaf by the '/'-joined path of dict keys (``layers/wq``,
``embed``, ...).  The port's parameter dict uses those same names as flat
keys, and the leaf layouts agree, so importing is a copy of each leaf.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, f"{name}/")
        else:
            yield name, val


def params_from_reference(np_tree: dict, dtype=None,
                          device="cpu") -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> flat dict of tensors keyed by path.

    Arrays of a dtype numpy itself lacks (bfloat16) pass through float32.
    ``dtype`` casts every leaf; by default each keeps its own."""
    out = {}
    for name, leaf in _flatten(np_tree):
        arr = np.asarray(leaf)
        src_bf16 = arr.dtype.name == "bfloat16"
        if src_bf16:
            arr = arr.astype(np.float32)
        t = torch.tensor(arr)                 # a copy: numpy may be read-only
        want = dtype or (torch.bfloat16 if src_bf16 else t.dtype)
        out[name] = t.to(device=device, dtype=want)
    return out
