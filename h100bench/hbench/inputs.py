"""The weights and prompts of a run, made from its seed.

Both sides get them from here: the program's executor has its tensors
filled in place (``fill_program``), and the plain reference draws the same
values again, one layer at a time (``layer_weights``).  Every leaf of every
layer has a generator of its own, seeded from (run seed, leaf, layer), so a
layer can be drawn again without the others.  The values are drawn on the
device in the served type (bf16 on the card), one call a leaf and layer.

Weights are Normal(0, 1/sqrt(n)) with n the dimension a product contracts
over, so every projection keeps its input's scale and the logits come out
near unit variance; the token embedding is Normal(0, 1); norm scales are
Normal(1, 0.1), so a path that skips one is seen.

This module imports torch only: the reference reads it.
"""
from __future__ import annotations

import hashlib

import torch


def leaf_seed(seed: int, name: str, index: int) -> int:
    """A 63-bit generator seed for one leaf of one layer."""
    h = hashlib.sha256(f"{int(seed)}/{name}/{int(index)}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def layer_leaves(model: dict) -> dict[str, tuple[tuple, float, float]]:
    """name -> (shape, mean, std) of one layer's leaves, in the layout
    ``y = x @ w`` (a (in, out) matrix; experts stacked first)."""
    d, f = model["d_model"], model["d_ff"]
    h, kv, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    out = {
        "wq": ((d, h * dh), 0.0, d ** -0.5),
        "wk": ((d, kv * dh), 0.0, d ** -0.5),
        "wv": ((d, kv * dh), 0.0, d ** -0.5),
        "wo": ((h * dh, d), 0.0, (h * dh) ** -0.5),
        "ln1_scale": ((d,), 1.0, 0.1),
        "ln2_scale": ((d,), 1.0, 0.1),
    }
    e = model.get("n_experts")
    if e:
        out.update({
            "router": ((d, e), 0.0, d ** -0.5),
            "moe_w1": ((e, d, f), 0.0, d ** -0.5),
            "moe_w2": ((e, d, f), 0.0, d ** -0.5),
            "moe_w3": ((e, f, d), 0.0, f ** -0.5),
        })
    else:
        out.update({
            "w1": ((d, f), 0.0, d ** -0.5),
            "w2": ((d, f), 0.0, d ** -0.5),
            "w3": ((f, d), 0.0, f ** -0.5),
        })
    return out


def top_leaves(model: dict) -> dict[str, tuple[tuple, float, float]]:
    """The leaves outside the layers: embedding (vocab, d), head (vocab,
    d) used as ``x @ head.T``, final norm scale."""
    v, d = model["vocab"], model["d_model"]
    return {"embed": ((v, d), 0.0, 1.0),
            "lm_head": ((v, d), 0.0, d ** -0.5),
            "final_norm_scale": ((d,), 1.0, 0.1)}


def draw_(out: torch.Tensor, seed: int, name: str, index: int,
          mean: float, std: float) -> torch.Tensor:
    """Fill ``out`` (contiguous) in place with the leaf's values."""
    if not out.is_contiguous():
        raise ValueError(f"{name}: a leaf is drawn into contiguous memory")
    g = torch.Generator(device=out.device)
    g.manual_seed(leaf_seed(seed, name, index))
    return out.normal_(mean, std, generator=g)


def draw(shape: tuple, seed: int, name: str, index: int, mean: float,
         std: float, dtype, device) -> torch.Tensor:
    return draw_(torch.empty(shape, dtype=dtype, device=device), seed, name,
                 index, mean, std)


def prompts(seed: int, bucket: int, prompt_len: int, vocab: int,
            device) -> torch.Tensor:
    """The (bucket, prompt_len) int64 prompt batch of a bucket."""
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, "prompt", bucket))
    return torch.randint(0, vocab, (bucket, prompt_len), generator=g,
                         device=device)


def layer_weights(model: dict, seed: int, layer: int, dtype,
                  device) -> dict[str, torch.Tensor]:
    """One layer's leaves drawn in the served ``dtype``."""
    return {name: draw(shape, seed, name, layer, mean, std, dtype, device)
            for name, (shape, mean, std) in layer_leaves(model).items()}


def top_weights(model: dict, seed: int, dtype, device) -> dict:
    return {name: draw(shape, seed, name, 0, mean, std, dtype, device)
            for name, (shape, mean, std) in top_leaves(model).items()}


def fill_program(params: dict, model: dict, seed: int) -> int:
    """Overwrite the program's parameters in place with the run's weights.

    ``params`` is the program's flat dict: ``layers/<leaf>`` stacked
    (layers, 1, ...) and the top leaves.  Raises if a name or a shape is
    not the one the benchmark makes; returns the number of draws."""
    n = model["n_layers"]
    leaves = layer_leaves(model)
    tops = top_leaves(model)
    want = {f"layers/{k}" for k in leaves} | set(tops)
    if set(params) != want:
        raise ValueError(f"program leaves {sorted(set(params) ^ want)} are "
                         f"not the benchmark's")
    draws = 0
    for key, t in params.items():
        if key.startswith("layers/"):
            name = key[len("layers/"):]
            shape, mean, std = leaves[name]
            if tuple(t.shape) != (n, 1) + shape:
                raise ValueError(f"{key}: shape {tuple(t.shape)}, the "
                                 f"benchmark's is {(n, 1) + shape}")
            for i in range(n):
                draw_(t[i, 0], seed, name, i, mean, std)
                draws += 1
        else:
            shape, mean, std = tops[key]
            if tuple(t.shape) != shape:
                raise ValueError(f"{key}: shape {tuple(t.shape)}, the "
                                 f"benchmark's is {shape}")
            draw_(t, seed, key, 0, mean, std)
            draws += 1
    return draws
