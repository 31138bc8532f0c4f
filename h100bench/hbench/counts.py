"""Operations and bytes of the served work, from shapes alone.

Frozen copies of the program's counts, so that no later change of the
program moves the yardstick:

* the data-sheet peaks of an H100 SXM (``DEVICE_PEAKS``,
  ``src/repro_torch/launch/roofline.py:29-37``);
* ``bound`` and ``window_pairs`` of ``chip_smoke.py`` (lines 218-223 and
  598-602), and its byte and operation counts of a flash-attention launch
  (lines 508-509, 673-674) and a flash-decode launch (lines 538-539, 545):
  each input read and each output written once, masked pairs and slots
  skipped, a decode row counting its live slots.

``token_flops`` counts the useful work of served tokens: 2 operations a
multiply-add over every weight a token meets (the layers' projections, the
router and the experts it is routed to, the head where logits are taken),
plus the QK and PV products over the positions it attends to.  The
program's ``model_flops`` (``launch/roofline.py:160``) has no attention
term.
"""
from __future__ import annotations

# H100 SXM data sheet: dense bf16 FLOP/s, HBM bytes/s
PEAK_BF16_FLOPS = 989e12
HBM_BW = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds on the card for the given bf16 work."""
    return max(nbytes / HBM_BW, flops / PEAK_BF16_FLOPS)


def window_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs a causal attention with a sliding ``window``
    computes over ``s`` positions: query i sees min(i + 1, window) keys."""
    w = min(window, s) if window else s
    return w * (w + 1) // 2 + (s - w) * w


def flash_attention(model: dict, b: int, s: int, esize: int = 2) -> tuple:
    """(bytes, flops) of one prefill launch over a (b, s) batch."""
    h, kv, d = model["n_heads"], model["n_kv_heads"], model["d_head"]
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * esize
    flops = 4.0 * b * h * d * window_pairs(s, model.get("window"))
    return nbytes, flops


def flash_decode(model: dict, b: int, t: int, esize: int = 2) -> tuple:
    """(bytes, flops) of one decode launch writing position ``t`` (its
    ``t + 1`` live slots)."""
    h, kv, d = model["n_heads"], model["n_kv_heads"], model["d_head"]
    live = t + 1
    nbytes = (2 * b * h * d + 2 * b * live * kv * d) * esize + 4
    flops = 4.0 * b * h * d * live
    return nbytes, flops


def layer_weights_per_token(model: dict) -> int:
    """Multiply-adds a token makes with one layer's weights."""
    d, f = model["d_model"], model["d_ff"]
    h, kv, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    attn = d * h * dh * 2 + d * kv * dh * 2
    e = model.get("n_experts")
    if e:
        return attn + d * e + model["top_k"] * 3 * d * f
    return attn + 3 * d * f


def attended(model: dict, pos: int) -> int:
    """Keys the token at position ``pos`` attends to."""
    w = model.get("window")
    return min(pos + 1, w) if w else pos + 1


def request_flops(model: dict, prompt_len: int, gen_len: int) -> float:
    """Useful operations of one request: its prompt's prefill (logits of
    the last position only) and ``gen_len`` decode steps."""
    n, d, v = model["n_layers"], model["d_model"], model["vocab"]
    h, dh = model["n_heads"], model["d_head"]
    per_tok = 2.0 * n * layer_weights_per_token(model)
    head = 2.0 * d * v
    pairs = window_pairs(prompt_len, model.get("window")) + sum(
        attended(model, prompt_len + j) for j in range(gen_len))
    attn = 4.0 * n * h * dh * pairs
    return (prompt_len + gen_len) * per_tok + (1 + gen_len) * head + attn
