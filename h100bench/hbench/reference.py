"""Plain float32 reference of the served models, in blocks.

Computes, for batches of prompts and the tokens the program served after
them, the logits at every served position: the prompt's last position and
each decode position.  It follows the served model's equations as the
configuration file states them (pre-norm decoder: RMSNorm, RoPE with a
half-split rotation, causal grouped-query attention with an optional
sliding window, SwiGLU MLP or a top-k Mixture of Experts with a capacity,
a final RMSNorm and an untied head), written from those equations with
plain ``torch`` operations; it imports no code of the program.

Serving semantics that the numbers depend on:

* The prompt is one prefill; each served token is then fed back one
  decode step at a time.  Attention over a cache is causal attention over
  the whole sequence, so the reference runs the whole sequence at once.
* MoE routing groups tokens into "rows" and drops the assignments past an
  expert's capacity ``ceil(T * k / E * capacity_factor)`` (T tokens in the
  row), in token-major order.  A prefill routes each prompt as one row; a
  decode step routes the batch's B new tokens as one row.  Ties in the
  router go to the lower expert index.

The weights are drawn again here, layer by layer, from the run's seed
(``hbench.inputs``), in the served type; each matrix is widened to
float32 where it is used, so the reference holds one layer in the served
type and one matrix in float32.  TF32 is switched off.

``quant="fp8"`` is the control: every product's two operands rounded to
float8 e4m3 with one scale a tensor, the step below bf16 that a faster
serving path would take.  ``quant="bf16"`` rounds them to bf16 instead:
a witness of what bf16 rounding alone does to the served logits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hbench import inputs


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


ROUNDING = {None: lambda t: t, "fp8": _fp8,
            "bf16": lambda t: t.to(torch.bfloat16).to(t.dtype)}


class _Math:
    def __init__(self, quant: str | None):
        if quant not in ROUNDING:
            raise ValueError(f"unknown precision {quant!r}")
        self.q = ROUNDING[quant]

    def mm(self, x, w):
        return self.q(x) @ self.q(w.float())


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta: float):
    """x (L, H, D): rotate the two halves of each head by fp32 angles."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions.to(torch.float32)[:, None] * freqs       # (L, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window):
    """Causal attention of one sequence; q (L, H, D), k / v (L, KV, D)."""
    length, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    pos = torch.arange(length, device=q.device)
    ok = pos[:, None] >= pos[None, :]
    if window:
        ok &= pos[:, None] - pos[None, :] < window
    s = s.masked_fill(~ok, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)


def capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(math.ceil(tokens * top_k / n_experts * factor))
    return max(1, min(c, tokens * top_k))


def route(probs, rows: list[torch.Tensor], top_k: int, factor: float):
    """Kept assignments over all routing rows: (token, expert, gate)
    index tensors.  ``probs`` (N, E) holds every token's router softmax,
    ``rows`` the token indices of each routing row in row order."""
    n_exp = probs.shape[1]
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    toks, exps, gts = [], [], []
    for row in rows:
        cap = capacity(len(row), n_exp, top_k, factor)
        e_row = idx[row].reshape(-1)                    # token-major order
        g_row = gates[row].reshape(-1)
        t_row = row.repeat_interleave(top_k)
        for e in range(n_exp):
            a = (e_row == e).nonzero().squeeze(1)[:cap]
            toks.append(t_row[a])
            exps.append(torch.full_like(a, e))
            gts.append(g_row[a])
    return torch.cat(toks), torch.cat(exps), torch.cat(gts)


def moe(m: _Math, x, w, rows, top_k: int, factor: float):
    """x (N, d) flat tokens; returns the experts' combined output."""
    probs = torch.softmax(m.mm(x, w["router"]), dim=-1)
    toks, exps, gates = route(probs, rows, top_k, factor)
    out = torch.zeros_like(x)
    for e in range(w["router"].shape[1]):
        sel = exps == e
        if not bool(sel.any()):
            continue
        t = toks[sel]
        xe = x[t]
        y = m.mm(m.mm(xe, w["moe_w1"][e]) * F.silu(m.mm(xe, w["moe_w2"][e])),
                 w["moe_w3"][e])
        out.index_add_(0, t, y * gates[sel][:, None])
    return out


@torch.no_grad()
def served_logits(model: dict, seed: int, groups: list[torch.Tensor],
                  prompt_len: int, dtype, device,
                  quant: str | None = None) -> list[torch.Tensor]:
    """Reference logits at the served positions.

    ``groups``: one (B, prompt_len + n_fed) int64 tensor per served batch,
    the prompt and the tokens fed back to decode.  Returns one (B, n_fed +
    1, vocab) float32 tensor per group: the logits after the prompt and
    after each fed token."""
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _served_logits(model, seed, groups, prompt_len, dtype, device,
                              _Math(quant))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _served_logits(model, seed, groups, prompt_len, dtype, device, m):
    length = groups[0].shape[1]
    if any(g.shape[1] != length for g in groups):
        raise ValueError("every served batch has one length")
    s = prompt_len
    tokens = torch.cat(groups).to(device)
    n_rows = tokens.shape[0]
    h, kv, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    eps, theta = model["norm_eps"], model["rope_theta"]
    top = inputs.top_weights(model, seed, dtype, device)
    x = top["embed"][tokens].float()                    # (R, L, d)
    pos = torch.arange(length, device=device)
    # routing rows over the flat (R * L) tokens: each prompt; then each
    # decode position of each served batch
    rows, first = [], 0
    flat = torch.arange(n_rows * length, device=device).view(n_rows, length)
    rows += [flat[r, :s] for r in range(n_rows)]
    for g in groups:
        b = g.shape[0]
        rows += [flat[first:first + b, p] for p in range(s, length)]
        first += b
    for layer in range(model["n_layers"]):
        w = inputs.layer_weights(model, seed, layer, dtype, device)
        for r in range(n_rows):
            hn = rms_norm(x[r], w["ln1_scale"].float(), eps)
            q = rope(m.mm(hn, w["wq"]).view(length, h, dh), pos, theta)
            k = rope(m.mm(hn, w["wk"]).view(length, kv, dh), pos, theta)
            v = m.mm(hn, w["wv"]).view(length, kv, dh)
            o = attention(q, k, v, model.get("window"))
            x[r] += m.mm(o.reshape(length, h * dh), w["wo"])
        hn = rms_norm(x, w["ln2_scale"].float(), eps).view(n_rows * length,
                                                           -1)
        if model.get("n_experts"):
            out = moe(m, hn, w, rows, model["top_k"],
                      model["capacity_factor"])
        else:
            out = m.mm(m.mm(hn, w["w1"]) * F.silu(m.mm(hn, w["w2"])),
                       w["w3"])
        x += out.view(n_rows, length, -1)
        del w, hn, out
    xs = rms_norm(x[:, s - 1:], top["final_norm_scale"].float(), eps)
    logits = m.mm(xs, top["lm_head"].T)
    out, first = [], 0
    for g in groups:
        out.append(logits[first:first + g.shape[0]])
        first += g.shape[0]
    return out
