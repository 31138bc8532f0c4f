"""Decoder-only transformer, dense family.

Parameters are a flat ``dict[str, Tensor]`` keyed by the reference's
checkpoint path names (``layers/wq``, ``embed``, ...); layer weights are
stacked as (n_macro, m, ...) and the layer loop is a Python loop over
them (PyTorch runs eagerly, so the reference's ``lax.scan`` has no
counterpart to preserve).

Modes:
  * prefill — forward over the prompt, KV cache written, last-token logits.
  * hidden  — final-norm hidden states of the whole sequence.
  * decode  — one token against the cache (:func:`decode_step`), which
    writes the cache and advances its position ``t`` in place, with ``t``
    kept on the device so a decode loop never syncs with the host.

Sliding-window and chunked-local ring caches and MoE layers (ROADMAP
item 3), and train mode with its loss (item 5), raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """Runtime (not architecture) options."""
    attn_chunk: int = 1024
    param_dtype: Any = torch.bfloat16
    act_dtype: Any = torch.bfloat16
    use_kernels: bool = False      # CUDA kernels vs the plain attention


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP item 3)")
    if cfg.window or cfg.global_every:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window / chunked-local ring caches are "
            f"not ported yet (ROADMAP item 3)")


def chunked_lm_loss(*args, **kwargs):
    raise NotImplementedError("the LM loss is not ported yet "
                              "(ROADMAP item 5, training substrate)")


# ---------------------------------------------------------------------------
# Layer geometry
# ---------------------------------------------------------------------------
def macro_shape(cfg: ModelConfig) -> tuple[int, int, list[str]]:
    """(n_macro, macro_size, kinds) — kinds[j] in {full, window, local, global}."""
    if cfg.global_every:
        m = cfg.global_every
        kinds = ["local"] * (m - 1) + ["global"]
        return cfg.n_layers // m, m, kinds
    kind = "window" if cfg.window else "full"
    return cfg.n_layers, 1, [kind]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def _layer_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shapes: dict[str, tuple] = {
        "wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
        "wo": (h * dh, d),
        "ln1_scale": (d,), "ln2_scale": (d,),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": (h * dh,), "bk": (kv * dh,), "bv": (kv * dh,)})
    if cfg.norm == "layernorm":
        shapes.update({"ln1_bias": (d,), "ln2_bias": (d,)})
    if cfg.mlp == "swiglu":
        shapes.update({"w1": (d, f), "w2": (d, f), "w3": (f, d)})
    else:
        shapes.update({"w1": (d, f), "b1": (f,), "w3": (f, d), "b3": (d,)})
    return shapes


def param_specs(cfg: ModelConfig, opts: RunOptions = RunOptions()) -> dict:
    """path name -> (shape, dtype)."""
    _check_supported(cfg)
    n_macro, m, _ = macro_shape(cfg)
    pd = opts.param_dtype
    specs = {f"layers/{k}": ((n_macro, m) + s, pd)
             for k, s in _layer_param_shapes(cfg).items()}
    specs["embed"] = ((cfg.vocab, cfg.d_model), pd)
    specs["final_norm_scale"] = ((cfg.d_model,), pd)
    if cfg.norm == "layernorm":
        specs["final_norm_bias"] = ((cfg.d_model,), pd)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((cfg.vocab, cfg.d_model), pd)
    return specs


def init_params(cfg: ModelConfig, generator: torch.Generator,
                opts: RunOptions = RunOptions(), device=None) -> dict:
    """Norm scales 1, biases 0, other weights Normal(0, 1/sqrt(fan_in)),
    drawn from ``generator`` (which must live on ``device``)."""
    out = {}
    for path, (shape, dtype) in param_specs(cfg, opts).items():
        name = path.rsplit("/", 1)[-1]
        if "norm" in name or name.startswith("ln"):
            fill = torch.ones if "scale" in name else torch.zeros
            out[path] = fill(shape, dtype=dtype, device=device)
        elif name.startswith("b"):
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[path] = L.dense_init(generator, shape, dtype, device=device)
    return out


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                opts: RunOptions = RunOptions()) -> dict:
    """name -> (shape, dtype); ``t`` is the next position to write."""
    _check_supported(cfg)
    n_macro, m, kinds = macro_shape(cfg)
    w = kvcache.cache_len(cfg, max_len, kinds[0])
    shape = (n_macro, m, batch, w, cfg.n_kv_heads, cfg.d_head)
    return {"t": ((), torch.int32), "k": (shape, opts.act_dtype),
            "v": (shape, opts.act_dtype)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               opts: RunOptions = RunOptions(), device=None) -> dict:
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in
            cache_specs(cfg, batch, max_len, opts).items()}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _norm(cfg, w, prefix, x):
    if cfg.norm == "rmsnorm":
        return L.rms_norm(x, w[f"{prefix}_scale"])
    return L.layer_norm(x, w[f"{prefix}_scale"], w[f"{prefix}_bias"])


def _qkv(cfg, w, x, positions):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ w["wq"]
    k = x @ w["wk"]
    v = x @ w["wv"]
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = L.apply_rope(q.reshape(b, s, h, dh), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, s, kv, dh), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, kv, dh)


def _mlp(cfg, w, x):
    if cfg.mlp == "swiglu":
        return L.swiglu_mlp(x, w["w1"], w["w2"], w["w3"])
    return L.gelu_mlp(x, w["w1"], w["b1"], w["w3"], w["b3"])


def _attn_full_seq(cfg, w, x, opts, q_offset=0):
    """Causal attention over a full sequence.  Returns (out, k, v)."""
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)
    q, k, v = _qkv(cfg, w, x, positions)
    if opts.use_kernels:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        o = fa_ops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    else:
        o = L.chunked_attention(q, k, v, causal=True, chunk=opts.attn_chunk,
                                q_offset=q_offset)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    return o @ w["wo"], k, v


def _attn_decode(cfg, w, x, k_cache, v_cache, t, opts):
    """One-token attention.  x: (B, 1, D); k_cache/v_cache: (B, S, KV, D)
    views into the stacked cache, written at slot ``t`` in place."""
    b = x.shape[0]
    pos = t.reshape(1)
    q, k_new, v_new = _qkv(cfg, w, x, pos)
    slot = pos.long()
    k_cache.index_copy_(1, slot, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v_new.to(v_cache.dtype))
    if opts.use_kernels:
        from repro_torch.kernels.flash_decode import ops as fd_ops
        o = fd_ops.flash_decode_at(q[:, 0], k_cache, v_cache, pos)[:, None]
    else:
        o = L.decode_attention(q, k_cache, v_cache, length=t + 1)
    o = o.reshape(b, 1, cfg.n_heads * cfg.d_head)
    return o @ w["wo"]


def _layer(params, i, j) -> dict:
    return {k[len("layers/"):]: v[i, j] for k, v in params.items()
            if k.startswith("layers/")}


def _head(cfg, params):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _logits(x, head):
    # bf16 operands give a bf16 product, widened afterwards; the
    # reference asks XLA for an fp32 result from the same operands
    return (x @ head.T).float()


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill / hidden)
# ---------------------------------------------------------------------------
def _embed(cfg, params, tokens, prefix_embeds, opts):
    x = params["embed"][tokens].to(opts.act_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(opts.act_dtype), x], dim=1)
    return x


def forward(cfg: ModelConfig, params: dict, tokens,
            prefix_embeds=None, opts: RunOptions = RunOptions(),
            mode: str = "prefill", cache: Optional[dict] = None,
            max_len: Optional[int] = None):
    """mode='prefill': (last_logits (B, V) fp32, cache);
    mode='hidden': (hidden (B, S, D), 0.0).

    In prefill mode ``cache`` (from :func:`init_cache`, with room for
    ``max_len`` positions) is written in place; without one a fresh cache
    is allocated."""
    if mode == "train":
        raise NotImplementedError("train mode is not ported yet "
                                  "(ROADMAP item 5, training substrate)")
    if mode not in ("prefill", "hidden"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_supported(cfg)
    n_macro, m, _ = macro_shape(cfg)
    x = _embed(cfg, params, tokens, prefix_embeds, opts)
    b, s, _ = x.shape
    if mode == "prefill" and cache is None:
        cache = init_cache(cfg, b, max_len if max_len is not None else s,
                           opts, device=x.device)
    for i in range(n_macro):
        for j in range(m):
            w = _layer(params, i, j)
            h = _norm(cfg, w, "ln1", x)
            a, k, v = _attn_full_seq(cfg, w, h, opts)
            if mode == "prefill":
                _fill_cache(cache, i, j, k, v)
            x = x + a
            x = x + _mlp(cfg, w, _norm(cfg, w, "ln2", x))
    x = _norm(cfg, params, "final_norm", x)
    if mode == "hidden":
        return x, 0.0
    cache["t"].fill_(s)
    return _logits(x[:, -1], _head(cfg, params)), cache


def _fill_cache(cache, i, j, k, v):
    """Write a layer's fresh keys / values (B, S, KV, DH) at slots [0, S)
    of a full cache and zero the slots after them, in place."""
    s = k.shape[1]
    for name, new in (("k", k), ("v", v)):
        layer = cache[name][i, j]
        if s > layer.shape[1]:
            raise ValueError(f"prompt of {s} tokens does not fit a cache "
                             f"of {layer.shape[1]} positions")
        layer[:, :s].copy_(new)
        layer[:, s:].zero_()


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens,
                opts: RunOptions = RunOptions()):
    """tokens: (B, 1) int.  Returns (logits (B, V) fp32, cache), the cache
    written at slot ``t`` and ``t`` advanced, in place."""
    _check_supported(cfg)
    n_macro, m, _ = macro_shape(cfg)
    t = cache["t"]
    x = params["embed"][tokens[:, :1]].to(opts.act_dtype)
    for i in range(n_macro):
        for j in range(m):
            w = _layer(params, i, j)
            h = _norm(cfg, w, "ln1", x)
            x = x + _attn_decode(cfg, w, h, cache["k"][i, j],
                                 cache["v"][i, j], t, opts)
            x = x + _mlp(cfg, w, _norm(cfg, w, "ln2", x))
    x = _norm(cfg, params, "final_norm", x)
    logits = _logits(x[:, 0], _head(cfg, params))
    t.add_(1)
    return logits, cache
