"""RWKV6 "Finch" [arXiv:2404.05892], attention-free with data-dependent
decay.

Time-mix runs the WKV6 recurrence per head (K = V = d_head):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (decay then write)
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)      (read pre-update + bonus)

with per-channel decay w_t = exp(-exp(w0 + lora_w(x_t))).

Prefill evaluates the recurrence chunk-parallel (32 rows per chunk): on
the CUDA WKV6 kernel with ``use_kernels``, else on :func:`wkv6_chunked`,
the plain version with an explicit (t, s, k) pair tensor so decay
differences stay in log space.  Decode (T = 1) is the plain
:func:`wkv6_step`, as in the reference.

Sharded steps (``launch/steps.py``) split the layer over the mesh's
'model' axis where it divides the head count (:func:`tp_cuts`): r, k, v
and the gate column-parallel over heads, the decay's low-rank output,
``w0``, ``u`` and the group norm taken for this rank's heads, WKV (the
kernel, the chunked plain version or the one-token step) on them, ``wo``
row-parallel and summed over 'model'; the channel mix's ``wck``
column-parallel and ``wcv`` row-parallel, the ``wcr`` gate computed on
this rank's channels and gathered, then applied to the sum, as the
reference's math puts it.  The ddlerp's second low-rank product runs on
this rank's channels and is gathered; its first, and the decay's first,
run whole on every rank.  The state holds this rank's heads.

Parameters are a flat ``dict[str, Tensor]`` keyed by the reference's path
names (``layers/wr``, ``embed``, ...), layer weights stacked on a leading
n_layers axis; the layer loop is a Python loop.  The cache holds the
per-layer states (``wkv`` fp32, the token-shift rows ``tm`` / ``cm``) and
the position ``t``; prefill and decode update it in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.transformer import RunOptions

LORA_MIX = 32       # rank of the ddlerp mix lora
LORA_DECAY = 64     # rank of the decay lora
WKV_CHUNK = 32


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def _layer_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    h, k = cfg.n_heads, cfg.d_head
    return {
        # time-mix
        "mu_x": (d,), "mu_rkvwg": (5, d),
        "wmix_a": (d, 5 * LORA_MIX), "wmix_b": (5, LORA_MIX, d),
        "w0": (d,), "wdec_a": (d, LORA_DECAY), "wdec_b": (LORA_DECAY, d),
        "u": (h, k),
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d),
        "ln1_scale": (d,), "ln1_bias": (d,),
        "gn_scale": (d,), "gn_bias": (d,),
        # channel-mix
        "mu_ck": (d,), "mu_cr": (d,),
        "wck": (d, f), "wcv": (f, d), "wcr": (d, d),
        "ln2_scale": (d,), "ln2_bias": (d,),
    }


def param_specs(cfg: ModelConfig, opts: RunOptions = RunOptions()) -> dict:
    """path name -> (shape, dtype)."""
    pd = opts.param_dtype
    specs = {f"layers/{k}": ((cfg.n_layers,) + s, pd)
             for k, s in _layer_param_shapes(cfg).items()}
    specs["embed"] = ((cfg.vocab, cfg.d_model), pd)
    specs["final_norm_scale"] = ((cfg.d_model,), pd)
    specs["final_norm_bias"] = ((cfg.d_model,), pd)
    specs["lm_head"] = ((cfg.vocab, cfg.d_model), pd)
    return specs


def init_params(cfg: ModelConfig, generator: torch.Generator,
                opts: RunOptions = RunOptions(), device=None) -> dict:
    """The reference's rules: scales 1, biases and mixes 0, ``w0`` -1,
    ``u`` 0, other weights Normal(0, 1/sqrt(fan_in)) drawn from
    ``generator`` (which must live on ``device``)."""
    out = {}
    for path, (shape, dtype) in param_specs(cfg, opts).items():
        name = path.rsplit("/", 1)[-1]
        if "scale" in name:
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif name == "w0":
            out[path] = torch.full(shape, -1.0, dtype=dtype, device=device)
        elif "bias" in name or name.startswith("mu") or name == "u":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[path] = L.dense_init(generator, shape, dtype, device=device)
    return out


# ---------------------------------------------------------------------------
# WKV6 recurrence, plain versions
# ---------------------------------------------------------------------------
def _wkv6_chunk(s, rc, kc, vc, lwc, u):
    """One chunk.  rc/kc/vc: (B, C, H, K); lwc: (B, C, H, K) fp32;
    s: (B, H, K, V) fp32.  Returns (s', y (B, C, H, V) fp32)."""
    rc, kc, vc = L.wide(rc), L.wide(kc), L.wide(vc)
    cum = torch.cumsum(lwc, dim=1)              # inclusive sum of lw
    cum_prev = cum - lwc
    # inter-chunk: y_t += (r_t * exp(cum_prev_t)) @ S
    y = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(cum_prev), s)
    # intra-chunk (t > s): pairwise decay differences in log space
    ddiff = cum_prev[:, :, None] - cum[:, None, :]          # (B, C, C, H, K)
    att = torch.einsum("bthk,bshk,btshk->btsh", rc, kc,
                       torch.exp(torch.clamp(ddiff, -60.0, 0.0)))
    c = rc.shape[1]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=rc.device), diagonal=-1)
    att = torch.where(mask[None, :, :, None], att, torch.zeros_like(att))
    y = y + torch.einsum("btsh,bshv->bthv", att, vc)
    # diagonal bonus: r_t (u * k_t) v_t
    diag = torch.einsum("bthk,hk,bthk->bth", rc, L.wide(u), kc)
    y = y + diag[..., None] * vc
    # state update: S' = diag(exp(cum_C)) S + sum_s exp(cum_C - cum_s) k_s v_s
    k_dec = kc * torch.exp(cum[:, -1:] - cum)
    s = s * torch.exp(cum[:, -1])[..., None] + torch.einsum(
        "bshk,bshv->bhkv", k_dec, vc)
    return s, y


def wkv6_chunked(r, k, v, lw, u, s0, chunk: int = WKV_CHUNK):
    """Chunk-parallel WKV6.  r/k/v/lw: (B, T, H, K), lw the log-decay
    (<= 0); u: (H, K); s0: (B, H, K, V) fp32.  Returns (y (B, T, H, V) in
    r's dtype, s_final fp32); a last chunk shorter than ``chunk`` runs
    as is."""
    t = r.shape[1]
    chunk = min(chunk, t)
    s, ys = L.wide(s0), []
    for t0 in range(0, t, chunk):
        sl = slice(t0, t0 + chunk)
        s, y = _wkv6_chunk(s, r[:, sl], k[:, sl], v[:, sl],
                           L.wide(lw[:, sl]), u)
        ys.append(y)
    return torch.cat(ys, dim=1).to(r.dtype), s


def wkv6_step(r, k, v, lw, u, s):
    """One decode step.  r/k/v/lw: (B, 1, H, K); s: (B, H, K, V) fp32.
    Returns (y (B, 1, H, V) in r's dtype, s')."""
    r1, k1, v1 = L.wide(r[:, 0]), L.wide(k[:, 0]), L.wide(v[:, 0])
    w1 = torch.exp(L.wide(lw[:, 0]))
    kv = k1[..., :, None] * v1[..., None, :]                # (B, H, K, V)
    y = torch.einsum("bhk,bhkv->bhv", r1,
                     s + L.wide(u)[None, :, :, None] * kv)
    s = s * w1[..., None] + kv
    return y[:, None].to(r.dtype), s


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------
def _ddlerp(w, x, x_prev, tp=None):
    """Data-dependent lerp -> [xr, xk, xv, xw, xg].  On a split the mix's
    low-rank output is computed for this rank's channels and gathered."""
    xx = x_prev - x
    base = x + xx * w["mu_x"]
    lora = torch.tanh(base @ w["wmix_a"])
    lora = lora.reshape(*lora.shape[:-1], 5, LORA_MIX)
    if tp is None:
        mix = torch.einsum("btir,ird->btid", lora, w["wmix_b"])
    else:
        mix = tp.gather_from(torch.einsum("btir,ird->btid", tp.copy_to(lora),
                                          w["wmix_b"]))
    mix = w["mu_rkvwg"] + mix
    out = x[..., None, :] + xx[..., None, :] * mix          # (B, T, 5, D)
    return out.unbind(dim=-2)


def _heads_split(cfg: ModelConfig, opts):
    """The ``dist.Split`` that splits the time mix's heads, where the
    'model' axis divides their count (as the state's spec does); else
    None, and every rank runs all heads."""
    tp = transformer.tp_split(opts)
    if tp is None or cfg.n_heads % tp.size:
        return None
    return tp


def time_mix(cfg, w, x, x_prev, s0, opts):
    """x: (B, T, D); x_prev: the same shifted by one token; s0: (B, H, K,
    V) fp32, this rank's heads on a split.  Returns (out, s_fin)."""
    b, t, d = x.shape
    h, kd = w["u"].shape[0], cfg.d_head
    tp = _heads_split(cfg, opts)
    xr, xk, xv, xw, xg = _ddlerp(w, x, x_prev, _channel_split(cfg, opts))
    lora = torch.tanh(xw @ w["wdec_a"])
    if tp is not None:
        xr, xk, xv, xg, lora = (tp.copy_to(a) for a in (xr, xk, xv, xg,
                                                        lora))
    r = (xr @ w["wr"]).reshape(b, t, h, kd)
    k = (xk @ w["wk"]).reshape(b, t, h, kd)
    v = (xv @ w["wv"]).reshape(b, t, h, kd)
    g = F.silu(xg @ w["wg"])
    wlog = w["w0"] + lora @ w["wdec_b"]
    # log decay <= 0
    lw = -torch.exp(torch.clamp(L.wide(wlog), -20.0, 4.0)).reshape(b, t, h,
                                                                   kd)
    if t == 1:
        y, s_fin = wkv6_step(r, k, v, lw, w["u"], s0)
    elif opts.use_kernels:
        from repro_torch.kernels.rwkv6 import ops as rwkv_ops
        y, s_fin = rwkv_ops.wkv6(r, k, v, lw, w["u"], s0)
    else:
        y, s_fin = wkv6_chunked(r, k, v, lw, w["u"], s0)
    # per-head group norm (population variance)
    y = y.reshape(b, t, h, kd)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = y.reshape(b, t, h * kd) * w["gn_scale"] + w["gn_bias"]
    out = (y * g).to(x.dtype) @ w["wo"]
    return (out if tp is None else tp.reduce_from(out)), s_fin


def channel_mix(cfg, w, x, x_prev, opts=None):
    xx = x_prev - x
    xk = x + xx * w["mu_ck"]
    xr = x + xx * w["mu_cr"]
    tp = transformer.tp_split(opts)
    if tp is None:
        kk = torch.square(torch.relu(xk @ w["wck"]))
        return torch.sigmoid(xr @ w["wcr"]) * (kk @ w["wcv"])
    kk = torch.square(torch.relu(tp.copy_to(xk) @ w["wck"]))
    if _channel_split(cfg, opts) is None:
        gate = torch.sigmoid(xr @ w["wcr"])
    else:
        gate = tp.gather_from(torch.sigmoid(tp.copy_to(xr) @ w["wcr"]))
    return gate * tp.reduce_from(kk @ w["wcv"])


def _channel_split(cfg, opts):
    """The split of d_model's channels (the ddlerp mix's and the ``wcr``
    gate's outputs, gathered after), where the 'model' axis divides it."""
    tp = transformer.tp_split(opts)
    return None if tp is None or cfg.d_model % tp.size else tp


def tp_cuts(cfg: ModelConfig, tp) -> dict:
    """{parameter name: (dim, [(lo, hi)])}: what this rank's computation
    reads of each whole parameter (``transformer.tp_cuts``)."""
    ff = [tp.part(cfg.d_ff)]
    cuts = {"wck": (-1, ff), "wcv": (-2, ff)}
    if cfg.d_model % tp.size == 0:
        ch = [tp.part(cfg.d_model)]
        cuts.update({"wcr": (-1, ch), "wmix_b": (-1, ch)})
    if cfg.n_heads % tp.size == 0:
        lo, hi = tp.part(cfg.n_heads)
        ch = (-1, [(lo * cfg.d_head, hi * cfg.d_head)])
        cuts.update({n: ch for n in ("wr", "wk", "wv", "wg", "w0",
                                     "wdec_b", "gn_scale", "gn_bias")})
        cuts.update({"wo": (-2, ch[1]), "u": (-2, [(lo, hi)])})
    out = {f"layers/{k}": v for k, v in cuts.items()}
    out.update(transformer.vocab_cuts(cfg, tp))
    return out


def _shift(x, prev_last):
    """x: (B, T, D); prev_last: (B, D), the token before position 0."""
    return torch.cat([prev_last[:, None, :], x[:, :-1]], dim=1)


def layer_full(cfg, w, x, state, opts):
    """state: {"wkv": (B, H, K, V), "tm": (B, D), "cm": (B, D)}.
    Returns (x, new state)."""
    h1 = L.layer_norm(x, w["ln1_scale"], w["ln1_bias"])
    tm_out, s_fin = time_mix(cfg, w, h1, _shift(h1, state["tm"]),
                             state["wkv"], opts)
    x = x + tm_out
    h2 = L.layer_norm(x, w["ln2_scale"], w["ln2_bias"])
    x = x + channel_mix(cfg, w, h2, _shift(h2, state["cm"]), opts)
    return x, {"wkv": s_fin, "tm": h1[:, -1], "cm": h2[:, -1]}


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                opts: RunOptions = RunOptions(), heads=None) -> dict:
    """name -> (shape, dtype); the state of ``heads`` heads (all by
    default).  The state does not grow with the sequence, so ``max_len``
    is accepted and ignored."""
    h, kd, d, ls = heads or cfg.n_heads, cfg.d_head, cfg.d_model, \
        cfg.n_layers
    return {"t": ((), torch.int32),
            "wkv": ((ls, batch, h, kd, kd), torch.float32),
            "tm": ((ls, batch, d), opts.act_dtype),
            "cm": ((ls, batch, d), opts.act_dtype)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               opts: RunOptions = RunOptions(), device=None,
               heads=None) -> dict:
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in
            cache_specs(cfg, batch, max_len, opts, heads).items()}


def _local_heads(cfg, opts) -> int:
    tp = _heads_split(cfg, opts)
    return cfg.n_heads if tp is None else cfg.n_heads // tp.size


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------
def _stack(cfg, params, x, cache, opts):
    """Every layer over x, reading each layer's state from ``cache`` and
    writing the new one back in place.  With ``cache`` None (train and
    hidden modes) every layer starts from a zero state and nothing is
    written, so autograd can run through the stack."""
    if cache is None:
        b = x.shape[0]
        zero = {"wkv": torch.zeros((b, _local_heads(cfg, opts), cfg.d_head,
                                    cfg.d_head),
                                   dtype=L.wide(x[:0]).dtype,
                                   device=x.device),
                "tm": torch.zeros((b, cfg.d_model), dtype=x.dtype,
                                  device=x.device)}
        zero["cm"] = zero["tm"]
        for w in transformer.unstack_layers(params):
            x = transformer.remat_layer(layer_full, opts, cfg, w, x, zero,
                                        opts)[0]
    else:
        for i, w in enumerate(transformer.unstack_layers(params)):
            state = {name: cache[name][i] for name in ("wkv", "tm", "cm")}
            x, new = layer_full(cfg, w, x, state, opts)
            for name, val in new.items():
                cache[name][i].copy_(val)
    x = L.layer_norm(x, params["final_norm_scale"],
                     params["final_norm_bias"])
    return x


def forward(cfg: ModelConfig, params: dict, tokens, prefix_embeds=None,
            opts: RunOptions = RunOptions(), mode: str = "prefill",
            cache: Optional[dict] = None, max_len: Optional[int] = None):
    """mode='train': (logits (B, S, V) fp32, 0.0);
    mode='prefill': (last_logits (B, V) fp32, cache);
    mode='hidden': (hidden (B, S, D), 0.0).

    Prefill starts from a zero state, as the reference's does: a passed
    ``cache`` is zeroed in place first (an executor reuses one cache per
    batch bucket), then holds the final states, with ``t`` set to S.
    Train and hidden modes take no cache and write none.
    ``prefix_embeds`` and ``max_len`` are ignored, as in the reference."""
    if mode not in ("train", "prefill", "hidden"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "prefill" and cache is not None:
        raise ValueError(f"{mode} mode writes no cache")
    b, s = tokens.shape
    x = transformer.embed_tokens(cfg, params, tokens, opts)
    if mode != "prefill":
        transformer.check_differentiable(params, opts)
        x = _stack(cfg, params, x, None, opts)
        if mode == "hidden":
            return x, 0.0
        return transformer.head_logits(cfg, x, params["lm_head"], opts), 0.0
    if cache is None:
        cache = init_cache(cfg, b, s, opts, device=x.device,
                           heads=_local_heads(cfg, opts))
    else:
        for name in ("wkv", "tm", "cm"):
            cache[name].zero_()
    x = _stack(cfg, params, x, cache, opts)
    cache["t"].fill_(s)
    return transformer.head_logits(cfg, x[:, -1], params["lm_head"],
                                   opts), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens,
                opts: RunOptions = RunOptions()):
    """tokens: (B, 1) int.  Returns (logits (B, V) fp32, cache), the states
    updated and ``t`` advanced in place."""
    x = transformer.embed_tokens(cfg, params, tokens[:, :1], opts)
    x = _stack(cfg, params, x, cache, opts)
    logits = transformer.head_logits(cfg, x[:, 0], params["lm_head"], opts)
    cache["t"].add_(1)
    return logits, cache


def lm_loss(cfg: ModelConfig, params: dict, tokens, labels,
            prefix_embeds=None, opts: RunOptions = RunOptions()):
    """Chunked cross-entropy over the hidden states (as the reference,
    ``prefix_embeds`` is ignored)."""
    x, _ = forward(cfg, params, tokens, None, opts, "hidden")
    return transformer.chunked_lm_loss(x, params["lm_head"], labels, opts,
                                       transformer.vocab_part(cfg, opts))
