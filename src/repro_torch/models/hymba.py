"""Hymba [arXiv:2411.13676], the hybrid family: every layer runs a
sliding-window GQA attention branch and a Mamba-style selective-SSM branch
in parallel over the same input and fuses their (per-branch normalised)
outputs.

As in the reference: every layer uses sliding-window attention, and
meta-tokens and the Mamba depthwise conv are omitted.

SSM recurrence (state N per channel, d_inner = d_model):

    h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) outer B_t
    y_t = C_t . h_t + D_skip * x_t

Prefill evaluates it chunk by chunk (chunks of 256, then a remainder
chunk), each chunk by a log2(C)-step doubling scan over its tokens; decode
is :func:`ssm_step`.  Neither branch runs a CUDA kernel, as neither runs a
Pallas kernel in the reference: prefill attention is the plain
``chunked_attention`` with the window mask, decode attention the plain
``decode_ring_attention``.

Sharded steps (``launch/steps.py``) split the layer over the mesh's
'model' axis (:func:`tp_cuts`): the attention branch as the transformer's
(this rank's heads, ``transformer.head_split``; decode gathers the new
token's heads and attends over this rank's slice of the ring,
``transformer._seq_shard_decode``); the SSM on this rank's channels where
the axis divides d_model (``w_in``'s x and z columns, ``w_dt`` on the
gathered x, ``b_dt``, ``a_log``, ``d_skip``, the state), ``w_B`` and
``w_C`` row-parallel (their sums feed every channel), ``w_out``
row-parallel; the SwiGLU FFN column- then row-parallel.

Parameters are a flat ``dict[str, Tensor]`` keyed by the reference's path
names (``layers/wq``, ``embed``, ...), layer weights stacked on a leading
n_layers axis.  The cache holds per layer a ring of keys and values, the
fp32 SSM state, and the position ``t``; prefill and decode write it in
place.  Prefill packs the ring at ``cache_len(cfg, S, "window")`` slots, S
the prompt length, as the reference does: a prompt shorter than the window
gets a ring only S slots wide, so decode evicts positions still inside the
window (ROADMAP §3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.transformer import RunOptions

SSM_CHUNK = 256


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def _layer_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, f, n = cfg.d_model, cfg.d_ff, cfg.ssm_state
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        # attention branch
        "wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
        "wo_attn": (h * dh, d),
        # mamba branch (d_inner = d)
        "w_in": (d, 2 * d),                       # -> (x_m, z)
        "w_dt": (d, d), "b_dt": (d,),
        "w_B": (d, n), "w_C": (d, n),
        "a_log": (d, n), "d_skip": (d,),
        "w_out": (d, d),
        # fusion norms
        "fuse_attn_scale": (d,), "fuse_ssm_scale": (d,),
        # pre-norms + mlp
        "ln1_scale": (d,), "ln2_scale": (d,),
        "w1": (d, f), "w2": (d, f), "w3": (f, d),
    }


def param_specs(cfg: ModelConfig, opts: RunOptions = RunOptions()) -> dict:
    """path name -> (shape, dtype)."""
    pd = opts.param_dtype
    specs = {f"layers/{k}": ((cfg.n_layers,) + s, pd)
             for k, s in _layer_param_shapes(cfg).items()}
    specs["embed"] = ((cfg.vocab, cfg.d_model), pd)
    specs["final_norm_scale"] = ((cfg.d_model,), pd)
    specs["lm_head"] = ((cfg.vocab, cfg.d_model), pd)
    return specs


def init_params(cfg: ModelConfig, generator: torch.Generator,
                opts: RunOptions = RunOptions(), device=None) -> dict:
    """The reference's rules: scales 1, ``b_dt`` and ``d_skip`` 0,
    ``a_log`` = log(1..N) along the state axis, other weights Normal(0,
    1/sqrt(fan_in)) drawn from ``generator`` (which must live on
    ``device``)."""
    out = {}
    for path, (shape, dtype) in param_specs(cfg, opts).items():
        name = path.rsplit("/", 1)[-1]
        if "scale" in name:
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif name in ("b_dt", "d_skip"):
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        elif name == "a_log":
            n = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            out[path] = torch.log(n).expand(shape).to(dtype).contiguous()
        else:
            out[path] = L.dense_init(generator, shape, dtype, device=device)
    return out


# ---------------------------------------------------------------------------
# Selective SSM
# ---------------------------------------------------------------------------
def _doubling_scan(da, dbx):
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2), the operator of the
    reference's ``associative_scan``, in log2(C) doubling steps.  Each
    step's decay stays its own factor, so no running sum of log-decays
    (whose negation overflows fp32) is ever formed."""
    off, c = 1, da.shape[1]
    while off < c:
        b_next = dbx.clone()
        b_next[:, off:].addcmul_(dbx[:, :-off], da[:, off:])
        a_next = da.clone()
        a_next[:, off:].mul_(da[:, :-off])
        da, dbx = a_next, b_next
        off *= 2
    return da, dbx


def ssm_scan(xm, dt, b_in, c_in, a_log, d_skip, h0, chunk: int = SSM_CHUNK):
    """xm/dt: (B, T, D); b_in/c_in: (B, T, N); h0: (B, D, N) fp32.

    Returns (y (B, T, D) in xm's dtype, h_fin (B, D, N) fp32).  Chunks of
    ``chunk`` tokens run in order, a last shorter one as the remainder."""
    t = xm.shape[1]
    a = -torch.exp(L.wide(a_log))                           # (D, N) < 0
    chunk = min(chunk, t)
    dt32 = L.wide(dt)
    da = torch.exp(dt32[..., None] * a)                     # (B, T, D, N)
    dbx = (dt32 * L.wide(xm))[..., None] * L.wide(b_in)[..., None, :]
    c32 = L.wide(c_in)
    h, ys = h0, []
    for t0 in range(0, t, chunk):
        sl = slice(t0, t0 + chunk)
        aa, bb = _doubling_scan(da[:, sl], dbx[:, sl])
        h_all = aa * h[:, None] + bb                        # (B, C, D, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, c32[:, sl]))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1) + L.wide(d_skip) * L.wide(xm)
    return y.to(xm.dtype), h


def ssm_step(xm, dt, b_in, c_in, a_log, d_skip, h):
    """One token.  xm/dt: (B, 1, D); b_in/c_in: (B, 1, N); h: (B, D, N)
    fp32.  Returns (y (B, 1, D) in xm's dtype, h')."""
    a = -torch.exp(L.wide(a_log))
    dt32 = L.wide(dt[:, 0])
    da = torch.exp(dt32[..., None] * a)
    dbx = (dt32 * L.wide(xm[:, 0]))[..., None] * L.wide(b_in[:, 0])[:, None]
    h = da * h + dbx
    y = torch.einsum("bdn,bn->bd", h, L.wide(c_in[:, 0]))
    y = y + L.wide(d_skip) * L.wide(xm[:, 0])
    return y[:, None].to(xm.dtype), h


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------
def _ssm_split(cfg: ModelConfig, opts):
    """The ``dist.Split`` that splits the SSM's channels, where the
    'model' axis divides d_model (as the state's spec does); else None,
    and every rank runs all channels."""
    tp = transformer.tp_split(opts)
    if tp is None or cfg.d_model % tp.size:
        return None
    return tp


def _mamba_branch(w, x, h0, decode: bool, tp=None):
    if tp is None:
        xm, z = (x @ w["w_in"]).chunk(2, dim=-1)
        dt = F.softplus(xm @ w["w_dt"] + w["b_dt"])
        b_in = xm @ w["w_B"]
        c_in = xm @ w["w_C"]
    else:
        # this rank's channels of x_m and z; dt reads every channel of
        # x_m; B and C sum over the channels, and every rank's scan reads
        # them whole
        xm, z = (tp.copy_to(x) @ w["w_in"]).chunk(2, dim=-1)
        dt = F.softplus(tp.gather_read(xm) @ w["w_dt"] + w["b_dt"])
        b_in = tp.copy_to(tp.reduce_from(xm @ w["w_B"]))
        c_in = tp.copy_to(tp.reduce_from(xm @ w["w_C"]))
    step = ssm_step if decode else ssm_scan
    y, h = step(xm, dt, b_in, c_in, w["a_log"], w["d_skip"], h0)
    out = (y * F.silu(z)) @ w["w_out"]
    return (out if tp is None else tp.reduce_from(out)), h


def _attn_branch(cfg, w, x, k_ring, v_ring, t, opts):
    """Full sequence (``t`` None): returns (out, k, v) with the fresh
    keys / values (B, S, KV, DH).  Decode (``t`` the 0-d position on the
    device): writes ring slot t mod W of ``k_ring`` / ``v_ring`` in place
    and returns (out, None, None)."""
    b, s, _ = x.shape
    dh = cfg.d_head
    positions = (torch.arange(s, device=x.device) if t is None
                 else t.reshape(1))
    tp = transformer.tp_split(opts)
    if tp is not None:
        x = tp.copy_to(x)
    q, k, v = (x @ w[n] for n in ("wq", "wk", "wv"))
    q = L.apply_rope(q.reshape(b, s, q.shape[-1] // dh, dh), positions,
                     cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, s, k.shape[-1] // dh, dh), positions,
                     cfg.rope_theta)
    v = v.reshape(b, s, v.shape[-1] // dh, dh)
    if t is None:
        plain = dataclasses.replace(opts, use_kernels=False)
        o = transformer.attend(cfg, q, k, v, plain, tp, window=cfg.window)
    elif tp is not None:
        hs = transformer.head_split(cfg, tp)
        k, v = (transformer.gather_heads(cfg, tp, a) for a in (k, v))
        q = transformer.gather_heads(cfg, tp, q, kv=False)
        o = transformer._seq_shard_decode(cfg, opts, q, k, v, k_ring,
                                          v_ring, t, "window")
        o = o[:, :, hs.q_lo:hs.q_hi]
        k = v = None
    else:
        slot = torch.remainder(positions, k_ring.shape[1]).long()
        k_ring.index_copy_(1, slot, k.to(k_ring.dtype))
        v_ring.index_copy_(1, slot, v.to(v_ring.dtype))
        o = L.decode_ring_attention(q, k_ring, v_ring, t=t,
                                    window=cfg.window)
        k = v = None
    out = o.reshape(b, s, o.shape[2] * dh) @ w["wo_attn"]
    return (out if tp is None else tp.reduce_from(out)), k, v


def layer(cfg, w, x, k_ring, v_ring, ssm, t, opts):
    """One hybrid layer over x (B, S, D).  ``ssm`` (B, D, N) fp32 is the
    SSM state the branch starts from; ``t`` None runs the full sequence,
    else one decode token at position t.  Returns (x, k, v, h_fin), k / v
    the fresh full-sequence keys / values (None in decode)."""
    hpre = L.rms_norm(x, w["ln1_scale"])
    attn_out, k, v = _attn_branch(cfg, w, hpre, k_ring, v_ring, t, opts)
    ssm_out, h_fin = _mamba_branch(w, hpre, ssm, decode=t is not None,
                                   tp=_ssm_split(cfg, opts))
    fused = 0.5 * (L.rms_norm(attn_out, w["fuse_attn_scale"]) +
                   L.rms_norm(ssm_out, w["fuse_ssm_scale"]))
    x = x + fused
    h2 = L.rms_norm(x, w["ln2_scale"])
    tp = transformer.tp_split(opts)
    if tp is None:
        return x + L.swiglu_mlp(h2, w["w1"], w["w2"], w["w3"]), k, v, h_fin
    ffn = L.swiglu_mlp(tp.copy_to(h2), w["w1"], w["w2"], w["w3"])
    return x + tp.reduce_from(ffn), k, v, h_fin


def tp_cuts(cfg: ModelConfig, tp) -> dict:
    """{parameter name: (dim, [(lo, hi), ...])}: what this rank's
    computation reads of each whole parameter (``transformer.tp_cuts``)."""
    dh, hs = cfg.d_head, transformer.head_split(cfg, tp)
    q = [(hs.q_lo * dh, hs.q_hi * dh)]
    kv = [(hs.kv_lo * dh, hs.kv_hi * dh)]
    ff = [tp.part(cfg.d_ff)]
    cuts = {"wq": (-1, q), "wk": (-1, kv), "wv": (-1, kv),
            "wo_attn": (-2, q), "w1": (-1, ff), "w2": (-1, ff),
            "w3": (-2, ff)}
    if cfg.d_model % tp.size == 0:
        d = cfg.d_model
        lo, hi = tp.part(d)
        ch = [(lo, hi)]
        cuts.update({"w_in": (-1, [(lo, hi), (d + lo, d + hi)]),
                     "w_dt": (-1, ch), "b_dt": (-1, ch), "a_log": (-2, ch),
                     "d_skip": (-1, ch), "w_B": (-2, ch), "w_C": (-2, ch),
                     "w_out": (-2, ch)})
    out = {f"layers/{k}": v for k, v in cuts.items()}
    out.update(transformer.vocab_cuts(cfg, tp))
    return out


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                opts: RunOptions = RunOptions(), channels=None) -> dict:
    """name -> (shape, dtype); the ring is ``cache_len(cfg, max_len,
    "window")`` slots wide, the SSM state ``channels`` wide (d_model by
    default)."""
    kv, dh, n = cfg.n_kv_heads, cfg.d_head, cfg.ssm_state
    d = channels or cfg.d_model
    ls = cfg.n_layers
    w = kvcache.cache_len(cfg, max_len, "window")
    return {"t": ((), torch.int32),
            "k": ((ls, batch, w, kv, dh), opts.act_dtype),
            "v": ((ls, batch, w, kv, dh), opts.act_dtype),
            "ssm": ((ls, batch, d, n), torch.float32)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               opts: RunOptions = RunOptions(), device=None,
               channels=None) -> dict:
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in
            cache_specs(cfg, batch, max_len, opts, channels).items()}


def _local_channels(cfg, opts) -> int:
    tp = _ssm_split(cfg, opts)
    return cfg.d_model if tp is None else cfg.d_model // tp.size


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------
def _stack(cfg, params, x, cache, t, opts):
    """Every layer over x, each starting from its SSM state in ``cache``
    and writing the new state and its ring back in place.  With ``cache``
    None (train and hidden modes) every layer starts from a zero state and
    nothing is written, so autograd can run through the stack."""
    if cache is None:
        zero = torch.zeros((x.shape[0], _local_channels(cfg, opts),
                            cfg.ssm_state),
                           dtype=L.wide(x[:0]).dtype, device=x.device)
        for w in transformer.unstack_layers(params):
            x = transformer.remat_layer(layer, opts, cfg, w, x, None, None,
                                        zero, None, opts)[0]
    else:
        tp = transformer.tp_split(opts)
        for i, w in enumerate(transformer.unstack_layers(params)):
            x, k, v, h_fin = layer(cfg, w, x, cache["k"][i], cache["v"][i],
                                   cache["ssm"][i], t, opts)
            if t is None:
                if tp is not None:      # the ring holds every kv head
                    k, v = (transformer.gather_heads(cfg, tp, a)
                            for a in (k, v))
                kvcache.write_prompt(cache["k"][i], k)
                kvcache.write_prompt(cache["v"][i], v)
            cache["ssm"][i].copy_(h_fin)
    return L.rms_norm(x, params["final_norm_scale"])


def forward(cfg: ModelConfig, params: dict, tokens, prefix_embeds=None,
            opts: RunOptions = RunOptions(), mode: str = "prefill",
            cache: Optional[dict] = None, max_len: Optional[int] = None):
    """mode='train': (logits (B, S, V) fp32, 0.0);
    mode='prefill': (last_logits (B, V) fp32, cache);
    mode='hidden': (hidden (B, S, D), 0.0).

    Prefill starts from a zero SSM state, as the reference's does: a
    passed ``cache`` (an executor reuses one per batch bucket) has its
    state zeroed in place first, and its ring must be ``cache_len(cfg, S,
    "window")`` slots wide, the width the reference's prefill packs.
    Train and hidden modes take no cache and write none.
    ``prefix_embeds`` and ``max_len`` are ignored, as in the reference."""
    if mode not in ("train", "prefill", "hidden"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "prefill" and cache is not None:
        raise ValueError(f"{mode} mode writes no cache")
    b, s = tokens.shape
    x = transformer.embed_tokens(cfg, params, tokens, opts)
    if mode != "prefill":
        x = _stack(cfg, params, x, None, None, opts)
        if mode == "hidden":
            return x, 0.0
        return transformer.head_logits(cfg, x, params["lm_head"], opts), 0.0
    if cache is None:
        cache = init_cache(cfg, b, s, opts, device=x.device,
                           channels=_local_channels(cfg, opts))
    else:
        want = kvcache.cache_len(cfg, s, "window")
        if cache["k"].shape[2] != want:
            raise ValueError(f"a prompt of {s} tokens packs a ring of "
                             f"{want} slots; the cache's ring has "
                             f"{cache['k'].shape[2]}")
        cache["ssm"].zero_()
    x = _stack(cfg, params, x, cache, None, opts)
    cache["t"].fill_(s)
    return transformer.head_logits(cfg, x[:, -1], params["lm_head"],
                                   opts), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens,
                opts: RunOptions = RunOptions()):
    """tokens: (B, 1) int.  Returns (logits (B, V) fp32, cache), the ring
    written at slot t mod W, the SSM states updated and ``t`` advanced, in
    place."""
    x = transformer.embed_tokens(cfg, params, tokens[:, :1], opts)
    x = _stack(cfg, params, x, cache, cache["t"], opts)
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
