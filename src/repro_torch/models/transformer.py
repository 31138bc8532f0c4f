"""Decoder-only transformer covering the dense / moe / vlm / audio families.

Parameters are a flat ``dict[str, Tensor]`` keyed by the reference's
checkpoint path names (``layers/wq``, ``embed``, ...); layer weights are
stacked as (n_macro, m, ...) and the layer loop is a Python loop over
them (PyTorch runs eagerly, so the reference's ``lax.scan`` has no
counterpart to preserve).  An arch with ``global_every = N`` (Llama-4:
N - 1 chunked-local layers, then one global layer) stacks L/N macro
blocks of N sub-layers, each with its own attention kind and cache.

Caches: a full-attention layer keeps (B, max_len, KV, DH); a
sliding-window or chunked-local layer keeps a ring of
``kvcache.cache_len`` slots, position p at slot p mod W.  Prefill packs a
prompt's last W positions into the ring (a prompt shorter than the ring
fills its first slots and zeroes the rest); decode writes slot t mod W and
attends through the plain ``decode_ring_attention``, as the reference
does.  With ``global_every`` the cache holds ``k_local`` / ``v_local``
rings and ``k_global`` / ``v_global`` full caches.

Modes:
  * train   — full-sequence fp32 logits, no cache (:func:`lm_loss` takes
    the hidden states instead and runs :func:`chunked_lm_loss`).
  * prefill — forward over the prompt, KV cache written, last-token logits.
  * hidden  — final-norm hidden states of the whole sequence.
  * decode  — one token against the cache (:func:`decode_step`), which
    writes the cache and advances its position ``t`` in place, with ``t``
    kept on the device so a decode loop never syncs with the host.

Sharded paths (``launch/steps.py`` sets ``RunOptions.mesh``): each rank
runs its batch block, and splits every product over the mesh's 'model'
axis as the reference's sharding rules and GSPMD do (:func:`tp_split`,
``models/dist.py``'s conjugate collectives): q / k / v column-parallel
on this rank's heads, attention on them, ``wo`` row-parallel and summed
over 'model'; the FFN column- then row-parallel (``b3`` added once after
the sum); MoE expert-parallel where the rules give it
(``n_experts % 16 == 0``), else each expert's hidden dim split
(``models/moe.py``); the vocabulary split for the embedding (a lookup
of this rank's rows, summed), the logits and the cross-entropy (a max
and sums over 'model').  Heads: rank r of ``tp`` ranks takes q heads
floor(r H / tp) ... floor((r + 1) H / tp) - 1 (the even block when tp
divides H; Hymba-1.5B's 25 heads over 16 give ranks one or two whole
heads, and a reduced model's 4 heads over 16 leave some ranks none), and
computes the kv heads those read: its kv block when tp divides
``n_kv_heads``, else each kv head on every rank that reads it.  The
weights arrive as this rank's blocks in that layout (:func:`tp_cuts`).
With ``explicit_tp_ffn`` the q/k/v and output projections (train and
prefill) and the SwiGLU FFN take this rank's weight blocks in the
reference's shard_map layout and gather them over 'data' themselves
(``layers.explicit_tp_*``), on the same heads.  Decode with
``seq_shard_decode`` gathers the new token's q, k and v over 'model'
and attends over this rank's slice of the cache's sequence
(:func:`_seq_shard_decode`); MoE decode routes the whole batch as one
row, as the reference's global view does, gathering it over the batch
axes.

Train and hidden modes allocate and write no cache, so autograd runs
through them; with ``RunOptions.remat == "full"`` each layer is
recomputed in backward (``torch.utils.checkpoint``) when gradients are
being recorded.  MoE layers (``models/moe.py``) add their
load-balancing loss to the aux output, and ``lm_loss`` adds 0.01 of it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import kvcache, moe
from repro_torch.models import layers as L
from repro_torch.obs import tracer as obs_tracer


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """Runtime (not architecture) options."""
    attn_chunk: int = 1024
    remat: str = "full"            # full | none (per-layer recompute)
    param_dtype: Any = torch.bfloat16
    act_dtype: Any = torch.bfloat16
    use_kernels: bool = False      # CUDA kernels vs the plain attention
    logit_chunk: int = 512         # CE loss seq-chunking (memory control)
    explicit_tp_ffn: bool = False  # explicit-collective TP projections/FFN
    shard_constraints: bool = False  # set by the step builders (no-op here)
    dp_spec: Any = ("data",)       # mesh axes carrying the batch
    tp_name: str = "model"
    sharding_mode: str = "auto"    # auto | 2d | dp_only (launch/shardings)
    seq_shard_decode: bool = True  # sequence-sharded decode over 'model'
    mesh: Any = None               # DeviceMesh of the sharded paths


def chunked_lm_loss(x, head, labels, opts: RunOptions, part=None):
    """Cross-entropy without materialising full-sequence logits.

    x: (B, S, D); head: (V, D); labels: (B, S) int.  Chunks of
    ``opts.logit_chunk`` positions (a shorter tail chunk when S is not a
    multiple): per chunk the (B, C, V) fp32 logits are built and reduced
    to sum(logsumexp - label logit); the total is divided by B * S.

    ``part`` (:func:`vocab_part`): head holds rows lo ... of a vocabulary
    split over 'model'; the logsumexp takes its max and its sum over the
    ranks, and the label logit is summed over them."""
    b, s, _ = x.shape
    c = min(opts.logit_chunk, s)
    total = torch.zeros((), dtype=L.wide(x[:0]).dtype, device=x.device)
    if part is not None:
        tp, lo, _ = part
        x = tp.copy_to(x)
    for start in range(0, s, c):
        logits = _logits(x[:, start:start + c], head)       # (B, C, V)
        # the label's logit by mask and sum, as the reference takes it:
        # its backward is elementwise, with no scatter of atomics
        iota = torch.arange(logits.shape[-1], device=x.device)
        if part is None:
            logz = torch.logsumexp(logits, dim=-1)
            hit = iota == labels[:, start:start + c, None]
        else:
            from repro_torch.models import dist
            m = dist.max_from(logits.amax(-1), tp.mesh, tp.axis)
            z = tp.reduce_from(torch.exp(logits - m[..., None]).sum(-1))
            logz = m + torch.log(z)
            hit = iota + lo == labels[:, start:start + c, None]
        ll = torch.where(hit, logits, torch.zeros_like(logits)).sum(-1)
        if part is not None:
            ll = tp.reduce_from(ll)
        total = total + (logz - ll).sum()
    return total / (b * s)


def tp_split(opts):
    """This rank's :class:`dist.Split` of the 'model' axis when a sharded
    step splits the compute over it; None off a mesh, and where 'model'
    carries the batch (pure DP)."""
    if opts is None or opts.mesh is None \
            or opts.tp_name in tuple(opts.dp_spec or ()):
        return None
    from repro_torch.models import dist
    return dist.Split(opts.mesh, opts.tp_name)


def vocab_part(cfg: ModelConfig, opts):
    """(split, lo, hi): this rank's rows of the embedding and the head
    when the vocabulary is split over 'model', which the rules do where
    the axis divides it; None otherwise (Hymba's 32001 over 16 stays
    whole, computed on every rank)."""
    tp = tp_split(opts)
    if tp is None or cfg.vocab % tp.size:
        return None
    return (tp, *tp.part(cfg.vocab))


def embed_tokens(cfg: ModelConfig, params: dict, tokens, opts):
    """``params["embed"][tokens]`` in the activation dtype; on a split
    vocabulary each rank looks up the tokens among its rows (zeros
    elsewhere) and the rows are summed over 'model', which is exact."""
    emb, part = params["embed"], vocab_part(cfg, opts)
    if part is None:
        return emb[tokens].to(opts.act_dtype)
    tp, lo, hi = part
    t = tokens.long() - lo
    inside = (t >= 0) & (t < hi - lo)
    rows = emb[torch.where(inside, t, torch.zeros_like(t))]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return tp.reduce_from(rows).to(opts.act_dtype)


def head_logits(cfg: ModelConfig, x, head, opts):
    """fp32 logits of ``x`` against ``head``: this rank's block of the
    vocabulary where it is split over 'model'."""
    part = vocab_part(cfg, opts)
    if part is not None:
        x = part[0].copy_to(x)
    return _logits(x, head)


class Heads(NamedTuple):
    """A rank's attention heads: q heads [q_lo, q_hi), the kv heads
    [kv_lo, kv_hi) they read, and each local q head's kv head as an
    index into the local ones."""
    q_lo: int
    q_hi: int
    kv_lo: int
    kv_hi: int
    kv_of: tuple


def head_split(cfg: ModelConfig, tp, rank=None) -> Heads:
    """The heads of rank ``rank`` (this rank by default) of ``tp``: q
    heads by :meth:`dist.Split.part`, and the kv heads those read (none
    on a rank with no q head)."""
    q_lo, q_hi = tp.part(cfg.n_heads, rank)
    if q_hi == q_lo:
        return Heads(q_lo, q_hi, 0, 0, ())
    rep = cfg.n_heads // cfg.n_kv_heads
    kv_lo, kv_hi = q_lo // rep, (q_hi - 1) // rep + 1
    return Heads(q_lo, q_hi, kv_lo, kv_hi,
                 tuple(h // rep - kv_lo for h in range(q_lo, q_hi)))


def _local_kv(k, heads: Heads):
    """k (B, S, KV_loc, D) as the local q heads read it: as it is where
    they group evenly over it (GQA), else one kv head per q head."""
    n_q, n_kv = len(heads.kv_of), k.shape[2]
    if n_q % n_kv == 0 and heads.kv_of == tuple(
            a // (n_q // n_kv) for a in range(n_q)):
        return k
    return k.index_select(2, torch.tensor(heads.kv_of, device=k.device))


def tp_cuts(cfg: ModelConfig, tp) -> dict:
    """{parameter name: (dim, [(lo, hi), ...])}: the part of each whole
    parameter that this rank's computation reads (the ranges along
    ``dim``, concatenated); a parameter without an entry is read whole."""
    from repro_torch.launch.shardings import expert_parallel
    dh, hs = cfg.d_head, head_split(cfg, tp)
    q = [(hs.q_lo * dh, hs.q_hi * dh)]
    kv = [(hs.kv_lo * dh, hs.kv_hi * dh)]
    ff = [tp.part(cfg.d_ff)]
    cuts = {"wq": (-1, q), "bq": (-1, q), "wk": (-1, kv), "bk": (-1, kv),
            "wv": (-1, kv), "bv": (-1, kv), "wo": (-2, q),
            "w1": (-1, ff), "w2": (-1, ff), "b1": (-1, ff), "w3": (-2, ff)}
    if cfg.n_experts and expert_parallel(cfg):
        ex = [tp.part(cfg.n_experts)]
        cuts.update({"moe_w1": (-3, ex), "moe_w2": (-3, ex),
                     "moe_w3": (-3, ex)})
    else:
        cuts.update({"moe_w1": (-1, ff), "moe_w2": (-1, ff),
                     "moe_w3": (-2, ff)})
    out = {f"layers/{k}": v for k, v in cuts.items()}
    out.update(vocab_cuts(cfg, tp))
    return out


def vocab_cuts(cfg: ModelConfig, tp) -> dict:
    """The embedding's and the head's cuts (:func:`tp_cuts`): this
    rank's rows where the vocabulary splits over 'model'."""
    if cfg.vocab % tp.size:
        return {}
    rows = (0, [tp.part(cfg.vocab)])
    return {"embed": rows, "lm_head": rows}


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
    if cfg.n_experts:
        e = cfg.n_experts
        shapes.update({
            "router": (d, e),
            "moe_w1": (e, d, f), "moe_w2": (e, d, f), "moe_w3": (e, f, d),
        })
    elif cfg.mlp == "swiglu":
        shapes.update({"w1": (d, f), "w2": (d, f), "w3": (f, d)})
    else:
        shapes.update({"w1": (d, f), "b1": (f,), "w3": (f, d), "b3": (d,)})
    return shapes


def param_specs(cfg: ModelConfig, opts: RunOptions = RunOptions()) -> dict:
    """path name -> (shape, dtype)."""
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
    n_macro, m, kinds = macro_shape(cfg)
    kvh, dh, ad = cfg.n_kv_heads, cfg.d_head, opts.act_dtype
    specs = {"t": ((), torch.int32)}
    if cfg.global_every:
        wl = kvcache.cache_len(cfg, max_len, "local")
        for name in ("k", "v"):
            specs[f"{name}_local"] = ((n_macro, m - 1, batch, wl, kvh, dh),
                                      ad)
            specs[f"{name}_global"] = ((n_macro, 1, batch, max_len, kvh, dh),
                                       ad)
    else:
        w = kvcache.cache_len(cfg, max_len, kinds[0])
        for name in ("k", "v"):
            specs[name] = ((n_macro, m, batch, w, kvh, dh), ad)
    return specs


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


def _use_explicit_tp(opts, mode="full_seq"):
    return (opts is not None and opts.explicit_tp_ffn and mode != "decode"
            and tp_split(opts) is not None)


def explicit_tp_params(cfg: ModelConfig, opts: RunOptions,
                       mode: str = "full_seq") -> set[str]:
    """Layer weights (names without ``layers/``) that the layers take as
    this rank's blocks in ``mode`` ("full_seq" or "decode"): the q/k/v
    and output projections outside decode, and the dense SwiGLU FFN."""
    names = set()
    if _use_explicit_tp(opts, mode):
        names |= {"wq", "wk", "wv", "wo"}
    if _use_explicit_tp(opts) and not cfg.n_experts and cfg.mlp == "swiglu":
        names |= {"w1", "w2", "w3"}
    return names


def _explicit_qkv(cfg, w, x, opts, tp):
    """Column-parallel q / k / v from the shard_map layout's blocks (the
    flattened head dims split evenly), cut to this rank's heads: a block
    is those heads where the axis divides the head count, else the whole
    is gathered over 'model' and the heads taken from it."""
    hs, dh = head_split(cfg, tp), cfg.d_head
    out = []
    for name, n, lo, hi in (("wq", cfg.n_heads, hs.q_lo, hs.q_hi),
                            ("wk", cfg.n_kv_heads, hs.kv_lo, hs.kv_hi),
                            ("wv", cfg.n_kv_heads, hs.kv_lo, hs.kv_hi)):
        y = L.explicit_tp_matmul(x, w[name], opts, row=False)
        if n % tp.size:
            y = tp.gather_read(y).narrow(-1, lo * dh, (hi - lo) * dh)
        out.append(y)
    return out


def _explicit_wo(cfg, w, o, opts, tp):
    """Row-parallel ``wo`` on this rank's heads from the shard_map
    layout's block (rows of the flattened heads split evenly); where the
    axis does not divide the head count the whole is gathered and this
    rank's rows taken."""
    if cfg.n_heads % tp.size == 0:
        return L.explicit_tp_matmul(o, w["wo"], opts, row=True)
    from repro_torch.models import dist
    hs = head_split(cfg, tp)
    wo = dist.unshard(w["wo"].to(o.dtype), (tp.axis, "data"), tp.mesh,
                      tuple(opts.dp_spec or ()) + (tp.axis,))
    rows = wo.narrow(0, hs.q_lo * cfg.d_head,
                     (hs.q_hi - hs.q_lo) * cfg.d_head)
    return tp.reduce_from(o @ rows)


def _qkv(cfg, w, x, positions, opts=None, mode="full_seq"):
    """q (B, S, H, D), k and v (B, S, KV, D), roped: of this rank's heads
    (:func:`head_split`) on a split."""
    b, s, _ = x.shape
    dh = cfg.d_head
    tp = tp_split(opts)
    if _use_explicit_tp(opts, mode):
        q, k, v = _explicit_qkv(cfg, w, x, opts, tp)
    else:
        if tp is not None:
            x = tp.copy_to(x)
        q = x @ w["wq"]
        k = x @ w["wk"]
        v = x @ w["wv"]
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = L.apply_rope(q.reshape(b, s, q.shape[-1] // dh, dh), positions,
                     cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, s, k.shape[-1] // dh, dh), positions,
                     cfg.rope_theta)
    return q, k, v.reshape(b, s, v.shape[-1] // dh, dh)


def _mlp(cfg, w, x, opts=None):
    """Returns (out, aux_loss)."""
    tp = tp_split(opts)
    if cfg.n_experts:
        from repro_torch.launch.shardings import expert_parallel
        b, s, d = x.shape
        # decode (S == 1): the flattened batch is one routing row, so the
        # capacity tracks the true token count; on a mesh the row is the
        # whole batch, gathered over the batch axes
        whole = s == 1 and opts is not None and opts.mesh is not None \
            and opts.dp_spec
        if whole:
            from repro_torch.models import dist
            x = dist.gather(x, (tuple(opts.dp_spec),), opts.mesh)
        xr = x.reshape(1, -1, d) if s == 1 else x
        out, aux = moe.moe_ffn(
            xr, w["router"], w["moe_w1"], w["moe_w2"], w["moe_w3"],
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, split=tp,
            expert_parallel=tp is not None and expert_parallel(cfg))
        out = out.reshape(x.shape)
        if whole:
            out = dist.local_block(out, (tuple(opts.dp_spec),), opts.mesh)
        return out, aux
    if cfg.mlp == "swiglu":
        if _use_explicit_tp(opts):
            return L.explicit_tp_swiglu(x, w["w1"], w["w2"], w["w3"],
                                        opts), 0.0
        if tp is not None:
            return tp.reduce_from(L.swiglu_mlp(tp.copy_to(x), w["w1"],
                                               w["w2"], w["w3"])), 0.0
        return L.swiglu_mlp(x, w["w1"], w["w2"], w["w3"]), 0.0
    if tp is not None:
        return tp.reduce_from(L.gelu_mlp(tp.copy_to(x), w["w1"], w["b1"],
                                         w["w3"])) + w["b3"], 0.0
    return L.gelu_mlp(x, w["w1"], w["b1"], w["w3"], w["b3"]), 0.0


def _masks(cfg, kind):
    """(window, local_block) of a layer kind."""
    return (cfg.window if kind == "window" else None,
            cfg.chunk_attn if kind == "local" else None)


def attend(cfg, q, k, v, opts, tp, window=None, local=None, q_offset=0):
    """Causal attention of q (B, S, H_loc, D) over k / v: the
    flash-attention kernel with ``use_kernels``, else the plain chunked
    one; on a split, this rank's heads (none on a rank without one)."""
    if tp is not None:
        if q.shape[2] == 0:
            # no head here: k and v stay in the graph (empty gradients),
            # so this rank's backward runs the collectives every rank runs
            return q + 0 * (k.sum() + v.sum())
        hs = head_split(cfg, tp)
        k, v = _local_kv(k, hs), _local_kv(v, hs)
    if opts.use_kernels:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                      local_block=local, q_offset=q_offset)
    return L.chunked_attention(q, k, v, causal=True, window=window,
                               local_block=local, chunk=opts.attn_chunk,
                               q_offset=q_offset)


def _attn_full_seq(cfg, w, x, kind, opts, q_offset=0):
    """Causal attention over a full sequence.  Returns (out, k, v), k and
    v of this rank's kv heads on a split."""
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)
    q, k, v = _qkv(cfg, w, x, positions, opts)
    window, local = _masks(cfg, kind)
    tp = tp_split(opts)
    o = attend(cfg, q, k, v, opts, tp, window, local, q_offset)
    o = o.reshape(b, s, q.shape[2] * cfg.d_head)
    if _use_explicit_tp(opts):
        return _explicit_wo(cfg, w, o, opts, tp), k, v
    if tp is not None:
        return tp.reduce_from(o @ w["wo"]), k, v
    return o @ w["wo"], k, v


def gather_heads(cfg, tp, x, kv: bool = True):
    """All heads (dim 2) of a tensor of which each rank holds its own
    (kv heads with ``kv``, else q heads), gathered over 'model'."""
    from repro_torch.models import dist
    parts = []
    for r in range(tp.size):
        hs = head_split(cfg, tp, r)
        parts.append((hs.kv_lo, hs.kv_hi) if kv else (hs.q_lo, hs.q_hi))
    return dist.gather_parts(x, tp.mesh, tp.axis, 2, parts)


def _seq_shard_decode(cfg, opts, q, k_new, v_new, k_cache, v_cache, t, kind):
    """Flash-decoding over this rank's slice of the sequence-sharded cache.

    q: (B, 1, H, D) and k_new / v_new: (B, 1, KV, D) of this rank's batch
    block; k_cache / v_cache: its (B, S_loc, KV, D) slice, number
    ``index('model')`` of the cache's S_loc * |model| slots, written in
    place.  Each rank
      * writes the new token only if it owns slot t (t mod the whole ring
        for a window / local layer),
      * computes partial attention over its slice, validity from the
        *global* slot index,
      * combines the partials: an all-reduce MAX of the row maxima, then
        all-reduce SUMs of the corrected l and acc over 'model'.
    Returns (B, 1, H, D)."""
    from repro_torch.models import dist
    mesh, axis = opts.mesh, opts.tp_name
    n_shards = dist.axis_size(mesh, axis)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    window, local_block = _masks(cfg, kind)
    s_loc = k_cache.shape[1]
    w_total = s_loc * n_shards
    pos = t.reshape(1).long()
    slot = pos if kind in ("full", "global") else torch.remainder(pos,
                                                                  w_total)
    lo = dist.axis_index(mesh, axis) * s_loc
    in_range = (slot >= lo) & (slot < lo + s_loc)
    loc = torch.clamp(slot - lo, 0, s_loc - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cur = cache.index_select(1, loc)
        cache.index_copy_(1, loc, torch.where(in_range, new.to(cache.dtype),
                                              cur))

    slots = lo + torch.arange(s_loc, device=q.device)
    if kind in ("full", "global"):
        kv_pos = slots
        valid = kv_pos <= t
    else:
        kv_pos = t - torch.remainder(t - slots, w_total)
        valid = kv_pos >= 0
        if window is not None:
            valid &= (t - kv_pos) < window
        if local_block is not None:
            valid &= kv_pos >= torch.div(t, local_block,
                                         rounding_mode="floor") * local_block

    k = L._expand_kv(k_cache, n_rep)
    v = L._expand_kv(v_cache, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", L.wide(q), L.wide(k))
    s = s * (1.0 / math.sqrt(cfg.d_head))
    s = torch.where(valid[None, None, None, :], s,
                    torch.full_like(s, L.NEG_INF))
    m_loc = s.amax(dim=-1)                                # (B, H, 1)
    p = torch.exp(s - m_loc[..., None])
    l_loc = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", L.wide(p.to(v.dtype)), L.wide(v))
    m_g = dist.all_reduce(m_loc.clone(), mesh, (axis,), dist.MAX)
    corr = torch.exp(m_loc - m_g)
    l_g = dist.all_reduce(l_loc * corr, mesh, (axis,))
    acc_g = dist.all_reduce(acc * corr[..., None], mesh, (axis,))
    out = acc_g / torch.clamp(l_g[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)               # (B, 1, H, D)


def _attn_decode(cfg, w, x, k_cache, v_cache, t, kind, opts):
    """One-token attention.  x: (B, 1, D); k_cache/v_cache: (B, W, KV, D)
    views into the stacked cache, written in place: at slot ``t`` of a
    full cache, or slot ``t mod W`` of a ring.  On a split the new
    token's q, k and v (this rank's heads) are gathered over 'model'
    first, and ``wo`` runs on this rank's heads."""
    b = x.shape[0]
    pos = t.reshape(1)
    q, k_new, v_new = _qkv(cfg, w, x, pos, opts, mode="decode")
    tp = tp_split(opts)
    if tp is not None:
        hs = head_split(cfg, tp)
        k_new, v_new = (gather_heads(cfg, tp, a) for a in (k_new, v_new))
    if opts.seq_shard_decode and opts.mesh is not None:
        if tp is not None:
            q = gather_heads(cfg, tp, q, kv=False)
        o = _seq_shard_decode(cfg, opts, q, k_new, v_new, k_cache, v_cache,
                              t, kind)
        if tp is not None:
            o = o[:, :, hs.q_lo:hs.q_hi]
    else:
        if kind in ("full", "global"):
            slot = pos.long()
        else:
            slot = torch.remainder(pos, k_cache.shape[1]).long()
        k_cache.index_copy_(1, slot, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, slot, v_new.to(v_cache.dtype))
        if tp is not None:
            k_cache = _local_kv(k_cache[:, :, hs.kv_lo:hs.kv_hi], hs)
            v_cache = _local_kv(v_cache[:, :, hs.kv_lo:hs.kv_hi], hs)
        o = _decode_attention(cfg, q, k_cache, v_cache, t, pos, kind, opts)
    o = o.reshape(b, 1, o.shape[2] * cfg.d_head) @ w["wo"]
    return o if tp is None else tp.reduce_from(o)


def _decode_attention(cfg, q, k_cache, v_cache, t, pos, kind, opts):
    if q.shape[2] == 0:
        return q
    if kind not in ("full", "global"):
        window, local = _masks(cfg, kind)
        return L.decode_ring_attention(q, k_cache, v_cache, t=t,
                                       window=window, local_block=local)
    if opts.use_kernels:
        from repro_torch.kernels.flash_decode import ops as fd_ops
        return fd_ops.flash_decode_at(q[:, 0], k_cache, v_cache,
                                      pos)[:, None]
    return L.decode_attention(q, k_cache, v_cache, length=t + 1)


def unstack_layers(params: dict, n_lead: int = 1) -> list[dict]:
    """Every layer's weights, one dict a layer (views), by ``unbind`` over
    the ``n_lead`` stacking dims.  Its backward stacks the per-layer
    gradients once, where selecting layer by layer would add a zero-filled
    gradient of the whole stack for every layer."""
    names = [k for k in params if k.startswith("layers/")]
    cols = [params[k].flatten(0, n_lead - 1).unbind(0) for k in names]
    return [{k[len("layers/"):]: c[i] for k, c in zip(names, cols)}
            for i in range(len(cols[0]))]


def _head(cfg, params):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _logits(x, head):
    # bf16 operands give a bf16 product, widened afterwards; the
    # reference asks XLA for an fp32 result from the same operands
    return L.wide(x @ head.T)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill / hidden)
# ---------------------------------------------------------------------------
def _embed(cfg, params, tokens, prefix_embeds, opts):
    x = embed_tokens(cfg, params, tokens, opts)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(opts.act_dtype), x], dim=1)
    return x


def _sublayer(cfg, w, x, kind, opts):
    """One layer over the full sequence.  Returns (x, aux, k, v)."""
    a, k, v = _attn_full_seq(cfg, w, _norm(cfg, w, "ln1", x), kind, opts)
    x = x + a
    out, aux = _mlp(cfg, w, _norm(cfg, w, "ln2", x), opts)
    return x + out, aux, k, v


def check_differentiable(params: dict, opts: RunOptions) -> None:
    """The CUDA kernels have no backward: refuse them under autograd."""
    if opts.use_kernels and torch.is_grad_enabled() and any(
            p.requires_grad for p in params.values()):
        raise ValueError("the CUDA kernels have no backward; take "
                         "gradients with use_kernels=False, as the "
                         "reference's trainer does")


def remat_layer(fn, opts: RunOptions, *args):
    """``fn(*args)``, recomputed in backward when ``opts.remat`` is "full"
    and autograd is recording."""
    if opts.remat == "full" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def forward(cfg: ModelConfig, params: dict, tokens,
            prefix_embeds=None, opts: RunOptions = RunOptions(),
            mode: str = "prefill", cache: Optional[dict] = None,
            max_len: Optional[int] = None):
    """mode='train': (logits (B, S, V) fp32, aux);
    mode='prefill': (last_logits (B, V) fp32, cache);
    mode='hidden': (hidden (B, S, D), aux).  ``aux`` is the MoE layers'
    summed load-balancing loss (a 0-d tensor), 0.0 without experts.
    On a split vocabulary the logits are this rank's block of it.

    In prefill mode ``cache`` (from :func:`init_cache`, with room for
    ``max_len`` positions) is written in place; without one a fresh cache
    is allocated.  Train and hidden modes take no cache."""
    if mode not in ("train", "prefill", "hidden"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "prefill" and cache is not None:
        raise ValueError(f"{mode} mode writes no cache")
    if mode != "prefill":
        check_differentiable(params, opts)
    _, m, kinds = macro_shape(cfg)
    x = _embed(cfg, params, tokens, prefix_embeds, opts)
    b, s, _ = x.shape
    if mode == "prefill" and cache is None:
        cache = init_cache(cfg, b, max_len if max_len is not None else s,
                           opts, device=x.device)
    aux, tp = 0.0, tp_split(opts)
    for idx, w in enumerate(unstack_layers(params, 2)):
        i, j = divmod(idx, m)
        if mode == "prefill":
            x, _, k, v = _sublayer(cfg, w, x, kinds[j], opts)
            if tp is not None:      # the cache holds every kv head
                k, v = gather_heads(cfg, tp, k), gather_heads(cfg, tp, v)
            _fill_cache(cfg, cache, i, j, kinds[j], k, v)
        else:
            x, a, _, _ = remat_layer(_sublayer, opts, cfg, w, x, kinds[j],
                                     opts)
            aux = aux + a
    x = _norm(cfg, params, "final_norm", x)
    if mode == "hidden":
        return x, aux
    if mode == "train":
        return head_logits(cfg, x, _head(cfg, params), opts), aux
    cache["t"].fill_(s)
    return head_logits(cfg, x[:, -1], _head(cfg, params), opts), cache


def _layer_cache(cfg, cache, i, j, kind):
    """(k, v) views of layer (i, j)'s cache, (B, W, KV, DH)."""
    if not cfg.global_every:
        return cache["k"][i, j], cache["v"][i, j]
    if kind == "global":
        return cache["k_global"][i, 0], cache["v_global"][i, 0]
    return cache["k_local"][i, j], cache["v_local"][i, j]


def _fill_cache(cfg, cache, i, j, kind, k, v):
    """Write a layer's fresh keys / values (B, S, KV, DH) into its cache,
    in place (``kvcache.write_prompt``): a ring keeps the last W positions
    of a longer prompt; a full cache must hold the whole prompt."""
    s = k.shape[1]
    for layer, new in zip(_layer_cache(cfg, cache, i, j, kind), (k, v)):
        if s > layer.shape[1] and kind in ("full", "global"):
            raise ValueError(f"prompt of {s} tokens does not fit a cache "
                             f"of {layer.shape[1]} positions")
        kvcache.write_prompt(layer, new)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens,
                opts: RunOptions = RunOptions()):
    """tokens: (B, 1) int.  Returns (logits (B, V) fp32, cache), each
    layer's cache written at slot ``t`` (full) or ``t mod W`` (ring) and
    ``t`` advanced, in place.

    Where the executor traces the task and a profiler records, the step's
    parts are profiler ranges (``repro.embed``, ``repro.attn``,
    ``repro.mlp``, inside it an MoE layer's ``repro.moe.route`` and
    ``repro.moe.experts``, ``repro.head``); that is decided once a step
    (``obs.tracer.step_ranges``), and otherwise each part enters a shared
    null context."""
    _, m, kinds = macro_shape(cfg)
    t = cache["t"]
    rng = obs_tracer.step_ranges()
    with rng("repro.embed"):
        x = embed_tokens(cfg, params, tokens[:, :1], opts)
    for idx, w in enumerate(unstack_layers(params, 2)):
        i, j = divmod(idx, m)
        with rng("repro.attn"):
            h = _norm(cfg, w, "ln1", x)
            x = x + _attn_decode(cfg, w, h,
                                 *_layer_cache(cfg, cache, i, j, kinds[j]),
                                 t, kinds[j], opts)
        with rng("repro.mlp"):
            x = x + _mlp(cfg, w, _norm(cfg, w, "ln2", x), opts)[0]
    with rng("repro.head"):
        x = _norm(cfg, params, "final_norm", x)
        logits = head_logits(cfg, x[:, 0], _head(cfg, params), opts)
        t.add_(1)
    if rng is not obs_tracer.no_range:
        obs_tracer.end_step()
    return logits, cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(cfg: ModelConfig, params: dict, tokens, labels,
            prefix_embeds=None, opts: RunOptions = RunOptions()):
    """Chunked cross-entropy over the token positions (the prefix
    positions of the vlm family are dropped first), plus 0.01 of the MoE
    load-balancing loss."""
    x, aux = forward(cfg, params, tokens, prefix_embeds, opts, "hidden")
    if prefix_embeds is not None:           # loss only over token positions
        x = x[:, prefix_embeds.shape[1]:]
    loss = chunked_lm_loss(x, _head(cfg, params), labels, opts,
                           vocab_part(cfg, opts))
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    return loss
