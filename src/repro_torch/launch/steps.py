"""Step builders: the sharded train / prefill / serve steps.

Each builder returns ``(fn, in_placements, out_placements, input_specs,
donate)``, the reference's five-tuple with DTensor placements (one tuple
a leaf, :func:`shardings.to_placements`) in place of its
``NamedSharding``s; ``input_specs`` holds meta-device tensors and
``donate`` the indices of the arguments ``fn`` updates in place.  ``fn``
runs on every rank of the mesh and takes and returns DTensors laid out
as the placements say (:func:`shardings.distribute` builds them).

How a step stands in for GSPMD, which the port does not have: state at
rest follows the specs exactly; every rank runs its batch block, and
splits the model's products over 'model' as the specs shard the weights
(tensor parallelism: the model code's ``transformer.tp_split``, with
the conjugate collectives of ``models/dist.py``).  Just before the step
each weight is gathered over the batch axes only ('data', and 'pod'
where present), keeping this rank's 'model' block, the FSDP-then-TP
layout of the reference's 2-D specs (:func:`models.dist.unshard`, whose
backward sums the gradient over the batch axes and keeps this rank's
block).  Where the model's split reads another part of a weight than
the rank's block at rest (Hymba's ``w_in`` x and z columns, kv heads the
axis does not divide, a replicated weight read in slices), the weight is
gathered whole and that part taken, the backward then also summing over
'model' (:func:`_weights`).  The explicit-TP layers take their blocks in
the shard_map layout instead (``transformer.explicit_tp_params``).
Results are cut to this rank's block of their out spec: logits stay
split over the vocabulary and RWKV6's and Hymba's states over heads and
channels, as the model computed them.  The numbers are GSPMD's (the
same math); only where the bytes move differs.

With ``AdamWConfig.compress_grads`` the train step's optimizer state
also holds ``err``, the int8 compression's error feedback, laid out as
the moments (``optim/adamw.py``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.registry import ModelConfig, ShapeSpec
from repro_torch.launch import shardings as sh
from repro_torch.launch.shardings import P
from repro_torch.models import dist, hymba, rwkv6, transformer
from repro_torch.models.model import RunOptions, get_model
from repro_torch.optim import adamw

# the layouts the explicit-TP layers take their weight blocks in
# (the reference's shard_map in_specs, behind the stacking dims)
_EXPLICIT_SPEC = {"wq": P(None, None, sh.FSDP, sh.TP),
                  "wk": P(None, None, sh.FSDP, sh.TP),
                  "wv": P(None, None, sh.FSDP, sh.TP),
                  "wo": P(None, None, sh.TP, sh.FSDP),
                  "w1": P(None, None, sh.FSDP, sh.TP),
                  "w2": P(None, None, sh.FSDP, sh.TP),
                  "w3": P(None, None, sh.TP, sh.FSDP)}


def _mesh_opts(opts: RunOptions, mesh, shape: ShapeSpec,
               tp: bool = True) -> RunOptions:
    """Set the mesh and its dp axes (None when the global batch is too
    small to shard, e.g. long_500k decode).  Without TP the batch takes
    the 'model' axis too (pure DP)."""
    dp = sh.dp_axes(mesh)
    if not tp:
        dp = tuple(dp) + (sh.TP,)
    extent = math.prod(sh.mesh_axes(mesh)[a] for a in dp)
    dp_spec = tuple(dp) if shape.global_batch >= extent else None
    return dataclasses.replace(opts, shard_constraints=True, dp_spec=dp_spec,
                               mesh=mesh)


def _batch_axes(opts) -> tuple:
    return tuple(opts.dp_spec or ())


def _non_batch(spec: P, opts) -> P:
    """``spec`` without its batch entries: the layout of a rank's batch
    block within the whole batch block."""
    dp = set(_batch_axes(opts))
    return P(*[None if e is not None and set(sh.spec_axes(e)) <= dp else e
               for e in spec])


def _weights(params: dict, p_spec: dict, cuts: dict, explicit: set, mesh,
             opts, grad: bool = False) -> dict:
    """The tensors the model runs on: each weight's part that this
    rank's computation reads (``cuts``, the model's ``tp_cuts``: its
    'model' block, or the whole where it has no cut), those in
    ``explicit`` as this rank's block in the explicit-TP layout.  With
    ``grad`` the gathers are differentiable (summing the gradient over
    the batch axes, and over 'model' too where a rank reads another part
    than its block), and explicit weights must already be in their
    layout."""
    dp = _batch_axes(opts)
    out = {}
    for k, local in params.items():
        spec, name = p_spec[k], k[len("layers/"):]
        if k.startswith("layers/") and name in explicit:
            want = _EXPLICIT_SPEC[name]
            if spec != want:
                if grad:
                    raise ValueError(f"{k}: explicit TP trains a weight "
                                     f"laid out {want}, not {spec}")
                local = _relayout(local, spec, want, mesh)
            out[k] = local
            continue
        cut = cuts.get(k)
        if cut is None or _is_block(local, spec, cut, mesh):
            # the whole weight, or this rank's 'model' block of it
            gspec = spec if cut is None else sh.strip_tp(spec)
            out[k] = (dist.unshard(local, gspec, mesh, dp) if grad
                      else dist.gather(local, gspec, mesh))
            continue
        whole = (dist.unshard(local, spec, mesh, dp + (sh.TP,)) if grad
                 else dist.gather(local, spec, mesh))
        dim, ranges = cut
        parts = [whole.narrow(dim, lo, hi - lo) for lo, hi in ranges]
        out[k] = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return out


def _is_block(local, spec: P, cut, mesh) -> bool:
    """Whether ``cut`` reads this rank's 'model' block of the weight at
    rest: one range, the rank's block along a dim that 'model' alone
    splits."""
    dim, ranges = cut
    dim %= local.dim()
    if len(ranges) != 1 or dim >= len(spec) or spec[dim] != sh.TP:
        return False
    if any(sh.TP in sh.spec_axes(e) for i, e in enumerate(spec) if i != dim):
        return False
    n = local.shape[dim]
    lo = dist.axis_index(mesh, sh.TP) * n
    return ranges[0] == (lo, lo + n)


def _cuts(cfg: ModelConfig, opts) -> dict:
    """The model's ``tp_cuts`` on this rank, {} where nothing is split."""
    tp = transformer.tp_split(opts)
    if tp is None:
        return {}
    family = {"ssm": rwkv6, "hybrid": hymba}.get(cfg.family, transformer)
    return family.tp_cuts(cfg, tp)


def _relayout(local, src: P, dst: P, mesh):
    """This rank's block under ``dst`` of the tensor whose block under
    ``src`` it holds."""
    return dist.local_block(dist.gather(local, src, mesh), dst,
                            mesh).contiguous()


def _meta(specs: dict, dtype=None) -> dict:
    """Meta-device tensors of {name: (shape, dtype)} specs (in ``dtype``
    when given)."""
    return {k: torch.empty(s, dtype=dtype or d, device="meta")
            for k, (s, d) in specs.items()}


def _locals(tree: dict) -> dict:
    return {k: v.to_local() for k, v in tree.items()}


def _explicit(cfg, opts, mode) -> set:
    if cfg.family in ("ssm", "hybrid"):
        return set()
    return transformer.explicit_tp_params(cfg, opts, mode)


def _logits_spec(cfg, shape, mesh, bdim) -> P:
    return sh.sanitize_pspec(P(bdim, sh.TP), (shape.global_batch, cfg.vocab),
                             mesh)


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     opts: RunOptions = RunOptions(),
                     opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """One AdamW step (``optim/adamw.update``) on the mean loss of the
    global batch.  Each rank's objective is its batch block's mean loss
    over the number of batch blocks, so the gathers' backward sums give
    the global gradient; the global-norm clip sums each leaf over the mesh
    dims along which it is sharded.  With ``opt_cfg.compress_grads`` the
    optimizer state holds ``err`` (``adamw.init_error_feedback``), laid
    out as the moments."""
    tp = sh.tp_applies(cfg, shape, opts.sharding_mode)
    opts = _mesh_opts(opts, mesh, shape, tp)
    model = get_model(cfg, opts, device=mesh.device_type)
    multi_pod = "pod" in mesh.mesh_dim_names
    dp = _batch_axes(opts)
    n_blocks = math.prod(dist.axis_size(mesh, a) for a in dp)
    explicit = _explicit(cfg, opts, "full_seq")
    cuts = _cuts(cfg, opts)

    params_specs0 = model.param_specs()
    p_raw = sh.param_pspecs(cfg)
    m_raw = sh.moment_pspecs(cfg, multi_pod)
    if not tp:
        p_raw, m_raw = sh.strip_tp(p_raw), sh.strip_tp(m_raw)
        # replicate the (small) embeddings: the chunked CE stays local
        for k in ("embed", "lm_head"):
            if k in p_raw:
                p_raw[k] = P(None, None)
                m_raw[k] = P(sh.FSDP, None)
    p_spec = sh.sanitize_tree(p_raw, params_specs0, mesh)
    m_spec = sh.sanitize_tree(m_raw, params_specs0, mesh)
    opt_spec = {"m": m_spec, "v": m_spec, "step": P()}
    if opt_cfg.compress_grads:
        opt_spec["err"] = m_spec
    b_spec = sh.batch_pspecs(cfg, shape, mesh,
                             dp=opts.dp_spec or sh.dp_axes(mesh))

    def train_step(params, opt_state, batch):
        names = sorted(params)
        leaves = {k: params[k].to_local().detach().requires_grad_(True)
                  for k in names}
        with torch.enable_grad():
            w = _weights(leaves, p_spec, cuts, explicit, mesh, opts,
                         grad=True)
            obj = model.loss(w, _locals(batch)) / n_blocks
            grads = torch.autograd.grad(obj, [leaves[k] for k in names])
        loss = dist.all_reduce(obj.detach().clone(), mesh, dp)
        grads = dict(zip(names, grads))
        # ZeRO-1 moments (multi-pod) cut the FSDP dim finer than the
        # parameters: the update runs on the moments' blocks
        moved = [k for k in names if m_spec[k] != p_spec[k]]
        upd_params = dict(params)
        for k in moved:
            upd_params[k] = sh.from_block(
                _relayout(params[k].to_local(), p_spec[k], m_spec[k], mesh),
                m_spec[k], mesh)
            grads[k] = _relayout(grads[k], p_spec[k], m_spec[k], mesh)
        grads = {k: sh.from_block(g, m_spec[k], mesh)
                 for k, g in grads.items()}
        err = opt_state.get("err")
        _, opt_state, err, metrics = adamw.update(opt_cfg, upd_params, grads,
                                                  opt_state, err)
        if err is not None:
            opt_state["err"] = err
        for k in moved:
            params[k].to_local().copy_(_relayout(
                upd_params[k].to_local(), m_spec[k], p_spec[k], mesh))
        scalar = {"loss": loss, **metrics}
        return params, opt_state, {k: sh.from_block(v, P(), mesh)
                                   for k, v in scalar.items()}

    in_pl = (sh.to_shardings(p_spec, mesh), sh.to_shardings(opt_spec, mesh),
             sh.to_shardings(b_spec, mesh))
    scalar_pl = sh.to_placements(P(), mesh)
    out_pl = (in_pl[0], in_pl[1],
              {"loss": scalar_pl, "grad_norm": scalar_pl, "lr": scalar_pl})

    opt_specs = {"m": _meta(params_specs0, torch.float32),
                 "v": _meta(params_specs0, torch.float32),
                 "step": torch.empty((), dtype=torch.int32, device="meta")}
    if opt_cfg.compress_grads:
        opt_specs["err"] = _meta(params_specs0, torch.float32)
    input_specs = (_meta(params_specs0), opt_specs, model.input_specs(shape))
    return train_step, in_pl, out_pl, input_specs, (0, 1)


def _serving_param_spec(cfg, model, mesh) -> dict:
    p_raw = sh.param_pspecs(cfg)
    if sh.weight_stationary_serving(cfg):
        p_raw = sh.strip_fsdp(p_raw)
    return sh.sanitize_tree(p_raw, model.param_specs(), mesh)


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                       opts: RunOptions = RunOptions()):
    """The prompt's last-token logits and a fresh cache, each rank on its
    batch block; the cache is cut to the cache specs (the transformers'
    and Hymba's keys and values over the sequence, RWKV6's and Hymba's
    states over heads and channels), the logits to theirs (the
    vocabulary over 'model' where it splits)."""
    opts = _mesh_opts(opts, mesh, shape)
    model = get_model(cfg, opts, device=mesh.device_type)
    explicit = _explicit(cfg, opts, "full_seq")
    cuts = _cuts(cfg, opts)
    p_spec = _serving_param_spec(cfg, model, mesh)
    b_spec = sh.batch_pspecs(cfg, shape, mesh)
    c_shapes = model.cache_specs(shape.global_batch, shape.seq_len)
    c_spec = sh.sanitize_tree(sh.cache_pspecs(cfg, shape, mesh), c_shapes,
                              mesh)
    dp = sh.dp_axes(mesh)
    logits_spec = _logits_spec(cfg, shape, mesh,
                               dp if shape.global_batch >= 2 else None)
    l_shape = (shape.global_batch, cfg.vocab)

    @torch.no_grad()
    def prefill_step(params, batch):
        w = _weights(_locals(params), p_spec, cuts, explicit, mesh, opts)
        logits, cache = model.prefill(w, _locals(batch),
                                      max_len=shape.seq_len)
        return _cut(logits, logits_spec, l_shape, mesh, opts), {
            k: _cut(v, c_spec[k], c_shapes[k][0], mesh, opts)
            for k, v in cache.items()}

    in_pl = (sh.to_shardings(p_spec, mesh), sh.to_shardings(b_spec, mesh))
    out_pl = (sh.to_placements(logits_spec, mesh),
              sh.to_shardings(c_spec, mesh))
    input_specs = (_meta(model.param_specs()), model.input_specs(shape))
    return prefill_step, in_pl, out_pl, input_specs, ()


def _cut(block: torch.Tensor, spec: P, shape, mesh, opts) -> DTensor:
    """A DTensor of ``spec`` from this rank's batch block of a tensor of
    global ``shape``; along a dim where the block is already this rank's
    part over 'model' (the split vocabulary, RWKV6's state heads, Hymba's
    state channels) it is not cut again."""
    keep = [None if e is not None and sh.TP in sh.spec_axes(e)
            and block.shape[d] < shape[d] else e
            for d, e in enumerate(_non_batch(spec, opts))]
    local = dist.local_block(block, P(*keep), mesh)
    return sh.from_block(local.contiguous(), spec, mesh)


def build_serve_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     opts: RunOptions = RunOptions()):
    """Decode: one new token against a seq_len-deep cache, written in
    place, on this rank's blocks of the cache: the transformers and Hymba
    attend over this rank's slice of the sequence
    (``transformer._seq_shard_decode``, no kernel, as in the reference),
    RWKV6 and Hymba step their states on this rank's heads and channels.
    Without ``seq_shard_decode`` the transformers gather their cache
    whole over 'model', decode, and keep their blocks."""
    opts = _mesh_opts(opts, mesh, shape)
    model = get_model(cfg, opts, device=mesh.device_type)
    explicit = _explicit(cfg, opts, "decode")
    cuts = _cuts(cfg, opts)
    p_spec = _serving_param_spec(cfg, model, mesh)
    c_shapes = model.cache_specs(shape.global_batch, shape.seq_len)
    c_spec = sh.sanitize_tree(sh.cache_pspecs(cfg, shape, mesh), c_shapes,
                              mesh)
    dp = sh.dp_axes(mesh)
    extent = math.prod(sh.mesh_axes(mesh)[a] for a in dp)
    bdim = dp if shape.global_batch >= extent else None
    tok_spec = sh.sanitize_pspec(P(bdim, None), (shape.global_batch, 1),
                                 mesh)
    logits_spec = _logits_spec(cfg, shape, mesh, bdim)
    l_shape = (shape.global_batch, cfg.vocab)
    local = cfg.family in ("ssm", "hybrid") or opts.seq_shard_decode
    # the sequence dim of the keys and values (transformers, Hymba's ring)
    seq_dim = 2 if cfg.family == "hybrid" else 3
    if local and cfg.family != "ssm":
        for k, spec in c_spec.items():
            if k not in ("t", "ssm") and spec[seq_dim] != sh.TP \
                    and sh.mesh_axes(mesh)[sh.TP] > 1:
                raise ValueError(f"cache {k!r}: its sequence does not split "
                                 f"over the 'model' axis ({spec}); the "
                                 f"sequence-sharded decode needs it to")

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        w = _weights(_locals(params), p_spec, cuts, explicit, mesh, opts)
        tok = tokens.to_local()
        if local:
            logits, _ = model.decode(w, _locals(cache), tok)
        else:
            whole = {k: dist.gather(v.to_local(), _non_batch(c_spec[k], opts),
                                    mesh) for k, v in cache.items()}
            logits, whole = model.decode(w, whole, tok)
            for k, v in cache.items():
                v.to_local().copy_(dist.local_block(
                    whole[k], _non_batch(c_spec[k], opts), mesh))
        return _cut(logits, logits_spec, l_shape, mesh, opts), cache

    in_pl = (sh.to_shardings(p_spec, mesh), sh.to_shardings(c_spec, mesh),
             sh.to_placements(tok_spec, mesh))
    out_pl = (sh.to_placements(logits_spec, mesh),
              sh.to_shardings(c_spec, mesh))
    cache_specs = _meta(model.cache_specs(shape.global_batch,
                                          shape.seq_len))
    tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                      device="meta")
    input_specs = (_meta(model.param_specs()), cache_specs, tok)
    return serve_step, in_pl, out_pl, input_specs, (1,)


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
               opts: RunOptions = RunOptions()):
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, opts)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, opts)
    return build_serve_step(cfg, shape, mesh, opts)
