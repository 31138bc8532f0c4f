"""Sharding rules: DP (+pod) x TP (+EP/SP) for every family.

The reference's rules, leaf for leaf, over the port's flat parameter
names (``layers/wq``, ``embed``, ...).  Conventions:

  * batch shards over the dp axes ("pod","data") -- unless the global batch
    is smaller than the dp extent (long_500k decode), in which case the
    KV/state sequence dim takes the parallelism instead (SP).
  * weights are 2-D sharded: one dim over "model" (TP), one over "data"
    (FSDP/ZeRO); replicated over "pod".
  * MoE experts shard over "model" when divisible (EP), else the
    per-expert hidden dim takes TP.
  * optimizer moments additionally shard their FSDP dim over "pod"
    (ZeRO-1 across pods).

A spec is a :class:`P`: one entry per tensor dim, each None (replicated),
an axis name, or a tuple of axis names laid out major to minor, as JAX's
``PartitionSpec``.  :func:`sanitize_pspec` drops the axes a dim does not
divide, so no uneven shard is ever made; :func:`to_placements` turns a
spec into DTensor placements on a ``DeviceMesh``.  Every rule takes a
``DeviceMesh`` or a ``{axis: size}`` mapping.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.registry import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import dp_axes, mesh_axes

TP = "model"
FSDP = "data"


class P(tuple):
    """A partition spec: a tuple of entries, a one-name tuple entry
    written as the name (as JAX normalises it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts whose leaves are specs (or,
    for ``rest``, anything at the same paths)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tp_applies(cfg: ModelConfig, shape: ShapeSpec, mode: str = "auto") -> bool:
    """Per-arch TP policy: small models (d_model <= 2048) train pure-DP at a
    global batch of 256 or more -- batch over both mesh axes, weights
    FSDP-sharded over 'data' and replicated over 'model'."""
    if mode == "2d":
        return True
    if mode == "dp_only":
        return False
    return not (shape.kind == "train" and cfg.d_model <= 2048
                and shape.global_batch >= 256)


def strip_tp(pspecs):
    return tree_map(lambda s: P(*[None if e == TP else e for e in s]),
                    pspecs)


def strip_fsdp(pspecs):
    return tree_map(lambda s: P(*[None if e == FSDP else e for e in s]),
                    pspecs)


def weight_stationary_serving(cfg: ModelConfig) -> bool:
    """Serving keeps the full TP weight slice resident per rank when the
    bf16 TP slice is small (<= 4 GB on 16 shards): FSDP sharding would
    re-gather every weight on each decode step."""
    return cfg.n_params * 2 / 16 <= 4e9


def expert_parallel(cfg: ModelConfig) -> bool:
    """MoE experts shard over 'model' (EP) when 16 divides their count."""
    return bool(cfg.n_experts) and cfg.n_experts % 16 == 0


def _transformer_layer_rules(cfg: ModelConfig) -> dict[str, P]:
    ep = expert_parallel(cfg)
    rules = {
        "wq": P(None, None, FSDP, TP),
        "wk": P(None, None, FSDP, TP),
        "wv": P(None, None, FSDP, TP),
        "wo": P(None, None, TP, FSDP),
        "bq": P(None, None, TP),
        "bk": P(None, None, TP),
        "bv": P(None, None, TP),
        "w1": P(None, None, FSDP, TP),
        "w2": P(None, None, FSDP, TP),
        "w3": P(None, None, TP, FSDP),
        "b1": P(None, None, TP),
        "b3": P(None, None, None),
        "router": P(None, None, FSDP, None),
        "moe_w1": P(None, None, TP, FSDP, None) if ep
        else P(None, None, None, FSDP, TP),
        "moe_w2": P(None, None, TP, FSDP, None) if ep
        else P(None, None, None, FSDP, TP),
        "moe_w3": P(None, None, TP, None, FSDP) if ep
        else P(None, None, None, TP, FSDP),
    }
    for n in ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias"):
        rules[n] = P(None, None, None)
    return rules


def _rwkv_layer_rules(cfg: ModelConfig) -> dict[str, P]:
    return {
        "wr": P(None, FSDP, TP), "wk": P(None, FSDP, TP),
        "wv": P(None, FSDP, TP), "wg": P(None, FSDP, TP),
        "wo": P(None, TP, FSDP),
        "wck": P(None, FSDP, TP), "wcv": P(None, TP, FSDP),
        "wcr": P(None, FSDP, TP),
        "wmix_a": P(None, FSDP, None), "wmix_b": P(None, None, None, FSDP),
        "wdec_a": P(None, FSDP, None), "wdec_b": P(None, None, FSDP),
        "u": P(None, TP, None),
        "mu_x": P(None, None), "mu_rkvwg": P(None, None, None),
        "w0": P(None, None),
        "ln1_scale": P(None, None), "ln1_bias": P(None, None),
        "ln2_scale": P(None, None), "ln2_bias": P(None, None),
        "gn_scale": P(None, None), "gn_bias": P(None, None),
        "mu_ck": P(None, None), "mu_cr": P(None, None),
    }


def _hymba_layer_rules(cfg: ModelConfig) -> dict[str, P]:
    return {
        "wq": P(None, FSDP, TP), "wk": P(None, FSDP, TP),
        "wv": P(None, FSDP, TP), "wo_attn": P(None, TP, FSDP),
        "w_in": P(None, FSDP, TP),
        "w_dt": P(None, FSDP, TP), "b_dt": P(None, None),
        "w_B": P(None, FSDP, None), "w_C": P(None, FSDP, None),
        "a_log": P(None, TP, None), "d_skip": P(None, None),
        "w_out": P(None, TP, FSDP),
        "fuse_attn_scale": P(None, None), "fuse_ssm_scale": P(None, None),
        "ln1_scale": P(None, None), "ln2_scale": P(None, None),
        "w1": P(None, FSDP, TP), "w2": P(None, FSDP, TP),
        "w3": P(None, TP, FSDP),
    }


def _model(cfg: ModelConfig):
    from repro_torch.models.model import get_model
    return get_model(cfg, device="meta")


def param_pspecs(cfg: ModelConfig) -> dict:
    """{parameter name: spec}, the names of ``Model.param_specs``."""
    if cfg.family == "ssm":
        layer = _rwkv_layer_rules(cfg)
    elif cfg.family == "hybrid":
        layer = _hymba_layer_rules(cfg)
    else:
        layer = _transformer_layer_rules(cfg)
    top = {
        "embed": P(TP, FSDP),
        "lm_head": P(TP, FSDP),
        "final_norm_scale": P(None),
        "final_norm_bias": P(None),
    }
    out = {}
    for name in _model(cfg).param_specs():
        if name.startswith("layers/"):
            out[name] = layer[name[len("layers/"):]]
        else:
            out[name] = top[name]
    return out


def moment_pspecs(cfg: ModelConfig, multi_pod: bool) -> dict:
    """Optimizer moments: FSDP dim additionally sharded over 'pod' (ZeRO-1)."""
    base = param_pspecs(cfg)
    if not multi_pod:
        return base
    return tree_map(lambda s: P(*[(FSDP, "pod") if e == FSDP else e
                                  for e in s]), base)


def _dp_extent(mesh, dp) -> int:
    sizes = mesh_axes(mesh)
    extent = 1
    for a in dp:
        extent *= sizes[a]
    return extent


def batch_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 dp=None) -> dict:
    dp = dp if dp is not None else dp_axes(mesh)
    bdim = dp if shape.global_batch >= _dp_extent(mesh, dp) else None
    out = {"tokens": P(bdim, None)}
    if shape.kind == "train":
        out["labels"] = P(bdim, None)
    if "prefix_embeds" in _model(cfg).input_specs(shape):
        out["prefix_embeds"] = P(bdim, None, None)
    return out


def cache_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """KV caches: batch over dp (when it fits), sequence over 'model' (SP
    for decode: the softmax combine is an all-reduce, flash-decoding
    style).  SSM states: heads/channels over 'model'."""
    dp = dp_axes(mesh)
    b = dp if shape.global_batch >= _dp_extent(mesh, dp) else None
    seq = TP
    specs = _model(cfg).cache_specs(shape.global_batch, shape.seq_len)
    out: dict[str, P] = {}
    for k, (s, _) in specs.items():
        if k == "t":
            out[k] = P()
        elif k in ("k", "v") and cfg.family == "hybrid":
            out[k] = P(None, b, seq, None, None)            # (L,B,W,KV,DH)
        elif k in ("k", "v", "k_local", "v_local", "k_global", "v_global"):
            out[k] = P(None, None, b, seq, None, None)      # (nm,m,B,S,KV,DH)
        elif k == "wkv":
            out[k] = P(None, b, TP, None, None)             # (L,B,H,K,V)
        elif k == "ssm":
            out[k] = P(None, b, TP, None)                   # (L,B,D,N)
        elif k in ("tm", "cm"):
            out[k] = P(None, b, None)                       # (L,B,D)
        else:
            out[k] = P(*([None] * len(s)))
    return out


def _shape_of(spec_like) -> tuple:
    """The shape of a ``(shape, dtype)`` spec or of a tensor."""
    if hasattr(spec_like, "shape"):
        return tuple(spec_like.shape)
    return tuple(spec_like[0])


def sanitize_pspec(spec: P, shape: tuple, mesh) -> P:
    """Drop sharded axes whose extent is not divisible by the mesh axes
    (e.g. Hymba's vocab 32001 cannot take the 16-way 'model' axis), so no
    shard is ever uneven."""
    sizes = mesh_axes(mesh)
    out = []
    for dim, entry in zip(shape,
                          tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= sizes[a]
        out.append(entry if dim % total == 0 else None)
    return P(*out)


def sanitize_tree(pspecs, shape_specs, mesh):
    """:func:`sanitize_pspec` leaf-wise; ``shape_specs`` a matching tree
    of ``(shape, dtype)`` pairs or tensors."""
    return tree_map(lambda p, s: sanitize_pspec(p, _shape_of(s), mesh),
                    pspecs, shape_specs)


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one ``Shard(dim)`` or
    ``Replicate()`` per mesh dim.

    DTensor shards one tensor dim over several mesh dims in mesh-dim
    order, JAX in the entry's order.  Where the two differ for a pair of
    axes (the moments' ("data", "pod") on a ("pod", "data", "model")
    mesh), the earlier mesh dim takes a strided shard whose split factor
    is the later one's size, which puts JAX's block at every coordinate;
    a longer out-of-order entry is refused."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_axes(mesh)
    out: list[Any] = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        order = [names.index(a) for a in axes]
        if order == sorted(order):
            for i in order:
                out[i] = Shard(dim)
        elif len(axes) == 2:
            later, earlier = order          # mesh dims of JAX's major, minor
            out[earlier] = _StridedShard(dim, split_factor=sizes[axes[0]])
            out[later] = Shard(dim)
        else:
            raise NotImplementedError(
                f"spec entry {entry!r} lays out {len(axes)} mesh axes in an "
                f"order other than the mesh's {tuple(names)}")
    return tuple(out)


def to_shardings(tree_pspecs, mesh):
    """:func:`to_placements` over a tree of specs."""
    return tree_map(lambda s: to_placements(s, mesh), tree_pspecs)


def from_block(local, spec: P, mesh):
    """``local``, this rank's block under ``spec``, as a DTensor.  A rank
    outside the mesh holds an empty block."""
    import torch
    from torch.distributed.tensor import DTensor

    shape = list(local.shape)
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            shape[d] *= mesh_axes(mesh)[a]
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def distribute(tree, pspecs, mesh):
    """Whole tensors (the same on every rank) -> DTensors laid out by
    ``pspecs``: each rank keeps its block, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import dist

    def put(spec, full):
        if mesh.get_coordinate() is None:
            return distribute_tensor(full, mesh, to_placements(spec, mesh),
                                     src_data_rank=None)
        return from_block(dist.local_block(full, spec, mesh).contiguous(),
                          spec, mesh)

    return tree_map(put, pspecs, tree)
