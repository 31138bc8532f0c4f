"""The port's multi-device layer against the reference's, on the CPU.

Sharding rules: the port's ``launch/shardings.py`` trees equal the
reference's leaf by leaf for every arch x shape on a 16 x 16 and a
2 x 16 x 16 mesh, evaluated on {axis: size} stand-ins (the reference's
rules read only a mesh's axis names and shape).

Everything else runs on ``torch.distributed`` gloo groups of 1, 2 and 4
ranks (the steps split their compute over 'model': every family's train,
prefill and serve steps, a 16-expert MoE whose experts split over
'model', Hymba's prefill where its kv heads do not divide the axis, and
int8 compression of sharded gradients), each rank a fresh interpreter
(``python -c``) that imports this file for its jobs, so the ranks never
import jax or the reference: the parent computes the reference's
numbers, hands the ranks their inputs as a torch file, and compares what
rank 0 writes back.  Each group starts
through a ``FileStore`` under its own ``tmp_path`` directory, runs every
job of its world size in one process group, and is killed when it
outlives GROUP_TIMEOUT (the test then fails).

Tolerances (float32 throughout):
  * RANK_TOL = 2e-5 where no sum is split across ranks, SPLIT_TOL = 2e-4
    where one is (TP all-reduce, the sequence combine, the batch-mean
    loss; the reference's own bound for its sharded step against the
    plain model, tests/test_distribution.py);
  * where the port is held against the reference's *model*, the whole-
    model tolerances of the port's parity tests: MODEL_TOL = 1e-4 for
    logits and caches (tests/test_torch_model.py, test_torch_rwkv6.py,
    test_torch_hymba.py) and WKV_TOL = 5e-3 for RWKV6's recurrent state
    (the reference's own WKV_TOL), each raised to SPLIT_TOL where that is
    larger;
  * gradients (read from the first AdamW moment after one step, which is
    (1 - b1) x the clipped gradient) within GRAD_TOL = 1e-4 x the leaf's
    largest |m|, as tests/test_torch_train.py holds the port's gradients,
    SPLIT_TOL x that where sums are split;
  * int8 compression: from the same gradients the quantised gradients
    and residuals equal the reference's exactly; through a train step,
    whose gradients differ from the reference's by rounding, each first
    moment within one quantisation step (the leaf's scale, times
    (1 - b1) and the clip) plus the split tolerance.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys
import time
import traceback
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import (ARCH_IDS, SHAPES, ShapeSpec,
                                          get_config, reduced)
from repro_torch.launch import shardings as sh
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.model import RunOptions

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANK_TOL, SPLIT_TOL = 2e-5, 2e-4
MODEL_TOL, WKV_TOL, GRAD_TOL = 1e-4, 5e-3, 1e-4
GROUP_TIMEOUT = 240.0           # seconds, each spawned group
F32 = RunOptions(attn_chunk=16, remat="none", param_dtype=torch.float32,
                 act_dtype=torch.float32)
SMALL = ShapeSpec("small_decode", 64, 2, "decode")
SMALL_TRAIN = ShapeSpec("small_train", 32, 2, "train")
SMALL_PREFILL = ShapeSpec("small_prefill", 64, 2, "prefill")
SERVE_ARCHS = ["internlm2_20b", "mixtral_8x22b", "llama4_maverick_400b_a17b",
               "rwkv6_1_6b", "hymba_1_5b", "moe16"]
SERVE_MESHES = [(1, 1), (1, 2), (2, 2)]
SEQ_MESHES = [(1, 2), (1, 4)]
SEQ_KINDS = ["full", "window", "local"]
SEQ_W, SEQ_WINDOW, SEQ_CHUNK = 16, 12, 8
TP_MESHES = [(1, 2), (2, 2)]
TP_FNS = ["row", "column", "swiglu"]
TRAIN_MESHES = [(1, 1), (2, 1), (1, 2)]
PREFILL_ARCHS = ["hymba_1_5b", "rwkv6_1_6b"]
# explicit TP through the whole model: the prefill and train steps of the
# reduced InternLM2 with explicit_tp_ffn, against the reference's plain math
TP_MODEL_MESHES = [(1, 2), (2, 2)]
AT_REST = [((1, 2), ("data", "model")), ((2, 1), ("data", "model")),
           ((2, 2), ("data", "model")), ((2, 2, 1), ("pod", "data", "model"))]
AT_REST_ARCHS = ["internlm2_1_8b", "mixtral_8x22b"]
TRAIN_ARCH, DP_ONLY_ARCH = "internlm2_1_8b", "musicgen_medium"
# the tensor-parallel split of every family: train steps (beside
# TRAIN_ARCH's), prefill steps, and a reduced Mixtral with 16 experts, so
# that the rules make its experts parallel over 'model'
EP_ARCH = "moe16"
TP_TRAIN = [(a, m) for a in ("mixtral_8x22b", "rwkv6_1_6b", "hymba_1_5b")
            for m in ((1, 2), (2, 2))] + [(EP_ARCH, (1, 2))]
TP_PREFILL = [(a, m) for a in ("internlm2_1_8b", "mixtral_8x22b")
              for m in ((1, 2), (2, 2))] + [
    ("hymba_1_5b", (2, 2)), ("rwkv6_1_6b", (2, 2)), ("hymba_1_5b", (1, 4))]
COMPRESS_MESHES = [(1, 2), (2, 2)]
# the train batch's key, 1 unless named here.  Key 1 puts one position of
# the reduced Hymba's layer-1 SSM output at rms 2.3e-3, a mean square
# (5.2e-6) below rms_norm's eps (1e-5): its fused norm's backward then
# amplifies float32 rounding, so that the reference's and the unsharded
# port's float32 gradients each differ from float64 by 4.7e-4 and 7.4e-4
# of a leaf's largest, beyond SPLIT_TOL, and no float32 split could meet
# it.  Key 0 (that of tests/test_torch_train.py's Hymba gradient check)
# keeps both within 2e-5 of float64.
BATCH_KEY = {"hymba_1_5b": 0}
# multi-pod: the moments' FSDP dim is cut over ("data", "pod"), finer than
# the parameters', so the update runs on the moments' blocks
POD_MESH, POD_AXES = (2, 2, 1), ("pod", "data", "model")


def port_cfg(arch):
    if arch == EP_ARCH:
        return dataclasses.replace(reduced(get_config("mixtral_8x22b")),
                                   n_experts=16)
    cfg = reduced(get_config(arch))
    # reduced() leaves Llama-4 at 2 layers, no whole macro block of 4
    return dataclasses.replace(cfg, n_layers=4) if cfg.global_every else cfg


def _world(mesh_shape) -> int:
    return int(np.prod(mesh_shape))


# ===========================================================================
# per-rank side: runs in the spawned interpreters (no jax, no reference)
# ===========================================================================
class _Rank:
    def __init__(self, rank: int, world: int):
        self.rank, self.world, self._meshes = rank, world, {}

    def mesh(self, shape, axes=("data", "model")):
        from repro_torch.launch.mesh import make_test_mesh
        key = (tuple(shape), tuple(axes))
        if key not in self._meshes:
            self._meshes[key] = make_test_mesh(shape, axes, device_type="cpu")
        return self._meshes[key]


def _put(tree, placements, mesh):
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: _put(v, placements[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements)


def _full(tree):
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor()


def _job_serve(ctx, inp, arch, mesh_shape):
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.kernels.flash_decode import ops as fd_ops
    mesh = ctx.mesh(mesh_shape)
    fn, in_pl, out_pl, specs, donate = build_serve_step(port_cfg(arch), SMALL,
                                                        mesh, F32)
    args = [_put(x, pl, mesh) for x, pl in
            zip((inp["params"], inp["cache"], inp["tokens"]), in_pl)]
    fd_ops.flash_decode_at.launches = 0
    logits, cache = fn(*args)
    assert fd_ops.flash_decode_at.launches == 0
    assert donate == (1,) and cache is args[1]
    assert tuple(logits.placements) == tuple(out_pl[0])
    return {"logits": logits.full_tensor(), "cache": _full(cache)}


def _job_seq_decode(ctx, inp, kind, mesh_shape):
    from repro_torch.models import dist
    mesh = ctx.mesh(mesh_shape)
    opts = dataclasses.replace(F32, mesh=mesh, dp_spec=None)
    cfg = _seq_cfg()
    spec = (None, "model")
    out = {}
    for t in inp["ts"][kind]:
        kc = dist.local_block(inp["k_cache"], spec, mesh).clone()
        vc = dist.local_block(inp["v_cache"], spec, mesh).clone()
        o = transformer._seq_shard_decode(
            cfg, opts, inp["q"], inp["k_new"], inp["v_new"], kc, vc,
            torch.tensor(t, dtype=torch.int32), kind)
        out[t] = {"out": o, "k": dist.gather(kc, spec, mesh),
                  "v": dist.gather(vc, spec, mesh)}
    return out


def _seq_cfg():
    return dataclasses.replace(reduced(get_config("mixtral_8x22b")),
                               n_heads=4, n_kv_heads=2, d_head=8,
                               window=SEQ_WINDOW, chunk_attn=SEQ_CHUNK)


def _tp_specs(fn):
    """(x spec, {weight: spec}, output spec) of an explicit-TP function,
    batch over 'data'."""
    if fn == "row":
        return (("data", None, "model"), {"w": ("model", "data")},
                ("data", None, None))
    if fn == "column":
        return (("data", None, None), {"w": ("data", "model")},
                ("data", None, "model"))
    return (("data", None, None), {"w1": ("data", "model"),
                                   "w2": ("data", "model"),
                                   "w3": ("model", "data")},
            ("data", None, None))


def _job_explicit_tp(ctx, inp, fn, mesh_shape):
    from repro_torch.models import dist
    mesh = ctx.mesh(mesh_shape)
    opts = dataclasses.replace(F32, mesh=mesh, dp_spec=("data",),
                               explicit_tp_ffn=True)
    x_spec, w_specs, y_spec = _tp_specs(fn)
    x = dist.local_block(inp["x"], x_spec, mesh).clone().requires_grad_(True)
    ws = {k: dist.local_block(inp[k], s, mesh).clone().requires_grad_(True)
          for k, s in w_specs.items()}
    if fn == "swiglu":
        y = L.explicit_tp_swiglu(x, ws["w1"], ws["w2"], ws["w3"], opts)
    else:
        y = L.explicit_tp_matmul(x, ws["w"], opts, row=fn == "row")
    # this rank's share of the objective sum(y * r): its batch block, and
    # its 'model' slice where y is split over 'model'
    obj = (y * dist.local_block(inp["r"], y_spec, mesh)).sum()
    grads = torch.autograd.grad(obj, [x, *ws.values()])
    out = {"y": dist.gather(y.detach(), y_spec, mesh),
           "dx": dist.gather(grads[0], x_spec, mesh)}
    for (k, s), g in zip(w_specs.items(), grads[1:]):
        out["d" + k] = dist.gather(g, s, mesh)
    return out


def _job_train(ctx, inp, arch, mesh_shape, mode, explicit=False,
               axes=("data", "model"), compress=False):
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw
    mesh = ctx.mesh(mesh_shape, axes)
    opts = dataclasses.replace(F32, sharding_mode=mode,
                               explicit_tp_ffn=explicit)
    fn, in_pl, out_pl, specs, donate = build_train_step(
        port_cfg(arch), SMALL_TRAIN, mesh, opts,
        adamw.AdamWConfig(compress_grads=compress))
    params = _put(inp["params"], in_pl[0], mesh)
    state = adamw.init(inp["params"])
    if compress:
        state["err"] = adamw.init_error_feedback(inp["params"])
    opt = _put(state, in_pl[1], mesh)
    batch = _put(inp["batch"], in_pl[2], mesh)
    params, opt, metrics = fn(params, opt, batch)
    out = {"params": _full(params), "metrics": _full(metrics),
           "step": opt["step"].full_tensor(), "m": _full(opt["m"]),
           "batch_placements": repr(in_pl[2]["tokens"])}
    if compress:
        out["err"] = _full(opt["err"])
        # the reference's gradients, compressed as this mesh's blocks
        g = _put(inp["grads"], in_pl[1]["m"], mesh)
        err = _put(adamw.init_error_feedback(inp["grads"]), in_pl[1]["m"],
                   mesh)
        pairs = {k: adamw.compress_residual(g[k], err[k]) for k in g}
        out["g_hat"] = {k: v[0].full_tensor() for k, v in pairs.items()}
        out["residual"] = {k: v[1].full_tensor() for k, v in pairs.items()}
    return out


def _job_prefill(ctx, inp, arch, mesh_shape, explicit=False):
    from repro_torch.launch.steps import build_prefill_step
    mesh = ctx.mesh(mesh_shape)
    fn, in_pl, out_pl, specs, donate = build_prefill_step(
        port_cfg(arch), SMALL_PREFILL, mesh,
        dataclasses.replace(F32, explicit_tp_ffn=explicit))
    logits, cache = fn(_put(inp["params"], in_pl[0], mesh),
                       _put(inp["batch"], in_pl[1], mesh))
    return {"logits": logits.full_tensor(), "cache": _full(cache),
            "placements": {k: repr(v.placements) for k, v in cache.items()},
            "logits_placements": repr(logits.placements)}


def _job_at_rest(ctx, inp, arch, mesh_shape, axes):
    """Every rank's block of every parameter (and moment) under the
    placements of its spec, with the rank's mesh coordinates."""
    import torch.distributed as tdist
    from torch.distributed.tensor import distribute_tensor
    mesh = ctx.mesh(mesh_shape, axes)
    specs = _rest_specs(arch, mesh)
    mine = {"coord": dict(zip(axes, mesh.get_coordinate()))}
    for name, spec in specs.items():
        full = inp["params"][name.split(":", 1)[1]]
        mine[name] = distribute_tensor(full, mesh, sh.to_placements(
            spec, mesh)).to_local().clone()
    every = [None] * ctx.world
    tdist.all_gather_object(every, mine)
    return {"blocks": every, "specs": {k: tuple(v) for k, v in specs.items()}}


def _rest_specs(arch, mesh) -> dict:
    """param:<name> and moment:<name> specs, sanitized on ``mesh``."""
    cfg = port_cfg(arch)
    shapes = sh._model(cfg).param_specs()
    multi_pod = "pod" in sh.mesh_axes(mesh)
    out = {}
    for kind, tree in (("param", sh.param_pspecs(cfg)),
                       ("moment", sh.moment_pspecs(cfg, multi_pod))):
        for k, v in sh.sanitize_tree(tree, shapes, mesh).items():
            out[f"{kind}:{k}"] = v
    return out


def _job_elastic(ctx, inp):
    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.launch.shardings import P
    from repro_torch.runtime import elastic
    mesh = ctx.mesh((2, 2))
    tree = {"w": torch.zeros(8, 8)}
    out, step = ckpt.restore(inp["dir"], tree,
                             shardings={"w": P("data", None)}, mesh=mesh)
    restored = out["w"].full_tensor()
    local_rows = out["w"].to_local().shape[0]
    smaller = elastic.shrink_mesh(mesh, "data", 1)
    moved = elastic.reshard_state(out, {"w": P(None, "model")}, smaller)
    res = {"step": step, "restored": restored, "local_rows": local_rows,
           "smaller": tuple(smaller.mesh.shape)}
    if smaller.get_coordinate() is not None:
        res["moved"] = moved["w"].full_tensor()
        res["moved_local"] = tuple(moved["w"].to_local().shape)
    return res


JOBS = {"serve": _job_serve, "seq_decode": _job_seq_decode,
        "explicit_tp": _job_explicit_tp, "train": _job_train,
        "prefill": _job_prefill, "at_rest": _job_at_rest,
        "elastic": _job_elastic}


def _rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank of a group: every job of ``jobs.pt`` in order; rank 0
    writes the results after each job, a failing rank its traceback."""
    import torch.distributed as tdist
    torch.set_num_threads(1)
    workdir = pathlib.Path(workdir)
    tdist.init_process_group(
        "gloo", init_method=f"file://{workdir / 'store'}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    jobs = torch.load(workdir / "jobs.pt", weights_only=False)
    ctx, results = _Rank(rank, world), {}
    try:
        for key, name, inp, kwargs in jobs:
            results[key] = JOBS[name](ctx, inp, **kwargs)
            if rank == 0:
                torch.save(results, workdir / "out.tmp")
                os.replace(workdir / "out.tmp", workdir / "out.pt")
    except BaseException:
        (workdir / f"error{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        tdist.destroy_process_group()


# ===========================================================================
# parent side
# ===========================================================================
def _spawn(workdir: pathlib.Path, world: int, jobs: list):
    """Start a group of ``world`` ranks on ``jobs``; returns its handle."""
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(jobs, workdir / "jobs.pt")
    code = ("import importlib.util, sys; "
            f"sys.path[:0] = [{str(ROOT / 'src')!r}]; "
            "s = importlib.util.spec_from_file_location("
            f"'_dist_ranks', {str(pathlib.Path(__file__))!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            f"m._rank_main(int(sys.argv[1]), {world}, {str(workdir)!r})")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    procs = []
    for r in range(world):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code, str(r)],
                                       stdout=log, stderr=log, env=env,
                                       cwd=str(ROOT)), log))
    return {"dir": workdir, "procs": procs, "start": time.monotonic()}


def _join(group) -> dict:
    """Wait for a group within GROUP_TIMEOUT, killing it on expiry;
    returns {"results": ..., "error": text or None}."""
    error = None
    for p, log in group["procs"]:
        left = GROUP_TIMEOUT - (time.monotonic() - group["start"])
        try:
            p.wait(timeout=max(left, 0.1))
        except subprocess.TimeoutExpired:
            error = f"group timed out after {GROUP_TIMEOUT:.0f}s"
        log.close()
    for p, _ in group["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    d = group["dir"]
    if error is None and any(p.returncode for p, _ in group["procs"]):
        texts = [f.read_text() for f in sorted(d.glob("error*.txt"))]
        logs = [f.read_text()[-3000:] for f in sorted(d.glob("rank*.log"))]
        error = "\n".join(texts) or "\n".join(logs)
    results = (torch.load(d / "out.pt", weights_only=False)
               if (d / "out.pt").exists() else {})
    return {"results": results, "error": error}


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _ref_pair(arch, seed=0):
    """(reference model, its params as a numpy tree, port params)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as ref_get_config
    from repro.configs.registry import reduced as ref_reduced
    from repro.models.model import RunOptions as RefRunOptions
    from repro.models.model import get_model as ref_get_model
    from repro_torch.models.convert import params_from_reference

    if arch == EP_ARCH:
        cfg = dataclasses.replace(
            ref_reduced(ref_get_config("mixtral_8x22b")), n_experts=16)
    else:
        cfg = ref_reduced(ref_get_config(arch))
    if cfg.global_every:
        cfg = dataclasses.replace(cfg, n_layers=4)
    opts = RefRunOptions(attn_chunk=16, remat="none",
                         param_dtype=jnp.float32, act_dtype=jnp.float32)
    model = ref_get_model(cfg, opts)
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    return model, tree, params_from_reference(tree)


def _flat_np(tree) -> dict:
    from repro_torch.models.convert import flat_items
    return {k: np.asarray(v) for k, v in flat_items(tree)}


def _serve_inputs():
    import jax.numpy as jnp
    out = {}
    for arch in SERVE_ARCHS:
        model, tree, params = _ref_pair(arch)
        rng = np.random.default_rng(1)
        cache = {k: np.asarray(v) for k, v in
                 model.init_cache(SMALL.global_batch, SMALL.seq_len).items()}
        for k in cache:
            if k != "t":
                cache[k] = rng.normal(size=cache[k].shape).astype(np.float32)
        cache["t"] = np.asarray(10, np.int32)
        tok = rng.integers(0, model.cfg.vocab, (SMALL.global_batch, 1))
        logits, new = model.decode(tree, {k: jnp.asarray(v)
                                          for k, v in cache.items()},
                                   jnp.asarray(tok, jnp.int32))
        out[arch] = ({"params": params,
                      "cache": {k: torch.from_numpy(np.array(v))
                                for k, v in cache.items()},
                      "tokens": torch.from_numpy(tok).int()},
                     {"logits": _np(logits),
                      "cache": {k: np.asarray(v) for k, v in new.items()}})
    return out


def _seq_inputs():
    rng = np.random.default_rng(2)
    b, h, kv, d = 2, 4, 2, 8

    def rnd(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    inp = {"q": rnd(b, 1, h, d), "k_new": rnd(b, 1, kv, d),
           "v_new": rnd(b, 1, kv, d), "k_cache": rnd(b, SEQ_W, kv, d),
           "v_cache": rnd(b, SEQ_W, kv, d),
           # first, middle and last of 4 shards; past one wrap for rings
           "ts": {"full": [1, 6, 14], "window": [1, 6, 14, 21, 37],
                  "local": [1, 6, 14, 21, 37]}}
    cfg = _seq_cfg()
    want = {}
    for kind in SEQ_KINDS:
        for t in inp["ts"][kind]:
            kc, vc = inp["k_cache"].clone(), inp["v_cache"].clone()
            tt = torch.tensor(t, dtype=torch.int32)
            slot = t if kind == "full" else t % SEQ_W
            kc[:, slot] = inp["k_new"][:, 0]
            vc[:, slot] = inp["v_new"][:, 0]
            if kind == "full":
                o = L.decode_attention(inp["q"], kc, vc, length=tt + 1)
            else:
                window, local = transformer._masks(cfg, kind)
                o = L.decode_ring_attention(inp["q"], kc, vc, t=tt,
                                            window=window, local_block=local)
            want[(kind, t)] = {"out": o, "k": kc, "v": vc}
    return inp, want


def _tp_inputs():
    rng = np.random.default_rng(3)

    def rnd(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    b, s, k, n = 4, 3, 8, 12
    inp = {"x": rnd(b, s, k), "w": rnd(k, n) / 3, "w1": rnd(k, n) / 3,
           "w2": rnd(k, n) / 3, "w3": rnd(n, k) / 3}
    want = {}
    for fn in TP_FNS:
        x = inp["x"].clone().requires_grad_(True)
        names = ["w"] if fn != "swiglu" else ["w1", "w2", "w3"]
        ws = [inp[n_].clone().requires_grad_(True) for n_ in names]
        y = (L.swiglu_mlp(x, *ws) if fn == "swiglu" else x @ ws[0])
        r = rnd(*y.shape)
        grads = torch.autograd.grad((y * r).sum(), [x, *ws])
        want[fn] = {"y": y.detach(), "dx": grads[0],
                    **{"d" + n_: g for n_, g in zip(names, grads[1:])}}
        want[fn]["r"] = r
    return inp, want


def _train_ref(arch, mode):
    """The reference's jitted train step on its 1x1 mesh, on the batch
    of key ``BATCH_KEY`` (1 by default)."""
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import build_train_step
    from repro.optim import adamw as ref_adamw

    model, tree, params = _ref_pair(arch)
    ref_shape = _ref_shape(SMALL_TRAIN)
    mesh = make_test_mesh()
    fn, in_sh, out_sh, _, _ = build_train_step(
        model.cfg, ref_shape, mesh,
        dataclasses.replace(model.opts, sharding_mode=mode))
    batch = model.dummy_inputs(ref_shape,
                               jax.random.PRNGKey(BATCH_KEY.get(arch, 1)))
    jtree = jax.tree.map(jnp.asarray, tree)
    with mesh:
        p2, o2, m = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
            jtree, ref_adamw.init(jtree), batch)
    inp = {"params": params,
           "batch": {k: torch.from_numpy(np.array(v)) for k, v in
                     batch.items()}}
    return inp, {"params": _flat_np(jax.tree.map(np.asarray, p2)),
                 "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 "lr": float(m["lr"]), "step": int(o2["step"]),
                 # after one step m = (1 - b1) x the clipped gradient
                 "m": _flat_np(jax.tree.map(np.asarray, o2["m"]))}


def _compress_ref(arch):
    """The reference's ``adamw.update`` with int8 compression on the
    whole tree of its gradients (``jax.value_and_grad`` of the model's
    loss, as its train step takes them), from zero error feedback; and
    its quantised gradients and residuals leaf by leaf."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as ref_adamw

    model, tree, params = _ref_pair(arch)
    batch = model.dummy_inputs(_ref_shape(SMALL_TRAIN), jax.random.PRNGKey(1))
    jtree = jax.tree.map(jnp.asarray, tree)
    loss, grads = jax.value_and_grad(model.loss)(jtree, batch)
    err0 = ref_adamw.init_error_feedback(jtree)
    p2, o2, err, m = ref_adamw.update(
        ref_adamw.AdamWConfig(compress_grads=True), jtree, grads,
        ref_adamw.init(jtree), err0)
    g_np = _flat_np(jax.tree.map(np.asarray, grads))
    inp = {"params": params,
           "batch": {k: torch.from_numpy(np.array(v)) for k, v in
                     batch.items()},
           "grads": {k: torch.from_numpy(v.copy()) for k, v in g_np.items()}}
    pick = {i: _flat_np(jax.tree.map(
        lambda g, e: np.asarray(ref_adamw.compress_residual(g, e)[i]),
        grads, err0)) for i in (0, 1)}
    return inp, {"params": _flat_np(jax.tree.map(np.asarray, p2)),
                 "loss": float(loss), "grad_norm": float(m["grad_norm"]),
                 "lr": float(m["lr"]), "step": int(o2["step"]),
                 "m": _flat_np(jax.tree.map(np.asarray, o2["m"])),
                 "err": _flat_np(jax.tree.map(np.asarray, err)),
                 # each leaf's quantisation step: max |g| / 127
                 "scale": {k: float(np.abs(v).max()) / 127.0
                           for k, v in g_np.items()},
                 "g_hat": pick[0], "residual": pick[1]}


def _ref_shape(shape):
    from repro.configs.registry import ShapeSpec as RefShapeSpec
    return RefShapeSpec(shape.name, shape.seq_len, shape.global_batch,
                        shape.kind)


def _prefill_ref(arch):
    import jax.numpy as jnp
    model, tree, params = _ref_pair(arch)
    toks = np.random.default_rng(4).integers(
        0, model.cfg.vocab, (SMALL_PREFILL.global_batch,
                             SMALL_PREFILL.seq_len))
    logits, cache = model.prefill(tree, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)},
                                  max_len=SMALL_PREFILL.seq_len)
    return ({"params": params, "batch": {"tokens": torch.from_numpy(toks)}},
            {"logits": _np(logits),
             "cache": {k: np.asarray(v) for k, v in cache.items()}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's results and the reference's numbers they are held
    against: {"want": ..., world: {"results", "error"}}."""
    serve = _serve_inputs()
    seq_inp, seq_want = _seq_inputs()
    tp_inp, tp_want = _tp_inputs()
    train = _train_ref(TRAIN_ARCH, "auto")
    dp_only = _train_ref(DP_ONLY_ARCH, "dp_only")
    tp_train = {a: _train_ref(a, "auto") for a in {a for a, _ in TP_TRAIN}}
    compressed = _compress_ref(TRAIN_ARCH)
    prefill = {arch: _prefill_ref(arch) for arch in
               set(PREFILL_ARCHS + [TRAIN_ARCH] + [a for a, _ in TP_PREFILL])}
    base = tmp_path_factory.mktemp("dist")
    ckpt_dir = base / "ckpt"
    from repro_torch.checkpoint import checkpointing as ckpt
    elastic_tree = {"w": torch.arange(64.0).reshape(8, 8)}
    ckpt.save(ckpt_dir, 1, elastic_tree)

    jobs = {1: [], 2: [], 4: []}
    for arch in SERVE_ARCHS:
        for m in SERVE_MESHES:
            jobs[_world(m)].append((("serve", arch, m), "serve",
                                    serve[arch][0],
                                    {"arch": arch, "mesh_shape": m}))
    for m in SEQ_MESHES:
        for kind in SEQ_KINDS:
            jobs[_world(m)].append((("seq", kind, m), "seq_decode", seq_inp,
                                    {"kind": kind, "mesh_shape": m}))
    for m in TP_MESHES:
        for fn in TP_FNS:
            inp = dict(tp_inp, r=tp_want[fn]["r"])
            jobs[_world(m)].append((("tp", fn, m), "explicit_tp", inp,
                                    {"fn": fn, "mesh_shape": m}))
    for m in TRAIN_MESHES:
        jobs[_world(m)].append((("train", m), "train", train[0],
                                {"arch": TRAIN_ARCH, "mesh_shape": m,
                                 "mode": "auto"}))
    jobs[4].append((("train_pod", POD_MESH), "train", train[0],
                    {"arch": TRAIN_ARCH, "mesh_shape": POD_MESH,
                     "mode": "auto", "axes": POD_AXES}))
    jobs[2].append((("dp_only", (1, 2)), "train", dp_only[0],
                    {"arch": DP_ONLY_ARCH, "mesh_shape": (1, 2),
                     "mode": "dp_only"}))
    for arch in PREFILL_ARCHS:
        jobs[2].append((("prefill", arch), "prefill", prefill[arch][0],
                        {"arch": arch, "mesh_shape": (1, 2)}))
    for m in TP_MODEL_MESHES:
        jobs[_world(m)].append((("prefill_tp", m), "prefill",
                                prefill[TRAIN_ARCH][0],
                                {"arch": TRAIN_ARCH, "mesh_shape": m,
                                 "explicit": True}))
        jobs[_world(m)].append((("train_tp", m), "train", train[0],
                                {"arch": TRAIN_ARCH, "mesh_shape": m,
                                 "mode": "auto", "explicit": True}))
    for arch, m in TP_TRAIN:
        jobs[_world(m)].append((("tp_train", arch, m), "train",
                                tp_train[arch][0],
                                {"arch": arch, "mesh_shape": m,
                                 "mode": "auto"}))
    for arch, m in TP_PREFILL:
        jobs[_world(m)].append((("tp_prefill", arch, m), "prefill",
                                prefill[arch][0],
                                {"arch": arch, "mesh_shape": m}))
    for m in COMPRESS_MESHES:
        jobs[_world(m)].append((("compress", m), "train", compressed[0],
                                {"arch": TRAIN_ARCH, "mesh_shape": m,
                                 "mode": "auto", "compress": True}))
    for arch in AT_REST_ARCHS:
        _, tree, params = _ref_pair(arch)
        for m, axes in AT_REST:
            jobs[_world(m)].append((("rest", arch, m), "at_rest",
                                    {"params": params},
                                    {"arch": arch, "mesh_shape": m,
                                     "axes": axes}))
    jobs[4].append((("elastic",), "elastic", {"dir": str(ckpt_dir)}, {}))

    groups = {w: _spawn(base / f"world{w}", w, j) for w, j in jobs.items()}
    out = {w: _join(g) for w, g in groups.items()}
    out["want"] = {"serve": {a: v[1] for a, v in serve.items()},
                   "seq": seq_want, "tp": tp_want, "train": train[1],
                   "dp_only": dp_only[1],
                   "tp_train": {a: v[1] for a, v in tp_train.items()},
                   "compress": compressed[1],
                   "prefill": {a: v[1] for a, v in prefill.items()},
                   "elastic": elastic_tree["w"]}
    return out


def _result(runs, world, key):
    got = runs[world]["results"].get(key)
    if got is None:
        pytest.fail(f"the {world}-rank group did not return {key}: "
                    f"{runs[world]['error']}")
    return got


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _tol(mesh_shape, base=RANK_TOL):
    return max(base, SPLIT_TOL) if _world(mesh_shape) > 1 else base


# ---- 1. sharding rules -----------------------------------------------------
RULE_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ref_mesh(sizes: dict):
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _spec_tree(tree) -> dict:
    from repro_torch.models.convert import flat_items
    return {k: tuple(v) for k, v in flat_items(tree)}


@pytest.mark.parametrize("mesh_name", list(RULE_MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_rules_match_reference(arch, shape_name, mesh_name):
    from repro.configs.registry import SHAPES as REF_SHAPES
    from repro.configs.registry import get_config as ref_get_config
    from repro.launch import shardings as ref_sh
    from repro.models.model import get_model as ref_get_model

    sizes = RULE_MESHES[mesh_name]
    mesh, ref_mesh = sizes, _ref_mesh(sizes)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    shape, ref_shape = SHAPES[shape_name], REF_SHAPES[shape_name]
    multi_pod = "pod" in sizes
    pairs = {
        "param": (sh.param_pspecs(cfg), ref_sh.param_pspecs(ref_cfg)),
        "moment": (sh.moment_pspecs(cfg, multi_pod),
                   ref_sh.moment_pspecs(ref_cfg, multi_pod)),
        "batch": (sh.batch_pspecs(cfg, shape, mesh),
                  ref_sh.batch_pspecs(ref_cfg, ref_shape, ref_mesh)),
        "cache": (sh.cache_pspecs(cfg, shape, mesh),
                  ref_sh.cache_pspecs(ref_cfg, ref_shape, ref_mesh)),
        "strip_tp": (sh.strip_tp(sh.param_pspecs(cfg)),
                     ref_sh.strip_tp(ref_sh.param_pspecs(ref_cfg))),
        "strip_fsdp": (sh.strip_fsdp(sh.param_pspecs(cfg)),
                       ref_sh.strip_fsdp(ref_sh.param_pspecs(ref_cfg))),
    }
    model, ref_model = sh._model(cfg), ref_get_model(ref_cfg)
    b, s = shape.global_batch, shape.seq_len
    pairs["param_sanitized"] = (
        sh.sanitize_tree(pairs["param"][0], model.param_specs(), mesh),
        ref_sh.sanitize_tree(pairs["param"][1], ref_model.param_specs(),
                             ref_mesh))
    pairs["cache_sanitized"] = (
        sh.sanitize_tree(pairs["cache"][0], model.cache_specs(b, s), mesh),
        ref_sh.sanitize_tree(pairs["cache"][1], ref_model.cache_specs(b, s),
                             ref_mesh))
    for what, (port, ref) in pairs.items():
        assert _spec_tree(port) == _spec_tree(ref), what
    assert sh.tp_applies(cfg, shape) == ref_sh.tp_applies(ref_cfg, ref_shape)
    for mode in ("2d", "dp_only"):
        assert sh.tp_applies(cfg, shape, mode) == \
            ref_sh.tp_applies(ref_cfg, ref_shape, mode)
    assert sh.weight_stationary_serving(cfg) == \
        ref_sh.weight_stationary_serving(ref_cfg)
    assert sh.dp_axes(mesh) == ref_sh.dp_axes(ref_mesh)


def test_tp_policy_and_sanitize_as_the_reference_states_them():
    assert not sh.tp_applies(get_config("musicgen_medium"), SHAPES["train_4k"])
    assert sh.tp_applies(get_config("qwen1_5_110b"), SHAPES["train_4k"])
    assert sh.tp_applies(get_config("musicgen_medium"), SHAPES["decode_32k"])
    assert sh.weight_stationary_serving(get_config("internlm2_20b"))
    assert not sh.weight_stationary_serving(get_config("qwen1_5_110b"))
    mesh = {"data": 16, "model": 16}
    assert sh.sanitize_pspec(sh.P("model", "data"), (32001, 1600), mesh) == \
        sh.P(None, "data")


# ---- 2. state at rest ------------------------------------------------------
def _numpy_block(full: np.ndarray, spec, coord: dict, sizes: dict):
    """The block of ``full`` that JAX's PartitionSpec puts at ``coord``."""
    out = full
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        out = np.split(out, n, axis=dim)[idx]
    return out


@pytest.mark.parametrize("mesh_shape,axes", AT_REST,
                         ids=["x".join(map(str, m)) for m, _ in AT_REST])
@pytest.mark.parametrize("arch", AT_REST_ARCHS)
def test_state_at_rest_is_the_reference_layout(runs, arch, mesh_shape, axes):
    got = _result(runs, _world(mesh_shape), ("rest", arch, mesh_shape))
    _, tree, _ = _ref_pair(arch)
    flat = _flat_np(tree)
    sizes = dict(zip(axes, mesh_shape))
    strided = 0
    for rank_blocks in got["blocks"]:
        coord = rank_blocks["coord"]
        for name, spec in got["specs"].items():
            want = _numpy_block(flat[name.split(":", 1)[1]], spec, coord,
                                sizes)
            np.testing.assert_array_equal(rank_blocks[name].numpy(), want,
                                          err_msg=f"{name} at {coord}")
            strided += any(isinstance(e, tuple) for e in spec)
    # the (pod, data, model) mesh holds the moments' ("data", "pod") dims
    assert (strided > 0) == ("pod" in axes)


# ---- 3. serve step ---------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", SERVE_MESHES,
                         ids=["x".join(map(str, m)) for m in SERVE_MESHES])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_step_matches_reference_decode(runs, arch, mesh_shape):
    got = _result(runs, _world(mesh_shape), ("serve", arch, mesh_shape))
    want = runs["want"]["serve"][arch]
    tol = _tol(mesh_shape, MODEL_TOL)
    _close(got["logits"], want["logits"], tol)
    assert set(got["cache"]) == set(want["cache"])
    for k, v in want["cache"].items():
        if k == "t":
            assert int(got["cache"][k]) == int(v) == 11
        else:
            _close(got["cache"][k], v, tol)


# ---- 4. sequence-sharded decode --------------------------------------------
@pytest.mark.parametrize("mesh_shape", SEQ_MESHES,
                         ids=["x".join(map(str, m)) for m in SEQ_MESHES])
@pytest.mark.parametrize("kind", SEQ_KINDS)
def test_seq_shard_decode_matches_unsharded_decode(runs, kind, mesh_shape):
    got = _result(runs, _world(mesh_shape), ("seq", kind, mesh_shape))
    want = runs["want"]["seq"]
    s_loc = SEQ_W // mesh_shape[1]
    shards = set()
    for t, out in got.items():
        w = want[(kind, t)]
        _close(out["out"], w["out"], SPLIT_TOL)
        torch.testing.assert_close(out["k"], w["k"], atol=0, rtol=0)
        torch.testing.assert_close(out["v"], w["v"], atol=0, rtol=0)
        shards.add((t if kind == "full" else t % SEQ_W) // s_loc)
    assert {0, mesh_shape[1] - 1} <= shards
    if kind != "full":
        assert max(got) >= SEQ_W          # past one wrap of the ring


# ---- 5. explicit TP --------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", TP_MESHES,
                         ids=["x".join(map(str, m)) for m in TP_MESHES])
@pytest.mark.parametrize("fn", TP_FNS)
def test_explicit_tp_values_and_gradients_match_plain(runs, fn, mesh_shape):
    got = _result(runs, _world(mesh_shape), ("tp", fn, mesh_shape))
    want = runs["want"]["tp"][fn]
    assert set(got) == set(want) - {"r"}
    for k in got:
        _close(got[k], want[k], SPLIT_TOL)


# ---- 6. train step ---------------------------------------------------------
def _check_train(got, want, tol):
    m = got["metrics"]
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=tol)
    np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"],
                               rtol=tol)
    np.testing.assert_allclose(float(m["lr"]), want["lr"], rtol=RANK_TOL)
    assert int(got["step"]) == want["step"] == 1
    assert set(got["params"]) == set(want["params"]) == set(got["m"])
    for k, v in want["params"].items():
        _close(got["params"][k], v, tol)
    # the gradients, through the first moment: each leaf within GRAD_TOL
    # (or SPLIT_TOL) x its largest |m|, as tests/test_torch_train.py holds
    # the port's gradients
    for k, v in want["m"].items():
        scale = max(GRAD_TOL, tol) * float(np.abs(v).max())
        np.testing.assert_allclose(_np(got["m"][k]), v, atol=scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("mesh_shape", TRAIN_MESHES,
                         ids=["x".join(map(str, m)) for m in TRAIN_MESHES])
def test_train_step_matches_reference(runs, mesh_shape):
    got = _result(runs, _world(mesh_shape), ("train", mesh_shape))
    _check_train(got, runs["want"]["train"], _tol(mesh_shape))


def test_multi_pod_train_step_with_zero1_moments_matches_reference(runs):
    got = _result(runs, 4, ("train_pod", POD_MESH))
    _check_train(got, runs["want"]["train"], SPLIT_TOL)


def test_pure_dp_train_step_matches_reference(runs):
    assert not sh.tp_applies(get_config(DP_ONLY_ARCH), SHAPES["train_4k"])
    got = _result(runs, 2, ("dp_only", (1, 2)))
    # pure DP: the batch is split over both mesh axes
    assert got["batch_placements"].count("Shard(dim=0)") == 2
    _check_train(got, runs["want"]["dp_only"], SPLIT_TOL)


@pytest.mark.parametrize("mesh_shape", TP_MODEL_MESHES,
                         ids=["x".join(map(str, m)) for m in TP_MODEL_MESHES])
def test_explicit_tp_train_step_matches_reference(runs, mesh_shape):
    got = _result(runs, _world(mesh_shape), ("train_tp", mesh_shape))
    _check_train(got, runs["want"]["train"], SPLIT_TOL)


# ---- 7. prefill step -------------------------------------------------------
@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_step_matches_reference_prefill(runs, arch):
    got = _result(runs, 2, ("prefill", arch))
    want = runs["want"]["prefill"][arch]
    _close(got["logits"], want["logits"], MODEL_TOL)
    assert set(got["cache"]) == set(want["cache"])
    for k, v in want["cache"].items():
        _close(got["cache"][k], v, WKV_TOL if k == "wkv" else MODEL_TOL)
    # the cache is laid out by its spec: something split over 'model'
    assert any("Shard" in p for p in got["placements"].values())


@pytest.mark.parametrize("mesh_shape", TP_MODEL_MESHES,
                         ids=["x".join(map(str, m)) for m in TP_MODEL_MESHES])
def test_explicit_tp_prefill_step_matches_reference(runs, mesh_shape):
    got = _result(runs, _world(mesh_shape), ("prefill_tp", mesh_shape))
    want = runs["want"]["prefill"][TRAIN_ARCH]
    _close(got["logits"], want["logits"], SPLIT_TOL)
    for k, v in want["cache"].items():
        _close(got["cache"][k], v, SPLIT_TOL)


# ---- 8. the split over 'model', every family ------------------------------
@pytest.mark.parametrize("arch,mesh_shape", TP_TRAIN,
                         ids=[f"{a}-{'x'.join(map(str, m))}"
                              for a, m in TP_TRAIN])
def test_tensor_parallel_train_step_matches_reference(runs, arch, mesh_shape):
    got = _result(runs, _world(mesh_shape), ("tp_train", arch, mesh_shape))
    _check_train(got, runs["want"]["tp_train"][arch], SPLIT_TOL)


@pytest.mark.parametrize("arch,mesh_shape", TP_PREFILL,
                         ids=[f"{a}-{'x'.join(map(str, m))}"
                              for a, m in TP_PREFILL])
def test_tensor_parallel_prefill_step_matches_reference(runs, arch,
                                                        mesh_shape):
    got = _result(runs, _world(mesh_shape), ("tp_prefill", arch,
                                             mesh_shape))
    want = runs["want"]["prefill"][arch]
    _close(got["logits"], want["logits"], SPLIT_TOL)
    assert set(got["cache"]) == set(want["cache"])
    for k, v in want["cache"].items():
        _close(got["cache"][k], v, WKV_TOL if k == "wkv" else SPLIT_TOL)
    # the logits stay split over the vocabulary ('model' is the mesh's
    # last dim), as the reference's logits spec says
    assert "Shard(dim=1)" in got["logits_placements"]


@pytest.mark.parametrize("mesh_shape", COMPRESS_MESHES,
                         ids=["x".join(map(str, m)) for m in COMPRESS_MESHES])
def test_int8_compression_of_sharded_gradients_is_the_references(
        runs, mesh_shape):
    got = _result(runs, _world(mesh_shape), ("compress", mesh_shape))
    want = runs["want"]["compress"]
    assert set(got["g_hat"]) == set(want["g_hat"])
    for k, v in want["g_hat"].items():
        np.testing.assert_array_equal(got["g_hat"][k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(got["residual"][k].numpy(),
                                      want["residual"][k], err_msg=k)


@pytest.mark.parametrize("mesh_shape", COMPRESS_MESHES,
                         ids=["x".join(map(str, m)) for m in COMPRESS_MESHES])
def test_compressed_train_step_matches_reference(runs, mesh_shape):
    got = _result(runs, _world(mesh_shape), ("compress", mesh_shape))
    want = runs["want"]["compress"]
    m = got["metrics"]
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=SPLIT_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"],
                               rtol=SPLIT_TOL)
    np.testing.assert_allclose(float(m["lr"]), want["lr"], rtol=RANK_TOL)
    assert int(got["step"]) == want["step"] == 1
    for k, v in want["params"].items():
        _close(got["params"][k], v, SPLIT_TOL)
    clip = min(1.0, 1.0 / want["grad_norm"])
    for k, v in want["m"].items():
        step = 0.1 * clip * want["scale"][k]
        np.testing.assert_allclose(
            _np(got["m"][k]), v, rtol=0,
            atol=step + SPLIT_TOL * float(np.abs(v).max()), err_msg=k)
        e = want["err"][k]
        np.testing.assert_allclose(
            _np(got["err"][k]), e, rtol=0,
            atol=want["scale"][k] + SPLIT_TOL * float(np.abs(e).max()),
            err_msg=k)


# ---- 9. elastic ------------------------------------------------------------
def test_restore_onto_a_mesh_then_shrink_and_reshard(runs):
    got = _result(runs, 4, ("elastic",))
    want = runs["want"]["elastic"]
    assert got["step"] == 1 and got["local_rows"] == 4
    assert got["smaller"] == (1, 2)
    torch.testing.assert_close(got["restored"], want, atol=0, rtol=0)
    torch.testing.assert_close(got["moved"], want, atol=0, rtol=0)
    assert got["moved_local"] == (8, 4)
