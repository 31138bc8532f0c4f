"""The port's dry-run (``launch/{dryrun,op_analysis,collectives}.py``) on
the CPU, against the reference's HLO analysis.

The reference's four claims of ``tests/test_hlo_analysis.py`` are held
on the port's recorders: FLOPs exact through a loop with backward and
through nested loops, the wire-byte model per collective kind, and a
collective in a loop counted each time it runs.  Then, for a reduced
config of each family and each step kind, the port's dry-run FLOPs at
world 1 equal the reference's ``hlo_analysis`` of the compiled step on
jax's one CPU device (rel 2%, the reference's tolerance); the per-rank
argument bytes on the production meshes equal the reference's sharding
rules; the split of the computation over 'model' is pinned; and one
full-size cell runs end to end.  Every fake process group is torn
down (``clean_group``); no test starts another interpreter.
"""
from __future__ import annotations

import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.cluster import gpu_profiles
from repro_torch.configs.registry import ShapeSpec, get_config, reduced
from repro_torch.launch import collectives, dryrun, op_analysis
from repro_torch.launch.mesh import (fake_process_group,
                                     make_production_mesh, make_test_mesh)
from repro_torch.models.model import RunOptions

FLOP_RTOL = 0.02      # tests/test_hlo_analysis.py:28


@pytest.fixture(autouse=True)
def clean_group():
    """No process group before a test, and none left after it, even when
    the test failed inside one."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a test left a process group initialised")


def _flops(fn, *args) -> float:
    with op_analysis.analyzing(args) as state:
        out = fn(*args)
    return op_analysis.finish(state, out)["flops"]


# ---- the reference's four claims -------------------------------------------

def test_flops_exact_through_loop():
    """fwd + dx + dw of every layer; x takes a gradient too, so layer 0's
    dx runs, as in the reference's scan body."""
    L, B, D = 7, 8, 64
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, D, generator=g, requires_grad=True)
    w = torch.randn(L, D, D, generator=g, requires_grad=True)

    def step(x, w):
        c = x
        for layer in range(L):
            c = torch.tanh(c @ w[layer])
        return torch.autograd.grad((c ** 2).sum(), [x, w])

    true = 3 * L * 2 * B * D * D
    assert _flops(step, x, w) == pytest.approx(true, rel=FLOP_RTOL)


def test_nested_loops_multiply():
    L_out, L_in, D = 3, 5, 32
    x = torch.ones(4, D)
    w = torch.full((L_out, D, D), 1.0 / D)

    def f(x, w):
        c = x
        for wo in w:
            for _ in range(L_in):
                c = c @ wo
        return c.sum()

    true = L_out * L_in * 2 * 4 * D * D
    assert _flops(f, x, w) == pytest.approx(true, rel=FLOP_RTOL)


def test_collective_wire_bytes_model():
    with fake_process_group(8):
        group = dist.new_group([0, 1, 2, 3])
        rec = collectives.CollectiveRecorder()
        with rec:
            t = torch.zeros(8, 16)
            dist.all_reduce(t, group=group)
            out = torch.empty(32, 16)
            dist.all_gather_into_tensor(out, t, group=group)
        res = rec.summary()
    ar_bytes = 8 * 16 * 4
    ag_bytes = 32 * 16 * 4
    expected = 2 * (3 / 4) * ar_bytes + (3 / 4) * ag_bytes
    assert res["total_wire_bytes"] == pytest.approx(expected)
    assert res["n_collectives"] == 2
    assert [i[:3] for i in res["items"]] == [
        ("all-reduce", ar_bytes, 4), ("all-gather", ag_bytes, 4)]


def test_collectives_inside_loop_counted_each_run():
    with fake_process_group(4):
        rec = collectives.CollectiveRecorder()
        c = torch.ones(4, 8)
        with rec:
            for _ in range(6):
                s = c.sum().reshape(1)
                dist.all_reduce(s)
                c = c * s
        res = rec.summary()
    assert sum(i[3] for i in res["items"] if i[0] == "all-reduce") == 6
    assert res["total_wire_bytes"] == pytest.approx(6 * 2 * (3 / 4) * 4)


# ---- parity with the reference's dry-run analysis at world 1 --------------

PARITY_ARCHS = {"dense": "internlm2_1_8b", "ssm": "rwkv6_1_6b",
                "hybrid": "hymba_1_5b", "moe": "mixtral_8x22b"}


def _ref_flops(arch: str, kind: str, seq: int, batch: int) -> float:
    from repro.configs.registry import ShapeSpec as RefShape
    from repro.configs.registry import get_config as ref_get_config
    from repro.configs.registry import reduced as ref_reduced
    from repro.launch import hlo_analysis
    from repro.launch import steps as ref_steps
    from repro.launch.mesh import make_test_mesh as ref_test_mesh
    from repro.models.model import RunOptions as RefRunOptions

    cfg = ref_reduced(ref_get_config(arch))
    mesh = ref_test_mesh()
    fn, in_sh, out_sh, specs, donate = ref_steps.build_step(
        cfg, RefShape("parity", seq, batch, kind), mesh, RefRunOptions())
    with mesh:
        compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(*specs).compile()
    return hlo_analysis.analyze(compiled.as_text())["flops"]


def _port_trace(cfg, shape, mesh_shape=(1, 1), axes=("data", "model")):
    with fake_process_group(math.prod(mesh_shape)):
        mesh = make_test_mesh(mesh_shape, axes, device_type="cpu")
        return dryrun.trace_step(cfg, shape, mesh, RunOptions())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(PARITY_ARCHS))
def test_flops_match_reference_hlo_analysis_at_world_1(family, kind):
    """The same plain math on both sides (``RunOptions()``: no kernels,
    remat "full"), so the products agree."""
    arch = PARITY_ARCHS[family]
    seq, batch = 64, 2
    ref = _ref_flops(arch, kind, seq, batch)
    port = _port_trace(reduced(get_config(arch)),
                       ShapeSpec("parity", seq, batch, kind))["flops"]
    assert ref > 0
    assert port == pytest.approx(ref, rel=FLOP_RTOL)


# ---- per-rank argument bytes on the production meshes ---------------------

PROD_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ref_arg_specs(arch: str, shape, sizes: dict) -> list:
    """(spec, shape, dtype) of every argument leaf of the reference's step
    for ``shape``, by the reference's rules on an {axis: size} stand-in
    mesh (the leaves ``repro.launch.steps`` passes, laid out as it lays
    them out)."""
    import types

    from repro.configs.registry import ShapeSpec as RefShape
    from repro.configs.registry import get_config as ref_get_config
    from repro.configs.registry import reduced as ref_reduced
    from repro.launch import shardings as ref_sh
    from repro.models.model import get_model as ref_get_model

    cfg = ref_reduced(ref_get_config(arch))
    rshape = RefShape(shape.name, shape.seq_len, shape.global_batch,
                      shape.kind)
    mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))
    model = ref_get_model(cfg)
    p_specs = model.param_specs()
    leaves = []

    def add(specs, shapes):
        specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        shapes = jax.tree.leaves(shapes)
        assert len(specs) == len(shapes)
        leaves.extend((p, s.shape, s.dtype) for p, s in zip(specs, shapes))

    if rshape.kind == "train":
        assert ref_sh.tp_applies(cfg, rshape)
        dp = ref_sh.dp_axes(mesh)
        p = ref_sh.sanitize_tree(ref_sh.param_pspecs(cfg), p_specs, mesh)
        m = ref_sh.sanitize_tree(
            ref_sh.moment_pspecs(cfg, "pod" in sizes), p_specs, mesh)
        add(p, p_specs)
        f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape,
                                                          np.float32),
                           p_specs)
        add(m, f32)
        add(m, f32)
        leaves.append(((), (), np.int32))
        add(ref_sh.batch_pspecs(cfg, rshape, mesh, dp=dp),
            model.input_specs(rshape))
    else:
        assert rshape.kind == "decode"
        raw = ref_sh.param_pspecs(cfg)
        if ref_sh.weight_stationary_serving(cfg):
            raw = ref_sh.strip_fsdp(raw)
        add(ref_sh.sanitize_tree(raw, p_specs, mesh), p_specs)
        c_shapes = model.cache_specs(rshape.global_batch, rshape.seq_len)
        add(ref_sh.sanitize_tree(ref_sh.cache_pspecs(cfg, rshape, mesh),
                                 c_shapes, mesh), c_shapes)
        dp = ref_sh.dp_axes(mesh)
        bdim = dp if rshape.global_batch >= math.prod(
            sizes[a] for a in dp) else None
        leaves.append((ref_sh.sanitize_pspec(
            jax.sharding.PartitionSpec(bdim, None),
            (rshape.global_batch, 1), mesh), (rshape.global_batch, 1),
            np.int32))
    return leaves


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("mesh_name", list(PROD_MESHES))
def test_per_rank_argument_bytes_follow_the_reference_rules(mesh_name, kind):
    """argument_bytes = sum over leaves of the leaf's bytes / the product
    of the mesh sizes of its spec's axes, exactly."""
    arch = "internlm2_1_8b"
    sizes = PROD_MESHES[mesh_name]
    shape = ShapeSpec("rest", 64, 32, kind)
    want = 0
    for spec, shp, dtype in _ref_arg_specs(arch, shape, sizes):
        split = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else
                      (() if entry is None else (entry,))):
                split *= sizes[a]
        nbytes = math.prod(shp) * np.dtype(dtype).itemsize
        assert nbytes % split == 0
        want += nbytes // split
    got = _port_trace(reduced(get_config(arch)), shape,
                      tuple(sizes.values()), tuple(sizes))
    assert got["memory"]["argument_bytes"] == want


# ---- the split over 'model' ------------------------------------------------

SPLIT_RTOL = 0.15       # the reduced config's 2 kv heads over 4 ranks


def test_train_step_splits_compute_over_model_axis():
    """Each rank of the port's train step computes its 'model' share of
    every product (``launch/steps.py``), as GSPMD does: on (1, 4) a rank
    of the reduced InternLM2 runs within 15% of a quarter of the (1, 1)
    step's FLOPs (its 2 kv heads do not divide 4, so each rank computes
    the kv head its q head reads: 1.083 of a quarter), and exchanges
    collectives; tests/test_torch_tensor_parallel.py holds every family
    to the reference's counts."""
    cfg = reduced(get_config("internlm2_1_8b"))
    shape = ShapeSpec("split", 64, 8, "train")
    split = _port_trace(cfg, shape, (1, 4))
    one = _port_trace(cfg, shape)
    assert split["flops"] == pytest.approx(one["flops"] / 4, rel=SPLIT_RTOL)
    assert split["collectives"]["n_collectives"] > 0
    assert one["collectives"]["n_collectives"] == 0


# ---- the production mesh and the calibration ------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_the_references(multi_pod):
    with pytest.raises(RuntimeError, match="no process group"):
        make_production_mesh(multi_pod=multi_pod)
    world = 512 if multi_pod else 256
    with fake_process_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_process_group(8):
                pass
    assert not dist.is_initialized()


def test_calibrated_overhead_reads_the_decode_record(tmp_path, monkeypatch):
    monkeypatch.setattr(gpu_profiles, "DRYRUN_DIR", tmp_path)
    assert gpu_profiles._calibrated_overhead("internlm2_20b") == 1.3
    rec = tmp_path / "internlm2_20b__decode_32k__single.json"
    rec.write_text(json.dumps({"roofline": {"useful_ratio": 0.5}}))
    assert gpu_profiles._calibrated_overhead("internlm2_20b") == 2.0
    rec.write_text(json.dumps({"roofline": {"useful_ratio": 0.9}}))
    assert gpu_profiles._calibrated_overhead("internlm2_20b") == \
        pytest.approx(1 / 0.9)
    rec.write_text("{not json")
    assert gpu_profiles._calibrated_overhead("internlm2_20b") == 1.3


def test_full_size_decode_cell_and_its_calibration(tmp_path, monkeypatch):
    """InternLM2-20B decode_32k on 16 x 16, end to end: the record's
    schema, the card's memory flag, and the calibration it feeds (split
    over 'model' as GSPMD splits it, the step's useful ratio is at least
    0.5, and the overhead its reciprocal, unclipped)."""
    monkeypatch.setattr(gpu_profiles, "DRYRUN_DIR", tmp_path)
    out = dryrun.run_cell("internlm2_20b", "decode_32k", multi_pod=False)
    assert out["status"] == "ok", out.get("traceback")
    assert out["n_chips"] == 256 and out["peaks"] == "H100 SXM"
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "peak_bytes_est"):
        assert out["memory"][key] >= 0
    m = out["memory"]
    assert m["peak_bytes_est"] == m["argument_bytes"] + \
        m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"]
    assert m["alias_bytes"] > 0                  # the cache, in place
    assert "fits_h100_sxm_80g" in out
    r = out["roofline"]
    assert r["flops_per_device"] == out["cost"]["flops"] > 0
    assert 0.5 <= r["useful_ratio"] <= 1
    saved = json.loads(
        (tmp_path / "internlm2_20b__decode_32k__single.json").read_text())
    assert saved["cost"] == out["cost"]
    assert gpu_profiles._calibrated_overhead("internlm2_20b") == \
        pytest.approx(1 / r["useful_ratio"])
    assert not dist.is_initialized()


def test_failing_cell_is_reported_and_fails_main(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(gpu_profiles, "DRYRUN_DIR", tmp_path)

    def broken(*a, **k):
        raise ValueError("traced nothing")

    monkeypatch.setattr(dryrun, "trace_step", broken)
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "internlm2_1_8b", "--shape", "decode_32k",
                     "--mesh", "single"])
    assert "ERROR ValueError: traced nothing" in capsys.readouterr().out
    rec = json.loads((tmp_path / "internlm2_1_8b__decode_32k__single.json"
                      ).read_text())
    assert rec["status"] == "error"
    assert not dist.is_initialized()
    skip = dryrun.run_cell("internlm2_20b", "long_500k", multi_pod=False)
    assert skip["applicable"] is False and "skip_reason" in skip
