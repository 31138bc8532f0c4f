"""Multi-pod dry-run: a step's per-rank cost on the production mesh,
traced on one host that touches no device.

For every (architecture x input shape) cell: start a fake process group
of 256 ranks (16 x 16, single pod) or 512 (2 x 16 x 16, multi-pod), build
the production mesh over it, build the cell's step (``launch/steps.py``)
and run it once, as rank 0, on DTensors whose local blocks are fake
tensors (``FakeTensorMode``: shapes and dtypes, no data).  Three recorders
watch the run: ``FlopCounterMode`` for the FLOPs, ``op_analysis.OpBytes``
for the bytes and the memory, ``collectives.CollectiveRecorder`` for the
collectives and their wire bytes.  The roofline terms use the card's
data-sheet peaks (``launch/roofline.py``, the H100 SXM unless
``--device-name`` names another) and the mesh's 'model' width.  Each
record goes to ``build/dryrun/<cell>.json``; a failing cell is recorded
as an error, as a bug report, and makes ``main`` exit nonzero.

The numbers are per rank, as they are.  The port's steps split the
computation over 'model' as GSPMD does (``launch/steps.py``), so a
rank's FLOPs come to the reference's per-device count where GSPMD splits
evenly (``tests/test_torch_tensor_parallel.py``); they are not rescaled.
A hand-written CUDA kernel is no aten op: ``FlopCounterMode`` does not
see it, on the card or here, and on fake CUDA tensors (``device``) its
wrapper launches nothing (``kernels/flash_attention/ops.py``).

The reference's ``--causal-pair-scan`` is left out: it sets a
``RunOptions`` field that nothing in the reference reads, and the port's
``RunOptions`` has no such field.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2_20b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import json
import re
import time
import traceback

import torch

from repro_torch.cluster import gpu_profiles
from repro_torch.configs.registry import (ARCH_IDS, SHAPES, ModelConfig,
                                          ShapeSpec, cell_applicable,
                                          get_config)
from repro_torch.launch import collectives as coll
from repro_torch.launch import op_analysis
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models.model import RunOptions

DEFAULT_DEVICE = "H100 SXM"


def _fake_inputs(specs, placements, mesh, mode, device="cpu"):
    """DTensors of the meta ``specs`` laid out by ``placements``, each
    local block a fake tensor on ``device``.  A block's shape is the
    spec's divided by the mesh dims that shard it (``launch/steps.py``
    makes every shard even), computed outside fake mode."""
    from torch.distributed.tensor import DTensor

    if isinstance(specs, dict):
        return {k: _fake_inputs(v, placements[k], mesh, mode, device)
                for k, v in specs.items()}
    shape = list(specs.shape)
    for i, p in enumerate(placements):
        dim = getattr(p, "dim", None)
        if dim is not None:
            shape[dim] //= mesh.size(i)
    with mode:
        local = torch.empty(shape, dtype=specs.dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=specs.shape, stride=specs.stride())


def trace_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
               opts: RunOptions = RunOptions()) -> dict:
    """Build the cell's step on ``mesh`` (over an initialised process
    group, fake or not) and run it once on fake inputs on the mesh's
    device type (the CPU's for the production mesh) under the three
    recorders: {'flops', 'bytes', 'memory', 'collectives', 'trace_s'}."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    fn, in_pl, _, input_specs, _ = build_step(cfg, shape, mesh, opts)
    mode = FakeTensorMode()
    args = tuple(_fake_inputs(s, p, mesh, mode, mesh.device_type)
                 for s, p in zip(input_specs, in_pl))
    rec = coll.CollectiveRecorder()
    with mode, op_analysis.analyzing(args) as state, rec:
        outputs = fn(*args)
    out = op_analysis.finish(state, outputs)
    out["collectives"] = rec.summary()
    out["trace_s"] = time.perf_counter() - t0
    return out


def _fits_key(peaks: rf.DevicePeaks) -> str:
    """The record's key for "the peak fits the card's memory", naming the
    card and its size (the reference's ``fits_hbm16g``)."""
    slug = re.sub(r"\W+", "_", peaks.name.lower())
    return f"fits_{slug}_{peaks.hbm_bytes / 1e9:g}g"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opts: RunOptions = RunOptions(), save: bool = True,
             tag: str = "", device_name: str = DEFAULT_DEVICE) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    cell = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    out: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "tag": tag, "applicable": ok}
    if not ok:
        out["skip_reason"] = why
        if save:
            _save(cell, out)
        return out

    try:
        peaks = rf.device_peaks(device_name)
        n_chips = 512 if multi_pod else 256
        with fake_process_group(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod)
            model_axis = mesh.size(list(mesh.mesh_dim_names).index("model"))
            traced = trace_step(cfg, shape, mesh, opts)
        cinfo = traced["collectives"]
        terms = rf.roofline(cfg, shape, traced["flops"], traced["bytes"],
                            cinfo["total_wire_bytes"], n_chips, peaks,
                            model_axis)
        out.update({
            "status": "ok",
            "n_chips": n_chips,
            "trace_s": traced["trace_s"],
            "peaks": peaks.name,
            "memory": traced["memory"],
            "cost": {"flops": traced["flops"],
                     "bytes_upper": traced["bytes"],
                     "bytes_analytic": rf.analytic_memory_bytes(
                         cfg, shape, n_chips, model_axis)},
            "collectives": {k: v for k, v in cinfo.items() if k != "items"},
            "collective_items": cinfo["items"][:64],
            "roofline": terms.to_dict(),
        })
        out[_fits_key(peaks)] = bool(
            out["memory"]["peak_bytes_est"] <= peaks.hbm_bytes)
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        out.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    if save:
        _save(cell, out)
    return out


def _save(cell: str, out: dict):
    gpu_profiles.DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    with open(gpu_profiles.DRYRUN_DIR / f"{cell}.json", "w") as f:
        json.dump(out, f, indent=1, default=str)


def _fmt(out: dict) -> str:
    if not out.get("applicable", True):
        return f"SKIP ({out['skip_reason'][:60]})"
    if out.get("status") != "ok":
        return f"ERROR {out.get('error', '?')[:120]}"
    r = out["roofline"]
    mem_gb = out["memory"]["peak_bytes_est"] / 1e9
    return (f"ok trace={out['trace_s']:.1f}s mem={mem_gb:.2f}GB "
            f"comp={r['compute_s']*1e3:.2f}ms mem={r['memory_s']*1e3:.2f}ms "
            f"coll={r['collective_s']*1e3:.2f}ms dom={r['dominant'][:4]} "
            f"useful={r['useful_ratio']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--tag", default="")
    ap.add_argument("--sharding", default="auto",
                    choices=["auto", "2d", "dp_only"])
    ap.add_argument("--no-seq-shard-decode", action="store_true")
    ap.add_argument("--explicit-tp", action="store_true")
    ap.add_argument("--device-name", default=DEFAULT_DEVICE,
                    help="the card whose data-sheet peaks price the "
                    "roofline (launch/roofline.py DEVICE_PEAKS)")
    args = ap.parse_args(argv)

    opts = RunOptions(remat=args.remat, attn_chunk=args.attn_chunk,
                      sharding_mode=args.sharding,
                      seq_shard_decode=not args.no_seq_shard_decode,
                      explicit_tp_ffn=args.explicit_tp)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                out = run_cell(arch, shape, mp, opts, tag=args.tag,
                               device_name=args.device_name)
                print(f"{arch:26s} {shape:12s} "
                      f"{'multi ' if mp else 'single'} {_fmt(out)}",
                      flush=True)
                if out.get("status") == "error":
                    n_fail += 1
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
