"""Serving launcher: real-compute ESG serving on the card.

``--real`` serves a model on this host through the full control plane:
scenario arrivals enter via the Gateway, ESG_1Q plans batches against a
*measured* profile table (``launch/profile_kernels``), and every
dispatched task is executed for real by ``serving.executor.TorchExecutor``
(CUDA flash-attention prefill + flash-decode steps).  ``--bench-out``
writes the predicted-vs-measured comparison.

Emulate mode (the zoo of per-arch profiles on an emulated cluster) waits
for an H100 counterpart of the reference's TPU zoo profiles (ROADMAP
item 4).

    PYTHONPATH=src python -m repro_torch.launch.serve --real \
        --prompt-len 128 --gen-len 16 --n 24 --bench-out build/serve.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.cluster.emulator import ClusterSim
from repro_torch.core.profiles import Config, ProfileTable
from repro_torch.core.scheduler import ESGScheduler
from repro_torch.core.workflows import Workflow


def _serve_once(arch: str, table: ProfileTable, scenario: str,
                n_requests: int, seed: int, slo_mult: float,
                autoscaler, executor):
    """One Gateway → ESG → ClusterSim run over a one-stage app; returns
    (sim, telemetry summary)."""
    from repro_torch.serving import Gateway, get_autoscaler, get_scenario

    apps = {arch: Workflow.pipeline(arch, [arch])}
    sched = ESGScheduler(apps, {arch: table}, risk_sigma=0.05)
    scaler = get_autoscaler(autoscaler) if autoscaler else None
    # one shareable-GPU host: capacity pressure is what makes the planner
    # walk the batch lattice instead of serving everything at batch 1.
    # count_overhead=False keeps simulated time decoupled from this host's
    # wall clock, so the executor cannot leak into the predictions.
    sim = ClusterSim(apps, {arch: table}, {arch: table.fn}, sched,
                     n_invokers=1, vcpus=8, vgpus=1, noise_sigma=0.0,
                     seed=seed, count_overhead=False, autoscaler=scaler,
                     track_digest=True, executor=executor)
    gw = Gateway(sim)
    # pace arrivals to the measured service time so requests queue and
    # the planner leaves batch 1
    pace = max(table.fn.t1_ms / 2.0, 1.0)
    try:
        sc = get_scenario(scenario, app_names=[arch], mean_interval_ms=pace)
    except TypeError:   # uniform-family scenarios have no rate knob
        sc = get_scenario(scenario, app_names=[arch])
    gw.inject(sc, n_requests, seed=seed + 1, slo_mult=slo_mult)
    tel = gw.run()
    tel.scenario = scenario
    return sim, tel.summary()


def serve_real(arch: str = "internlm2_1_8b", n_requests: int = 48,
               scenario: str = "mmpp", autoscaler: str | None = None,
               slo_mult: float = 8.0, seed: int = 0,
               gen_len: int = 16, prompt_len: int = 128,
               batches: tuple = (1, 2, 4, 8), quotas: tuple = (1.0, 0.5),
               profile_path: str | None = None, reps: int = 2,
               bench_out: str | None = None, reduced: bool = False,
               dtype=torch.bfloat16, device=None, log=print) -> dict:
    """Real-compute serving through the full control plane.

    Every request goes through the Gateway → autoscaler → ``ClusterSim``
    dispatch path; ESG_1Q plans batches against a measured profile table
    (built in-process, or loaded from ``profile_path``), and each
    dispatched task is executed for real by ``TorchExecutor``.  Afterwards
    the run is replayed without the executor, and the two schedule digests
    are reported (attaching the executor must not change the schedule).

    Returns the benchmark payload (``bench_out`` writes it as JSON): the
    per-cell predicted vs measured times, executor cache stats, roofline
    cross-checks, telemetry and the digests.
    """
    from repro_torch.launch.profile_kernels import build_artifact
    from repro_torch.serving.executor import TorchExecutor

    ex = TorchExecutor(arch, batch_lattice=tuple(batches),
                       quotas=tuple(quotas), prompt_len=prompt_len,
                       gen_len=gen_len, seed=seed, reduced=reduced,
                       dtype=dtype, device=device)
    scale = "reduced" if reduced else "full"
    log(f"[serve-real] warming {arch} ({scale}, {ex.dtype}, {ex.device}): "
        f"{len(ex.batch_lattice)} buckets x {len(ex.quotas)} quotas ...")
    w = ex.warmup()
    log(f"[serve-real] warmup: {w['warmup_compiles']} cells built in "
        f"{w['warmup_s']:.1f}s ({w['cells']} cache cells)")

    if profile_path:
        with open(profile_path) as f:
            artifact = json.load(f)
        if artifact.get("arch") != arch:
            raise SystemExit(f"profile {profile_path} is for "
                             f"{artifact.get('arch')!r}, not {arch!r}")
    else:
        artifact = build_artifact(ex, reps=reps, log=lambda *_: None)
    table = ProfileTable.from_measured(artifact)
    log(f"[serve-real] measured profile: lattice={table.batch_lattice} "
        f"t1={table.fn.t1_ms:.1f}ms provenance={table.fn.provenance}")

    sim, s = _serve_once(arch, table, scenario, n_requests, seed, slo_mult,
                         autoscaler, ex)
    recs = ex.drain()
    ex.shutdown()
    digest = sim.run_digest()
    replay, _ = _serve_once(arch, table, scenario, n_requests, seed,
                            slo_mult, autoscaler, None)

    # predicted (planner profile) vs measured (device wall) per cell
    by_cell: dict[tuple, list] = {}
    for r in recs:
        if r.tid >= 0:
            by_cell.setdefault((r.bucket, r.quota), []).append(r.wall_ms)
    cells, err_sum, err_n = [], 0.0, 0
    for (bucket, quota), walls in sorted(by_cell.items()):
        c = Config(bucket, 1, 1)
        predicted = table.fn.exec_ms(
            c, quota_vgpu=quota if quota < 1.0 else None)
        # floor estimator on both legs: wall noise is one-sided
        measured = float(np.min(walls))
        err = abs(predicted - measured) / measured if measured else 0.0
        cells.append({"batch": bucket, "quota": quota,
                      "n_executed": len(walls), "predicted_ms": predicted,
                      "measured_ms": measured, "abs_err": err})
        err_sum += err * len(walls)
        err_n += len(walls)
    mean_abs_err = err_sum / err_n if err_n else 0.0
    stats = ex.stats()

    bench = {
        "schema": "repro.realcompute_bench.v1",
        "arch": arch,
        "reduced": reduced,
        "scenario": scenario,
        "n_requests": n_requests,
        "seed": seed,
        "slo_mult": slo_mult,
        "backend": artifact["backend"],
        "interpret": artifact["interpret"],
        "device_name": artifact.get("device_name"),
        "profile": {k: artifact[k] for k in
                    ("batch_lattice", "quota_lattice", "prompt_len",
                     "gen_len")},
        "executor": stats,
        "cells": cells,
        "mean_abs_err": mean_abs_err,
        "roofline": artifact["roofline"],
        "quota_check": artifact["quota_check"],
        "dispatched_tasks": len(sim.tasks),
        "digest": {"with_executor": digest,
                   "without_executor": replay.run_digest()},
        "telemetry": {
            "slo_attainment": s["slo_attainment"],
            "scheduler": s["scheduler"],
            "autoscaler": s["autoscaler"],
            "injected": s["injected"],
            "completed": s["completed"],
            "shed": s["shed"],
            "cold_starts": s["cold_starts"],
            "profile_provenance": s.get("profile_provenance", {}),
        },
    }
    log(f"[serve-real] {arch}({scale})/{scenario}: "
        f"slo={s['slo_attainment']:.3f} executed={stats['executed']} "
        f"hit_rate={stats['post_warmup_hit_rate']} "
        f"mean_abs_err={mean_abs_err:.3f}")
    if bench_out:
        with open(bench_out, "w") as f:
            json.dump(bench, f, indent=2)
        log(f"[serve-real] wrote {bench_out}")
    return bench


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    from repro_torch.serving.traces import SCENARIOS
    ap.add_argument("--scenario", default="mmpp", choices=sorted(SCENARIOS))
    ap.add_argument("--autoscaler", default=None,
                    choices=["ewma", "finegrained", "vertical", "none"])
    ap.add_argument("--slo-mult", type=float, default=8.0)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="measured batch lattice")
    ap.add_argument("--quotas", type=float, nargs="+", default=[1.0, 0.5],
                    help="measured fractional-quota lattice")
    ap.add_argument("--gen-len", type=int, default=16,
                    help="decode steps per request")
    ap.add_argument("--prompt-len", type=int, default=128,
                    help="prompt length")
    ap.add_argument("--reps", type=int, default=2,
                    help="profiling reps per lattice cell")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="load a measured-profile artifact instead of "
                         "profiling in-process")
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="write the predicted-vs-measured JSON here")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's tiny same-family config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there, "
                         "in float32)")
    args = ap.parse_args(argv)
    if not args.real:
        raise SystemExit("only --real serving is ported; emulate mode waits "
                         "for H100 zoo profiles (ROADMAP item 4)")
    dev = torch.device(args.device or "cuda")
    return serve_real(arch=args.arch, n_requests=args.n,
                      scenario=args.scenario, autoscaler=args.autoscaler,
                      slo_mult=args.slo_mult, seed=args.seed,
                      gen_len=args.gen_len, prompt_len=args.prompt_len,
                      batches=tuple(args.batches), quotas=tuple(args.quotas),
                      profile_path=args.profile, reps=args.reps,
                      bench_out=args.bench_out, reduced=args.reduced,
                      dtype=torch.bfloat16 if dev.type == "cuda"
                      else torch.float32, device=dev)


if __name__ == "__main__":
    main()
