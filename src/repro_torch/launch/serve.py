"""Serving launcher: ESG scheduling over the model zoo.

Two modes:

  * emulate (default): the paper's controller (ESG or a baseline)
    schedules LM-pipeline workflows onto the emulated 16-host cluster,
    with per-arch latency profiles from the H100 roofline model
    (``cluster/gpu_profiles``).  Host only: no model runs and no kernel
    launches.

  * ``--real``: serves a model on this host through the full control
    plane: scenario arrivals enter via the Gateway, ESG_1Q plans batches
    against a *measured* profile table (``launch/profile_kernels``), and
    every dispatched task is executed for real by
    ``serving.executor.TorchExecutor`` (for InternLM2, CUDA
    flash-attention prefill and flash-decode steps; for ``--arch
    rwkv6_1_6b``, the CUDA WKV6 kernel in prefill; for ``--arch
    hymba_1_5b``, plain PyTorch sliding-window attention and selective
    SSM with a ring KV cache, no kernel, as in the reference; for
    ``--arch mixtral_8x22b``, CUDA flash-attention prefill with the
    sliding window, then plain ring decode and expert GEMMs).
    ``--layers`` cuts the depth and keeps every width (full-width
    Mixtral-8x22B fits one 80 GB card only so).  ``--bench-out`` writes
    the predicted-vs-measured comparison.

    PYTHONPATH=src python -m repro_torch.launch.serve
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario mmpp \
        --autoscaler ewma --scheduler esg
    PYTHONPATH=src python -m repro_torch.launch.serve --real \
        --prompt-len 128 --gen-len 16 --n 24 --bench-out build/serve.json
    PYTHONPATH=src python -m repro_torch.launch.serve --real \
        --arch rwkv6_1_6b --reduced --device cpu --n 8 --prompt-len 8 \
        --gen-len 2 --batches 1 2
    PYTHONPATH=src python -m repro_torch.launch.serve --real \
        --arch hymba_1_5b --reduced --device cpu --n 8 --prompt-len 8 \
        --gen-len 2 --batches 1 2
    PYTHONPATH=src python -m repro_torch.launch.serve --real \
        --arch mixtral_8x22b --layers 12 --n 24
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.cluster.emulator import ClusterSim
from repro_torch.cluster.gpu_profiles import zoo_tables
from repro_torch.cluster.workload import generate
from repro_torch.core.profiles import Config, ProfileTable
from repro_torch.core.scheduler import ESGScheduler
from repro_torch.core.workflows import Workflow

# LM pipelines over the assigned architectures (DAG stage = one model)
ZOO_APPS = {
    "draft_verify": Workflow.pipeline(
        "draft_verify", ["rwkv6_1_6b", "internlm2_20b"]),
    "vlm_caption": Workflow.pipeline(
        "vlm_caption", ["internvl2_76b", "internlm2_1_8b"]),
    "code_review": Workflow.pipeline(
        "code_review", ["starcoder2_7b", "mixtral_8x22b"]),
    "music_tagging": Workflow.pipeline(
        "music_tagging", ["musicgen_medium", "hymba_1_5b",
                          "internlm2_1_8b"]),
}


def _make_scheduler(name: str, tables):
    if name == "esg":
        return ESGScheduler(ZOO_APPS, tables, risk_sigma=0.05)
    from repro_torch.core.baselines.aquatope import AquatopeScheduler
    from repro_torch.core.baselines.fastgshare import FaSTGShareScheduler
    from repro_torch.core.baselines.infless import INFlessScheduler
    from repro_torch.core.baselines.orion import OrionScheduler
    factories = {"infless": INFlessScheduler, "fastgshare": FaSTGShareScheduler,
                 "orion": OrionScheduler, "aquatope": AquatopeScheduler}
    return factories[name](ZOO_APPS, tables)


def emulate(setting: str = "moderate-normal", n: int = 200, seed: int = 0,
            scheduler: str = "esg", scenario: str | None = None,
            autoscaler: str | None = None, slo_mult: float = 1.0,
            overlap: bool = False, prefetch: bool = False,
            trace_out: str | None = None, metrics_out: str | None = None,
            audit_out: str | None = None, calibrate: bool = False,
            health_out: str | None = None,
            log=print, tables: dict | None = None) -> dict:
    """Emulated serving over the model zoo, on the host only, over
    ``tables`` (default: ``zoo_tables()``, the H100 data sheet's peaks).

    Legacy mode (``scenario=None``) drives the paper's uniform-interval
    ``setting`` through ``cluster.workload.generate``.  Scenario mode runs
    the online-serving stack: ``serving.traces`` arrival engine behind the
    ``serving.gateway`` admission front end, with the warm-pool policy
    named by ``autoscaler`` (ewma | finegrained | vertical | none).

    Any of ``trace_out`` / ``metrics_out`` / ``audit_out`` /
    ``health_out`` attaches the flight recorder (``repro_torch.obs``) and
    exports the Perfetto trace / metrics time-series / planner audit
    log / health-alert stream after the run.  ``calibrate=True`` closes
    the pricing loop: an online ``ProfileCalibrator`` subscribed to the
    audit stream corrects the planner's exec estimates per (app, stage)
    as the run progresses, and ``health_out`` additionally wires the
    SLO health engine's alerts into the gateway's admission check and
    the autoscaler's congestion hooks.
    """
    from repro_torch.serving import Gateway, get_autoscaler, get_scenario

    tables = tables if tables is not None else zoo_tables()
    profiles = {a: t.fn for a, t in tables.items()}
    sched = _make_scheduler(scheduler, tables)
    scaler = get_autoscaler(autoscaler) if autoscaler else None
    recorder = None
    health = None
    if trace_out or metrics_out or audit_out or calibrate or health_out:
        from repro_torch.obs import HealthEngine, ProfileCalibrator, Recorder
        if health_out is not None:
            health = HealthEngine()
        # calibration consumes the audit stream, so the audit log is on
        # whenever either consumer needs it
        recorder = Recorder(health=health)
        if calibrate:
            if not hasattr(sched, "calibrator"):
                raise SystemExit(f"--calibrate requires the ESG scheduler "
                                 f"(got {scheduler!r})")
            sched.calibrator = ProfileCalibrator().attach(recorder.audit)
    sim = ClusterSim(ZOO_APPS, tables, profiles, sched, seed=seed,
                     autoscaler=scaler, overlap=overlap, prefetch=prefetch,
                     recorder=recorder)
    if health is not None and scaler is not None:
        scaler.health = health

    def _export():
        if recorder is None:
            return
        written = recorder.export(trace_out, metrics_out, audit_out,
                                  health_out)
        for kind, path in written.items():
            log(f"[obs] wrote {kind} -> {path}")
        cal = getattr(sched, "calibrator", None)
        if cal is not None:
            log(f"[obs] calibration: {cal.observations} observations, "
                f"{cal.updates} published factor updates")
        if health is not None:
            hs = health.summary()
            log(f"[obs] health: {hs['alerts_total']} alert transitions, "
                f"active={hs['active'] or 'none'}")

    if scenario is None:
        generate(sim, setting, n, profiles, seed=seed + 1)
        sim.run()
        s = sim.summary()
        log(f"[serve-emulate] {s['scheduler']}: hit={s['slo_hit_rate']:.3f} "
            f"cost=${s['total_cost']:.4f} mean_lat={s['mean_latency_ms']:.0f}ms "
            f"sched_ovh={s['mean_sched_overhead_ms']:.2f}ms")
        _export()
        return s
    gw = Gateway(sim, health=health)
    sc = get_scenario(scenario, app_names=list(ZOO_APPS))
    gw.inject(sc, n, seed=seed + 1, slo_mult=slo_mult)
    tel = gw.run()
    tel.scenario = scenario
    s = tel.summary()
    log(f"[serve-scenario] {scenario}/{s['scheduler']}/{s['autoscaler']}: "
        f"slo={s['slo_attainment']:.3f} $/1k={s['cost_per_1k']:.4f} "
        f"cold={s['cold_starts']} shed={s['shed']} "
        f"p95={s['latency']['p95_ms']:.0f}ms")
    _export()
    return s


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
               n_layers: int | None = None,
               dtype=torch.bfloat16, device=None, log=print) -> dict:
    """Real-compute serving through the full control plane.

    Every request goes through the Gateway → autoscaler → ``ClusterSim``
    dispatch path; ESG_1Q plans batches against a measured profile table
    (built in-process, or loaded from ``profile_path``), and each
    dispatched task is executed for real by ``TorchExecutor``, at the
    config's depth or at ``n_layers``.  Afterwards
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
                       n_layers=n_layers, dtype=dtype, device=device)
    scale = (f"{'reduced' if reduced else 'full'}, "
             f"{ex.cfg.n_layers} layers")
    log(f"[serve-real] warming {arch} ({scale}, {ex.dtype}, {ex.device}): "
        f"{len(ex.batch_lattice)} buckets x {len(ex.quotas)} quotas ...")
    w = ex.warmup()
    log(f"[serve-real] {arch} ({scale}) warmup: {w['warmup_compiles']} "
        f"cells built in "
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
    log(f"[serve-real] {arch} ({scale}) measured profile: "
        f"lattice={table.batch_lattice} "
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
        "n_layers": ex.cfg.n_layers,
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
    ap.add_argument("--setting", default="moderate-normal")
    ap.add_argument("--n", type=int, default=None,
                    help="requests (default: 200 emulated, 48 with --real)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", default="esg",
                    choices=["esg", "infless", "fastgshare", "orion",
                             "aquatope"])
    from repro_torch.serving.traces import SCENARIOS
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS),
                    help="serving scenario; omit for the legacy uniform "
                         "setting (with --real: mmpp)")
    ap.add_argument("--autoscaler", default=None,
                    choices=["ewma", "finegrained", "vertical", "none"],
                    help="warm-pool policy (default: ewma); 'vertical' "
                         "adds fractional vGPU resizing of running pools")
    ap.add_argument("--slo-mult", type=float, default=None,
                    help="SLO multiplier (default: 1.0 emulated, 8.0 with "
                         "--real)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped swap pipeline: restart penalties "
                         "become async PCIe transfer completions")
    ap.add_argument("--prefetch", action="store_true",
                    help="predictive next-stage weight prefetch "
                         "(requires --overlap)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-request spans and write a "
                         "Perfetto-loadable Chrome-trace JSON here")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="record windowed metrics and write JSON "
                         "(or CSV if PATH ends in .csv) here")
    ap.add_argument("--audit-out", default=None, metavar="PATH",
                    help="record the planner decision audit log "
                         "and write JSONL here")
    ap.add_argument("--calibrate", action="store_true",
                    help="close the pricing loop: correct the planner's "
                         "exec estimates online from the audit stream's "
                         "predicted-vs-realized records (ESG only)")
    ap.add_argument("--health-out", default=None, metavar="PATH",
                    help="run the SLO burn-rate health engine (alerts "
                         "feed the gateway + autoscaler) and write its "
                         "alert stream as JSONL here")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="(--real) measured batch lattice")
    ap.add_argument("--quotas", type=float, nargs="+", default=[1.0, 0.5],
                    help="(--real) measured fractional-quota lattice")
    ap.add_argument("--gen-len", type=int, default=16,
                    help="(--real) decode steps per request")
    ap.add_argument("--prompt-len", type=int, default=128,
                    help="(--real) prompt length")
    ap.add_argument("--reps", type=int, default=2,
                    help="(--real) profiling reps per lattice cell")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="(--real) load a measured-profile artifact "
                         "instead of profiling in-process")
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="(--real) write the predicted-vs-measured JSON "
                         "here")
    ap.add_argument("--reduced", action="store_true",
                    help="(--real) serve the arch's tiny same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="(--real) serve this many layers at every "
                         "published width (default: the config's depth)")
    ap.add_argument("--device", default=None,
                    help="(--real) torch device (default: cuda; 'cpu' to "
                         "run there, in float32)")
    args = ap.parse_args(argv)
    if not args.real:
        return emulate(args.setting, args.n if args.n else 200,
                       seed=args.seed, scheduler=args.scheduler,
                       scenario=args.scenario, autoscaler=args.autoscaler,
                       slo_mult=args.slo_mult if args.slo_mult is not None
                       else 1.0, overlap=args.overlap,
                       prefetch=args.prefetch, trace_out=args.trace_out,
                       metrics_out=args.metrics_out,
                       audit_out=args.audit_out, calibrate=args.calibrate,
                       health_out=args.health_out)
    dev = torch.device(args.device or "cuda")
    return serve_real(arch=args.arch, n_requests=args.n if args.n else 48,
                      scenario=args.scenario or "mmpp",
                      autoscaler=args.autoscaler,
                      slo_mult=args.slo_mult if args.slo_mult is not None
                      else 8.0, seed=args.seed,
                      gen_len=args.gen_len, prompt_len=args.prompt_len,
                      batches=tuple(args.batches), quotas=tuple(args.quotas),
                      profile_path=args.profile, reps=args.reps,
                      bench_out=args.bench_out, reduced=args.reduced,
                      n_layers=args.layers, dtype=torch.bfloat16 if dev.type == "cuda"
                      else torch.float32, device=dev)


if __name__ == "__main__":
    main()
