#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(``h100bench/configs/<config>.json``: the model's sizes) and a traffic
mix (``h100bench/traffic/<traffic>.json``: arrivals, lengths, release,
load as a share of the knee, SLO); the cell's own file
(``h100bench/workloads/<cell>.json``) freezes what belongs to that pair:
the knee, the B = 1 task time the SLO is a multiple of, the batch
lattice, the measured profile's passes and the check's limits.  Each
metric ``<name>`` is read by ``h100bench/metrics/<name>.py``, or, for a
name ``<base>.<part>`` that has no file of its own, by
``h100bench/metrics/<base>.py``.

A run: set-up (the program's executor with the seed's weights and
prompts, warm-up, its measured profile, the arrivals planned by the
program's ESG control plane), then the window (the planned tasks
released on the wall clock to the executor on the card), then the check
of what the timed path produced against the plain reference.  It prints
the check's numbers with their limits as its last lines on standard error
and one JSON line as the last line of standard output.  With ``--trace
1`` a slice of the window runs under ``torch.profiler`` and the per-layer
metrics are reported instead of the end-to-end ones.

``--device cpu --reduced`` runs the same stages on the CPU with the
configuration's family at a tiny size (a dry run for the tests; the
device metrics are then left out).  ``--rate-rps`` overrides the mix's
mean rate, for a knee sweep.  ``--out DIR`` writes the run's records
and spans there.  ``calibrate.py`` drives ``run_cell`` with faults
planted under the timed path or the control in the program's place.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against ``/proc/uptime``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell entry, configuration file, mix): the mix is the
    traffic file with the cell file's numbers and what follows from them,
    its mean rate (``load_of_knee`` x the knee) and its SLO in ms (the
    traffic's ``slo_ms``, or ``slo_of_t1`` x the cell's B = 1 task)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json")
                     .read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    mix.update(json.loads((HERE / "workloads" / f"{name}.json").read_text()))
    mix["mean_rate_rps"] = mix["load_of_knee"] * mix["knee_rps"]
    if "slo_ms" not in mix:
        mix["slo_ms"] = mix["slo_of_t1"] * mix["t1_ms"]
    return bench, cell, cfg, mix


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def metric_file(name: str) -> pathlib.Path:
    """The reader of metric ``name``: its own file, or its base's."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / (
        name.split(".", 1)[0] + ".py")


def read_metric(name: str, run):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_').replace('-', '_')}",
        metric_file(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def traced_slice(predicted_ms, seconds: float, model: dict,
                 gen_len: int) -> tuple[float, int]:
    """(start on the window's clock, tasks) of the profiled slice: the
    tasks that start from the middle of the window on, as many as keep the
    profiler's events (about 100 launches a layer and step) under 50,000
    and the slice under about 3 s."""
    per_task = (1 + gen_len) * model["n_layers"] * 100
    mean_ms = sum(predicted_ms) / len(predicted_ms)
    n = min(50_000 // per_task, int(3000.0 // mean_ms))
    return 0.45 * seconds, max(n, 1)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rate-rps", type=float, default=None)
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None, faults: tuple = ()) -> int:
    """Run the cell and print its result; ``faults``
    (``hbench.faults.KINDS``) plants faults under the timed path, for the
    tests of the check."""
    got = run_cell(parse(argv), faults)
    if got["result"] is None:
        return got["rc"]
    nums, checks = got["numbers"], got["result"]["checks"]
    print(f"[h100bench] compared: {json.dumps(nums)}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(got["result"]))
    return 0


def run_cell(args, faults: tuple = (), stand_in: str | None = None) -> dict:
    """One run of the cell: ``{"rc", "result", "numbers", "run"}``, the
    result being the line ``main`` prints (None where the run may print
    none).  ``stand_in`` (``"fp8"``, ``"bf16"``) puts the reference in
    that precision in the program's place in the served numbers: the
    control, for ``calibrate.py``."""
    trace = bool(args.trace)
    build = ROOT / "build" / "h100bench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    bench, cell, cfg, mix = load_cell(args.workload)
    none = {"result": None, "numbers": None, "run": None}

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if args.device == "cuda" and found < cell["chips"]:
        print(f"[h100bench] needs {cell['chips']} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return dict(none, rc=2)
    from hbench import faults as fault_kinds
    from hbench import judge, records, serve, traffic
    from hbench import trace as tr
    from hbench.spans import Spans

    device = torch.device(args.device)
    spans = Spans()
    if args.reduced:
        mix = dict(mix, prompt_len=min(mix["prompt_len"], 16),
                   gen_len=min(mix["gen_len"], 2))
    with spans.span("setup"):
        with spans.span("executor"):
            ex, model = serve.build_executor(cfg, mix, args.seed, device,
                                             args.reduced)
        with spans.span("warmup"):
            ex.warmup()
        with spans.span("profile"):
            table = serve.measured_profile(ex, mix["profile_reps"])
        with spans.span("plan"):
            arrivals = traffic.arrivals(mix, args.seconds, args.seed,
                                        args.rate_rps)
            tasks, admitted = serve.plan(cfg["arch"], table, arrivals,
                                         mix["slo_ms"], args.seed)
    from repro_torch.core.profiles import Config
    buckets = [ex.bucket_of(len(t.jobs)) for t in tasks]
    predicted = [table.fn.exec_ms(Config(b, 1, 1)) for b in buckets]
    profile_ms = {b: table.fn.exec_ms(Config(b, 1, 1))
                  for b in ex.batch_lattice}
    n_expected = len(tasks)
    if mix["release"] == "backlog":
        acc, n_expected = 0.0, 0
        while n_expected < len(tasks) and acc <= args.seconds * 1e3:
            acc += predicted[n_expected]
            n_expected += 1
    sample = judge.choose_sample(buckets, n_expected, args.seed)
    slice_ = (traced_slice(predicted, args.seconds, model, mix["gen_len"])
              if trace and tasks else None)
    for kind in faults:
        if kind not in fault_kinds.ABOVE_STEPS:
            fault_kinds.install(ex, kind, model["vocab"])
    steps = serve.Steps(ex, sample, mix["gen_len"], slice_, spans)
    for kind in faults:
        if kind in fault_kinds.ABOVE_STEPS:
            fault_kinds.install(ex, kind, model["vocab"])
    setup_s = process_age_s()
    runs, t0 = serve.run_window(ex, tasks, mix["release"], args.seconds,
                                grace_s=60.0, spans=spans, steps=steps)
    end_s = time.perf_counter() - t0
    if steps.prof is not None and not steps.trace_window[1]:
        ex._pool.submit(steps.stop_profile).result()
    ex.shutdown()
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # ---- records -----------------------------------------------------------
    first = steps.slice_end - len(steps.traced)
    traced_ids = {tasks[i].tid for i in range(first, steps.slice_end)
                  if 0 <= i < len(tasks)} if steps.traced else set()
    task_rows, reqs, done_of = records.build(
        tasks, runs, buckets, predicted, ex.records, traced_ids, arrivals,
        admitted)
    run = records.Run(
        cell=args.workload, release=mix["release"], seconds=args.seconds,
        end_s=args.seconds if mix["release"] == "backlog" else end_s,
        slo_ms=mix["slo_ms"], prompt_len=mix["prompt_len"],
        gen_len=mix["gen_len"], model=model,
        device=torch.cuda.get_device_name(device) if on_card else "cpu",
        setup_s=setup_s, requests=reqs, tasks=task_rows)
    if steps.prof is not None:
        with spans.span("read_trace"):
            w0, w1 = steps.trace_window
            run.trace = tr.read(steps.prof, w1 - w0, steps.traced,
                                mix["prompt_len"], mix["gen_len"])
        steps.prof = None
    # a backlog's tasks still queued at the close were never released;
    # on a schedule every task was, and one unserved by the end failed
    released = [r for r in runs if mix["release"] == "schedule"
                or not r.cancelled or r.done_s is not None]
    attempted = sum(r.n_jobs for r in released)
    failed = sum(r.n_jobs for r in released
                 if r.error is not None or r.done_s is None)
    failed += sum(1 for uid, ok in admitted.items()
                  if ok and uid not in done_of)
    metrics = {}
    for m in cell_metrics(bench, args.workload, trace):
        v = read_metric(m["name"], run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- the check, once the program is freed ------------------------------
    steps.uninstall()
    acct = judge.accounting_errors(tasks, runs, admitted, ex.records,
                                   ex.bucket_of, ex.nonfinite)
    kept, dtype = steps.kept, ex.dtype
    state = judge.state_errors(kept, mix["prompt_len"])
    exact = judge.output_errors(kept)
    del ex, steps, table
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with spans.span("check"):
        nums = judge.served_numbers(model, args.seed, kept,
                                    mix["prompt_len"], dtype, device,
                                    stand_in)
    del kept
    limits = mix["limits"]
    nums["accounting_errors"] = acct
    nums["state_errors"] = state
    nums.update(exact)
    checks = {k: nums[k] for k in limits}
    correct = nums["compared_rows"] > 0 and all(
        checks[k] <= limits[k] for k in checks)

    bad = forbidden_modules()
    if bad:
        print(f"[h100bench] the run loaded {bad}: the benchmark runs "
              f"without JAX and the JAX package", file=sys.stderr)
        return dict(none, rc=3)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        stem = f"{args.workload}-s{args.seed}-t{args.trace}"
        spans.dump(out / f"{stem}-spans.json")
        (out / f"{stem}-records.json").write_text(json.dumps({
            "tasks": [vars(t) for t in task_rows],
            "requests": [vars(r) for r in reqs],
            "trace": vars(run.trace) if run.trace else None}))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": run.device, "count": 1 if on_card else 0,
           "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps}
    result["profile_ms"] = {str(b): ms for b, ms in profile_ms.items()}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    print(f"[h100bench] {args.workload} seed {args.seed}: "
          f"{len(tasks)} tasks, {len(arrivals)} requests, "
          f"{nums['compared_rows']} rows compared, set-up {setup_s:.3f} s, "
          f"check {spans.total('check'):.3f} s", file=sys.stderr)
    return {"rc": 0, "result": result, "numbers": nums, "run": run}


if __name__ == "__main__":
    sys.exit(main())
