#!/usr/bin/env python3
"""Run a cell with the program's step tracer, and read where the device
idles inside the program's steps.  The benchmark's runs never call it.

    python3 h100bench/step_spans.py --workload <cell> --seeds S1 [S2 ...] \
        --seconds <s> [--trace 0|1] [--tracer 0|1] [--out FILE]

Each seed is a whole run of the cell through ``run.run_cell``, one after
another in this process, as ``calibrate.py`` makes them: the same set-up,
window, records and check as a benchmark run.  With ``--tracer 1``, the
default where ``--trace 1`` (itself the default), the executor is handed
an ``obs.tracer.StepTracer`` once it is built, so its tasks leave
wall-clock spans, and while the slice is profiled its decode steps open
their profiler ranges.  A traced run with a tracer keeps the profiled
slice as ``hbench.step_idle.StepSlice`` on the run's ``step_slice``,
which ``metrics/decode_idle_ms.py`` reads.

Each run prints one JSON line: the run's metrics, ``decode_idle_ms`` and
the device's busy time per decode step of the slice, the slice's idle
time split by where the host was, for the operations launched inside a
decode span the least time from the span's stamp to their launch and to
their start on the device and from launch to start (``*_us_min``, with
the count of device starts before their span's stamp), the executor's
decode time per step outside the slice, and the idle gaps of the
breakdown.  ``--device cpu
--reduced`` runs the same at a tiny size (no device: no idle is read).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


def load_run():
    spec = importlib.util.spec_from_file_location("h100bench_run",
                                                  HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_traced(run_mod, argv: list, tracer: bool) -> dict:
    """One ``run_cell`` with a ``StepTracer`` on the executor (if
    ``tracer``) and the profiled slice kept on the run; returns
    ``run_cell``'s dict."""
    for p in (str(HERE), str(HERE.parent / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from hbench import serve, step_idle
    from hbench import trace as tr
    from repro_torch.obs.tracer import StepTracer

    st = StepTracer() if tracer else None
    kept = {}
    build, read = serve.build_executor, tr.read

    def build_traced(*a, **k):
        ex, model = build(*a, **k)
        ex.tracer = st
        return ex, model

    def read_kept(prof, *a, **k):
        kept["slice"] = step_idle.capture(prof, st.spans)
        return read(prof, *a, **k)

    if st is not None:
        serve.build_executor, tr.read = build_traced, read_kept
    try:
        got = run_mod.run_cell(run_mod.parse(argv))
    finally:
        serve.build_executor, tr.read = build, read
    if got["run"] is not None:
        got["run"].step_slice = kept.get("slice")
    got["spans"] = len(st.spans) if st else 0
    return got


def summary(run_mod, got: dict) -> dict:
    """What one run read: see the module's docstring."""
    from hbench import step_idle

    run, res = got["run"], got["result"]
    row = {"correct": res["correct"], "metrics": res["metrics"],
           "device": res["device"], "spans": got["spans"],
           "decode_step_ms": run_mod.read_metric("decode_step_ms", run)}
    s = getattr(run, "step_slice", None)
    if s is not None:
        n, idle_ns, span_ns = step_idle.inside(s, "repro.decode")
        seen = step_idle.launches_in(s)

        def least(pairs):
            return min(b - a for a, b in pairs) / 1e3 if seen else None

        row.update(
            decode_idle_ms=run_mod.read_metric("decode_idle_ms", run),
            decode_busy_ms=(span_ns - idle_ns) / n / 1e6 if n else None,
            decode_spans=n, window_ms=(s.end_ns - s.start_ns) / 1e6,
            idle_ms=sum(b - a for a, b in step_idle.idle(s)) / 1e6,
            idle_split_ms={k: v / 1e6
                           for k, v in step_idle.split(s).items()},
            device_ops=len(s.device), launches_checked=len(seen),
            lead_us_min=least((t0, d) for t0, _, d in seen),
            launch_us_min=least((t0, h) for t0, h, _ in seen),
            queue_us_min=least((h, d) for _, h, d in seen),
            starts_before_stamp=sum(1 for t0, _, d in seen if d < t0))
    if "breakdown" in res:
        row["idle_gaps"] = res["breakdown"]["idle_gaps"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rate-rps", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.tracer is None:
        args.tracer = args.trace
    run_mod = load_run()
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        cell_argv = ["--workload", args.workload, "--seed", str(seed),
                     "--seconds", str(args.seconds), "--trace",
                     str(args.trace), "--device", args.device]
        cell_argv += ["--reduced"] if args.reduced else []
        cell_argv += (["--rate-rps", str(args.rate_rps)]
                      if args.rate_rps is not None else [])
        got = run_traced(run_mod, cell_argv, bool(args.tracer))
        if got["result"] is None:
            raise SystemExit(f"the run of seed {seed} printed no result "
                             f"(rc {got['rc']})")
        row = {"workload": args.workload, "seed": seed,
               "trace": args.trace, "tracer": args.tracer,
               **summary(run_mod, got)}
        del got
        gc.collect()
        if args.device == "cuda":
            import torch
            torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
