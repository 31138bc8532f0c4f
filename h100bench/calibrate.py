#!/usr/bin/env python3
"""Calibrate a cell on the card: the knee, the check's readings, the
control's and the planted faults'.  The benchmark's runs never call it.

    python3 h100bench/calibrate.py --workload <cell> \
        [--sweep R1 R2 ...] [--seeds S1 S2 ...] [--control] [--witness] \
        [--faults] [--seconds S]

Every reading is a whole run of the cell through ``run.run_cell``, one
after another in this process: the same set-up, window, records and
check as a benchmark run, at the cell's own sizes, with what is being
calibrated put in place:

* ``--sweep``: for each mean rate, a run at that rate over
  ``--sweep-seconds``: hit rate, p95, the executor's lag behind the
  schedule in the middle and at the end of the window, sheds.  The knee
  is the highest rate whose lag does not grow.
* ``--seeds``: for each seed, a run of the program: the check's numbers
  and ``correct`` (the lower readings).  With ``--control`` also a run on
  the same seed with the control, the reference in fp8, in the program's
  place in the served numbers: ``correct`` has to come out false (the
  upper readings).  With ``--witness`` a run with the reference in bf16
  there, a witness of what bf16 rounding alone does.
* ``--faults``: each fault of ``hbench.faults`` planted under the timed
  path, on the first three seeds: ``correct`` has to come out false.

Each reading is one JSON line on standard output and in ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sweep", type=float, nargs="*", default=[])
    ap.add_argument("--sweep-seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location("h100bench_run",
                                                  HERE / "run.py")
    run_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_mod)
    out = open(args.out, "a") if args.out else None

    def once(seed, seconds, rate=None, faults=(), stand_in=None):
        argv = ["--workload", args.workload, "--seed", str(seed),
                "--seconds", str(seconds), "--device", args.device]
        argv += ["--reduced"] if args.reduced else []
        argv += ["--rate-rps", str(rate)] if rate is not None else []
        got = run_mod.run_cell(run_mod.parse(argv), faults, stand_in)
        gc.collect()
        if args.device == "cuda":
            import torch
            torch.cuda.empty_cache()
        if got["result"] is None:
            raise SystemExit(f"the run of seed {seed} printed no result "
                             f"(rc {got['rc']})")
        return got

    def emit(kind, got, **extra):
        res = got["result"]
        row = {"kind": kind, "workload": args.workload, **extra,
               "correct": res["correct"], "numbers": got["numbers"],
               "limits": {k: v["limit"] for k, v in res["checks"].items()},
               "profile_ms": res["profile_ms"],
               "gpu_ms_per_req": run_mod.read_metric("gpu_ms_per_req",
                                                     got["run"]),
               "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    seed0 = (args.seeds or [1])[0]
    for rate in args.sweep:
        got = once(seed0, args.sweep_seconds, rate)
        run = got["run"]
        done = [t for t in run.tasks if t.done_s is not None]
        lag = [(t.done_s - t.wall_ms / 1e3) - t.release_s for t in done]
        tail = max(len(lag) // 10, 1)
        mid = lag[len(lag) // 2:][:tail]
        emit("sweep", got, rate_rps=rate, requests=len(run.requests),
             shed=sum(1 for r in run.requests if not r.admitted),
             tasks=len(run.tasks), end_s=run.end_s,
             lag_mid_s=sum(mid) / len(mid) if mid else None,
             lag_end_s=sum(lag[-tail:]) / tail if lag else None,
             **{m: run_mod.read_metric(m, run) for m in (
                 "slo_hit_rate", "req_p95_ms", "batch_fill", "profile_err",
                 "tokens_s")})
    for seed in args.seeds:
        emit("seed", once(seed, args.seconds), seed=seed)
        if args.control:
            emit("control", once(seed, args.seconds, stand_in="fp8"),
                 seed=seed)
        if args.witness:
            emit("witness", once(seed, args.seconds, stand_in="bf16"),
                 seed=seed)
    if args.faults:
        from hbench import faults
        for kind in faults.KINDS:
            for seed in args.seeds[:3]:
                emit("fault", once(seed, args.seconds, faults=(kind,)),
                     seed=seed, fault=kind)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
