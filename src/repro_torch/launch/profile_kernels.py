"""Measured-profile pipeline: time the real model over the lattice.

Times the port's execution (via ``serving.executor.TorchExecutor``: the
arch's prefill and decode steps, on the CUDA kernels of its family; Hymba's
path has none) across
the (batch-bucket, quota) lattice and emits a ``repro.measured_profile.v1``
JSON artifact that ``ProfileTable.from_measured`` loads in place of the zoo
numbers.

Two cross-checks ride along in the artifact:

* **Roofline** — on a CUDA device, each quota-1.0 cell is compared against
  the analytic lower bound of ``launch/roofline.py`` for the card it ran
  on.  A CPU run has no device bound and records none.
* **Quota exponent** — the fractional-quota slowdown measured from the
  serialized-pass emulation is fit to the profile model's power law and
  reported next to ``QUOTA_SLOWDOWN_EXP``.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.profile_kernels \
        --arch internlm2_1_8b --out build/profile.json
    PYTHONPATH=src python -m repro_torch.launch.profile_kernels \
        --arch hymba_1_5b --out build/profile_hymba.json
    PYTHONPATH=src python -m repro_torch.launch.profile_kernels \
        --reduced --device cpu --smoke     # batches (1, 2), quota 1.0, 1 rep
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.core.profiles import QUOTA_SLOWDOWN_EXP
from repro_torch.launch.roofline import device_peaks, model_flops, roofline


def roofline_check(executor, bucket: int, measured_ms: float,
                   stage: str) -> dict:
    """Compare one measured quota-1.0 cell against the analytic roofline
    bound of the executor's card for the same config and shape."""
    peaks = device_peaks(torch.cuda.get_device_name(executor.device))
    cfg = executor.cfg
    seq = executor.prompt_len if stage == "prefill" else 1
    kind = "prefill" if stage == "prefill" else "decode"
    shape = ShapeSpec(f"profile_{stage}", seq_len=seq,
                      global_batch=bucket, kind=kind)
    terms = roofline(cfg, shape,
                     flops_per_device=model_flops(cfg, shape),
                     bytes_upper=0.0,       # analytic memory model only
                     wire_bytes_per_device=0.0, n_chips=1, peaks=peaks,
                     model_axis=1)
    bound_ms = terms.bound_s * 1e3
    if stage == "decode":                  # per decode step
        measured_ms = measured_ms / max(executor.gen_len, 1)
    return {
        "stage": stage,
        "batch": bucket,
        "device_peaks": peaks.name,
        "bound_ms": bound_ms,
        "measured_ms": measured_ms,
        "bound_fraction": bound_ms / measured_ms if measured_ms else 0.0,
        "dominant": terms.dominant,
    }


def quota_exponent(cells: list[dict]) -> dict:
    """Fit measured quota slowdowns to ``(1/q)^alpha`` per bucket and
    report the mean exponent next to the profile model's constant."""
    base = {c["batch"]: c["e2e_ms"] for c in cells if c["quota"] == 1.0}
    exps = []
    for c in cells:
        q = c["quota"]
        if q >= 1.0 or c["batch"] not in base or base[c["batch"]] <= 0:
            continue
        slowdown = c["e2e_ms"] / base[c["batch"]]
        if slowdown > 0:
            exps.append(math.log(slowdown) / math.log(1.0 / q))
    if not exps:
        return {"model_exponent": QUOTA_SLOWDOWN_EXP,
                "measured_exponent": None, "n_points": 0}
    mean = sum(exps) / len(exps)
    return {
        "model_exponent": QUOTA_SLOWDOWN_EXP,
        "measured_exponent": mean,
        "max_abs_dev": max(abs(e - mean) for e in exps),
        "n_points": len(exps),
    }


def build_artifact(executor, reps: int = 3, cold_ms: float = 0.0,
                   input_mb: float = 0.01, log=print) -> dict:
    """Measure every (bucket, quota) lattice cell on a warmed
    :class:`TorchExecutor` and assemble the ``repro.measured_profile.v1``
    artifact ``ProfileTable.from_measured`` consumes."""
    if not executor._warmed:
        executor.warmup()
    on_card = executor.device.type == "cuda"
    cells, checks = [], []
    for bucket in executor.batch_lattice:
        for quota in executor.quotas:
            rec = executor.measure(bucket, quota, reps=reps)
            cells.append({
                "batch": bucket,
                "quota": quota,
                "prefill_ms": rec.prefill_ms,
                "decode_ms": rec.decode_ms,
                "e2e_ms": rec.wall_ms,
                "reps": reps,
            })
            log(f"  cell batch={bucket} quota={quota}: "
                f"{rec.wall_ms:.2f} ms ({rec.prefill_ms:.2f} prefill + "
                f"{rec.decode_ms:.2f} decode)")
            if quota == 1.0 and on_card:
                checks.append(roofline_check(
                    executor, bucket, rec.prefill_ms, "prefill"))
                checks.append(roofline_check(
                    executor, bucket, rec.decode_ms, "decode"))
    return {
        "schema": "repro.measured_profile.v1",
        "arch": executor.arch,
        "reduced": executor.reduced,
        "backend": executor.device.type,
        "interpret": False,
        "device_name": (torch.cuda.get_device_name(executor.device)
                        if on_card else "cpu"),
        "dtype": str(executor.dtype).replace("torch.", ""),
        "prompt_len": executor.prompt_len,
        "gen_len": executor.gen_len,
        "batch_lattice": list(executor.batch_lattice),
        "quota_lattice": list(executor.quotas),
        "cells": cells,
        "roofline": checks,
        "quota_check": quota_exponent(cells),
        "cold_ms": cold_ms,
        "input_mb": input_mb,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Measure real model latencies over the batch/quota "
                    "lattice and emit a measured-profile artifact")
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--quotas", type=float, nargs="+", default=[1.0, 0.5])
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny same-family config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny lattice (batches 1,2; quota 1.0; 1 rep)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.batches, args.quotas, args.reps = [1, 2], [1.0], 1

    from repro_torch.serving.executor import TorchExecutor

    dev = torch.device(args.device or "cuda")
    ex = TorchExecutor(args.arch, batch_lattice=tuple(args.batches),
                       quotas=tuple(args.quotas),
                       prompt_len=args.prompt_len, gen_len=args.gen_len,
                       seed=args.seed, reduced=args.reduced,
                       dtype=torch.bfloat16 if dev.type == "cuda"
                       else torch.float32, device=dev)
    print(f"[profile] warming {args.arch} "
          f"({len(args.batches)} buckets x {len(ex.quotas)} quotas) ...")
    w = ex.warmup()
    print(f"[profile] warmup: {w['warmup_compiles']} cells built, "
          f"{w['warmup_s']:.1f}s")
    artifact = build_artifact(ex, reps=args.reps)
    ex.shutdown()
    qc = artifact["quota_check"]
    if qc["measured_exponent"] is not None:
        print(f"[profile] quota exponent: measured "
              f"{qc['measured_exponent']:.3f} vs model "
              f"{qc['model_exponent']} ({qc['n_points']} points)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
        print(f"[profile] wrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()
