"""Where one served request's time goes on the card.

Builds the serving executor for one batch bucket, times its prefill + decode
pass on the host clock (floor of ``--reps``), then runs one more pass under
``torch.profiler`` and reports the device's busy share of that pass (the
union of its kernels' intervals over the pass's wall time), the kernels
that took the device time and the host operators that took the CPU time,
by name.  The profiler slows the host, so the profiled pass is longer than
the timed ones; the kernel times are the device's.

    PYTHONPATH=src python -m repro_torch.launch.profile_step --batch 1 \
        --out build/step_profile.json
    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        --arch rwkv6_1_6b --batch 1 8
    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        --arch hymba_1_5b --batch 1 8
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_pass(ex, bucket: int) -> dict:
    """One prefill + decode pass of ``bucket`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex._run(bucket, 1.0)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        r = by_name.setdefault(e.name, [0, 0.0])
        r[0] += 1
        r[1] += e.time_range.end - e.time_range.start
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {
        "wall_ms": wall_us / 1e3,
        "device_kernels": len(kernels),
        "device_busy_ms": busy / 1e3 if kernels else None,
        "device_busy_share": busy / wall_us if kernels else None,
        "top_kernels": [{"name": n[:120], "count": c, "ms": us / 1e3}
                        for n, (c, us) in top[:15]],
        "top_host_ops": [{"name": e.key[:120], "count": e.count,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3}
                         for e in host[:15]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.serving.executor import TorchExecutor

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    ex = TorchExecutor(args.arch, batch_lattice=tuple(args.batch),
                       quotas=(1.0,), prompt_len=args.prompt_len,
                       gen_len=args.gen_len, device="cuda")
    ex.warmup()
    out = {"arch": args.arch, "device": smi, "prompt_len": args.prompt_len,
           "gen_len": args.gen_len, "buckets": {}}
    for b in args.batch:
        rec = ex.measure(b, 1.0, reps=args.reps)
        row = {"prefill_ms": rec.prefill_ms, "decode_ms": rec.decode_ms,
               "decode_step_ms": rec.decode_ms / args.gen_len,
               "profiled_pass": profile_pass(ex, b)}
        out["buckets"][b] = row
        p = row["profiled_pass"]
        print(f"[profile-step] batch={b}: prefill {rec.prefill_ms:.3f} ms, "
              f"decode {rec.decode_ms:.3f} ms ({row['decode_step_ms']:.3f} "
              f"ms/step); profiled pass {p['wall_ms']:.3f} ms, device busy "
              f"{p['device_busy_ms']} ms (share {p['device_busy_share']}), "
              f"{p['device_kernels']} kernels")
        for k in p["top_kernels"][:8]:
            print(f"[profile-step]   device {k['ms']:.3f} ms x{k['count']} "
                  f"{k['name']}")
        for k in p["top_host_ops"][:8]:
            print(f"[profile-step]   host {k['self_cpu_ms']:.3f} ms "
                  f"x{k['count']} {k['name']}")
    ex.shutdown()
    print(f"[profile-step] {smi}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
