"""Where one served request's (or one training step's) time goes on the
card.

Builds the serving executor for one batch bucket, times its prefill + decode
pass on the host clock (floor of ``--reps``), then runs one more pass under
``torch.profiler`` and reports the device's busy share of that pass (the
union of its kernels' intervals over the pass's wall time), the kernels
that took the device time and the host operators that took the CPU time,
by name.  The profiler slows the host, so the profiled pass is longer than
the timed ones; the kernel times are the device's.

``--train`` does the same for one full-width training step of ``--arch``
at ``--train-batch`` x ``--seq`` tokens in bf16 (``runtime.Trainer``, under
its deterministic algorithms): the step's loss-and-backward and AdamW parts
timed apart after 2 warm-up steps (median of ``--reps``), then one step
profiled.

    PYTHONPATH=src python -m repro_torch.launch.profile_step --batch 1 \
        --out build/step_profile.json
    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        --arch rwkv6_1_6b --batch 1 8
    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        --arch hymba_1_5b --batch 1 8
    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        --arch mixtral_8x22b --layers 12 --batch 1 8
    PYTHONPATH=src python -m repro_torch.launch.profile_step --train
"""
from __future__ import annotations

import argparse
import json
import statistics
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
    return profile_call(lambda: ex._run(bucket, 1.0))


def profile_call(fn) -> dict:
    """``fn()`` once under the profiler, synchronised at its end."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
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


def profile_train(arch: str, batch: int, seq: int, reps: int) -> dict:
    """Full-width training steps of ``arch`` in bf16: loss-and-backward and
    the AdamW update timed apart (host clock, synchronised), then one step
    under the profiler."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import RunOptions
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                             deterministic)

    cfg = get_config(arch)
    tr = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=seq,
                                 global_batch=batch), TrainerConfig(),
                 RunOptions(remat="none"),
                 adamw.AdamWConfig(lr=3e-3, warmup_steps=20),
                 device="cuda")
    state = tr.init_state()
    parts = {"loss_backward_ms": [], "adamw_ms": []}
    with deterministic(tr.device):
        for step in range(2):
            tr.train_step(state, tr.data.batch(step))
        for step in range(2, 2 + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, grads = tr.loss_and_grads(state["params"],
                                         tr.data.batch(step))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state["params"], state["opt"], _, _ = adamw.update(
                tr.opt_cfg, state["params"], grads, state["opt"])
            torch.cuda.synchronize()
            parts["loss_backward_ms"].append((t1 - t0) * 1e3)
            parts["adamw_ms"].append((time.perf_counter() - t1) * 1e3)
            del grads
        prof = profile_call(lambda: tr.train_step(
            state, tr.data.batch(2 + reps)))
    out = {k: statistics.median(v) for k, v in parts.items()}
    out.update({"arch": arch, "batch": batch, "seq": seq,
                "n_params": cfg.n_params, "profiled_step": prof})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve this many layers at every published width "
                         "(default: the config's depth)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--train", action="store_true",
                    help="profile a full-width training step instead")
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)

    from repro_torch.serving.executor import TorchExecutor

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.train:
        out = profile_train(args.arch, args.train_batch, args.seq,
                            args.reps)
        p = out["profiled_step"]
        print(f"[profile-train] {args.arch} bf16 B={args.train_batch} "
              f"S={args.seq}: loss+backward {out['loss_backward_ms']:.3f} "
              f"ms, AdamW {out['adamw_ms']:.3f} ms (medians of "
              f"{args.reps}); profiled step {p['wall_ms']:.3f} ms, device "
              f"busy {p['device_busy_ms']} ms (share "
              f"{p['device_busy_share']}), {p['device_kernels']} kernels")
        for k in p["top_kernels"][:12]:
            print(f"[profile-train]   device {k['ms']:.3f} ms x{k['count']} "
                  f"{k['name']}")
        for k in p["top_host_ops"][:8]:
            print(f"[profile-train]   host {k['self_cpu_ms']:.3f} ms "
                  f"x{k['count']} {k['name']}")
        print(f"[profile-train] {smi}")
        out["device"] = smi
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=2)
        return out
    ex = TorchExecutor(args.arch, batch_lattice=tuple(args.batch),
                       quotas=(1.0,), prompt_len=args.prompt_len,
                       gen_len=args.gen_len, n_layers=args.layers,
                       device="cuda")
    ex.warmup()
    depth = ex.cfg.n_layers
    out = {"arch": args.arch, "n_layers": depth, "device": smi,
           "prompt_len": args.prompt_len, "gen_len": args.gen_len,
           "buckets": {}}
    for b in args.batch:
        rec = ex.measure(b, 1.0, reps=args.reps)
        row = {"prefill_ms": rec.prefill_ms, "decode_ms": rec.decode_ms,
               "decode_step_ms": rec.decode_ms / args.gen_len,
               "profiled_pass": profile_pass(ex, b)}
        out["buckets"][b] = row
        p = row["profiled_pass"]
        print(f"[profile-step] {args.arch} {depth} layers batch={b}: "
              f"prefill {rec.prefill_ms:.3f} ms, "
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
