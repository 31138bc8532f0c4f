#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100 class).

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is nonzero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every ``src/repro_torch/kernels/*/csrc/*.cu``, one ``nvcc`` each,
   all at once, with the compiler's register / spill report;
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the serving path's shapes and at small shapes with every mask,
   with TF32 off; then the kernel's time, the plain version's time and
   one PyTorch library call's time (CUDA events, median of 30 launches
   after warmup, L2 flushed between launches, host launch overhead kept
   out of the span); then the reduced model with the kernels against the
   same model on the plain path;
4. serve: ``serve_real`` on full-width InternLM2-1.8B in bf16 through
   Gateway -> ESGScheduler -> ClusterSim -> TorchExecutor, with the kernels'
   launch counters set to 0 just before and read just after, and the
   run's invariants asserted;
5. report: one JSON line of kernel numbers, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
nonzero and prints no result.  Longer outputs go to ``build/chip_smoke/``.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build" / "chip_smoke"

# serving run: prompt 128, 16 generated tokens, the (1, 2, 4, 8) batch
# lattice at quotas (1.0, 0.5), 24 mmpp requests, seed 0
ARCH = "internlm2_1_8b"
PROMPT_LEN, GEN_LEN = 128, 16
BATCHES, QUOTAS = (1, 2, 4, 8), (1.0, 0.5)
N_REQUESTS, SEED = 24, 0
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_TOL = 1e-4    # reduced model, fp32, kernels vs plain path: logits
SLEEP_CYCLES = 4_000_000   # ~2 ms of device time at H100 clocks


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one ``fn()`` call, by CUDA events, with the
    L2 cache flushed before every timed launch.  A sleep kernel ahead of
    the start event keeps the device busy while the host enqueues the
    call, so the host's launch overhead falls outside the timed span."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(peaks, nbytes: float, flops: float, dtype: str) -> tuple:
    """(least ms, "bytes" | "operations") on the card for the given work."""
    rate = peaks.peak_flops if dtype == "bfloat16" else peaks.fp32_flops
    t_bytes = nbytes / peaks.hbm_bw * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _err(torch, out, ref, tol: float) -> float:
    err = float((out.float() - ref.float()).abs().max())
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    if not ok or not math.isfinite(err):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {err} > tol {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_flash_attention(torch, fa_ops, cfg) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)

    def case(b, sq, skv, h, kvh, d, dtype, **kw):
        q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, skv, kvh, d), generator=g,
                        device="cuda").to(dtype)
        v = torch.randn((b, skv, kvh, d), generator=g,
                        device="cuda").to(dtype)
        kw = dict(causal=True, q_offset=skv - sq, **kw)
        out = fa_ops.flash_attention(q, k, v, **kw)
        ref = fa_ops.flash_attention_oracle(q, k, v, **kw)
        torch.cuda.synchronize()
        return _err(torch, out, ref, TOL[str(dtype)[6:]])

    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    main_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            err = case(b, PROMPT_LEN, PROMPT_LEN, h, kvh, d, dtype)
            log(f"[kernels] flash_attention B={b} S={PROMPT_LEN} H={h} "
                f"KV={kvh} D={d} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                f"tol={TOL[str(dtype)[6:]]}")
            if dtype == torch.bfloat16:
                main_err = max(main_err, err)
    small = [  # (b, sq, skv, h, kvh, d, masks)
        (2, 256, 256, 4, 2, 64, {}),
        (2, 256, 256, 4, 1, 64, {"window": 64}),
        (1, 384, 384, 4, 2, 64, {"local_block": 128}),
        (2, 200, 200, 2, 2, 64, {}),
        (1, 128, 384, 4, 4, 64, {}),                  # q_offset 256
        (2, 40, 40, 4, 2, 16, {}),                    # S < tile
        (1, 24, 24, 4, 2, 32, {"window": 8}),
        (2, 50, 90, 4, 2, 16, {"local_block": 16}),   # q_offset 40
        (1, 100, 100, 8, 2, 128, {"window": 30, "local_block": 64}),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for (b, sq, skv, hh, kk, dd, masks) in small:
            err = case(b, sq, skv, hh, kk, dd, dtype, **masks)
            log(f"[kernels] flash_attention B={b} Sq={sq} Skv={skv} H={hh} "
                f"KV={kk} D={dd} {masks} {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e}")
    return {"max_abs_err": main_err, "tol": TOL["bfloat16"]}


def check_flash_decode(torch, fd_ops, cfg) -> dict:
    g = torch.Generator(device="cuda").manual_seed(2)

    def inputs(b, s, h, kvh, d, dtype):
        q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
        kc = torch.randn((b, s, kvh, d), generator=g,
                         device="cuda").to(dtype)
        vc = torch.randn((b, s, kvh, d), generator=g,
                         device="cuda").to(dtype)
        return q, kc, vc

    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_main = PROMPT_LEN + GEN_LEN
    main_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype)[6:]]
        for b in (1, 8):
            q, kc, vc = inputs(b, s_main, h, kvh, d, dtype)
            t = torch.zeros(1, dtype=torch.int32, device="cuda")
            # one launch setup, several device positions
            for pos in (0, PROMPT_LEN // 2 + 3, s_main - 1):
                t.fill_(pos)
                out = fd_ops.flash_decode_at(q, kc, vc, t)
                ref = fd_ops.decode_ref(q, kc, vc, t=pos)
                torch.cuda.synchronize()
                err = _err(torch, out, ref, tol)
                if dtype == torch.bfloat16:
                    main_err = max(main_err, err)
                log(f"[kernels] flash_decode_at B={b} S={s_main} H={h} "
                    f"KV={kvh} D={d} t={pos} {str(dtype)[6:]}: "
                    f"max_abs_err={err:.3e} tol={tol}")
    small = [  # (b, h, kvh, s, d, t, masks)
        (2, 8, 2, 1024, 64, 1023, {}),
        (2, 8, 8, 1024, 128, 700, {}),
        (1, 4, 2, 512, 64, 2000, {"window": 512}),
        (1, 4, 4, 256, 64, 900, {"local_block": 128}),
        (2, 4, 2, 700, 64, 699, {}),                  # S not a tile multiple
        (2, 4, 2, 64, 16, 17, {}),
        (2, 4, 2, 64, 16, 40, {"window": 16}),
        (2, 4, 2, 64, 16, 29, {"local_block": 8}),
        (1, 16, 2, 100, 32, 250, {"window": 60, "local_block": 32}),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype)[6:]]
        for (b, hh, kk, s, dd, pos, masks) in small:
            q, kc, vc = inputs(b, s, hh, kk, dd, dtype)
            ref = fd_ops.decode_ref(q, kc, vc, t=pos, **masks)
            t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
            out_at = fd_ops.flash_decode_at(q, kc, vc, t, **masks)
            out_static = fd_ops.flash_decode(q, kc, vc, t=pos, **masks)
            torch.cuda.synchronize()
            e1 = _err(torch, out_at, ref, tol)
            e2 = _err(torch, out_static, ref, tol)
            log(f"[kernels] flash_decode(_at) B={b} H={hh} KV={kk} S={s} "
                f"D={dd} t={pos} {masks} {str(dtype)[6:]}: "
                f"max_abs_err={max(e1, e2):.3e}")
    return {"max_abs_err": main_err, "tol": TOL["bfloat16"]}


def time_kernels(torch, fa_ops, fd_ops, cfg, peaks) -> dict:
    """Kernel / plain / library times at the largest serving bucket (and
    at batch 1), bf16."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(3)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    bf = torch.bfloat16
    esize = 2
    rows = {}
    for b in (max(BATCHES), 1):
        s = PROMPT_LEN
        q = torch.randn((b, s, h, d), generator=g, device="cuda").to(bf)
        k = torch.randn((b, s, kvh, d), generator=g, device="cuda").to(bf)
        v = torch.randn((b, s, kvh, d), generator=g, device="cuda").to(bf)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize
        flops = 4.0 * b * h * d * s * (s + 1) / 2     # causal pairs
        b_ms, b_by = bound(peaks, nbytes, flops, "bfloat16")
        fa = {
            "ms": time_ms(torch, lambda: fa_ops.flash_attention(q, k, v)),
            "plain_ms": time_ms(
                torch, lambda: fa_ops.flash_attention_oracle(q, k, v)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B={b} S={s} H={h} KV={kvh} D={d} bf16",
        }
        s = PROMPT_LEN + GEN_LEN
        pos = s - 1
        qd = torch.randn((b, h, d), generator=g, device="cuda").to(bf)
        kc = torch.randn((b, s, kvh, d), generator=g, device="cuda").to(bf)
        vc = torch.randn((b, s, kvh, d), generator=g, device="cuda").to(bf)
        t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
        mask = (torch.arange(s, device="cuda") <= pos)[None, None, None, :]
        qdt, kct, vct = qd[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
        nbytes = (2 * qd.numel() + 2 * b * (pos + 1) * kvh * d) * esize + 4
        flops = 4.0 * b * h * d * (pos + 1)
        b_ms, b_by = bound(peaks, nbytes, flops, "bfloat16")
        fd = {
            "ms": time_ms(torch, lambda: fd_ops.flash_decode_at(qd, kc, vc, t)),
            "plain_ms": time_ms(
                torch, lambda: fd_ops.decode_ref(qd, kc, vc, t=t)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qdt, kct, vct, attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B={b} S={s} t={pos} H={h} KV={kvh} D={d} bf16",
        }
        fds = {"ms": time_ms(
            torch, lambda: fd_ops.flash_decode(qd, kc, vc, t=pos)),
            "shape": fd["shape"]}
        rows[b] = {"flash_attention": fa, "flash_decode_at": fd,
                   "flash_decode": fds}
        for name, r in rows[b].items():
            log(f"[timing] {name} {r['shape']}: " + " ".join(
                f"{k}={r[k]:.4f}" for k in
                ("ms", "plain_ms", "library_ms", "bound_ms") if k in r)
                + (f" bound_by={r['bound_by']}" if "bound_by" in r else ""))
    return rows


def check_model(torch) -> float:
    """Reduced InternLM2 in fp32 on the card: the kernel path against the
    plain path, prefill and decode logits."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.models.model import RunOptions, get_model

    cfg = reduced(get_config(ARCH))
    f32 = torch.float32
    plain = get_model(cfg, RunOptions(param_dtype=f32, act_dtype=f32),
                      "cuda")
    kern = get_model(cfg, RunOptions(param_dtype=f32, act_dtype=f32,
                                     use_kernels=True), "cuda")
    params = plain.init(SEED)
    g = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (2, 52), generator=g, device="cuda")
    lp, cp = plain.prefill(params, {"tokens": toks[:, :48]}, max_len=52)
    lk, ck = kern.prefill(params, {"tokens": toks[:, :48]}, max_len=52)
    errs = [float((lp - lk).abs().max())]
    for i in range(48, 52):
        lp, cp = plain.decode(params, cp, toks[:, i:i + 1])
        lk, ck = kern.decode(params, ck, toks[:, i:i + 1])
        errs.append(float((lp - lk).abs().max()))
    err = max(errs)
    if not err <= MODEL_TOL:
        raise AssertionError(f"reduced model: kernel path vs plain path "
                             f"logits differ by {err} > {MODEL_TOL}")
    log(f"[kernels] reduced {ARCH} fp32, kernels vs plain path: "
        f"max |logits diff| over prefill + 4 decode steps = {err:.3e} "
        f"(tol {MODEL_TOL})")
    return err


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------
def serve(torch, fa_ops, fd_ops, cfg) -> dict:
    from repro_torch.launch.serve import serve_real

    fa_ops.flash_attention.launches = 0
    fd_ops.flash_decode_at.launches = 0
    fd_ops.flash_decode.launches = 0
    t0 = time.perf_counter()
    bench = serve_real(arch=ARCH, reduced=False, dtype=torch.bfloat16,
                       device="cuda", n_requests=N_REQUESTS,
                       scenario="mmpp", seed=SEED, prompt_len=PROMPT_LEN,
                       gen_len=GEN_LEN, batches=BATCHES, quotas=QUOTAS,
                       bench_out=str(OUT / "serve_bench.json"), log=log)
    launches = {"flash_attention": fa_ops.flash_attention.launches,
                "flash_decode_at": fd_ops.flash_decode_at.launches}
    serve_s = time.perf_counter() - t0

    ex, tel = bench["executor"], bench["telemetry"]
    n_layers = cfg.n_layers
    executed = sum(c["n_executed"] for c in bench["cells"])
    checks = {
        "every request answered or shed":
            tel["completed"] + tel["shed"] == tel["injected"] == N_REQUESTS,
        "one executor record per dispatched task":
            executed == ex["executed"] == bench["dispatched_tasks"] > 0,
        "post-warmup hit rate 1.0": ex["post_warmup_hit_rate"] == 1.0,
        "every prefill through the flash_attention kernel":
            launches["flash_attention"] == n_layers * ex["prefill_passes"] > 0,
        "every decode step through the flash_decode kernel":
            launches["flash_decode_at"] == n_layers * ex["decode_steps"] > 0,
        "logits finite": ex["nonfinite_passes"] == 0,
        "digest unchanged by the executor":
            bench["digest"]["with_executor"]
            == bench["digest"]["without_executor"],
    }
    log(f"[serve] {ARCH} full width bf16: {serve_s:.1f}s, "
        f"{tel['injected']} requests ({tel['completed']} done, "
        f"{tel['shed']} shed), {bench['dispatched_tasks']} tasks, "
        f"{ex['prefill_passes']} prefill passes, {ex['decode_steps']} "
        f"decode steps, launches {launches}")
    log(f"[serve] slo_attainment={tel['slo_attainment']:.4f} "
        f"mean_abs_err={bench['mean_abs_err']:.4f} "
        f"hit_rate={ex['post_warmup_hit_rate']} "
        f"digest={bench['digest']['with_executor']}")
    for c in bench["cells"]:
        log(f"[serve] cell batch={c['batch']} quota={c['quota']}: "
            f"predicted {c['predicted_ms']:.3f} ms, measured "
            f"{c['measured_ms']:.3f} ms (n={c['n_executed']}, "
            f"abs_err {c['abs_err']:.4f})")
    for r in bench["roofline"]:
        log(f"[serve] roofline {r['stage']} batch={r['batch']}: bound "
            f"{r['bound_ms']:.4f} ms ({r['dominant']}, {r['device_peaks']}), "
            f"measured {r['measured_ms']:.4f} ms, fraction "
            f"{r['bound_fraction']:.4f}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve invariants failed: {failed}")
    log(f"[serve] invariants hold: {list(checks)}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    OUT.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    log(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{n} {r['seconds']:.1f}s" for n, r in built.items()))
    for n, r in built.items():
        for line in r["log"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"[build] {n}: {line.strip()}")

    # 3. kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.launch.roofline import device_peaks

    cfg = get_config(ARCH)
    peaks = device_peaks(name)
    fa_chk = check_flash_attention(torch, fa_ops, cfg)
    fd_chk = check_flash_decode(torch, fd_ops, cfg)
    timing = time_kernels(torch, fa_ops, fd_ops, cfg, peaks)
    check_model(torch)

    # 4. serve
    launches = serve(torch, fa_ops, fd_ops, cfg)

    # 5. report
    big = timing[max(BATCHES)]
    kernels = []
    for kname, chk, src, rep in (
            ("flash_attention", fa_chk,
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:88"),
            ("flash_decode_at", fd_chk,
             "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode/flash_decode.py:139")):
        r = big[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[kname], "max_abs_err": chk["max_abs_err"],
            "tol": chk["tol"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump({"kernels": kernels, "timing": timing,
                   "device": name, "nvidia_smi": smi}, f, indent=2)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
