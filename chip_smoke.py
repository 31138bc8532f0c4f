#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100 class).

    python3 chip_smoke.py [--wkv6-previous CU]

Phases, in order; any failure raises and the exit code is nonzero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every ``src/repro_torch/kernels/*/csrc/*.cu``, one ``nvcc`` each,
   all at once, with the compiler's register / spill report;
3. kernels: each CUDA kernel (flash-attention, flash-decode, WKV6)
   against its plain PyTorch version on the card, at the serving paths'
   shapes and at small shapes with every mask, padding tail and head dim,
   every q-tile route of the bf16 flash-attention and the float32 route,
   flash-decode's cluster edge cases (t = 0, empty blocks, S = 4096,
   ring masks), its static-position entry (``flash_decode``, t by value)
   there and at Llama-4 Maverick's chunked-local ring (B = 8, S = 8192,
   t = 8292: 101 live slots), one profiled static call (one kernel, no
   host-to-device copy, one allocation), and every (VB, P, CPT) route of
   WKV6 at T = 1, 31, 33 and 200, with TF32 off; then the kernel's time,
   the plain version's time and, where one exists, one PyTorch library
   call's time (CUDA events, median of 30 launches after warmup, L2
   flushed between launches, host launch overhead kept out of the span),
   at the serving shapes and at one long shape per kernel (the static
   flash-decode beside ``flash_decode_at`` at the serving shapes, S = 4096
   and the chunked-local ring, with SDPA given the ring's mask), WKV6's
   time on each of its routes at every serving bucket and, with ``--wkv6-previous``, an earlier WKV6 design's time
   beside it (its source built apart from the package); flash-attention's
   window route at Mixtral-8x22B's shapes (B = 1 and 8 at S = 128, and
   B = 1 at S = 4160 and 4224, past the 4096-token window, with the rows
   past the window checked on their own), timed at B = 8 S = 128 and
   B = 1 S = 4160; then each reduced model (InternLM2, RWKV6) with the
   kernels against the same model on the plain path, the reduced Hymba
   (which runs no kernel, as in the reference) on the card against the
   same model on the CPU, at a prompt wider than its window (a rolled
   ring) and one narrower (the reference's prompt-wide ring), and the
   reduced Mixtral (window 32) and Llama-4 (chunk 32, one global layer in
   four) on the card's kernel path against the CPU's plain path, at
   prompts 48 and 16, with their launch counts;
4. serve: ``serve_real`` on full-width InternLM2-1.8B, RWKV6-1.6B and
   Hymba-1.5B, then on full-width Mixtral-8x22B at a depth cut of
   MIXTRAL_LAYERS layers, all in bf16, through Gateway -> ESGScheduler ->
   ClusterSim -> TorchExecutor, each with every kernel's launch counter
   set to 0 just before and read just after, and the run's invariants
   asserted: each kernel of the path launched once per layer per prefill
   pass or decode step, every other kernel (for Hymba, every kernel) not
   at all, every decode step after warm-up replayed from the bucket's
   CUDA graph (the graphs and the peak memory logged); Mixtral's peak
   memory leaves MIN_FREE_GIB of the card free;
   then the cut Mixtral on a prompt of 4160 tokens and 4 decode steps
   (ring slots, decode writes and finite logits gated; the bf16 distance
   from the plain path and the differing expert routes reported), and
   whether the code_review app's StarCoder2-7B fits beside it;
5. emulate (host only, no model and no kernel runs): the zoo's profile
   tables for this card (each arch's t1), then ``emulate`` at
   moderate-normal with ESG and with each of the four baselines, and one
   mmpp scenario run with the ewma autoscaler, every request accounted
   for, every kernel counter at 0;
6. train (plain PyTorch autograd, no kernel, as in the reference): the
   reference's token stream at full width on the card against the CPU;
   the reduced InternLM2, RWKV6, Hymba, Mixtral and Llama-4, 3 AdamW
   steps on the card against the same 3 on the CPU, the losses in float32
   and every parameter's update in float64; the reduced InternLM2 in
   bf16, 12 steps with a failure injected at step 6 and a resume from the
   step-4 checkpoint, against an uninterrupted run; full-width
   InternLM2-1.8B in bf16 at B = 8, S = 128, 8 steps with a checkpoint at
   step 4 and one more step with int8 gradient compression, timed; every
   kernel counter at 0;
7. shard (the multi-device layer, ``launch/steps.py``, on a one-rank
   NCCL process group and a (1, 1) mesh): full-width InternLM2-1.8B in
   bf16 from seed 0 through the sharded prefill step with the kernels at
   B = 8, S = 128 (flash-attention once a layer, no other kernel), its
   logits and cache against the unsharded ``Model.prefill``, and again
   with explicit TP; 16 serve steps (the sequence-sharded decode, no
   flash-decode launch, as in the reference), each against the unsharded
   plain decode from the same state; full-width RWKV6-1.6B through the
   sharded prefill (WKV6 once a layer) against the unsharded prefill,
   logits and state, and 16 serve steps with the state kept in its
   layout (heads over 'model'), each against the unsharded plain decode;
   3 train steps against phase 6's Trainer losses, the third of them
   counted (FlopCounterMode, peak memory after a reset); the prefill is
   counted too; then the process group destroyed;
8. dryrun (``launch/dryrun.py``: fake process groups, fake tensors, no
   device, no kernel): the shard phase's train cell traced on a (1, 1)
   mesh of one fake rank, its FLOPs against the card's count of the same
   step (rel 1e-9) and its estimated peak against the card's
   ``max_memory_allocated`` (10%); then the multi-pod example's cell,
   InternLM2-20B train_4k on 2 x 16 x 16 (512 fake ranks), must trace;
   then rank 0 of a 2-way and of an 8-way 'model' group on the card (a
   fake process group, a (1, n) CUDA mesh, real bf16 tensors, full-width
   InternLM2-1.8B): the sharded prefill (flash-attention once a layer on
   the rank's heads) and a train step, each timed and counted under
   FlopCounterMode: equal to the trace of the same cell on fake CUDA
   tensors (rel 1e-9), within 2% of 1 / n of the shard phase's (1, 1)
   count, peak within 10% of the traced one (values are not compared:
   a fake collective moves no data);
9. report: one JSON line of kernel numbers, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
nonzero and prints no result.  Longer outputs go to ``build/chip_smoke/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build" / "chip_smoke"

# serving runs: prompt 128, 16 generated tokens, the (1, 2, 4, 8) batch
# lattice at quotas (1.0, 0.5), 24 mmpp requests, seed 0
ARCH = "internlm2_1_8b"
RWKV_ARCH = "rwkv6_1_6b"
HYMBA_ARCH = "hymba_1_5b"
MIXTRAL_ARCH = "mixtral_8x22b"
LLAMA4_ARCH = "llama4_maverick_400b_a17b"
# full-width Mixtral-8x22B at a depth cut: every published width, 12 of its
# 56 layers (2.50e9 parameters, 4.66 GiB in bf16, a layer), so that the
# card keeps MIN_FREE_GIB free at the serving peak
MIXTRAL_LAYERS = 12
MIN_FREE_GIB = 8.0
# a prompt past Mixtral's 4096-token window: the ring rolls by 64
LONG_PROMPT, LONG_DECODE = 4160, 4
PROMPT_LEN, GEN_LEN = 128, 16
BATCHES, QUOTAS = (1, 2, 4, 8), (1.0, 0.5)
N_REQUESTS, SEED = 24, 0
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# WKV6: the reference's WKV_TOL (tests/test_realcompute.py) for float32,
# the bf16 kernel tolerance for bf16
WKV_TOL = {"float32": 5e-3, "bfloat16": 2e-2}
MODEL_TOL = 1e-4    # reduced model, fp32, kernels vs plain path: logits
# the rows of a windowed attention past its window are averages over 4096
# keys, far smaller than the first rows: their own check takes an atol of
# ROWS_TOL x their rms (and rtol ROWS_TOL)
ROWS_TOL = 2e-2
EMULATE_N = 200
# training: reduced models, card vs CPU, 3 AdamW steps from the same
# parameters on the same batches: in float32 (TF32 off) each step's loss
# within rel TRAIN_LOSS_RTOL; in float64 each parameter's total update
# within TRAIN_UPDATE_RTOL of the CPU's (relative L2 norm), one rule for
# every leaf of every arch.  The update is gated in float64 because Adam
# divides by |g|: a gradient element at float32's noise level can flip
# the sign of its update, so a float32 update distance measures rounding
# as much as the port (the float32 distance is printed beside the CPU's
# own float32-vs-float64 distance)
TRAIN_ARCHS = (ARCH, RWKV_ARCH, HYMBA_ARCH, MIXTRAL_ARCH, LLAMA4_ARCH)
TRAIN_LOSS_RTOL, TRAIN_UPDATE_RTOL = 1e-5, 1e-3
RESTART_ATOL = 1e-6   # final loss, resumed vs uninterrupted (bf16)
FULL_BATCH, FULL_SEQ, FULL_STEPS, FULL_CKPT_AT, FULL_WARMUP = 8, 128, 8, 4, 2
SLEEP_CYCLES = 4_000_000   # ~2 ms of device time at H100 clocks
# the shard phase: full-width InternLM2-1.8B on a one-rank NCCL mesh,
# prefill at B = 8 and S = PROMPT_LEN, SHARD_DECODE serve steps, and
# SHARD_TRAIN_STEPS train steps at the phase-6 shape; logits and losses
# (relative) within BF16_TOL of the unsharded path
SHARD_BATCH, SHARD_DECODE, SHARD_TRAIN_STEPS = 8, 16, 3
BF16_TOL = TOL["bfloat16"]
# the dry-run phase holds its trace of the shard phase's train cell to
# that phase's step SHARD_COUNTED_STEP (counted under FlopCounterMode,
# peak memory read after a reset): the same aten ops run, so the FLOPs
# agree to rounding; the traced peak (inputs + the storages alive at
# once) within DRYRUN_PEAK_RTOL of max_memory_allocated
SHARD_COUNTED_STEP = 2
DRYRUN_FLOP_RTOL, DRYRUN_PEAK_RTOL = 1e-9, 0.10
# the dry-run phase's ranks of a 'model' group of RANK_SPLITS ranks (a fake
# process group: collectives move no data), on the card: the sharded
# prefill and a train step counted, each within SPLIT_FLOP_RTOL of 1 / n
# of the shard phase's (1, 1) count
RANK_SPLITS, SPLIT_FLOP_RTOL = (2, 8), 0.02


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


def _err(torch, out, ref, tol: float) -> tuple:
    """(max |out - ref|, margin) with atol = rtol = ``tol``; the margin is
    max |out - ref| / (atol + rtol |ref|), the share of the allowed error
    used (the check fails above 1)."""
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    margin = float((diff / (tol + tol * ref.float().abs())).max())
    if not margin <= 1.0 or not math.isfinite(err):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {err}, margin {margin} > 1 "
                             f"(atol = rtol = {tol})")
    return err, margin


def _worst(a: tuple, b: tuple) -> tuple:
    return max(a[0], b[0]), max(a[1], b[1])


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_flash_attention(torch, fa_ops, cfg) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = set()

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

    def route(b, sq, skv, h, dtype) -> str:
        """The bf16 kernel's (q tile, kv tile) for this launch (float32: the
        FMA route)."""
        if dtype != torch.bfloat16:
            return "fma"
        tile = fa_ops.choose_tiles(b, h, sq, skv, n_sm)
        tiles.add(tile)
        return f"tc q_tile={tile[0]} kv_tile={tile[1]}"

    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    main = (0.0, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            err, margin = case(b, PROMPT_LEN, PROMPT_LEN, h, kvh, d, dtype)
            log(f"[kernels] flash_attention B={b} S={PROMPT_LEN} H={h} "
                f"KV={kvh} D={d} {str(dtype)[6:]} "
                f"{route(b, PROMPT_LEN, PROMPT_LEN, h, dtype)}: "
                f"max_abs_err={err:.3e} "
                f"margin={margin:.3f} tol={TOL[str(dtype)[6:]]}")
            if dtype == torch.bfloat16:
                main = _worst(main, (err, margin))
    # the 32-row q tile: the least batch at S = 256 whose 64-row grid falls
    # short of the SMs and whose 32-row grid does not
    b32 = -(-n_sm // (2 * 4 * h))
    small = [  # (b, sq, skv, h, kvh, d, masks)
        (b32, 256, 256, h, kvh, d, {}),
        (2, 200, 200, h, kvh, d, {}),                 # Sq not a multiple of 16
        (1, 512, 512, h, kvh, d, {}),                 # 32-row q, 64-row kv
        (1, 2048, 2048, h, kvh, d, {}),               # the long prompt
        (2, 256, 256, 4, 2, 64, {}),
        (2, 256, 256, 4, 1, 64, {"window": 64}),
        (1, 384, 384, 4, 2, 64, {"local_block": 128}),
        (2, 200, 200, 2, 2, 64, {}),
        (1, 128, 384, 4, 4, 64, {}),                  # q_offset 256
        (2, 40, 40, 4, 2, 16, {}),                    # S < tile
        (1, 24, 24, 4, 2, 32, {"window": 8}),
        (2, 50, 90, 4, 2, 16, {"local_block": 16}),   # q_offset 40
        (1, 100, 100, 8, 2, 128, {"window": 30, "local_block": 64}),
        # head blocks of the sharded prefill: a rank of a 2-way and of an
        # 8-way 'model' group at full width
        (SHARD_BATCH, PROMPT_LEN, PROMPT_LEN, h // 2, kvh // 2, d, {}),
        (SHARD_BATCH, PROMPT_LEN, PROMPT_LEN, h // 8, kvh // 8, d, {}),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for (b, sq, skv, hh, kk, dd, masks) in small:
            err, margin = case(b, sq, skv, hh, kk, dd, dtype, **masks)
            log(f"[kernels] flash_attention B={b} Sq={sq} Skv={skv} H={hh} "
                f"KV={kk} D={dd} {masks} {str(dtype)[6:]} "
                f"{route(b, sq, skv, hh, dtype)}: max_abs_err={err:.3e} "
                f"margin={margin:.3f}")
    want = {(q, kv) for q in fa_ops.Q_TILES for kv in fa_ops.KV_TILES}
    if tiles != want:
        raise AssertionError(f"bf16 (q tile, kv tile) routes checked: "
                             f"{sorted(tiles)}, want all of {sorted(want)}")
    return _check_row(main, TOL["bfloat16"])


def _check_row(main: tuple, tol: float) -> dict:
    """The main path's (bf16) agreement, as the kernels JSON line gives it:
    the check is allclose(atol=tol, rtol=tol), passed iff margin <= 1."""
    return {"max_abs_err": main[0], "margin": main[1], "atol": tol,
            "rtol": tol}


def chunked_local_shape(lcfg) -> tuple:
    """(b, s, t, h, kvh, d, masks) of the static flash-decode's ring timing
    shape: a chunked-local layer of Llama-4 Maverick (its ring of
    ``chunk_attn`` slots) at B = 8, 100 positions into its second chunk,
    so 101 of the ring's slots are live."""
    c = lcfg.chunk_attn
    return (8, c, c + 100, lcfg.n_heads, lcfg.n_kv_heads, lcfg.d_head,
            {"local_block": c})


def decode_mask(torch, s: int, pos: int, masks: dict):
    """The slots the decode mask admits at ``pos``, from the reference's
    formula (src/repro/kernels/flash_decode/flash_decode.py:44-55)."""
    slots = torch.arange(s, device="cuda")
    window, local = masks.get("window"), masks.get("local_block")
    if window is None and local is None:
        return slots <= pos
    kv_pos = pos - torch.remainder(pos - slots, s)
    ok = kv_pos >= 0
    if window is not None:
        ok &= (pos - kv_pos) < window
    if local is not None:
        ok &= kv_pos >= (pos // local) * local
    return ok


def profile_static_decode(torch, fd_ops, cfg) -> dict:
    """One static ``flash_decode`` call at the serving shape under
    ``torch.profiler``: exactly one kernel on the device, no host-to-device
    copy, and one allocation (the output)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, s = max(BATCHES), PROMPT_LEN + GEN_LEN
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((b, cfg.n_heads, cfg.d_head), generator=g,
                    device="cuda").bfloat16()
    kc, vc = (torch.randn((b, s, cfg.n_kv_heads, cfg.d_head), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    fd_ops.flash_decode(q, kc, vc, t=s - 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        fd_ops.flash_decode(q, kc, vc, t=s - 1)
        allocated = torch.cuda.memory_stats()["allocation.all.allocated"] \
            - before
        torch.cuda.synchronize()
    on_device = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    copies = [n for n in on_device if "Memcpy" in n]
    log(f"[kernels] flash_decode B={b} S={s} t={s - 1} under the profiler: "
        f"device events {on_device}, allocations {allocated}")
    if copies or len(on_device) != 1 or "fd_cluster_kernel" not in \
            on_device[0] or allocated != 1:
        raise AssertionError(f"static flash_decode: want one kernel, no "
                             f"copy and one allocation; got {on_device}, "
                             f"{allocated} allocations")
    return {"device_events": on_device, "allocations": allocated}


def check_flash_decode(torch, fd_ops, cfg, lcfg) -> tuple:
    """Both entries against the plain version; returns the bf16 agreement
    of ``flash_decode_at`` (the path's) and of the static ``flash_decode``
    at the serving shapes and the chunked-local ring."""
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
    main = static = (0.0, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype)[6:]]
        for b in (1, 8):
            q, kc, vc = inputs(b, s_main, h, kvh, d, dtype)
            t = torch.zeros(1, dtype=torch.int32, device="cuda")
            # one launch setup, several device positions
            for pos in (0, PROMPT_LEN // 2 + 3, s_main - 1):
                t.fill_(pos)
                out = fd_ops.flash_decode_at(q, kc, vc, t)
                out_static = fd_ops.flash_decode(q, kc, vc, t=pos)
                ref = fd_ops.decode_ref(q, kc, vc, t=pos)
                torch.cuda.synchronize()
                err, margin = _err(torch, out, ref, tol)
                err_s, margin_s = _err(torch, out_static, ref, tol)
                if dtype == torch.bfloat16:
                    main = _worst(main, (err, margin))
                    static = _worst(static, (err_s, margin_s))
                log(f"[kernels] flash_decode_at B={b} S={s_main} H={h} "
                    f"KV={kvh} D={d} t={pos} {str(dtype)[6:]}: "
                    f"max_abs_err={err:.3e} margin={margin:.3f} tol={tol}; "
                    f"flash_decode: max_abs_err={err_s:.3e} "
                    f"margin={margin_s:.3f}")
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
        # a cache shorter than one cluster's chunks (a cluster of 2 blocks)
        (2, h, kvh, 40, d, 39, {}),
        # t = 20 at S = 144: 4 of the cluster's 5 blocks hold no valid slot
        (1, h, kvh, s_main, d, 20, {}),
        # S = 4096: every block walks 16 chunks
        (8, h, kvh, 4096, d, 4095, {}),
        # the ring masks over a full cluster, each block several chunks
        (2, h, kvh, 1024, d, 3000, {"window": 300}),
        (2, h, kvh, 1024, d, 2500, {"local_block": 256}),
        (1, h, kvh, 1024, d, 1500, {"window": 700, "local_block": 512}),
        # a window's arc of live slots wrapping past slot 0
        (2, h, kvh, 1024, d, 1100, {"window": 300}),
    ]
    cb, cs, ct, ch, ckv, cd, cmasks = chunked_local_shape(lcfg)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype)[6:]]
        # the chunked-local ring: the static kernel walks 101 of 8192 slots
        q, kc, vc = inputs(cb, cs, ch, ckv, cd, dtype)
        ref = fd_ops.decode_ref(q, kc, vc, t=ct, **cmasks)
        t = torch.full((1,), ct, dtype=torch.int32, device="cuda")
        out_at = fd_ops.flash_decode_at(q, kc, vc, t, **cmasks)
        out_static = fd_ops.flash_decode(q, kc, vc, t=ct, **cmasks)
        torch.cuda.synchronize()
        err, margin = _err(torch, out_at, ref, tol)
        err_s, margin_s = _err(torch, out_static, ref, tol)
        if dtype == torch.bfloat16:
            static = _worst(static, (err_s, margin_s))
        log(f"[kernels] flash_decode(_at) chunked-local B={cb} H={ch} "
            f"KV={ckv} S={cs} D={cd} t={ct} {cmasks} {str(dtype)[6:]} "
            f"(live {fd_ops.live_slots(cs, ct, **cmasks)}): "
            f"flash_decode_at max_abs_err={err:.3e} margin={margin:.3f}; "
            f"flash_decode max_abs_err={err_s:.3e} margin={margin_s:.3f}")
        del q, kc, vc, ref, out_at, out_static
        for (b, hh, kk, s, dd, pos, masks) in small:
            q, kc, vc = inputs(b, s, hh, kk, dd, dtype)
            ref = fd_ops.decode_ref(q, kc, vc, t=pos, **masks)
            t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
            out_at = fd_ops.flash_decode_at(q, kc, vc, t, **masks)
            out_static = fd_ops.flash_decode(q, kc, vc, t=pos, **masks)
            torch.cuda.synchronize()
            err, margin = _worst(_err(torch, out_at, ref, tol),
                                 _err(torch, out_static, ref, tol))
            log(f"[kernels] flash_decode(_at) B={b} H={hh} KV={kk} S={s} "
                f"D={dd} t={pos} {masks} {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} margin={margin:.3f}")
    return _check_row(main, TOL["bfloat16"]), _check_row(static,
                                                         TOL["bfloat16"])


def time_kernels(torch, fa_ops, fd_ops, cfg, lcfg, peaks) -> dict:
    """Kernel / plain / library times at the largest serving bucket and at
    batch 1, bf16, and at one long shape per kernel: flash-attention at
    B=1 S=2048 (bound by operations) and flash-decode at B=8 S=4096 (bound
    by bytes, the cache larger than L2); the static flash-decode beside
    the dynamic one at those decode shapes and at Llama-4's chunked-local
    ring; then kernel / library times at every bucket of the serving
    lattice (each takes its own tiles)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(3)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    bf = torch.bfloat16
    esize = 2
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def attention(b, s, plain=True):
        q = torch.randn((b, s, h, d), generator=g, device="cuda").to(bf)
        k = torch.randn((b, s, kvh, d), generator=g, device="cuda").to(bf)
        v = torch.randn((b, s, kvh, d), generator=g, device="cuda").to(bf)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize
        flops = 4.0 * b * h * d * s * (s + 1) / 2     # causal pairs
        b_ms, b_by = bound(peaks, nbytes, flops, "bfloat16")
        return {
            "ms": time_ms(torch, lambda: fa_ops.flash_attention(q, k, v)),
            **({"plain_ms": time_ms(
                torch, lambda: fa_ops.flash_attention_oracle(q, k, v))}
               if plain else {}),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "tiles": fa_ops.choose_tiles(b, h, s, s, n_sm),
            "shape": f"B={b} S={s} H={h} KV={kvh} D={d} bf16",
        }

    def decode(b, s, pos, plain=True, static=True, masks=None, hh=h,
               kk=kvh, d=d):
        """flash_decode_at's row and, with ``static``, flash_decode's, each
        with its plain and SDPA times (SDPA with the decode mask as a
        boolean ``attn_mask``, the same call for both rows); the bound
        counts the live slots (the static kernel's walk)."""
        masks = masks or {}
        qd = torch.randn((b, hh, d), generator=g, device="cuda").to(bf)
        kc = torch.randn((b, s, kk, d), generator=g, device="cuda").to(bf)
        vc = torch.randn((b, s, kk, d), generator=g, device="cuda").to(bf)
        t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
        mask = decode_mask(torch, s, pos, masks)
        n_live = int(mask.sum())
        mask = mask[None, None, None, :]
        qdt, kct, vct = qd[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
        nbytes = (2 * qd.numel() + 2 * b * n_live * kk * d) * esize
        flops = 4.0 * b * hh * d * n_live
        shape = (f"B={b} S={s} t={pos} H={hh} KV={kk} D={d}"
                 + "".join(f" {k}={v}" for k, v in masks.items())
                 + f" live={n_live} bf16")
        library = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qdt, kct, vct, attn_mask=mask, enable_gqa=True))
        b_ms, b_by = bound(peaks, nbytes + 4, flops, "bfloat16")
        fd = {
            "ms": time_ms(torch, lambda: fd_ops.flash_decode_at(
                qd, kc, vc, t, **masks)),
            **({"plain_ms": time_ms(torch, lambda: fd_ops.decode_ref(
                qd, kc, vc, t=t, **masks))} if plain else {}),
            "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
            "shape": shape,
        }
        if not static:
            return fd, None
        b_ms, b_by = bound(peaks, nbytes, flops, "bfloat16")
        fds = {
            "ms": time_ms(torch, lambda: fd_ops.flash_decode(
                qd, kc, vc, t=pos, **masks)),
            "plain_ms": time_ms(torch, lambda: fd_ops.decode_ref(
                qd, kc, vc, t=pos, **masks)),
            "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
            "shape": shape,
        }
        return fd, fds

    # the method's floor: one launch of a one-element kernel, timed alike
    tiny = torch.zeros(1, device="cuda")
    rows = {"floor": {"one-element add_": {
        "ms": time_ms(torch, lambda: tiny.add_(1)), "shape": "1 element"}}}
    for b in (max(BATCHES), 1):
        s = PROMPT_LEN + GEN_LEN
        fd, fds = decode(b, s, s - 1)
        rows[b] = {"flash_attention": attention(b, PROMPT_LEN),
                   "flash_decode_at": fd, "flash_decode": fds}
    fd, fds = decode(max(BATCHES), 4096, 4095)
    rows["long"] = {"flash_attention": attention(1, 2048),
                    "flash_decode_at": fd, "flash_decode": fds}
    cb, cs, ct, ch, ckv, cd, cmasks = chunked_local_shape(lcfg)
    fd, fds = decode(cb, cs, ct, masks=cmasks, hh=ch, kk=ckv, d=cd)
    rows["chunked_local"] = {"flash_decode_at": fd, "flash_decode": fds}
    s = PROMPT_LEN + GEN_LEN
    for b in BATCHES:
        rows[f"lattice B={b}"] = {
            "flash_attention": attention(b, PROMPT_LEN, plain=False),
            "flash_decode_at": decode(b, s, s - 1, plain=False,
                                      static=False)[0]}
    for key, row in rows.items():
        for name, r in row.items():
            log(f"[timing] {name} {r['shape']}: " + " ".join(
                f"{k}={r[k]:.4f}" for k in
                ("ms", "plain_ms", "library_ms", "bound_ms") if k in r)
                + (f" bound_by={r['bound_by']}" if "bound_by" in r else "")
                + (f" tiles={r['tiles']}" if "tiles" in r else ""))
    return rows


def window_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal attention with a sliding ``window``
    computes over ``s`` positions: query i sees min(i + 1, window) keys."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def mixtral_attention(torch, fa_ops, mcfg, peaks) -> dict:
    """flash-attention's window route at Mixtral's shapes, bf16, against
    its plain version: the serving prefill (B = 1 and 8, S = 128, inside
    the window) and a long prompt past the window (B = 1, S = 4160 and
    4224), whose rows past the window are also checked on their own at an
    atol of ROWS_TOL x their rms, a check the plain attention without the
    window must fail.  Then kernel / plain / library times at B = 8
    S = 128 and at B = 1 S = 4160; the library call is SDPA with the
    causal window as a boolean mask."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(8)
    h, kvh, d, w = mcfg.n_heads, mcfg.n_kv_heads, mcfg.d_head, mcfg.window
    bf = torch.bfloat16
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def inputs(b, s):
        return [torch.randn((b, s, n, d), generator=g, device="cuda").to(bf)
                for n in (h, kvh, kvh)]

    def shape(b, s):
        return f"B={b} S={s} H={h} KV={kvh} D={d} window={w} bf16"

    main = (0.0, 0.0)
    for b, s in ((1, PROMPT_LEN), (8, PROMPT_LEN), (1, LONG_PROMPT),
                 (1, LONG_PROMPT + 64)):
        q, k, v = inputs(b, s)
        out = fa_ops.flash_attention(q, k, v, window=w)
        ref = fa_ops.flash_attention_oracle(q, k, v, window=w)
        torch.cuda.synchronize()
        err, margin = _err(torch, out, ref, TOL["bfloat16"])
        if s == PROMPT_LEN:
            main = _worst(main, (err, margin))
        log(f"[kernels] flash_attention Mixtral {shape(b, s)} tiles="
            f"{fa_ops.choose_tiles(b, h, s, s, n_sm)}: max_abs_err="
            f"{err:.3e} margin={margin:.3f} tol={TOL['bfloat16']}")
        if s > w:
            rows = slice(w, s)
            atol = ROWS_TOL * float(ref[:, rows].float().square().mean()
                                    .sqrt())
            diff = (out[:, rows].float() - ref[:, rows].float()).abs()
            allowed = atol + ROWS_TOL * ref[:, rows].float().abs()
            margin_rows = float((diff / allowed).max())
            full = fa_ops.flash_attention_oracle(q, k, v)
            margin_full = float(((full[:, rows].float()
                                  - ref[:, rows].float()).abs()
                                 / allowed).max())
            log(f"[kernels] flash_attention Mixtral {shape(b, s)}, the "
                f"{s - w} rows past the window: max_abs_err="
                f"{float(diff.max()):.3e} margin={margin_rows:.3f} (atol "
                f"{atol:.3e} = {ROWS_TOL} x their rms, rtol {ROWS_TOL}); "
                f"the plain attention without the window: margin "
                f"{margin_full:.3f} (must fail: > 1)")
            if not (margin_rows <= 1.0 and margin_full > 1.0):
                raise AssertionError(
                    f"flash_attention's window route at {shape(b, s)}: rows "
                    f"past the window margin {margin_rows}, unwindowed "
                    f"margin {margin_full}")
            del full
        del q, k, v, out, ref

    rows = {}
    for b, s in ((max(BATCHES), PROMPT_LEN), (1, LONG_PROMPT)):
        q, k, v = inputs(b, s)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pos = torch.arange(s, device="cuda")
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :]
                                                 < w)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        flops = 4.0 * b * h * d * window_pairs(s, w)
        b_ms, b_by = bound(peaks, nbytes, flops, "bfloat16")
        long = s > PROMPT_LEN
        rows["long" if long else "serve"] = {
            "ms": time_ms(torch, lambda: fa_ops.flash_attention(q, k, v,
                                                                window=w)),
            "plain_ms": time_ms(
                torch, lambda: fa_ops.flash_attention_oracle(q, k, v,
                                                             window=w),
                reps=5 if long else 30, warmup=1 if long else 5),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "tiles": fa_ops.choose_tiles(b, h, s, s, n_sm),
            "shape": shape(b, s)}
        del q, k, v, qt, kt, vt
    for r in rows.values():
        log(f"[timing] flash_attention Mixtral {r['shape']}: " + " ".join(
            f"{key}={r[key]:.4f}" for key in
            ("ms", "plain_ms", "library_ms", "bound_ms"))
            + f" bound_by={r['bound_by']} tiles={r['tiles']}")
    rows["serve"].update(_check_row(main, TOL["bfloat16"]))
    return rows


def _wkv6_inputs(torch, g, b, t, h, kd, dtype):
    """r, k, v (B, T, H, K) in ``dtype``; lw = -exp(N(0, 1)), u = 0.5 N(0,
    1) and a nonzero s0 ~ N(0, 1), in float32."""
    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (n(b, t, h, kd).to(dtype) for _ in range(3))
    return r, k, v, -torch.exp(n(b, t, h, kd)), 0.5 * n(h, kd), n(b, h, kd,
                                                                  kd)


def check_wkv6(torch, rw_ops, rcfg) -> dict:
    g = torch.Generator(device="cuda").manual_seed(5)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def case(r, k, v, lw, u, s0, shape=None):
        tol = WKV_TOL[str(r.dtype)[6:]]
        if shape is None:
            y, s_fin = rw_ops.wkv6(r, k, v, lw, u, s0)
        else:
            y, s_fin = rw_ops._launch(r, k, v, lw, u, s0, shape)
        y_ref, s_ref = rw_ops.wkv6_ref(
            *(x.transpose(1, 2) for x in (r, k, v, lw)), u, s0)
        torch.cuda.synchronize()
        return _worst(_err(torch, y, y_ref.transpose(1, 2), tol),
                      _err(torch, s_fin, s_ref, tol))

    def route(b, h, kd):
        return "VB={} P={} CPT={}".format(*rw_ops.launch_shape(b, h, kd,
                                                               n_sm))

    h, kd = rcfg.n_heads, rcfg.d_head
    main = (0.0, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8):
            err, margin = case(*_wkv6_inputs(torch, g, b, PROMPT_LEN, h, kd,
                                             dtype))
            log(f"[kernels] wkv6 B={b} T={PROMPT_LEN} H={h} K=V={kd} "
                f"{str(dtype)[6:]} {route(b, h, kd)}: "
                f"max_abs_err(y, s_fin)={err:.3e} "
                f"margin={margin:.3f} tol={WKV_TOL[str(dtype)[6:]]}")
            if dtype == torch.bfloat16:
                main = _worst(main, (err, margin))
    small = [  # (b, t, h, kd): padding tails, every head dim, one row
        (2, 48, 2, 8), (2, 70, 2, 16), (1, 32, 1, 128), (2, 70, 4, 128),
        (1, 96, 2, 64), (2, 40, 3, 32), (2, 1, 2, 16),
        # head blocks of a sharded prefill: 2- and 16-way 'model' groups
        (SHARD_BATCH, PROMPT_LEN, h // 2, kd),
        (SHARD_BATCH, PROMPT_LEN, h // 16, kd)]
    for dtype in (torch.float32, torch.bfloat16):
        for (b, t, hh, kk) in small:
            err, margin = case(*_wkv6_inputs(torch, g, b, t, hh, kk, dtype))
            log(f"[kernels] wkv6 B={b} T={t} H={hh} K=V={kk} "
                f"{str(dtype)[6:]} {route(b, hh, kk)}: max_abs_err={err:.3e} "
                f"margin={margin:.3f}")
        # strided inputs: every other head of a wider tensor
        r, k, v, lw, u, s0 = _wkv6_inputs(torch, g, 2, 70, 4, 16, dtype)
        err, margin = case(*(x[:, :, ::2] for x in (r, k, v, lw)), u[::2],
                           s0[:, ::2])
        log(f"[kernels] wkv6 strided B=2 T=70 H=2 of 4 K=V=16 "
            f"{str(dtype)[6:]}: max_abs_err={err:.3e} margin={margin:.3f}")
        # every (VB, P, CPT) route at every head dim: one token, inside one
        # staged chunk, one past it, several chunks with a ragged tail
        for kk in rw_ops.HEAD_DIMS:
            worst = (0.0, 0.0)
            for shape in rw_ops.routes(kk):
                for t in (1, 31, 33, 200):
                    worst = _worst(worst, case(
                        *_wkv6_inputs(torch, g, 2, t, 2, kk, dtype), shape))
            log(f"[kernels] wkv6 every route of K=V={kk} "
                f"{rw_ops.routes(kk)} at B=2 T=1,31,33,200 H=2 "
                f"{str(dtype)[6:]}: max_abs_err={worst[0]:.3e} "
                f"margin={worst[1]:.3f}")
    return _check_row(main, WKV_TOL["bfloat16"])


def wkv6_work(b: int, t: int, h: int, kd: int, esize: int) -> tuple:
    """(bytes, fp32 operations) of one WKV6 call with K == V: the least
    work of the function, not of the kernel's chunked algorithm.  Bytes:
    r, k, v (``esize`` bytes), lw, u and s0 (float32) read once, y written
    once in r's dtype and s_fin in float32.  Operations, per token and
    head of the recurrence y_t = r_t (S + diag(u) k_t v_t^T),
    S <- diag(exp(lw_t)) S + k_t v_t^T, a multiply, an add or an exp being
    one: r_t S (2 K V), the decay and rank-1 update of S (3 K V), exp(lw_t)
    (K) and the bonus (r_t u k_t) v_t (3 K + 2 V)."""
    vd = kd
    nbytes = (b * t * h * kd * (3 * esize + 4) + h * kd * 4
              + 2 * b * h * kd * vd * 4 + b * t * h * vd * esize)
    per_token = 5 * kd * vd + 4 * kd + 2 * vd
    return nbytes, float(b * t * h * per_token)


def previous_wkv6(torch, source: str):
    """The WKV6 kernel of an earlier design, from a copy of its source kept
    outside the package (e.g. ``git show <commit>:src/repro_torch/kernels/
    rwkv6/csrc/rwkv6.cu``): built with the package's nvcc flags into
    ``build/chip_smoke/`` and called through its C interface, which takes
    no (VB, P, CPT).  Returns wkv6(r, k, v, lw, u, s0) -> (y, s_fin)."""
    import ctypes

    from repro_torch.kernels import _build

    lib_path = OUT / "wkv6_previous.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    source], check=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.repro_rwkv6_fwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes, fn.restype = [P] * 8 + [I] * 5 + [L] * 15 + [P], I

    def wkv6(r, k, v, lw, u, s0):
        b, t, h, kd = r.shape
        y = torch.empty_like(v)
        s_fin = torch.empty_like(s0)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                 s_fin.data_ptr(), int(r.dtype == torch.bfloat16), b, t, h,
                 kd, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *lw.stride()[:3], *y.stride()[:3],
                 torch.cuda.current_stream().cuda_stream)
        _build.check(lib, "repro_rwkv6", err)
        return y, s_fin
    return wkv6


def time_wkv6(torch, rw_ops, rcfg, peaks, previous=None) -> dict:
    """WKV6 kernel / plain times at the prefill shapes of the largest
    serving bucket and of batch 1, bf16 r/k/v as the model gives them,
    and at one long prompt (T = 2048, not on the path) at both batches;
    the kernel's time on every (VB, P, CPT) route at every bucket of the
    serving lattice; and, given ``previous`` (:func:`previous_wkv6`), that
    design's time at the two serving shapes beside this one's, in turns
    (previous, kernel, kernel, previous), after checking it against the
    plain version.  Bound at the float32 rate: every term is fp32, as in
    the reference.  No single PyTorch call computes WKV6, so there is no
    library time."""
    from repro_torch.models.rwkv6 import wkv6_chunked

    g = torch.Generator(device="cuda").manual_seed(6)
    h, kd = rcfg.n_heads, rcfg.d_head
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for b, t in ((max(BATCHES), PROMPT_LEN), (1, PROMPT_LEN),
                 (max(BATCHES), 2048), (1, 2048)):
        r, k, v, lw, u, s0 = _wkv6_inputs(torch, g, b, t, h, kd,
                                          torch.bfloat16)
        args_t = [x.transpose(1, 2) for x in (r, k, v, lw)]
        nbytes, ops = wkv6_work(b, t, h, kd, 2)
        b_ms, b_by = bound(peaks, nbytes, ops, "float32")
        long = t > PROMPT_LEN
        row = {
            "ms": time_ms(torch, lambda: rw_ops.wkv6(r, k, v, lw, u, s0)),
            "plain_ms": time_ms(
                torch, lambda: rw_ops.wkv6_ref(*args_t, u, s0),
                reps=5 if long else 30, warmup=1 if long else 5),
            "chunked_ms": time_ms(
                torch, lambda: wkv6_chunked(r, k, v, lw, u, s0)),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "operations": ops,
            "route": rw_ops.launch_shape(b, h, kd, n_sm),
            "shape": f"B={b} T={t} H={h} K=V={kd} bf16",
        }
        if previous is not None and not long:
            y, s_fin = previous(r, k, v, lw, u, s0)
            y_ref, s_ref = rw_ops.wkv6_ref(*args_t, u, s0)
            torch.cuda.synchronize()
            _worst(_err(torch, y, y_ref.transpose(1, 2),
                        WKV_TOL["bfloat16"]),
                   _err(torch, s_fin, s_ref, WKV_TOL["bfloat16"]))
            turns = [time_ms(torch, lambda: fn(r, k, v, lw, u, s0))
                     for fn in (previous, rw_ops.wkv6, rw_ops.wkv6,
                                previous)]
            row["previous_ms"] = [turns[0], turns[3]]
            row["turns_ms"] = [turns[1], turns[2]]
        rows[f"long B={b}" if long else b] = row
        log(f"[timing] wkv6 {row['shape']} "
            + "VB={} P={} CPT={}: ".format(*row["route"]) + " ".join(
                f"{key}={row[key]:.4f}" for key in
                ("ms", "plain_ms", "chunked_ms", "bound_ms"))
            + f" bound_by={b_by} library_ms=None")
        if "previous_ms" in row:
            log(f"[timing] wkv6 {row['shape']} previous design vs this, in "
                f"turns: previous {row['previous_ms'][0]:.4f}, "
                f"{row['previous_ms'][1]:.4f}; this "
                f"{row['turns_ms'][0]:.4f}, {row['turns_ms'][1]:.4f}")
    for b in BATCHES:
        r, k, v, lw, u, s0 = _wkv6_inputs(torch, g, b, PROMPT_LEN, h, kd,
                                          torch.bfloat16)
        by_route = {
            "VB={} P={} CPT={}".format(*shape): time_ms(
                torch, lambda: rw_ops._launch(r, k, v, lw, u, s0, shape))
            for shape in rw_ops.routes(kd)}
        rows[f"routes B={b}"] = {
            "routes_ms": by_route,
            "route": rw_ops.launch_shape(b, h, kd, n_sm),
            "shape": f"B={b} T={PROMPT_LEN} H={h} K=V={kd} bf16"}
        log(f"[timing] wkv6 B={b} T={PROMPT_LEN} by route (launch_shape: "
            + "VB={} P={} CPT={}): ".format(*rows[f"routes B={b}"]["route"])
            + ", ".join(f"{name} {ms:.4f}" for name, ms in by_route.items()))
    return rows


def check_model(torch, arch: str, prefill_kernels: tuple,
                decode_kernels: tuple) -> float:
    """A reduced model in fp32 on the card: the kernel path against the
    plain path, prefill (48 tokens) and 4 decode steps' logits.  The
    parameters u, mu_* and w0 (RWKV6) get seeded noise, since at init u = 0
    and mu = 0 would hide a wrong bonus term or token mix.  Over both
    paths each of ``prefill_kernels`` must launch once per layer and each
    of ``decode_kernels`` once per layer per step: the kernel path went
    through them and the plain path did not."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.models.model import RunOptions, get_model

    cfg = reduced(get_config(arch))
    f32 = torch.float32
    plain = get_model(cfg, RunOptions(param_dtype=f32, act_dtype=f32),
                      "cuda")
    kern = get_model(cfg, RunOptions(param_dtype=f32, act_dtype=f32,
                                     use_kernels=True), "cuda")
    params = plain.init(SEED)
    g = torch.Generator(device="cuda").manual_seed(4)
    for name, x in params.items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("u", "w0") or leaf.startswith("mu"):
            x.add_(0.5 * torch.randn(x.shape, generator=g, device="cuda",
                                     dtype=x.dtype))
    for fn in prefill_kernels + decode_kernels:
        fn.launches = 0
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
    want = [(fn, cfg.n_layers) for fn in prefill_kernels] + \
        [(fn, cfg.n_layers * 4) for fn in decode_kernels]
    for fn, n in want:
        if fn.launches != n:
            raise AssertionError(f"reduced {arch}: {fn.__name__} launched "
                                 f"{fn.launches} times, want {n}")
    log(f"[kernels] reduced {arch} fp32, kernels vs plain path: "
        f"max |logits diff| over prefill + 4 decode steps = {err:.3e} "
        f"(tol {MODEL_TOL})")
    return err


def check_hybrid_on_card(torch, arch: str) -> float:
    """The reduced Hymba in fp32 on the card against the same model on the
    CPU, the parameters initialised once and copied, with seeded noise on
    d_skip, b_dt, a_log and the four norm scales (their init values would
    hide a wrong skip, dt or fusion term): prefill and 4 decode steps'
    logits and the final caches, at S = 48 (wider than the window of 32,
    so the ring is rolled) and S = 16 (narrower: the reference's
    prompt-wide ring, whose decode evicts positions inside the window)."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.models.model import RunOptions, get_model

    cfg = reduced(get_config(arch))
    f32 = torch.float32
    opts = RunOptions(param_dtype=f32, act_dtype=f32)
    card, host = get_model(cfg, opts, "cuda"), get_model(cfg, opts, "cpu")
    params = card.init(SEED)
    g = torch.Generator(device="cuda").manual_seed(7)
    for name, x in params.items():
        if name.rsplit("/", 1)[-1] in (
                "d_skip", "b_dt", "a_log", "ln1_scale", "ln2_scale",
                "fuse_attn_scale", "fuse_ssm_scale"):
            x.add_(0.5 * torch.randn(x.shape, generator=g, device="cuda"))
    host_params = {k: v.cpu() for k, v in params.items()}
    worst = 0.0
    for s in (48, 16):
        toks = torch.randint(0, cfg.vocab, (2, s + 4), generator=g,
                             device="cuda")
        lc, cc = card.prefill(params, {"tokens": toks[:, :s]})
        lh, ch = host.prefill(host_params, {"tokens": toks[:, :s].cpu()})
        errs = [float((lc.cpu() - lh).abs().max())]
        for i in range(s, s + 4):
            lc, cc = card.decode(params, cc, toks[:, i:i + 1])
            lh, ch = host.decode(host_params, ch, toks[:, i:i + 1].cpu())
            errs.append(float((lc.cpu() - lh).abs().max()))
        cache_err = max(float((cc[n].cpu() - ch[n]).abs().max())
                        for n in ("k", "v", "ssm"))
        ring = cc["k"].shape[2]
        err = max(errs + [cache_err])
        if not err <= MODEL_TOL or ring != min(s, cfg.window) or \
                not int(cc["t"]) == int(ch["t"]) == s + 4:
            raise AssertionError(
                f"reduced {arch} S={s}: card vs CPU logits / caches differ "
                f"by {err} (tol {MODEL_TOL}), ring {ring} slots, t "
                f"{int(cc['t'])} vs {int(ch['t'])}")
        log(f"[kernels] reduced {arch} fp32 S={s} (ring {ring} slots, "
            f"window {cfg.window}), card vs CPU: max |logits diff| over "
            f"prefill + 4 decode steps = {max(errs):.3e}, caches "
            f"{cache_err:.3e} (tol {MODEL_TOL})")
        worst = max(worst, err)
    return worst


def reduced_at_depth(arch: str):
    """``reduced(arch)``, with Llama-4's depth raised to 4: the registry's 2
    layers stack no block of 4 (three chunked-local, one global)."""
    import dataclasses

    from repro_torch.configs.registry import get_config, reduced

    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, n_layers=cfg.global_every) \
        if cfg.global_every else cfg


def check_moe_on_card(torch, arch: str, counters: dict,
                      per_step: dict) -> float:
    """A reduced MoE model in fp32: the kernel path on the card against the
    plain path on the CPU, the parameters initialised once and copied,
    prefill and 4 decode steps' logits and the final caches, at S = 48
    (past the ring of 32: a rolled ring) and S = 16 (inside it: the ring
    padded out to max_len's width).  Counters at 0 before; after, each
    kernel in ``per_step`` launched once per layer of its kind per prefill
    or decode step, every other kernel not at all."""
    from repro_torch.models.model import RunOptions, get_model

    cfg = reduced_at_depth(arch)
    f32 = torch.float32
    card = get_model(cfg, RunOptions(param_dtype=f32, act_dtype=f32,
                                     use_kernels=True), "cuda")
    host = get_model(cfg, RunOptions(param_dtype=f32, act_dtype=f32),
                     "cpu")
    host_params = host.init(SEED)
    params = {k: v.cuda() for k, v in host_params.items()}
    g = torch.Generator().manual_seed(9)
    for fn in counters.values():
        fn.launches = 0
    worst = 0.0
    for s in (48, 16):
        toks = torch.randint(0, cfg.vocab, (2, s + 4), generator=g)
        lc, cc = card.prefill(params, {"tokens": toks[:, :s].cuda()},
                              max_len=s + 4)
        lh, ch = host.prefill(host_params, {"tokens": toks[:, :s]},
                              max_len=s + 4)
        errs = [float((lc.cpu() - lh).abs().max())]
        for i in range(s, s + 4):
            lc, cc = card.decode(params, cc, toks[:, i:i + 1].cuda())
            lh, ch = host.decode(host_params, ch, toks[:, i:i + 1])
            errs.append(float((lc.cpu() - lh).abs().max()))
        names = sorted(n for n in ch if n != "t")
        cache_err = max(float((cc[n].cpu() - ch[n]).abs().max())
                        for n in names)
        err = max(errs + [cache_err])
        log(f"[kernels] reduced {arch} fp32 {cfg.n_layers} layers S={s} "
            f"(caches {names}, widths {[ch[n].shape[3] for n in names]}), "
            f"card kernel path vs CPU plain path: max |logits diff| over "
            f"prefill + 4 decode steps = {max(errs):.3e}, caches "
            f"{cache_err:.3e} (tol {MODEL_TOL})")
        if not (err <= MODEL_TOL and int(cc["t"]) == int(ch["t"]) == s + 4):
            raise AssertionError(f"reduced {arch} S={s}: card vs CPU differ "
                                 f"by {err} (tol {MODEL_TOL})")
        worst = max(worst, err)
    n_global = cfg.n_layers // cfg.global_every if cfg.global_every else 0
    per_layer = {"prefill": cfg.n_layers, "global decode": n_global * 4}
    want = {name: 2 * per_layer[per_step[name]] if name in per_step else 0
            for name in counters}
    got = {name: fn.launches for name, fn in counters.items()}
    log(f"[kernels] reduced {arch}: launches {got} (want {want})")
    if got != want:
        raise AssertionError(f"reduced {arch}: launches {got}, want {want}")
    return worst


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------
def serve(torch, arch: str, cfg, counters: dict, per_step: dict,
          n_layers=None) -> tuple:
    """Serve ``arch`` at full width (at ``n_layers`` of depth, if given:
    ``cfg`` is then the config at that depth); ``counters`` maps every
    kernel's name to its wrapper, ``per_step`` the kernels of this path to
    the executor count they follow ("prefill_passes" or "decode_steps"):
    each launches once per layer per pass or step, every other kernel not
    at all.  Returns (launches, peak allocated bytes, peak reserved
    bytes)."""
    import gc

    from repro_torch.launch.serve import serve_real

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    bench = serve_real(arch=arch, reduced=False, n_layers=n_layers,
                       dtype=torch.bfloat16, device="cuda",
                       n_requests=N_REQUESTS, scenario="mmpp", seed=SEED,
                       prompt_len=PROMPT_LEN, gen_len=GEN_LEN,
                       batches=BATCHES, quotas=QUOTAS,
                       bench_out=str(OUT / f"serve_bench_{arch}.json"),
                       log=log)
    launches = {name: fn.launches for name, fn in counters.items()}
    serve_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())

    ex, tel = bench["executor"], bench["telemetry"]
    executed = sum(c["n_executed"] for c in bench["cells"])
    checks = {
        "every request answered or shed":
            tel["completed"] + tel["shed"] == tel["injected"] == N_REQUESTS,
        "one executor record per dispatched task":
            executed == ex["executed"] == bench["dispatched_tasks"] > 0,
        "post-warmup hit rate 1.0": ex["post_warmup_hit_rate"] == 1.0,
        "every decode step after warm-up replayed from a CUDA graph":
            ex["graph_steps"]
            == ex["decode_steps"] - ex["warmup_decode_steps"] > 0,
        "served at the asked depth": ex["n_layers"] == cfg.n_layers,
    }
    for name in counters:
        if name in per_step:
            unit = per_step[name]
            what = {"prefill_passes": "prefill",
                    "decode_steps": "decode step"}[unit]
            checks[f"every {what} through the {name} kernel"] = \
                launches[name] == cfg.n_layers * ex[unit] > 0
        else:
            checks[f"no {name} launch"] = launches[name] == 0
    checks.update({
        "logits finite": ex["nonfinite_passes"] == 0,
        "digest unchanged by the executor":
            bench["digest"]["with_executor"]
            == bench["digest"]["without_executor"],
    })
    log(f"[serve] {arch} full width bf16, {cfg.n_layers} layers: "
        f"{serve_s:.1f}s, peak allocated {peak[0] / 2**30:.3f} GiB, "
        f"reserved {peak[1] / 2**30:.3f} GiB, "
        f"{tel['injected']} requests ({tel['completed']} done, "
        f"{tel['shed']} shed), {bench['dispatched_tasks']} tasks, "
        f"{ex['prefill_passes']} prefill passes, {ex['decode_steps']} "
        f"decode steps ({ex['warmup_decode_steps']} in warm-up, "
        f"{ex['graph_steps']} replayed from {ex['graph_captures']} CUDA "
        f"graphs), launches {launches}")
    log(f"[serve] {arch} ({cfg.n_layers} layers) "
        f"slo_attainment={tel['slo_attainment']:.4f} "
        f"mean_abs_err={bench['mean_abs_err']:.4f} "
        f"hit_rate={ex['post_warmup_hit_rate']} "
        f"digest={bench['digest']['with_executor']}")
    for c in bench["cells"]:
        log(f"[serve] {arch} ({cfg.n_layers} layers) cell batch="
            f"{c['batch']} quota={c['quota']}: "
            f"predicted {c['predicted_ms']:.3f} ms, measured "
            f"{c['measured_ms']:.3f} ms (n={c['n_executed']}, "
            f"abs_err {c['abs_err']:.4f})")
    for r in bench["roofline"]:
        log(f"[serve] {arch} ({cfg.n_layers} layers) roofline {r['stage']} "
            f"batch={r['batch']}: bound "
            f"{r['bound_ms']:.4f} ms ({r['dominant']}, {r['device_peaks']}), "
            f"measured {r['measured_ms']:.4f} ms, fraction "
            f"{r['bound_fraction']:.4f}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{arch} serve invariants failed: {failed}")
    log(f"[serve] {arch} ({cfg.n_layers} layers) invariants hold: "
        f"{list(checks)}")
    return launches, peak[0], peak[1]


def mixtral_long_prompt(torch, mcfg, counters: dict) -> dict:
    """Full-width Mixtral at the depth cut, bf16, B = 1, a prompt of
    LONG_PROMPT tokens (past the 4096-token window) and LONG_DECODE decode
    steps, on the kernel path with every counter at 0 before.  Gated:
    ring slot i of the first layer holds the keys of position i mod 4096
    (recomputed from the prompt), each decode step writes slot t mod 4096
    of every layer and nothing else, the logits are finite, and the
    prefill went through flash_attention once a layer.  Reported, not
    gated: the same run on the plain path on the card, its logits' relative
    L2 distance from the kernel path's at every step and the number of
    top-k expert assignments that differ between the two: in bf16, routes
    whose two best experts are near-tied flip under any change of rounding,
    and each flip moves every later layer, so no bound holds that is not
    tuned to this run."""
    import gc
    from unittest import mock

    import torch.nn.functional as F

    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.model import RunOptions, get_model

    gc.collect()
    torch.cuda.empty_cache()
    w, s = mcfg.window, LONG_PROMPT
    kern = get_model(mcfg, RunOptions(use_kernels=True), "cuda")
    plain = get_model(mcfg, RunOptions(), "cuda")
    params = kern.init(SEED)
    g = torch.Generator(device="cuda").manual_seed(10)
    toks = torch.randint(0, mcfg.vocab, (1, s + LONG_DECODE), generator=g,
                         device="cuda")
    routes = {"kernel": [], "plain": []}

    def run(model, name):
        real = moe._top_k

        def recording(probs, k):
            vals, idx = real(probs, k)
            routes[name].append(idx.reshape(-1, k).cpu())
            return vals, idx

        with torch.inference_mode(), mock.patch.object(moe, "_top_k",
                                                       recording):
            lg, cache = model.prefill(params, {"tokens": toks[:, :s]},
                                      max_len=s + LONG_DECODE)
            logits, written = [lg], []
            for i in range(s, s + LONG_DECODE):
                before = cache["k"].clone()
                t = int(cache["t"])
                # the eager step: the routes are recorded on the host
                # inside it, which a replayed CUDA graph would not do
                lg, cache = model.decode_step(params, cache,
                                              toks[:, i:i + 1])
                slots = (cache["k"] != before).any(-1).any(-1).any(2)
                written.append((t, slots.nonzero()[:, 2].unique().tolist(),
                                int(slots.sum())))
                logits.append(lg)
        return torch.stack(logits), cache, written

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    lk, ck, written = run(kern, "kernel")
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    with torch.inference_mode():
        layer0 = T.unstack_layers(params, 2)[0]
        x = T._norm(mcfg, layer0, "ln1",
                    T._embed(mcfg, params, toks[:, :s], None, kern.opts))
        _, k0, _ = T._qkv(mcfg, layer0, x, torch.arange(s, device="cuda"))
    # before decode: ring slot i holds position p with p mod w == i, the
    # last of them; decode since overwrote slots s .. s + LONG_DECODE - 1
    pos = torch.arange(s - w, s, device="cuda")
    want = k0[0, pos[torch.argsort(pos % w)]]
    kept = [i for i in range(w) if i not in {t % w for t, _, _ in written}]
    ring_err = float((ck["k"][0, 0, 0, kept].float()
                      - want[kept].float()).abs().max())
    ring_tol = TOL["bfloat16"] * float(want.float().abs().max())
    lp, _, _ = run(plain, "plain")
    rel = [float((a.float() - b.float()).norm() / b.float().norm())
           for a, b in zip(lk, lp)]
    # an assignment differs where a token's expert is not among the
    # other path's k experts for that token
    e = mcfg.n_experts
    differ = sum(int((1 - (F.one_hot(a, e) * F.one_hot(b, e).sum(1, True))
                          .sum(-1)).sum())
                 for a, b in zip(routes["kernel"], routes["plain"]))
    total = sum(a.numel() for a in routes["kernel"])
    checks = {
        "ring slot i holds position i mod 4096": ring_err <= ring_tol,
        "decode wrote slot t mod 4096 of every layer only": all(
            slots == [t % w] and n == mcfg.n_layers
            for t, slots, n in written),
        "logits finite": bool(torch.isfinite(lk).all()),
        "the prefill through flash_attention, once a layer":
            launches["flash_attention"] == mcfg.n_layers,
        "no flash_decode_at, flash_decode or wkv6 launch":
            launches["flash_decode_at"] == launches["flash_decode"]
            == launches["wkv6"] == 0,
    }
    log(f"[long] {MIXTRAL_ARCH} full width bf16, {mcfg.n_layers} layers, B=1 "
        f"S={s} + {LONG_DECODE} decode steps on the kernel path "
        f"({kernel_s:.1f}s): ring of {ck['k'].shape[3]} slots rolled by "
        f"{s - w}, slot i = position i mod {w} in layer 0 (max |err| "
        f"{ring_err:.3e}, tol {ring_tol:.3e}); decode wrote slots "
        f"{[sl for _, sl, _ in written]} in every layer; launches {launches}")
    log(f"[long] reported, not gated (near-tied routes flip under bf16 "
        f"rounding, and a flip moves every later layer): logits rel L2, "
        f"kernel path vs plain path on the card, prefill then each decode "
        f"step {[f'{r:.3e}' for r in rel]}; top-k assignments differing "
        f"{differ} of {total}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{MIXTRAL_ARCH} long prompt: {failed}")
    log(f"[long] {MIXTRAL_ARCH} ({mcfg.n_layers} layers) checks hold: "
        f"{list(checks)}")
    out = {"launches": launches["flash_attention"], "ring_err": ring_err,
           "logits_rel_l2": rel, "topk_differ": differ, "topk_total": total,
           "kernel_s": kernel_s}
    out["code_review"] = code_review_fit(torch, params)
    return out


def code_review_fit(torch, mixtral_params: dict) -> dict:
    """Whether the code_review app's two stages fit one card together:
    the card's free memory with Mixtral at the depth cut resident, against
    full-width StarCoder2-7B's bf16 parameters plus MIN_FREE_GIB to spare
    (measured, reported, not gated)."""
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import RunOptions, get_model

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    specs = get_model(get_config("starcoder2_7b"), RunOptions(),
                      "cuda").param_specs()
    need = sum(math.prod(shape) * 2 for shape, _ in specs.values())
    mix = sum(p.numel() * p.element_size() for p in mixtral_params.values())
    fits = free - need >= MIN_FREE_GIB * 2**30
    log(f"[serve] code_review on one card: {free / 2**30:.3f} GiB free of "
        f"{total / 2**30:.3f} beside Mixtral's {mix / 2**30:.3f} GiB of "
        f"parameters ({MIXTRAL_LAYERS} layers); StarCoder2-7B's parameters "
        f"take {need / 2**30:.3f} GiB: the two stages "
        f"{'fit' if fits else 'do not fit'} with {MIN_FREE_GIB} GiB to "
        f"spare")
    return {"free_gib": free / 2**30, "total_gib": total / 2**30,
            "mixtral_params_gib": mix / 2**30,
            "starcoder_params_gib": need / 2**30, "fits": fits}


# ---------------------------------------------------------------------------
# phase 5: emulate (host only)
# ---------------------------------------------------------------------------
def emulate_phase(name: str, counters: dict) -> dict:
    """The zoo's profiles for this card, then ``emulate`` over those
    tables with ESG, the four baselines and one scenario run; no kernel
    may launch."""
    from repro_torch.cluster.gpu_profiles import zoo_tables
    from repro_torch.launch import serve
    from repro_torch.launch.roofline import device_peaks

    peaks = device_peaks(name)
    tables = zoo_tables(peaks=peaks)
    log("[emulate] host only: analytic zoo profiles, no model, no kernel")
    log(f"[emulate] t1_ms ({peaks.name} peaks, the tables every run "
        f"below schedules over): " + ", ".join(
            f"{a} {t.fn.t1_ms:.3f}" for a, t in tables.items()))
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = {"t1_ms": {a: t.fn.t1_ms for a, t in tables.items()}}
    for sched in ("esg", "infless", "fastgshare", "orion", "aquatope"):
        s = serve.emulate("moderate-normal", EMULATE_N, seed=SEED,
                          scheduler=sched, log=log, tables=tables)
        if not (s["completed"] + s["shed"] == EMULATE_N
                and 0.0 <= s["slo_hit_rate"] <= 1.0):
            raise AssertionError(
                f"emulate {sched}: {s['completed']} done + {s['shed']} "
                f"shed of {EMULATE_N}, hit rate {s['slo_hit_rate']}")
        out[sched] = {k: s[k] for k in ("completed", "shed",
                                        "slo_hit_rate", "total_cost",
                                        "mean_latency_ms")}
    s = serve.emulate("moderate-normal", EMULATE_N, seed=SEED,
                      scenario="mmpp", autoscaler="ewma", log=log,
                      tables=tables)
    if not (s["injected"] == s["completed"] + s["shed"] == EMULATE_N
            and 0.0 <= s["slo_attainment"] <= 1.0):
        raise AssertionError(f"emulate mmpp/ewma: {s['injected']} injected, "
                             f"{s['completed']} done, {s['shed']} shed, "
                             f"attainment {s['slo_attainment']}")
    out["mmpp_ewma"] = {k: s[k] for k in ("injected", "completed", "shed",
                                          "slo_attainment", "cost_per_1k")}
    launches = {n: fn.launches for n, fn in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"emulate launched kernels: {launches}")
    log(f"[emulate] 6 runs of {EMULATE_N} requests in "
        f"{time.perf_counter() - t0:.1f}s, every request accounted for, "
        f"launches {launches}")
    return out


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------
def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict)
            else None if v is None else v.to(device) for k, v in tree.items()}


def token_stream_on_card(torch, smi: str) -> dict:
    """The training data stream at full width (InternLM2-1.8B's vocab,
    B = 8, S = 128) drawn on the card, timed, against the same batch's
    first two rows drawn on the CPU: the two must agree token for token."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream

    cfg = get_config(ARCH)
    dc = DataConfig(vocab=cfg.vocab, seq_len=FULL_SEQ,
                    global_batch=FULL_BATCH)
    card, host = TokenStream(dc, device="cuda"), TokenStream(dc)
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = card.batch(0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    rows = host.batch(0, host.host_slice(0, FULL_BATCH // 2))
    host_s = time.perf_counter() - t0
    differ = int((b["tokens"][:2].cpu() != rows["tokens"]).sum()
                 + (b["labels"][:2, -1:].cpu() != rows["labels"][:, -1:])
                 .sum())
    n = rows["tokens"].numel() + rows["labels"].shape[0]
    log(f"[train] token stream, full-width {ARCH} batch ({FULL_BATCH} x "
        f"{FULL_SEQ + 1} over vocab {cfg.vocab}) on the card: "
        f"{[round(t, 3) for t in ms]} ms a batch (median "
        f"{statistics.median(ms):.3f}); card vs CPU over {n} tokens of two "
        f"rows: {differ} differ (the CPU's two rows in {host_s:.1f}s); card: "
        f"{smi}")
    if differ:
        raise AssertionError(f"token stream: {differ} of {n} tokens differ "
                             f"between the card and the CPU")
    return {"batch_ms": ms, "differ": differ, "compared": n}


def train_card_vs_cpu(torch, arch: str) -> dict:
    """3 AdamW steps of the reduced ``arch`` on the card and on the CPU from
    the same parameters and batches, in float32 and in float64.  Gated:
    the float32 losses within rel TRAIN_LOSS_RTOL, and every parameter's
    float64 update within TRAIN_UPDATE_RTOL of the CPU's.  Printed for
    every parameter: its float32 update distance, card vs CPU, beside the
    CPU's own float32-vs-float64 distance."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import RunOptions
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                             deterministic)

    cfg = reduced_at_depth(arch)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)

    def trainer(dtype, device):
        return Trainer(cfg, dc, TrainerConfig(seed=SEED),
                       RunOptions(remat="none", param_dtype=dtype,
                                  act_dtype=dtype), opt_cfg, log_fn=log,
                       device=device)

    host = trainer(torch.float32, "cpu")
    p0 = host.init_state()["params"]
    batches = [host.data.batch(step) for step in range(3)]

    def run(dtype, device):
        tr = trainer(dtype, device)
        params = {k: v.to(device=device, dtype=dtype, copy=True)
                  for k, v in p0.items()}
        state = {"params": params, "opt": adamw.init(params), "err_fb": None}
        with deterministic(tr.device):
            losses = [float(tr.train_step(state, b)["loss"]) for b in batches]
        return losses, {k: v.cpu().double() for k, v in
                        state["params"].items()}

    (lc32, c32), (lh32, h32) = (run(torch.float32, d) for d in ("cuda",
                                                                 "cpu"))
    (_, c64), (_, h64) = (run(torch.float64, d) for d in ("cuda", "cpu"))

    def dist(a, b, ref):
        return {k: float((a[k] - b[k]).norm() / (ref[k] - p0[k].double())
                         .norm().clamp_min(1e-300)) for k in p0}

    upd32, upd64 = dist(c32, h32, h32), dist(c64, h64, h64)
    own = dist(h32, h64, h64)
    loss_err = max(abs(c - h) / abs(h) for c, h in zip(lc32, lh32))
    worst64 = max(upd64.values())
    over = sorted(k for k, v in upd64.items() if not v <= TRAIN_UPDATE_RTOL)
    log(f"[train] reduced {arch} ({cfg.n_layers} layers), 3 steps card vs "
        f"CPU: float32 losses {[round(x, 6) for x in lc32]}, max rel loss "
        f"diff {loss_err:.3e} (tol {TRAIN_LOSS_RTOL}); float64 max rel "
        f"update diff {worst64:.3e} (tol {TRAIN_UPDATE_RTOL}), leaves over "
        f"it: {over}")
    log(f"[train] reduced {arch} float32 update diff card vs CPU | the "
        f"CPU's own float32 vs float64, per leaf: " + ", ".join(
            f"{k} {upd32[k]:.3e} | {own[k]:.3e}" for k in sorted(p0)))
    if not (loss_err <= TRAIN_LOSS_RTOL and not over
            and all(math.isfinite(x) for x in lc32)):
        raise AssertionError(f"reduced {arch}: card and CPU training differ")
    return {"loss_rel_err": loss_err, "update_rel_err_f64": upd64,
            "update_rel_err_f32": upd32, "cpu_f32_vs_f64": own}


def train_restart(torch) -> dict:
    """The reference's restart-equivalence shape on the card, reduced
    InternLM2 at bf16 parameters: 12 steps, checkpoints every 4, a failure
    at step 6, the resumed run's final loss against an uninterrupted one."""
    import shutil

    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import RunOptions
    from repro_torch.runtime.trainer import (SimulatedFailure, Trainer,
                                             TrainerConfig)

    cfg = reduced(get_config(ARCH))
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    opts = RunOptions(attn_chunk=32, remat="none")       # bf16

    def trainer(name, **kw):
        d = OUT / f"train_restart_{name}"
        return Trainer(cfg, dc, TrainerConfig(
            steps=12, ckpt_every=4, ckpt_dir=str(d), log_every=100, **kw),
            opts, log_fn=log, device="cuda")

    for name in ("a", "b"):
        shutil.rmtree(OUT / f"train_restart_{name}", ignore_errors=True)
    ra = trainer("a").run()
    try:
        trainer("b", fail_at_step=6).run()
        raise AssertionError("the injected failure did not fire")
    except SimulatedFailure:
        pass
    rb = trainer("b").run()
    diff = abs(ra["final_loss"] - rb["final_loss"])
    log(f"[train] reduced {ARCH} bf16 restart: uninterrupted final loss "
        f"{ra['final_loss']:.7f}, resumed ({rb['steps_run']} steps after "
        f"the step-4 checkpoint) {rb['final_loss']:.7f}, |diff| {diff:.3e} "
        f"(tol {RESTART_ATOL})")
    if not (diff <= RESTART_ATOL and rb["steps_run"] == 8):
        raise AssertionError("the resumed run does not repeat the "
                             "uninterrupted one")
    for name in ("a", "b"):
        shutil.rmtree(OUT / f"train_restart_{name}", ignore_errors=True)
    return {"final_loss": ra["final_loss"], "resumed_final_loss":
            rb["final_loss"], "abs_diff": diff}


def train_full_width(torch, peaks, smi: str) -> dict:
    """Full-width InternLM2-1.8B in bf16 at the CLI's defaults (B = 8,
    S = 128): 8 AdamW steps, a checkpoint at step 4, one more step with
    int8 compression; timed with the device synchronised per step."""
    import dataclasses
    import gc
    import shutil

    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import RunOptions
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                             deterministic)

    cfg = get_config(ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = OUT / "train_full_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tr = Trainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=FULL_SEQ,
                                 global_batch=FULL_BATCH),
                 TrainerConfig(seed=SEED), RunOptions(remat="none"),
                 adamw.AdamWConfig(lr=3e-3, warmup_steps=20,
                                   total_steps=FULL_STEPS), log_fn=log,
                 device="cuda")
    state = tr.init_state()
    rows, step_ms, save_s = [], [], None
    with deterministic(tr.device):
        for step in range(FULL_STEPS + 1):
            if step == FULL_STEPS:     # one more step, gradients compressed
                tr.opt_cfg = dataclasses.replace(tr.opt_cfg,
                                                 compress_grads=True)
                state["err_fb"] = adamw.init_error_feedback(state["params"])
            batch = tr.data.batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
            if step + 1 == FULL_CKPT_AT:
                t0 = time.perf_counter()
                ckpt.save(ckpt_dir, step + 1, state)
                save_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[FULL_WARMUP:FULL_STEPS]
    med = statistics.median(timed)
    tokens = FULL_BATCH * FULL_SEQ
    # N counts the parameters that enter a matmul: an untied input
    # embedding is a gather and does none
    n_mm = cfg.n_params - (0 if cfg.tie_embeddings
                           else cfg.vocab * cfg.d_model)
    mfu = 6.0 * n_mm * tokens / (med * 1e-3) / peaks.peak_flops
    ck_gb = sum(p.stat().st_size for p in
                (ckpt_dir / f"step_{FULL_CKPT_AT:08d}").iterdir()) / 1e9
    restored = ckpt.latest_step(ckpt_dir)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] full-width {ARCH} bf16 B={FULL_BATCH} S={FULL_SEQ}: "
        f"losses {[round(l, 4) for l, _ in rows]}, grad norms "
        f"{[round(g, 4) for _, g in rows]} (last step int8-compressed)")
    log(f"[train] step ms {[round(t, 3) for t in step_ms]}; median of "
        f"steps {FULL_WARMUP}-{FULL_STEPS - 1}: {med:.3f} ms, "
        f"{tokens / (med * 1e-3):.1f} tokens/s, peak allocated "
        f"{peak / 2**30:.3f} GiB, 6*N*tokens/step/bf16 peak "
        f"{mfu:.4f} (N = {n_mm}, the input embedding left out; peak "
        f"{peaks.peak_flops:.3e} "
        f"FLOP/s); checkpoint at step {FULL_CKPT_AT}: {ck_gb:.3f} GB in "
        f"{save_s:.1f}s; card: {smi}")
    if not (all(math.isfinite(l) and math.isfinite(g) for l, g in rows)
            and restored == FULL_CKPT_AT):
        raise AssertionError("full-width training: non-finite loss or grad "
                             "norm, or no checkpoint")
    return {"losses": [l for l, _ in rows], "grad_norms": [g for _, g in rows],
            "step_ms": step_ms, "median_step_ms": med,
            "tokens_per_s": tokens / (med * 1e-3), "peak_bytes": peak,
            "model_flops_share": mfu, "n_params": cfg.n_params,
            "n_matmul_params": n_mm,
            "checkpoint_gb": ck_gb, "checkpoint_s": save_s}


def train_phase(torch, peaks, smi: str, counters: dict) -> dict:
    for fn in counters.values():
        fn.launches = 0
    out = {"token_stream": token_stream_on_card(torch, smi)}
    out.update({arch: train_card_vs_cpu(torch, arch)
                for arch in TRAIN_ARCHS})
    out["restart"] = train_restart(torch)
    out["full_width"] = train_full_width(torch, peaks, smi)
    launches = {n: fn.launches for n, fn in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"training launched kernels: {launches}")
    log(f"[train] launches {launches}: training runs no kernel, as the "
        f"reference's")
    return out


# ---------------------------------------------------------------------------
# phase 7: shard (the multi-device layer on a one-rank NCCL mesh)
# ---------------------------------------------------------------------------
def _reset(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def _launches(counters: dict) -> dict:
    return {n: fn.launches for n, fn in counters.items()}


def _want_launches(counters: dict, got: dict, what: str, **want) -> None:
    full = {n: want.get(n, 0) for n in counters}
    if got != full:
        raise AssertionError(f"{what}: launches {got}, want {full}")


def _gate(torch, what: str, out, ref, tol: float) -> float:
    """max |out - ref|, finite and within atol = rtol = ``tol``."""
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if not (math.isfinite(err) and bool(
            (diff <= tol + tol * ref.float().abs()).all())):
        raise AssertionError(f"{what}: max abs err {err} beyond atol = rtol "
                             f"= {tol}")
    return err


def shard_phase(torch, counters: dict, smi: str, trainer_losses) -> dict:
    """Full-width InternLM2-1.8B (bf16, random weights from SEED) through
    the sharded step builders on a one-rank NCCL mesh: the prefill step
    with the kernels (flash-attention once per layer, no other kernel)
    against the unsharded ``Model.prefill``; SHARD_DECODE serve steps
    (the sequence-sharded decode, no kernel, as in the reference), each
    against the unsharded plain decode from the same state; the prefill
    again with explicit TP; and
    SHARD_TRAIN_STEPS train steps against the Trainer's first losses of
    phase 6.  Every counter is set to 0 before each run and read after."""
    import gc

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import RunOptions, get_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import deterministic

    t_start = time.perf_counter()
    cfg = get_config(ARCH)
    store = OUT / "shard_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    mesh = make_test_mesh((1, 1), device_type="cuda")
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    log(f"[shard] one-rank NCCL mesh {axes}; full-width {ARCH} bf16, seed "
        f"{SEED}")

    def put(tree, placements):
        if isinstance(tree, dict):
            return {k: put(v, placements[k]) for k, v in tree.items()}
        return distribute_tensor(tree, mesh, placements)

    def whole(tree):
        return {k: v.full_tensor() for k, v in tree.items()}

    opts = RunOptions(remat="none", use_kernels=True)
    model = get_model(cfg, opts, device="cuda")
    params = model.init(SEED)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    b, s = SHARD_BATCH, PROMPT_LEN
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g,
                           device="cuda")

    # prefill: the kernels' path, against the unsharded Model.prefill
    pre_shape = ShapeSpec("shard_prefill", s, b, "prefill")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_logits, ref_cache = model.prefill(params, {"tokens": tokens},
                                          max_len=s)
    torch.cuda.synchronize()
    out = {"unsharded_prefill_ms": (time.perf_counter() - t0) * 1e3}
    for explicit in (False, True):
        name = "prefill_explicit_tp" if explicit else "prefill"
        fn, in_pl, out_pl, _, _ = steps.build_prefill_step(
            cfg, pre_shape, mesh,
            dataclasses.replace(opts, explicit_tp_ffn=explicit))
        args = (put(params, in_pl[0]), put({"tokens": tokens}, in_pl[1]))
        torch.cuda.synchronize()
        _reset(counters)
        t0 = time.perf_counter()
        logits, cache = fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = _launches(counters)
        _want_launches(counters, got, f"shard {name}",
                       flash_attention=cfg.n_layers)
        errs = {"logits": _gate(torch, f"shard {name} logits",
                                logits.full_tensor(), ref_logits, BF16_TOL)}
        for k, v in whole(cache).items():
            errs[k] = _gate(torch, f"shard {name} cache {k}", v,
                            ref_cache[k], BF16_TOL)
        log(f"[shard] {name} B={b} S={s}: {ms:.3f} ms (host clock; the "
            f"unsharded prefill {out['unsharded_prefill_ms']:.3f} ms), "
            f"launches {got}, max abs err vs the unsharded prefill {errs}")
        out[name] = {"launches": got, "ms": ms, "max_abs_err": errs}
        del logits, cache
        if not explicit:
            # phase 8's reference: the (1, 1) step's FLOPs (the kernel is
            # no aten op: FlopCounterMode counts everything else)
            counter = FlopCounterMode(display=False)
            with counter:
                fn(*args)
            torch.cuda.synchronize()
            out[name]["counted_flops"] = float(counter.get_total_flops())
            log(f"[shard] {name} under FlopCounterMode: "
                f"{out[name]['counted_flops']:.6e} FLOPs")
        del args
    del ref_logits, ref_cache

    # serve: the sequence-sharded decode against the plain unsharded one
    depth = s + SHARD_DECODE
    dec_shape = ShapeSpec("shard_decode", depth, b, "decode")
    fn, in_pl, _, _, _ = steps.build_serve_step(cfg, dec_shape, mesh, opts)
    plain = get_model(cfg, dataclasses.replace(opts, use_kernels=False),
                      device="cuda")
    _, cache0 = model.prefill(params, {"tokens": tokens}, max_len=depth)
    sh_params = put(params, in_pl[0])
    sh_cache = put(cache0, in_pl[1])
    del cache0
    nxt = tokens[:, -1:]
    errs, step_ms, plain_ms, scale = [], [], [], 0.0
    _reset(counters)
    for _ in range(SHARD_DECODE):
        tok = distribute_tensor(nxt.int(), mesh, in_pl[2])
        # the plain decode starts from the state this step starts from
        state = {k: v.full_tensor().clone() for k, v in sh_cache.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, sh_cache = fn(sh_params, sh_cache, tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logits = logits.full_tensor()
        t0 = time.perf_counter()
        # a fresh state every step: the eager step, no graph to capture
        ref, _ = plain.decode_step(params, state, nxt)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        errs.append(_gate(torch, "shard serve logits", logits, ref,
                          BF16_TOL))
        scale = max(scale, float(ref.float().abs().max()))
        nxt = logits.argmax(-1, keepdim=True)
    got = _launches(counters)
    _want_launches(counters, got, "shard serve")
    if int(sh_cache["t"].full_tensor()) != depth:
        raise AssertionError("shard serve: the cache's position did not "
                             "advance to the end")
    log(f"[shard] serve B={b}: {SHARD_DECODE} decode steps from a "
        f"{s}-token prompt, step ms {[round(t, 3) for t in step_ms]} (host "
        f"clock; median {statistics.median(step_ms):.3f}, the unsharded "
        f"plain decode's {statistics.median(plain_ms):.3f}), launches {got} "
        f"(flash_decode_at 0: the mesh decode is the "
        f"sequence-sharded plain path, as in the reference), max abs err "
        f"vs the unsharded plain decode from the same state "
        f"{[round(e, 6) for e in errs]} (max |logit| {scale})")
    out["serve"] = {"launches": got, "step_ms": step_ms,
                    "unsharded_plain_ms": plain_ms,
                    "max_abs_err": max(errs), "max_abs_logit": scale}
    del sh_params, sh_cache, state, params, model, plain
    gc.collect()
    torch.cuda.empty_cache()
    out["rwkv6"] = shard_rwkv6(torch, counters, smi, mesh, put)

    # train: SHARD_TRAIN_STEPS steps against the Trainer's first losses
    tr_shape = ShapeSpec("shard_train", FULL_SEQ, FULL_BATCH, "train")
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20,
                                total_steps=FULL_STEPS)
    tr_opts = RunOptions(remat="none")
    fn, in_pl, _, _, donate = steps.build_train_step(cfg, tr_shape, mesh,
                                                     tr_opts, opt_cfg)
    params = get_model(cfg, tr_opts, device="cuda").init(SEED)
    sh_params = put(params, in_pl[0])
    sh_opt = put(adamw.init(params), in_pl[1])
    del params
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=FULL_SEQ,
                                  global_batch=FULL_BATCH), device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    counted: dict = {}
    _reset(counters)
    with deterministic(torch.device("cuda")):
        for step in range(SHARD_TRAIN_STEPS):
            batch = put(data.batch(step), in_pl[2])
            torch.cuda.synchronize()
            if step == SHARD_COUNTED_STEP:
                # phase 8's reference: this step's FLOPs and peak memory
                # (the peak so far is kept for the phase's own reading)
                counted["peak_before"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                counted["allocated_before"] = torch.cuda.memory_allocated()
                flop_counter = FlopCounterMode(display=False)
            else:
                flop_counter = contextlib.nullcontext()
            t0 = time.perf_counter()
            with flop_counter:
                sh_params, sh_opt, m = fn(sh_params, sh_opt, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if step == SHARD_COUNTED_STEP:
                counted["flops"] = float(flop_counter.get_total_flops())
                counted["peak_bytes"] = torch.cuda.max_memory_allocated()
            losses.append(float(m["loss"].full_tensor()))
            norms.append(float(m["grad_norm"].full_tensor()))
    peak = max(counted["peak_before"], torch.cuda.max_memory_allocated())
    got = _launches(counters)
    _want_launches(counters, got, "shard train")
    rel = [abs(a - b_) / abs(b_) for a, b_ in zip(losses, trainer_losses)]
    log(f"[shard] train B={FULL_BATCH} S={FULL_SEQ}: losses {losses} vs the "
        f"Trainer's {list(trainer_losses[:SHARD_TRAIN_STEPS])} (rel "
        f"{rel}), grad norms {norms}, step ms "
        f"{[round(t, 3) for t in step_ms]} (host clock, device synchronised"
        f"), peak allocated {peak / 2**30:.3f} GiB; card: {smi}")
    if not (len(rel) == SHARD_TRAIN_STEPS
            and all(r <= BF16_TOL for r in rel)):
        raise AssertionError(f"shard train: losses {losses} vs the "
                             f"Trainer's {trainer_losses}")
    log(f"[shard] train step {SHARD_COUNTED_STEP} under FlopCounterMode: "
        f"{counted['flops']:.6e} FLOPs, peak allocated "
        f"{counted['peak_bytes'] / 2**30:.3f} GiB "
        f"({counted['allocated_before'] / 2**30:.3f} GiB allocated before "
        f"it); card: {smi}")
    out["train"] = {"launches": got, "losses": losses, "grad_norms": norms,
                    "loss_rel_err": rel, "step_ms": step_ms,
                    "peak_bytes": peak, "counted_step": counted}
    del sh_params, sh_opt, batch, m
    dist.destroy_process_group()
    store.unlink(missing_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    log(f"[shard] phase {out['seconds']:.1f}s; process group destroyed")
    return out


def shard_rwkv6(torch, counters: dict, smi: str, mesh, put) -> dict:
    """Full-width RWKV6-1.6B (bf16, random weights from SEED) through the
    sharded steps on the shard phase's mesh: the prefill at B =
    SHARD_BATCH, S = PROMPT_LEN with the kernels (WKV6 once a layer, no
    other kernel) against the unsharded ``Model.prefill``, logits and
    state; then SHARD_DECODE serve steps with the state kept in its
    layout (heads over 'model'), each against the unsharded plain decode
    from the same state (no kernel: decode is the one-token step, as in
    the reference).  Counters set to 0 before each run and read after."""
    import gc

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch import steps
    from repro_torch.models.model import RunOptions, get_model

    cfg = get_config(RWKV_ARCH)
    opts = RunOptions(remat="none", use_kernels=True)
    model = get_model(cfg, opts, device="cuda")
    params = model.init(SEED)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    b, s = SHARD_BATCH, PROMPT_LEN
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device="cuda")
    ref_logits, ref_cache = model.prefill(params, {"tokens": tokens})
    fn, in_pl, _, _, _ = steps.build_prefill_step(
        cfg, ShapeSpec("shard_prefill", s, b, "prefill"), mesh, opts)
    args = (put(params, in_pl[0]), put({"tokens": tokens}, in_pl[1]))
    torch.cuda.synchronize()
    _reset(counters)
    t0 = time.perf_counter()
    logits, cache = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = _launches(counters)
    _want_launches(counters, got, f"shard {RWKV_ARCH} prefill",
                   wkv6=cfg.n_layers)
    errs = {"logits": _gate(torch, f"shard {RWKV_ARCH} prefill logits",
                            logits.full_tensor(), ref_logits, BF16_TOL)}
    for k, v in cache.items():
        errs[k] = _gate(torch, f"shard {RWKV_ARCH} prefill {k}",
                        v.full_tensor(), ref_cache[k], BF16_TOL)
    placements = {k: repr(v.placements) for k, v in cache.items()}
    log(f"[shard] {RWKV_ARCH} prefill B={b} S={s}: {ms:.3f} ms (host "
        f"clock), launches {got}, max abs err vs the unsharded prefill "
        f"{errs}; state placements {placements}")
    out = {"prefill": {"launches": got, "ms": ms, "max_abs_err": errs}}
    del args, logits, cache

    fn, in_pl, _, _, _ = steps.build_serve_step(
        cfg, ShapeSpec("shard_decode", s + SHARD_DECODE, b, "decode"), mesh,
        opts)
    plain = get_model(cfg, dataclasses.replace(opts, use_kernels=False),
                      device="cuda")
    sh_params = put(params, in_pl[0])
    sh_cache = put(ref_cache, in_pl[1])
    nxt = tokens[:, -1:]
    errs, step_ms = [], []
    _reset(counters)
    for _ in range(SHARD_DECODE):
        tok = distribute_tensor(nxt.int(), mesh, in_pl[2])
        state = {k: v.full_tensor().clone() for k, v in sh_cache.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, sh_cache = fn(sh_params, sh_cache, tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logits = logits.full_tensor()
        # a fresh state every step: the eager step, no graph to capture
        ref, state = plain.decode_step(params, state, nxt)
        errs.append(_gate(torch, f"shard {RWKV_ARCH} serve logits", logits,
                          ref, BF16_TOL))
        for k, v in sh_cache.items():
            errs.append(_gate(torch, f"shard {RWKV_ARCH} serve {k}",
                              v.full_tensor(), state[k], BF16_TOL))
        nxt = logits.argmax(-1, keepdim=True)
    got = _launches(counters)
    _want_launches(counters, got, f"shard {RWKV_ARCH} serve")
    log(f"[shard] {RWKV_ARCH} serve B={b}: {SHARD_DECODE} steps, step ms "
        f"{[round(t, 3) for t in step_ms]} (host clock; median "
        f"{statistics.median(step_ms):.3f}), launches {got}, max abs err "
        f"(logits and state) vs the unsharded plain decode {max(errs)}; "
        f"card: {smi}")
    out["serve"] = {"launches": got, "step_ms": step_ms,
                    "max_abs_err": max(errs)}
    del sh_params, sh_cache, state, params, model, plain, ref_cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: dryrun (the multi-pod dry-run, fake ranks, no device)
# ---------------------------------------------------------------------------
def dryrun_phase(torch, counters: dict, smi: str, card: dict,
                 one: dict) -> dict:
    """The dry-run (``launch/dryrun.py``) on the shard phase's train
    cell: full-width InternLM2-1.8B, bf16, B = FULL_BATCH, S = FULL_SEQ,
    the same ``RunOptions``, traced on fake tensors on a (1, 1) mesh under
    a fake process group of 1, against that phase's counted step on the
    card (``card``): FLOPs equal (rel DRYRUN_FLOP_RTOL: the same aten ops
    run), the traced peak within DRYRUN_PEAK_RTOL of the card's
    ``max_memory_allocated``.  Then the multi-pod example's cell
    (InternLM2-20B train_4k on 2 x 16 x 16, 512 fake ranks) must trace,
    launching nothing; then one rank of each 'model' group of
    RANK_SPLITS (:func:`rank_steps`), against ``one``, the shard phase's
    (1, 1) counts and times."""
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_process_group, make_test_mesh
    from repro_torch.models.model import RunOptions

    t_start = time.perf_counter()
    _reset(counters)
    cfg = get_config(ARCH)
    shape = ShapeSpec("shard_train", FULL_SEQ, FULL_BATCH, "train")
    with fake_process_group(1):
        mesh = make_test_mesh((1, 1), device_type="cpu")
        traced = dryrun.trace_step(cfg, shape, mesh,
                                   RunOptions(remat="none"))
    flop_rel = abs(traced["flops"] - card["flops"]) / card["flops"]
    est = traced["memory"]["peak_bytes_est"]
    peak_rel = abs(est - card["peak_bytes"]) / card["peak_bytes"]
    log(f"[dryrun] {ARCH} train B={FULL_BATCH} S={FULL_SEQ} on a (1, 1) "
        f"mesh of fake ranks, traced in {traced['trace_s']:.1f}s: "
        f"{traced['flops']:.6e} FLOPs against the card's "
        f"{card['flops']:.6e} (rel {flop_rel:.3e}, want <= "
        f"{DRYRUN_FLOP_RTOL}); peak_bytes_est {est / 2**30:.3f} GiB "
        f"(arguments {traced['memory']['argument_bytes'] / 2**30:.3f}, "
        f"temp {traced['memory']['temp_bytes'] / 2**30:.3f}) against the "
        f"card's max_memory_allocated {card['peak_bytes'] / 2**30:.3f} GiB "
        f"(rel {peak_rel:.4f}, want <= {DRYRUN_PEAK_RTOL}); card: {smi}")
    if not flop_rel <= DRYRUN_FLOP_RTOL:
        raise AssertionError(f"dryrun: FLOPs {traced['flops']} vs the "
                             f"card's {card['flops']}")
    if not peak_rel <= DRYRUN_PEAK_RTOL:
        raise AssertionError(f"dryrun: peak_bytes_est {est} vs the card's "
                             f"{card['peak_bytes']}")
    cell = dryrun.run_cell("internlm2_20b", "train_4k", multi_pod=True,
                           save=False)
    if cell.get("status") != "ok":
        raise AssertionError(f"dryrun: the multi-pod example's cell "
                             f"failed: {cell.get('error')}\n"
                             f"{cell.get('traceback')}")
    r = cell["roofline"]
    log(f"[dryrun] internlm2_20b train_4k on 2x16x16 ({cell['n_chips']} "
        f"fake ranks): traced in {cell['trace_s']:.1f}s, "
        f"{cell['cost']['flops']:.6e} FLOPs a rank, per-rank peak "
        f"{cell['memory']['peak_bytes_est'] / 1e9:.2f} GB, roofline "
        f"({cell['peaks']} data sheet) compute {r['compute_s'] * 1e3:.1f} "
        f"ms | memory {r['memory_s'] * 1e3:.1f} ms | collective "
        f"{r['collective_s'] * 1e3:.1f} ms, useful ratio "
        f"{r['useful_ratio']:.4f}; card: {smi}")
    got = _launches(counters)
    _want_launches(counters, got, "dryrun")
    ranks = {n: rank_steps(torch, counters, smi, one, n)
             for n in RANK_SPLITS}
    out = {"ranks": ranks, "flops": traced["flops"],
           "card_flops": card["flops"],
           "flop_rel_err": flop_rel, "memory": traced["memory"],
           "card_peak_bytes": card["peak_bytes"],
           "card_allocated_before": card["allocated_before"],
           "peak_rel_err": peak_rel, "trace_s": traced["trace_s"],
           "multipod": {k: cell[k] for k in ("status", "n_chips", "trace_s",
                                             "memory", "cost", "roofline",
                                             "collectives")},
           "launches": got,
           "seconds": time.perf_counter() - t_start}
    log(f"[dryrun] phase {out['seconds']:.1f}s, launches {got}")
    return out


def rank_steps(torch, counters: dict, smi: str, one: dict, n: int) -> dict:
    """One rank of an ``n``-way 'model' group on the card: a fake process
    group of n ranks (its collectives move no data, so no value is
    compared here; the gloo tests hold the values), a (1, n) mesh over
    "cuda", real bf16 tensors, full-width InternLM2-1.8B from SEED.  The
    sharded prefill at B = SHARD_BATCH, S = PROMPT_LEN with the kernels
    (flash-attention once a layer on this rank's heads) and a train step
    at the shard phase's shape: each run once to warm, once timed, once
    counted under ``FlopCounterMode`` with the peak memory read after a
    reset.  Each count equals the dry-run's trace of the same cell on
    fake CUDA tensors (rel DRYRUN_FLOP_RTOL), lies within SPLIT_FLOP_RTOL
    of 1 / n of the (1, 1) count, and the card's peak within
    DRYRUN_PEAK_RTOL of the traced one.  A fake backend that refuses CUDA
    tensors fails the phase."""
    import gc

    from torch.distributed.tensor import distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import fake_process_group, make_test_mesh
    from repro_torch.models.model import RunOptions, get_model
    from repro_torch.optim import adamw

    cfg = get_config(ARCH)
    pre_shape = ShapeSpec("shard_prefill", PROMPT_LEN, SHARD_BATCH,
                          "prefill")
    tr_shape = ShapeSpec("shard_train", FULL_SEQ, FULL_BATCH, "train")
    pre_opts = RunOptions(remat="none", use_kernels=True)
    tr_opts = RunOptions(remat="none")
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20,
                                total_steps=FULL_STEPS)
    out = {}

    def put(tree, placements, mesh):
        if isinstance(tree, dict):
            return {k: put(v, placements[k], mesh) for k, v in tree.items()}
        return distribute_tensor(tree, mesh, placements)

    def settle():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def three(name, run, launches, mesh, shape, opts):
        """Warm, timed and counted runs of ``run``; the trace; checks."""
        for i in range(3):
            _reset(counters)
            settle()
            if i == 2:
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                counter = FlopCounterMode(display=False)
            else:
                counter = contextlib.nullcontext()
            t0 = time.perf_counter()
            with counter:
                run(i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            _want_launches(counters, _launches(counters),
                           f"rank of {n} {name}", **launches)
            if i == 1:
                timed = ms
        flops = float(counter.get_total_flops())
        peak = torch.cuda.max_memory_allocated()
        traced = dryrun.trace_step(cfg, shape, mesh, opts)
        want = one[name] / n
        rec = {"ms": timed, "one_ms": one[f"{name}_ms"], "flops": flops,
               "traced_flops": traced["flops"],
               "flop_rel_err": abs(flops - traced["flops"]) / flops,
               "share_rel_err": abs(flops - want) / want,
               "peak_bytes": peak, "allocated_before": before,
               "traced_peak_bytes": traced["memory"]["peak_bytes_est"],
               "launches": launches}
        rec["peak_rel_err"] = abs(rec["traced_peak_bytes"] - peak) / peak
        log(f"[dryrun] rank 0 of {n} on (1, {n}) {name}: {timed:.3f} ms "
            f"(host clock; the (1, 1) step {one[f'{name}_ms']:.3f} ms), "
            f"{flops:.6e} FLOPs on the card, {traced['flops']:.6e} traced "
            f"(rel {rec['flop_rel_err']:.3e}), 1/{n} of the (1, 1) "
            f"{one[name]:.6e} within {rec['share_rel_err']:.4f}; peak "
            f"{peak / 2**30:.3f} GiB ({before / 2**30:.3f} before), traced "
            f"{rec['traced_peak_bytes'] / 2**30:.3f} GiB (rel "
            f"{rec['peak_rel_err']:.4f}); launches {launches}; card: {smi}")
        if not rec["flop_rel_err"] <= DRYRUN_FLOP_RTOL:
            raise AssertionError(f"rank of {n} {name}: FLOPs {flops} vs "
                                 f"the trace's {traced['flops']}")
        if not rec["share_rel_err"] <= SPLIT_FLOP_RTOL:
            raise AssertionError(f"rank of {n} {name}: FLOPs {flops}, not "
                                 f"1/{n} of the (1, 1) {one[name]}")
        if not rec["peak_rel_err"] <= DRYRUN_PEAK_RTOL:
            raise AssertionError(f"rank of {n} {name}: peak {peak} vs the "
                                 f"trace's {rec['traced_peak_bytes']}")
        return rec

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (SHARD_BATCH, PROMPT_LEN),
                           generator=g, device="cuda")
    with fake_process_group(n):
        mesh = make_test_mesh((1, n), device_type="cuda")
        fn, in_pl, _, _, _ = steps.build_prefill_step(cfg, pre_shape, mesh,
                                                      pre_opts)
        params = get_model(cfg, pre_opts, device="cuda").init(SEED)
        args = (put(params, in_pl[0], mesh),
                put({"tokens": tokens}, in_pl[1], mesh))
        del params
        out["prefill"] = three(
            "prefill", lambda i: fn(*args),
            {"flash_attention": cfg.n_layers}, mesh, pre_shape, pre_opts)
        del args
        fn, in_pl, _, _, _ = steps.build_train_step(cfg, tr_shape, mesh,
                                                    tr_opts, opt_cfg)
        params = get_model(cfg, tr_opts, device="cuda").init(SEED)
        state = [put(params, in_pl[0], mesh),
                 put(adamw.init(params), in_pl[1], mesh)]
        del params
        data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=FULL_SEQ,
                                      global_batch=FULL_BATCH),
                           device="cuda")
        batches = [put(data.batch(i), in_pl[2], mesh) for i in range(3)]

        def train(i):
            state[0], state[1], _ = fn(state[0], state[1], batches[i])

        out["train"] = three("train", train, {}, mesh, tr_shape, tr_opts)
        del state, batches, fn
        settle()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wkv6-previous", metavar="CU",
                    help="a WKV6 source of an earlier design (the same C "
                    "interface without VB, P and CPT), timed beside the "
                    "package's kernel at the serving shapes")
    args = ap.parse_args()
    # before CUDA initialises: training runs deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.kernels.rwkv6 import ops as rw_ops
    from repro_torch.launch.roofline import device_peaks

    cfg, rcfg = get_config(ARCH), get_config(RWKV_ARCH)
    lcfg = get_config(LLAMA4_ARCH)
    peaks = device_peaks(name)
    fa_chk = check_flash_attention(torch, fa_ops, cfg)
    fd_chk, fds_chk = check_flash_decode(torch, fd_ops, cfg, lcfg)
    fds_profile = profile_static_decode(torch, fd_ops, cfg)
    wkv_chk = check_wkv6(torch, rw_ops, rcfg)
    timing = time_kernels(torch, fa_ops, fd_ops, cfg, lcfg, peaks)
    previous = (previous_wkv6(torch, args.wkv6_previous)
                if args.wkv6_previous else None)
    for key, row in time_wkv6(torch, rw_ops, rcfg, peaks,
                              previous).items():
        timing.setdefault(key, {})["wkv6"] = row
    mcfg = dataclasses.replace(get_config(MIXTRAL_ARCH),
                               n_layers=MIXTRAL_LAYERS)
    mixtral = mixtral_attention(torch, fa_ops, mcfg, peaks)
    check_model(torch, ARCH, (fa_ops.flash_attention,),
                (fd_ops.flash_decode_at,))
    check_model(torch, RWKV_ARCH, (rw_ops.wkv6,), ())
    check_hybrid_on_card(torch, HYMBA_ARCH)
    counters = {"flash_attention": fa_ops.flash_attention,
                "flash_decode_at": fd_ops.flash_decode_at,
                "flash_decode": fd_ops.flash_decode,
                "wkv6": rw_ops.wkv6}
    # Mixtral's layers all slide a window: its decode is the plain ring
    # attention; Llama-4's global layers decode through flash_decode_at
    check_moe_on_card(torch, MIXTRAL_ARCH, counters,
                      {"flash_attention": "prefill"})
    check_moe_on_card(torch, LLAMA4_ARCH, counters,
                      {"flash_attention": "prefill",
                       "flash_decode_at": "global decode"})

    # 4. serve, each path with every counter at 0 just before it
    launches = serve(torch, ARCH, cfg, counters,
                     {"flash_attention": "prefill_passes",
                      "flash_decode_at": "decode_steps"})[0]
    launches["wkv6"] = serve(torch, RWKV_ARCH, rcfg, counters,
                             {"wkv6": "prefill_passes"})[0]["wkv6"]
    # Hymba runs no kernel, as in the reference: every counter stays at 0
    serve(torch, HYMBA_ARCH, get_config(HYMBA_ARCH), counters, {})
    m_launches, m_peak, m_reserved = serve(
        torch, MIXTRAL_ARCH, mcfg, counters,
        {"flash_attention": "prefill_passes"}, n_layers=MIXTRAL_LAYERS)
    total = torch.cuda.get_device_properties(0).total_memory
    free_gib = (total - m_reserved) / 2**30
    log(f"[serve] {MIXTRAL_ARCH} at {MIXTRAL_LAYERS} of "
        f"{get_config(MIXTRAL_ARCH).n_layers} layers: peak allocated "
        f"{m_peak / 2**30:.3f} GiB, reserved {m_reserved / 2**30:.3f} GiB of "
        f"{total / 2**30:.3f} GiB; {free_gib:.3f} GiB free at the peak (want "
        f">= {MIN_FREE_GIB})")
    if not free_gib >= MIN_FREE_GIB:
        raise AssertionError(f"{MIXTRAL_ARCH} at {MIXTRAL_LAYERS} layers left "
                             f"{free_gib:.3f} GiB free at its peak")
    long = mixtral_long_prompt(torch, mcfg, counters)

    # 5. emulate, 6. train: neither launches a kernel
    emulated = emulate_phase(name, counters)
    trained = train_phase(torch, peaks, smi, counters)

    # 7. shard: the multi-device layer on a one-rank NCCL mesh
    sharded = shard_phase(torch, counters, smi,
                          trained["full_width"]["losses"])

    # 8. dryrun: fake ranks, fake tensors, against phase 7's counted step;
    # one rank of each 'model' group of RANK_SPLITS, on the card
    one = {"prefill": sharded["prefill"]["counted_flops"],
           "prefill_ms": sharded["prefill"]["ms"],
           "train": sharded["train"]["counted_step"]["flops"],
           "train_ms": sharded["train"]["step_ms"][1]}
    dried = dryrun_phase(torch, counters, smi,
                         sharded["train"]["counted_step"], one)

    # 9. report
    big = timing[max(BATCHES)]
    kernels = []
    for kname, chk, src, rep in (
            ("flash_attention", fa_chk,
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:88"),
            ("flash_decode_at", fd_chk,
             "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode/flash_decode.py:139"),
            ("wkv6", wkv_chk,
             "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
             "src/repro/kernels/rwkv6/rwkv6.py:73")):
        r = big[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[kname], **chk, "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    # flash-attention's rows at Mixtral's shapes, each with the launches of
    # its own path: the served requests, and the long prompt
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels[0]["mixtral"] = {
        **{k: mixtral["serve"][k] for k in keys},
        "max_abs_err": mixtral["serve"]["max_abs_err"],
        "margin": mixtral["serve"]["margin"],
        "launches": m_launches["flash_attention"],
        "n_layers": MIXTRAL_LAYERS}
    kernels[0]["mixtral_long"] = {
        **{k: mixtral["long"][k] for k in keys},
        "launches": long["launches"], "n_layers": MIXTRAL_LAYERS}
    # the shard phase's launches: the prefill step (and with explicit TP)
    # runs flash-attention once a layer; the mesh serve step runs the
    # sequence-sharded plain decode, no flash-decode launch
    kernels[0]["shard"] = {
        "launches": sharded["prefill"]["launches"]["flash_attention"],
        "launches_explicit_tp":
            sharded["prefill_explicit_tp"]["launches"]["flash_attention"],
        "n_layers": cfg.n_layers}
    kernels[1]["shard"] = {
        "launches": sharded["serve"]["launches"]["flash_decode_at"],
        "decode_steps": SHARD_DECODE}
    # the static-position entry over the same device body: no path launches
    # it (as in the reference, where only tests call it); its rows at the
    # serving bucket, the long linear cache and the chunked-local ring
    kernels[1]["static"] = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode/flash_decode.py:181",
        "launches": launches["flash_decode"], **fds_chk,
        **{k: big["flash_decode"][k] for k in keys},
        "long": {k: timing["long"]["flash_decode"][k] for k in keys},
        "chunked_local": {
            k: timing["chunked_local"]["flash_decode"][k] for k in keys},
        "device_events": fds_profile["device_events"],
        "allocations": fds_profile["allocations"]}
    # each rank of the dry-run phase's 'model' groups runs flash-attention
    # once a layer on its heads; RWKV6's sharded prefill runs WKV6 once a
    # layer
    kernels[0]["shard"]["rank_launches"] = {
        n: r["prefill"]["launches"]["flash_attention"]
        for n, r in dried["ranks"].items()}
    kernels[2]["shard"] = {
        "launches": sharded["rwkv6"]["prefill"]["launches"]["wkv6"],
        "n_layers": rcfg.n_layers}
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump({"kernels": kernels, "timing": timing,
                   "mixtral_attention": mixtral, "mixtral_long": long,
                   "mixtral_serve_peak_bytes": [m_peak, m_reserved],
                   "emulate": emulated, "train": trained,
                   "shard": sharded, "dryrun": dried,
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
