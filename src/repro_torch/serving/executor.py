"""Real-compute execution bridge: batched serving on the card.

``TorchExecutor`` runs the port's model through ``models/model.py`` (for a
transformer, CUDA flash-attention prefill and flash-decode steps, a
sliding-window or chunked-local layer decoding through the plain ring
attention and an MoE layer through the plain expert GEMMs; for
RWKV6, the CUDA WKV6 kernel in prefill and the plain one-token recurrence
in decode; for Hymba, plain PyTorch throughout, as in the reference: the
window-masked chunked attention and the doubling SSM scan in prefill, ring
attention and the one-token SSM step in decode) behind the emulator's
Gateway → autoscaler → ``ClusterSim`` dispatch path.  The emulator stays
the timing and placement model; every dispatched task is additionally
executed for real here, and the measured wall times check the emulator's
predictions.

Design:

* **Batch-lattice bucketing** — a dispatched batch of n jobs pads up to
  the nearest ``batch_lattice`` bucket, so the shapes the device ever sees
  are the profile lattice itself.
* **Depth cut** — ``n_layers`` serves the config at every published width
  with only its depth lowered (full-width Mixtral-8x22B does not fit one
  card at its 56 layers).
* **Cell cache** — each (arch, stage, batch-bucket, quota) key maps to a
  cell that holds the bucket's preallocated cache (KV cache or rings; RWKV6
  states; Hymba's ring KV cache, fp32 SSM states and ``t``) and token
  buffers.  A Hymba cell's ring is ``min(window, prompt_len)`` slots
  wide, the width the reference's prefill packs, not ``max_len``.
  A bucket's cell is built once (``compiles`` counts the builds, the
  counterpart of the reference's XLA compiles); after ``warmup()`` the
  hit rate is exactly 1.0.  Quota variants alias the bucket's cell, since
  quota is a pass count and not a shape.
* **In-place decode** — prefill writes the cell's cache and each decode
  step updates it in place (a transformer writes slot ``t``, Hymba slot
  ``t mod W``, with ``t`` on the device), so the decode loop allocates no
  cache and never syncs with the host.
* **Decode graphs** — ``Model.decode`` replays each bucket's decode step
  from a CUDA graph captured at the bucket's first step
  (``models/decode_graph.py``), on the card; ``warmup()`` captures every
  bucket, so the served steps only replay.  ``graph_steps`` counts the
  decode steps replayed since warm-up, ``graph_captures`` the graphs.
* **Async dispatch** — ``submit()`` enqueues onto a single worker thread
  and returns a future; ``drain()`` collects the records.
* **Step spans** — with a ``tracer`` (``obs.tracer.StepTracer``) each
  task leaves wall-clock spans on ``time.time_ns``: ``repro.task`` around
  the whole task, ``repro.prefill`` (prefill and argmax, issued, not
  waited for), one ``repro.decode`` a step (decode and argmax),
  ``repro.sync`` around each wait for the device and ``repro.check``
  around the finiteness check; the tracer is set on the worker thread
  for the task, so a transformer's decode step opens its own profiler
  ranges while a profiler records.  With no tracer each site enters a
  shared null context: no clock read, no profiler range.  The records'
  times stay on ``perf_counter``.

Fractional compute quota q < 1 is emulated as ``round(1/q)`` serialized
passes, as in the reference.  Wall times end in ``torch.cuda.synchronize``.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced as reduce_cfg
from repro_torch.gpu import SLICES_PER_VGPU
from repro_torch.models.model import RunOptions, get_model, resolve_device
from repro_torch.obs import tracer as obs_tracer

DEFAULT_BATCH_LATTICE = (1, 2, 4, 8)
DEFAULT_QUOTAS = (1.0, 0.5, 0.25)


@dataclasses.dataclass
class ExecRecord:
    """One real execution of a dispatched task (or a profiling rep)."""
    tid: int                    # emulator task id (-1 for profiling runs)
    func: str
    stage: str                  # emulator stage name ("" for profiling)
    n_jobs: int                 # real jobs in the batch (before padding)
    bucket: int                 # padded batch bucket actually executed
    quota: float                # fractional compute quota emulated
    wall_ms: float              # measured end-to-end (prefill + decode)
    prefill_ms: float           # prefill component
    decode_ms: float            # decode-loop component (gen_len steps)
    cache_hit: bool             # cell cache hit at submit time


@dataclasses.dataclass
class _Cell:
    """A bucket's preallocated buffers: prompt tokens, cache, next
    tokens."""
    tokens: torch.Tensor        # (bucket, prompt_len)
    cache: dict                 # from Model.init_cache(bucket, cache_len)
    next_tokens: torch.Tensor   # (bucket, 1) int64


class TorchExecutor:
    """Cell-cached batched real execution for one arch."""

    def __init__(self, arch: str = "internlm2_1_8b",
                 batch_lattice: tuple = DEFAULT_BATCH_LATTICE,
                 quotas: tuple = DEFAULT_QUOTAS,
                 prompt_len: int = 32, gen_len: int = 4,
                 seed: int = 0, use_kernels: bool = True,
                 reduced: bool = False, n_layers: Optional[int] = None,
                 dtype=torch.bfloat16, device=None,
                 tracer: Optional[obs_tracer.StepTracer] = None):
        self.device = resolve_device(device)
        self.tracer = tracer             # spans of the tasks, or None
        self.arch = arch
        self.reduced = reduced
        cfg = get_config(arch)
        cfg = reduce_cfg(cfg) if reduced else cfg
        if n_layers is not None:
            if n_layers < 1 or n_layers % (cfg.global_every or 1):
                raise ValueError(
                    f"{arch}: a depth of {n_layers} layers is not a whole "
                    f"number (>= 1) of {cfg.global_every or 1}-layer blocks")
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        self.cfg = cfg
        self.dtype = dtype
        self.opts = RunOptions(use_kernels=use_kernels, attn_chunk=64,
                               param_dtype=dtype, act_dtype=dtype)
        self.model = get_model(self.cfg, self.opts, self.device)
        self.params = self.model.init(seed)
        self.batch_lattice = tuple(sorted(batch_lattice))
        self.quotas = tuple(sorted(quotas, reverse=True))
        if 1.0 not in self.quotas:
            self.quotas = (1.0,) + self.quotas
        self.prompt_len = prompt_len
        self.gen_len = gen_len
        self.max_len = prompt_len + gen_len
        # the reference's Hymba prefill packs its ring at the prompt's
        # width, whatever max_len is, and decode never widens it
        self.cache_len = (prompt_len if self.cfg.family == "hybrid"
                          else self.max_len)
        rng = np.random.default_rng(seed)
        # deterministic per-bucket token batches: padding a real batch
        # reuses the bucket's prefix, so shapes are a function of the bucket
        self._tokens = {
            b: torch.from_numpy(rng.integers(0, self.cfg.vocab,
                                             (b, prompt_len))).to(self.device)
            for b in self.batch_lattice
        }
        # cell cache: (arch, stage, bucket, quota) -> _Cell.  Both stages
        # of a bucket share one cell, and quota variants alias it; each
        # key still has its own entry so the hit/miss accounting covers
        # the full dispatch key.
        self._exe: dict[tuple, _Cell] = {}
        self.compiles = 0            # cells built
        self.warmup_compiles = 0     # ... of which during warmup()
        self.cache_hits = 0          # submit()-time cache hits
        self.cache_misses = 0        # submit()-time cache misses
        self.prefill_passes = 0      # model prefill calls
        self.decode_steps = 0        # model decode calls
        self.warmup_decode_steps = 0  # ... by the end of warmup()
        self._warm_replays = 0       # graph replays during warmup()
        self.nonfinite = 0           # passes whose logits were not finite
        self._warmed = False
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._futures: dict[int, Future] = {}
        self.records: list[ExecRecord] = []

    # ---- cell cache -------------------------------------------------------
    def _build_cell(self, bucket: int) -> _Cell:
        """Allocate one bucket's buffers (once per bucket)."""
        self.compiles += 1
        return _Cell(tokens=self._tokens[bucket],
                     cache=self.model.init_cache(bucket, self.cache_len),
                     next_tokens=torch.zeros((bucket, 1), dtype=torch.long,
                                             device=self.device))

    def _cell(self, stage: str, bucket: int, quota: float):
        """Cache lookup for one (arch, stage, bucket, quota) key; builds
        the bucket's cell on a miss.  Returns (cell, hit)."""
        key = (self.arch, stage, bucket, quota)
        cell = self._exe.get(key)
        if cell is not None:
            return cell, True
        base_p = (self.arch, "prefill", bucket, 1.0)
        base_d = (self.arch, "decode", bucket, 1.0)
        if base_p not in self._exe:
            cell = self._build_cell(bucket)
            self._exe[base_p] = cell
            self._exe[base_d] = cell
        self._exe[(self.arch, "prefill", bucket, quota)] = self._exe[base_p]
        self._exe[(self.arch, "decode", bucket, quota)] = self._exe[base_d]
        return self._exe[key], False

    def warmup(self) -> dict:
        """Build every (stage, bucket, quota) cell and run one pass per
        bucket, so steady-state serving never builds again (post-warmup
        hit rate == 1.0)."""
        t0 = time.perf_counter()
        before = self.compiles
        for bucket in self.batch_lattice:
            for quota in self.quotas:
                self._cell("prefill", bucket, quota)
                self._cell("decode", bucket, quota)
            self._run(bucket, 1.0)     # execute once: warm the allocator
        self.warmup_compiles = self.compiles - before
        self.warmup_decode_steps = self.decode_steps
        self._warm_replays = self.model.graphs.replays
        self._warmed = True
        self.cache_hits = self.cache_misses = 0
        return {"warmup_compiles": self.warmup_compiles,
                "warmup_s": time.perf_counter() - t0,
                "cells": len(self._exe)}

    # ---- execution --------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _run(self, bucket: int, quota: float,
             tracer: Optional[obs_tracer.StepTracer] = None,
             tid: int = -1) -> tuple[float, float]:
        """One real serve of a bucket at a quota: prefill + gen_len greedy
        decode steps, ``round(1/q)`` serialized passes, spanned into
        ``tracer`` as task ``tid`` where one is given.  Returns
        (prefill_ms, decode_ms) wall components."""
        cell, _ = self._cell("prefill", bucket, quota)
        passes = max(int(round(1.0 / quota)), 1)
        span = obs_tracer.no_range if tracer is None else tracer.span
        pre_ms = dec_ms = 0.0
        for _ in range(passes):
            with span("repro.sync", tid):
                self._sync()
            t0 = time.perf_counter()
            with span("repro.prefill", tid):
                logits, cache = self.model.prefill(
                    self.params, {"tokens": cell.tokens}, cache=cell.cache)
                first = logits
                nxt = cell.next_tokens
                torch.argmax(logits, -1, keepdim=True, out=nxt)
            with span("repro.sync", tid):
                self._sync()
            t1 = time.perf_counter()
            for i in range(self.gen_len):
                with span("repro.decode", tid, i):
                    logits, cache = self.model.decode(self.params, cache, nxt)
                    torch.argmax(logits, -1, keepdim=True, out=nxt)
            with span("repro.sync", tid):
                self._sync()
            t2 = time.perf_counter()
            pre_ms += (t1 - t0) * 1e3
            dec_ms += (t2 - t1) * 1e3
            self.prefill_passes += 1
            self.decode_steps += self.gen_len
            with span("repro.check", tid):
                if not (torch.isfinite(first).all()
                        and torch.isfinite(logits).all()):
                    self.nonfinite += 1
        return pre_ms, dec_ms

    def bucket_of(self, n: int) -> int:
        for b in self.batch_lattice:
            if n <= b:
                return b
        return self.batch_lattice[-1]

    def quota_of(self, task) -> float:
        """Snap a task's delivered slice quota to the measured lattice."""
        cfg = task.config
        q = task.quota_slices / max(cfg.vgpu * SLICES_PER_VGPU, 1)
        return min(self.quotas, key=lambda x: abs(x - q))

    # ---- emulator hook ----------------------------------------------------
    def submit(self, task) -> Future:
        """ClusterSim._dispatch hook: execute the dispatched task for
        real, asynchronously.  Never blocks the emulator thread."""
        n_jobs = len(task.jobs)
        bucket = self.bucket_of(max(n_jobs, 1))
        quota = self.quota_of(task)
        # cache accounting on the caller thread, so the hit/miss order
        # follows the dispatch order deterministically
        _, hit_p = self._cell("prefill", bucket, quota)
        _, hit_d = self._cell("decode", bucket, quota)
        hit = hit_p and hit_d
        if hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        tid, func, stage = task.tid, task.func, task.stage

        def record(pre: float, dec: float) -> ExecRecord:
            rec = ExecRecord(tid=tid, func=func, stage=stage,
                             n_jobs=n_jobs, bucket=bucket, quota=quota,
                             wall_ms=pre + dec, prefill_ms=pre,
                             decode_ms=dec, cache_hit=hit)
            self.records.append(rec)
            return rec

        def work() -> ExecRecord:
            tracer = self.tracer
            if tracer is None:
                return record(*self._run(bucket, quota))
            obs_tracer.set_active(tracer)
            try:
                with tracer.span("repro.task", tid):
                    return record(*self._run(bucket, quota, tracer, tid))
            finally:
                obs_tracer.set_active(None)

        fut = self._pool.submit(work)
        self._futures[tid] = fut
        return fut

    def measure(self, bucket: int, quota: float, reps: int = 3,
                ) -> ExecRecord:
        """Synchronous timed run for profiling: floor of ``reps``.

        Wall-clock noise is one-sided (runs only ever get slower), so the
        minimum is the reproducible statistic."""
        runs = [self._run(bucket, quota) for _ in range(reps)]
        pre = float(np.min([r[0] for r in runs]))
        dec = float(np.min([r[1] for r in runs]))
        return ExecRecord(tid=-1, func=self.arch, stage="", n_jobs=bucket,
                          bucket=bucket, quota=quota, wall_ms=pre + dec,
                          prefill_ms=pre, decode_ms=dec, cache_hit=True)

    # ---- teardown / stats -------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> list[ExecRecord]:
        """Wait for all in-flight work; returns the full record list."""
        for fut in list(self._futures.values()):
            fut.result(timeout=timeout)
        return list(self.records)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)

    def stats(self) -> dict:
        served = self.cache_hits + self.cache_misses
        return {
            "arch": self.arch,
            "reduced": self.reduced,
            "n_layers": self.cfg.n_layers,
            "device": str(self.device),
            "dtype": str(self.dtype).replace("torch.", ""),
            "batch_lattice": list(self.batch_lattice),
            "quotas": list(self.quotas),
            "prompt_len": self.prompt_len,
            "gen_len": self.gen_len,
            "compiles": self.compiles,
            "warmup_compiles": self.warmup_compiles,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "post_warmup_hit_rate": (self.cache_hits / served) if served
            else None,
            "executed": len(self.records),
            "prefill_passes": self.prefill_passes,
            "decode_steps": self.decode_steps,
            "warmup_decode_steps": self.warmup_decode_steps,
            "graph_steps": self.model.graphs.replays - self._warm_replays,
            "graph_captures": self.model.graphs.captures,
            "nonfinite_passes": self.nonfinite,
        }
