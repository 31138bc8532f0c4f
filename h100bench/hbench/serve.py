"""The system under test, driven the way the benchmark measures it.

Set-up builds the program's ``TorchExecutor``, hands it the run's weights
and prompts, warms it, measures its profile (``build_artifact`` and
``ProfileTable.from_measured``) and plans the cell's arrivals through the
program's Gateway, ``ESGScheduler`` and ``ClusterSim`` (one invoker, one
vGPU, ``count_overhead=False``, as ``launch/serve.py::_serve_once`` wires
them), each arrival with the cell's fixed SLO.  The plan is the list of
dispatched tasks: each task's jobs, bucket and simulated dispatch time.

The window hands each task to ``TorchExecutor.submit`` on the wall clock:
``schedule`` releases a task when the window's clock reaches its dispatch
time, ``backlog`` releases every task at the start.

``Steps`` wraps the executor model's ``prefill`` and ``decode`` on the
instance (no program file changes): it counts the tasks as the worker
thread runs them, keeps the logits and the fed tokens of the tasks the
check samples, and starts and stops the profiled slice on the worker
thread.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from hbench import inputs
from hbench.spans import Spans


class Steps:
    """The executor model's steps, wrapped on its instance."""

    def __init__(self, ex, sample: set, gen_len: int, slice_=None,
                 spans: Spans | None = None):
        self.ex, self.gen_len = ex, gen_len
        self.sample = set(sample)
        self.slice = slice_                  # (start s, tasks) or None
        self.slice_at = None                 # perf_counter of the start
        self.slice_end = -1                  # first task after the slice
        self.spans = spans
        self.task = -1                       # task the worker is running
        self.step = 0                        # decode steps of that task
        self.kept: dict[int, dict] = {}      # task -> logits and fed tokens
        self.prof = None
        self.traced: list[int] = []          # bucket of each profiled task
        self.trace_window = (0.0, 0.0)
        self._prefill = ex.model.prefill
        self._decode = ex.model.decode
        ex.model.prefill = self.prefill
        ex.model.decode = self.decode

    def arm(self, t0: float):
        """Set the slice's start on the window's clock."""
        if self.slice:
            self.slice_at = t0 + self.slice[0]

    def uninstall(self):
        del self.ex.model.prefill, self.ex.model.decode

    def _sync(self):
        if self.ex.device.type == "cuda":
            torch.cuda.synchronize(self.ex.device)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.ex.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.trace_window = (time.perf_counter(), 0.0)

    def stop_profile(self):
        """Stop the slice; runs on the worker thread."""
        if self.prof is None or self.trace_window[1]:
            return
        self._sync()
        self.trace_window = (self.trace_window[0], time.perf_counter())
        self.prof.stop()

    def prefill(self, params, batch, *a, **kw):
        self.task += 1
        self.step = 0
        k = self.task
        if (self.slice_at is not None and self.prof is None
                and time.perf_counter() >= self.slice_at):
            self.slice_end = k + self.slice[1]
            self._start_profile()
        if self.prof is not None and not self.trace_window[1]:
            self.traced.append(batch["tokens"].shape[0])
        with self._span("prefill", k):
            logits, cache = self._prefill(params, batch, *a, **kw)
        if k in self.sample:
            self.kept[k] = {"bucket": batch["tokens"].shape[0],
                            "logits": [logits.detach().clone()], "fed": [],
                            "t": []}
        return logits, cache

    def decode(self, params, cache, tokens):
        k = self.task
        kept = self.kept.get(k)
        if kept is not None:
            kept["fed"].append(tokens.detach().clone())
        with self._span("decode", k):
            logits, cache = self._decode(params, cache, tokens)
        self.step += 1
        if kept is not None:
            kept["logits"].append(logits.detach().clone())
            if isinstance(cache, dict) and "t" in cache:
                kept["t"].append(cache["t"].detach().clone())
        if k == self.slice_end - 1 and self.step == self.gen_len:
            self.stop_profile()
        return logits, cache

    def _span(self, name, task):
        if self.prof is not None and not self.trace_window[1]:
            return torch.profiler.record_function(f"hbench.{name}")
        if self.spans is not None:
            return self.spans.span(name, task=task)
        return _nothing()


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def build_executor(cfg: dict, mix: dict, seed: int, device, reduced: bool):
    """The program's executor for the cell, filled with the run's weights
    and prompts; returns (executor, model sizes)."""
    from repro_torch.serving.executor import TorchExecutor

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    ex = TorchExecutor(cfg["arch"], batch_lattice=tuple(mix["batch_lattice"]),
                       quotas=(1.0,), prompt_len=mix["prompt_len"],
                       gen_len=mix["gen_len"], seed=seed, reduced=reduced,
                       n_layers=None if reduced else cfg["model"]["n_layers"],
                       dtype=dtype, device=device)
    model = sizes_of(ex.cfg) if reduced else dict(cfg["model"])
    if not reduced:
        got = sizes_of(ex.cfg)
        diff = {k: (got[k], v) for k, v in model.items() if got[k] != v}
        if diff:
            raise ValueError(f"the program's config differs from the "
                             f"benchmark's: {diff}")
    refill(ex, model, seed)
    return ex, model


def refill(ex, model: dict, seed: int) -> None:
    """Give the executor the seed's weights and prompts, in place (the
    bucket cells built by warm-up hold the same prompt tensors)."""
    inputs.fill_program(ex.params, model, seed)
    for b in ex.batch_lattice:
        ex._tokens[b].copy_(inputs.prompts(seed, b, ex.prompt_len,
                                           model["vocab"], ex.device))


def sizes_of(c) -> dict:
    """The sizes the harness reads from a program ``ModelConfig``."""
    return {"n_layers": c.n_layers, "d_model": c.d_model,
            "n_heads": c.n_heads, "n_kv_heads": c.n_kv_heads,
            "d_head": c.d_head, "d_ff": c.d_ff, "vocab": c.vocab,
            "norm_eps": 1e-5, "rope_theta": c.rope_theta,
            "window": c.window, "n_experts": c.n_experts,
            "top_k": c.top_k if c.n_experts else None,
            "capacity_factor": c.capacity_factor if c.n_experts else None}


def measured_profile(ex, reps: int):
    """The program's measured profile of the executor: the floor of
    ``reps`` timed passes a bucket (``build_artifact``)."""
    from repro_torch.core.profiles import ProfileTable
    from repro_torch.launch.profile_kernels import build_artifact

    return ProfileTable.from_measured(
        build_artifact(ex, reps=reps, log=lambda *_: None))


class _Plan:
    """Stands in for the executor while the emulator plans: keeps the
    dispatched tasks."""

    def __init__(self):
        self.tasks = []

    def submit(self, task):
        self.tasks.append(task)


def plan(arch: str, table, arrivals_ms, slo_ms: float, seed: int):
    """Dispatched tasks (by dispatch time) and each arrival's admission."""
    from repro_torch.cluster.emulator import ClusterSim
    from repro_torch.core.scheduler import ESGScheduler
    from repro_torch.core.workflows import Workflow
    from repro_torch.serving.gateway import Gateway

    apps = {arch: Workflow.pipeline(arch, [arch])}
    sched = ESGScheduler(apps, {arch: table}, risk_sigma=0.05)
    rec = _Plan()
    sim = ClusterSim(apps, {arch: table}, {arch: table.fn}, sched,
                     n_invokers=1, vcpus=8, vgpus=1, noise_sigma=0.0,
                     seed=seed % 2 ** 32, count_overhead=False,
                     executor=rec)
    gw = Gateway(sim)
    admit, admitted = sim.admission, {}

    def admission(s, inst):
        ok = admit(s, inst)
        admitted[inst.uid] = bool(ok)
        return ok

    sim.admission = admission
    for uid, t in enumerate(arrivals_ms):
        sim.add_arrival(arch, float(t), float(slo_ms), uid)
    gw.run()
    tasks = sorted(rec.tasks, key=lambda t: (t.dispatch_ms, t.tid))
    return tasks, admitted


@dataclasses.dataclass
class Released:
    """One task as the window ran it."""
    tid: int
    uids: list
    n_jobs: int
    release_s: float = -1.0
    done_s: float | None = None
    error: str | None = None
    cancelled: bool = False


def run_window(ex, tasks, release: str, seconds: float, grace_s: float,
               spans: Spans, steps: Steps) -> tuple[list[Released], float]:
    """Release the tasks on the wall clock and wait for them.  Returns
    the tasks as run and the window's origin (``perf_counter``)."""
    runs = [Released(t.tid, [j.inst.uid for j in t.jobs], len(t.jobs))
            for t in tasks]
    futs = []
    t0 = time.perf_counter()
    steps.arm(t0)

    def on_done(r: Released, fut):
        if fut.cancelled():
            r.cancelled = True
            return
        r.done_s = time.perf_counter() - t0
        if fut.exception() is not None:
            r.error = repr(fut.exception())

    with spans.span("window", release=release):
        for task, r in zip(tasks, runs):
            if release == "schedule":
                wait = t0 + task.dispatch_ms / 1e3 - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            r.release_s = time.perf_counter() - t0
            fut = ex.submit(task)
            fut.add_done_callback(lambda f, r=r: on_done(r, f))
            futs.append(fut)
        if release == "backlog":
            time.sleep(max(t0 + seconds - time.perf_counter(), 0.0))
            for f in futs:
                f.cancel()
    deadline = t0 + max(seconds, runs[-1].release_s if runs else 0) + grace_s
    with spans.span("drain"):
        for f in futs:
            left = deadline - time.perf_counter()
            if f.cancelled() or left <= 0:
                continue
            try:
                f.result(timeout=left)
            except Exception:   # recorded by on_done; judged as a failure
                pass
    for f in futs:
        f.cancel()
    return runs, t0
