"""The executor's wall-clock step spans and the decode step's profiler
ranges (``obs.tracer.StepTracer``), on the CPU at reduced size.

With no tracer a task reads no clock of the tracer's and enters no
profiler range or profiler check: ``time.time_ns``, the profiler's range
constructors and its enabled check are patched to raise, and the task's next tokens and cache equal a traced
run's bit for bit.  With a tracer every task leaves its spans nested in
its ``repro.task``; the decode step's ranges appear only while a
profiler records on the worker thread, and the spans' ``time_ns`` stamps
lie on the profiler's clock (through ``trace_start_ns``).
"""
from __future__ import annotations

import json
import time

import pytest
import torch

from repro_torch.obs import tracer as obs_tracer
from repro_torch.serving.executor import TorchExecutor

GEN = 3
DECODE_RANGES = {"repro.embed", "repro.attn", "repro.mlp", "repro.head"}
MOE_RANGES = {"repro.moe.route", "repro.moe.experts"}


class _Task:
    def __init__(self, tid, n_jobs=2):
        from repro_torch.core.profiles import Config
        self.tid = tid
        self.func = self.stage = "stage"
        self.jobs = [None] * n_jobs
        self.config = Config(n_jobs, 1, 1)
        self.quota_slices = 4


def _executor(arch, tracer=None):
    ex = TorchExecutor(arch, batch_lattice=(2,), quotas=(1.0,),
                       prompt_len=8, gen_len=GEN, seed=3, reduced=True,
                       dtype=torch.float32, device="cpu", tracer=tracer)
    ex.warmup()
    return ex


def _served(ex, tids):
    """Run the tasks; returns the bucket's next tokens and cache."""
    for tid in tids:
        ex.submit(_Task(tid)).result()
    cell = ex._exe[(ex.arch, "prefill", 2, 1.0)]
    return cell.next_tokens.clone(), {k: v.clone()
                                      for k, v in cell.cache.items()}


def _on_worker(ex, fn):
    return ex._pool.submit(fn).result()


def _profiled(ex, tids):
    """Run the tasks under a profiler started and stopped on the
    executor's worker thread, as the benchmark's slice is."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    _on_worker(ex, prof.start)
    _served(ex, tids)
    _on_worker(ex, prof.stop)
    return prof


def _raise(*a, **k):
    raise AssertionError("the untraced path reached the tracer's clock or "
                         "the profiler")


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b"])
def test_untraced_task_reads_no_clock_and_equals_a_traced_one(monkeypatch,
                                                              arch):
    traced = _served(_executor(arch, obs_tracer.StepTracer()), [0, 1])
    ex = _executor(arch)
    monkeypatch.setattr(time, "time_ns", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", _raise)
    plain = _served(ex, [0, 1])
    monkeypatch.undo()
    assert [r.tid for r in ex.records] == [0, 1]
    assert torch.equal(plain[0], traced[0])
    assert plain[1].keys() == traced[1].keys()
    for k in plain[1]:
        assert torch.equal(plain[1][k], traced[1][k]), k


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b",
                                  "rwkv6_1_6b"])
def test_each_task_nests_its_step_spans(arch):
    tracer = obs_tracer.StepTracer()
    ex = _executor(arch, tracer)
    assert tracer.spans == []                  # warm-up is not a task
    _served(ex, [5, 6])
    for tid in (5, 6):
        mine = [s for s in tracer.spans if s[3] == tid]
        names = [s[0] for s in mine]
        assert names.count("repro.task") == 1
        assert names.count("repro.prefill") == 1
        assert names.count("repro.decode") == GEN
        assert names.count("repro.sync") == 3
        assert names.count("repro.check") == 1
        assert len(names) == 6 + GEN
        (task,) = [s for s in mine if s[0] == "repro.task"]
        inner = sorted((s for s in mine if s is not task),
                       key=lambda s: s[1])
        assert all(task[1] <= s[1] <= s[2] <= task[2] for s in inner)
        assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
        assert [s[0] for s in inner] == (
            ["repro.sync", "repro.prefill", "repro.sync"]
            + ["repro.decode"] * GEN + ["repro.sync", "repro.check"])
        assert [s[4] for s in inner if s[0] == "repro.decode"] == list(
            range(GEN))
    assert obs_tracer._thread.tracer is None   # this thread never ran one
    assert _on_worker(ex, lambda: obs_tracer._thread.tracer) is None
    ex.shutdown()


def _range_names(prof):
    return [e.name for e in prof.events() if e.name.startswith("repro.")]


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b"])
def test_decode_ranges_only_while_a_profiler_records(monkeypatch, arch):
    tracer = obs_tracer.StepTracer()
    ex = _executor(arch, tracer)
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name, *a):
        entered.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    _served(ex, [0])
    assert entered == []                       # a tracer, no profiler
    assert len(tracer.spans) == 6 + GEN
    names = _range_names(_profiled(ex, [1]))
    layers = ex.cfg.n_layers
    want = DECODE_RANGES | (MOE_RANGES if ex.cfg.n_experts else set())
    got = {n for n in names if n in DECODE_RANGES | MOE_RANGES}
    assert got == want
    assert names.count("repro.attn") == GEN * layers
    assert names.count("repro.mlp") == GEN * layers
    if ex.cfg.n_experts:
        assert names.count("repro.moe.route") == GEN * layers
    assert entered.count("repro.attn") == GEN * layers
    # the executor's spans are mirrored too
    for n, c in [("repro.task", 1), ("repro.prefill", 1),
                 ("repro.decode", GEN), ("repro.sync", 3),
                 ("repro.check", 1)]:
        assert names.count(n) == c, n
    assert _on_worker(ex, lambda: (obs_tracer._thread.tracer,
                                   obs_tracer._thread.ranges)) == (
        None, obs_tracer.no_range)
    ex.shutdown()


def test_a_profiler_without_a_tracer_sees_no_program_range():
    ex = _executor("mixtral_8x22b")
    assert _range_names(_profiled(ex, [0])) == []
    ex.shutdown()


def test_stamps_lie_on_the_profilers_clock():
    """Each span is stamped inside its mirrored range: the range's start
    and end, read through ``trace_start_ns``, enclose the stamps (less
    5 us for the profiler's conversion of its clock), and the typical
    edge lies within 50 us of its stamp.  On another clock, such as
    ``perf_counter``'s, they would lie ~1e18 ns apart."""
    tracer = obs_tracer.StepTracer()
    ex = _executor("internlm2_1_8b", tracer)
    prof = _profiled(ex, [0, 1])
    start = prof.profiler.kineto_results.trace_start_ns()
    names = {s[0] for s in tracer.spans}
    ranges: dict[str, list] = {}
    for e in prof.events():
        if e.name in names:
            ranges.setdefault(e.name, []).append(
                (start + e.time_range.start * 1e3,
                 start + e.time_range.end * 1e3))
    assert set(ranges) == names and len(names) == 5
    edges = []
    for name, mirrored in ranges.items():
        mine = sorted((s[1], s[2]) for s in tracer.spans if s[0] == name)
        assert len(mine) == len(mirrored), name
        for (t0, t1), (r0, r1) in zip(mine, sorted(mirrored)):
            edges += [t0 - r0, r1 - t1]
    assert min(edges) >= -5e3, min(edges)           # ns
    assert sorted(edges)[len(edges) // 2] <= 50e3, sorted(edges)


def test_step_tracer_exports_on_its_own_process(tmp_path):
    tracer = obs_tracer.StepTracer()
    tracer.spans += [("repro.task", 2_000_000, 9_000_000, 4, 0),
                     ("repro.prefill", 2_500_000, 3_000_000, 4, 0),
                     ("repro.decode", 3_000_000, 4_000_000, 4, 0),
                     ("repro.decode", 4_000_000, 5_000_000, 4, 1)]
    doc = tracer.export_chrome_trace(str(tmp_path / "steps.json"))
    assert json.loads((tmp_path / "steps.json").read_text()) == doc
    ev = doc["traceEvents"]
    assert ev[0] == {"ph": "M", "name": "process_name",
                     "pid": obs_tracer.WALL_PID, "tid": 0,
                     "args": {"name": obs_tracer.WALL_PROCESS}}
    spans = [e for e in ev if e["ph"] == "X"]
    assert {e["pid"] for e in spans} == {obs_tracer.WALL_PID}
    assert obs_tracer.WALL_PID not in (obs_tracer.DEVICE_PID_BASE,
                                       obs_tracer.REQUEST_PID_BASE)
    task = next(e for e in spans if e["name"] == "repro.task")
    assert (task["ts"], task["dur"], task["cat"]) == (2000.0, 7000.0, "task")
    steps = [e["args"]["step"] for e in spans if e["name"] == "repro.decode"]
    assert steps == [0, 1]
    # decode spans that follow each other share a lane
    lanes = {e["tid"] for e in spans if e["name"] == "repro.decode"}
    assert len(lanes) == 1
