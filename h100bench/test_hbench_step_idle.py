"""The device-idle time inside the program's steps (``hbench.step_idle``,
``metrics/decode_idle_ms.py``) on synthetic slices, and the step tracer's
runs of a cell (``step_spans.py``) on the CPU at a tiny size."""
import importlib.util
import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT / "src"))

from hbench import records, step_idle  # noqa: E402

MS = 1_000_000                           # ns
H100 = "NVIDIA H100 80GB HBM3"


def reader():
    spec = importlib.util.spec_from_file_location(
        "test_metric_decode_idle_ms", HERE / "metrics" / "decode_idle_ms.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load(name):
    spec = importlib.util.spec_from_file_location(f"h100bench_{name}_test",
                                                  HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(step_slice=None, device=H100):
    r = records.Run(cell="c", release="backlog", seconds=10.0, end_s=10.0,
                    slo_ms=500.0, prompt_len=8, gen_len=2, model={},
                    device=device, setup_s=3.5, requests=[], tasks=[])
    if step_slice is not None:
        r.step_slice = step_slice
    return r


def sl(device, spans, start=0, end=100, launches=None):
    """A slice over [start, end] ms: device (start, end) ms intervals,
    spans (name, t0, t1) ms."""
    return step_idle.StepSlice(
        start * MS, end * MS,
        [(a * MS, b * MS, i + 1) for i, (a, b) in enumerate(device)],
        launches or {},
        [(n, a * MS, b * MS, 0, k) for k, (n, a, b) in enumerate(spans)])


def test_a_gap_half_inside_a_decode_span_counts_half():
    # the device idles over [10, 30]; the step covers [20, 40]
    s = sl([(0, 10), (30, 100)], [("repro.decode", 20, 40)])
    assert step_idle.idle(s) == [(10 * MS, 30 * MS)]
    assert step_idle.inside(s, "repro.decode") == (1, 10 * MS, 20 * MS)
    assert reader()(run(s)) == pytest.approx(10.0)


def test_a_gap_outside_every_decode_span_counts_nothing():
    s = sl([(0, 10), (30, 100)],
           [("repro.decode", 0, 10), ("repro.decode", 40, 60),
            ("repro.prefill", 10, 30)])
    assert step_idle.inside(s, "repro.decode") == (2, 0, 30 * MS)
    assert reader()(run(s)) == 0.0


def test_idle_is_over_the_steps_of_the_slice_clipped_to_it():
    # the first step starts before the slice, the last ends after it:
    # only the one that starts inside is counted, each is clipped
    s = sl([(20, 30), (40, 50)],
           [("repro.decode", -20, 15), ("repro.decode", 35, 120)],
           start=10, end=60)
    assert step_idle.idle(s) == [(10 * MS, 20 * MS), (30 * MS, 40 * MS),
                                 (50 * MS, 60 * MS)]
    assert step_idle.inside(s, "repro.decode") == (1, 15 * MS, 25 * MS)
    assert reader()(run(s)) == pytest.approx(15.0)


@pytest.mark.parametrize("case", ["no slice", "off the card", "no step"])
def test_the_reader_reads_nothing_without_its_inputs(case):
    s = sl([(0, 10)], [("repro.prefill", 0, 50)])
    r = {"no slice": run(),
         "off the card": run(sl([(0, 10)], [("repro.decode", 0, 50)]),
                             device="cpu"),
         "no step": run(s)}[case]
    assert reader()(r) is None


def test_the_idle_split_covers_the_slice_once():
    s = sl([(5, 10), (50, 55)],
           [("repro.task", 0, 80), ("repro.sync", 0, 5),
            ("repro.prefill", 5, 20), ("repro.sync", 20, 30),
            ("repro.decode", 30, 40), ("repro.decode", 40, 60),
            ("repro.sync", 60, 65), ("repro.check", 65, 70)])
    got = step_idle.split(s)
    assert got == {"decode": 25 * MS, "prefill": 10 * MS,
                   "sync_check": 25 * MS, "task_other": 10 * MS,
                   "outside_tasks": 20 * MS}
    assert sum(got.values()) == sum(b - a for a, b in step_idle.idle(s))


def test_each_launch_pairs_with_the_span_it_was_made_in():
    s = sl([(12, 14), (31, 33), (70, 71)],
           [("repro.decode", 10, 20), ("repro.decode", 30, 40)],
           launches={1: 11 * MS, 2: 30 * MS + 1, 3: 50 * MS})
    # the third was launched outside every step
    assert step_idle.launches_in(s) == [(10 * MS, 11 * MS, 12 * MS),
                                        (30 * MS, 30 * MS + 1, 31 * MS)]


def test_capture_of_a_cpu_profile_has_its_window_and_no_device():
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("repro.decode"):
            torch.ones(64).sum()
    spans = [("repro.decode", 1, 2, 0, 0)]
    s = step_idle.capture(prof, spans)
    assert s.device == [] and s.spans == spans
    assert s.end_ns > s.start_ns > 1e18       # time_ns: from the epoch
    assert step_idle.idle(s) == [(s.start_ns, s.end_ns)]


def dry(cell, trace):
    sp = load("step_spans")
    run_mod = sp.load_run()
    # a test worker has the other test files' imports loaded;
    # test_hbench_hygiene.py holds a fresh run to the check this skips
    run_mod.forbidden_modules = lambda: []
    argv = ["--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds",
            "1.5", "--trace", str(trace), "--device", "cpu", "--reduced",
            "--rate-rps", "60"]
    return sp, run_mod, sp.run_traced(run_mod, argv, bool(trace))


def test_a_traced_dry_run_carries_the_programs_spans():
    sp, run_mod, got = dry("internlm2_1_8b-p2048g8-open", 1)
    assert got["result"]["correct"] is True
    run_ = got["run"]
    s = run_.step_slice
    done = [t for t in run_.tasks if t.wall_ms is not None]
    names = [x[0] for x in s.spans]
    assert names.count("repro.task") == len(done) > 0
    assert names.count("repro.decode") == len(done) * run_.gen_len
    # the profiler starts inside a task's prefill and stops after a task's
    # last step: the slice holds whole tasks' steps
    n, _, _ = step_idle.inside(s, "repro.decode")
    assert n > 0 and n % run_.gen_len == 0
    assert n == sum(1 for x in s.spans if x[0] == "repro.decode"
                    and s.start_ns <= x[1] < s.end_ns)
    assert s.device == []                      # no card
    assert run_mod.read_metric("decode_idle_ms", run_) is None
    row = sp.summary(run_mod, got)
    assert row["decode_spans"] == n and row["lead_us_min"] is None
    assert row["decode_busy_ms"] == 0.0      # no device ran: all idle
    assert row["idle_ms"] == pytest.approx(sum(row["idle_split_ms"].values()))
    json.dumps(row)


def test_an_untraced_dry_run_carries_none():
    sp, run_mod, got = dry("internlm2_1_8b-p2048g8-open", 0)
    assert got["result"]["correct"] is True
    assert got["spans"] == 0 and got["run"].step_slice is None
    assert "decode_idle_ms" not in sp.summary(run_mod, got)
