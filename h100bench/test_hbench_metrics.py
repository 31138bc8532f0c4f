"""The metric readers' arithmetic on synthetic records: tails over every
request (shed and unanswered ones counted to the end of the run), rates
over the whole window, rooflines from the trace's launches."""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from hbench import counts, records, trace  # noqa: E402

MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "d_head": 16, "d_ff": 128, "vocab": 256, "window": None,
         "n_experts": None, "top_k": None}


def metric(name):
    spec = importlib.util.spec_from_file_location(
        f"test_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def task(tid, n, bucket, done, wall, traced=False):
    half = None if wall is None else wall / 2
    return records.Task(tid=tid, n_jobs=n, bucket=bucket, release_s=0.0,
                        done_s=done, wall_ms=wall, prefill_ms=half,
                        decode_ms=half, predicted_ms=(wall or 0.0) * 1.1,
                        traced=traced)


def run(release="schedule", requests=(), tasks=(), end_s=12.0,
        device="NVIDIA H100 80GB HBM3", trace_=None):
    return records.Run(cell="c", release=release, seconds=10.0, end_s=end_s,
                       slo_ms=500.0, prompt_len=8, gen_len=2, model=MODEL,
                       device=device, setup_s=3.5, requests=list(requests),
                       tasks=list(tasks), trace=trace_)


def test_tail_counts_every_request_to_the_end():
    reqs = [records.Request(i, 1.0, True, 0, 1.1) for i in range(17)]
    reqs += [records.Request(17, 2.0, False),            # shed
             records.Request(18, 3.0, True, 1, None),     # never answered
             records.Request(19, 4.0, True, 2, 4.4)]
    r = run(requests=reqs)
    lat = np.array([100.0] * 17 + [10000.0, 9000.0, 400.0])
    assert metric("req_p95_ms")(r) == pytest.approx(np.percentile(lat, 95))
    assert metric("slo_hit_rate")(r) == pytest.approx(100.0 * 18 / 20)
    assert metric("slo_hit_rate")(run(release="backlog",
                                      requests=reqs)) is None


def test_cost_and_rates():
    ts = [task(0, 3, 4, 1.0, 200.0), task(1, 8, 8, 2.0, 400.0),
          task(2, 1, 1, None, None), task(3, 2, 2, 3.0, 100.0, traced=True)]
    r = run(tasks=ts)
    assert metric("gpu_ms_per_req")(r) == pytest.approx(600.0 / 11)
    assert metric("batch_fill")(r) == pytest.approx(100.0 * 13 / 14)
    assert metric("profile_err")(r) == pytest.approx(10.0)
    assert metric("prefill_ms_per_ktok")(r) == pytest.approx(
        300.0 / (12 * 8 / 1e3))
    assert metric("decode_step_ms")(r) == pytest.approx(300.0 / 4)
    flops = 11 * counts.request_flops(MODEL, 8, 2)
    assert metric("step_mfu")(r) == pytest.approx(
        100.0 * flops / 0.6 / counts.PEAK_BF16_FLOPS)
    assert metric("step_mfu")(run(tasks=ts, device="cpu")) is None
    assert metric("setup_s")(r) == 3.5


def test_tokens_over_the_whole_window():
    ts = [task(0, 8, 8, 4.0, 4000.0), task(1, 8, 8, 9.0, 5000.0),
          task(2, 4, 4, 11.0, 2000.0)]      # started at 9 s, half inside
    r = run(release="backlog", tasks=ts, end_s=10.0)
    assert metric("tokens_s")(r) == pytest.approx((16 + 2) * 10 / 10.0)
    assert metric("gpu_ms_per_req")(r) == pytest.approx(9000.0 / 16)
    assert metric("tokens_s")(run(tasks=ts)) is None


def _slice(kernels, tasks=(8, 8)):
    return trace.Slice(window_s=2.0, busy_s=1.5, kernels=kernels,
                       idle_gaps=[], tasks=list(tasks), gen_len=2,
                       prompt_len=8)


def test_rooflines_read_only_whole_slices():
    fa = counts.bound_s(*counts.flash_attention(MODEL, 8, 8))
    s = _slice({"fa_tc_kernel<128>": [4, 4 * fa * 2]})
    assert metric("flash_attention_roofline")(run(trace_=s)) == \
        pytest.approx(50.0)
    s = _slice({"fa_tc_kernel<128>": [3, 1.0]})
    assert metric("flash_attention_roofline")(run(trace_=s)) is None
    fd = sum(counts.bound_s(*counts.flash_decode(MODEL, 8, 8 + j))
             for j in range(2)) * 2 * 2
    s = _slice({"fd_cluster_kernel": [8, fd * 4]})
    assert metric("flash_decode_roofline")(run(trace_=s)) == \
        pytest.approx(25.0)
    assert metric("flash_decode_roofline")(run(trace_=_slice({}))) is None
    assert metric("device_idle")(run(trace_=s)) == pytest.approx(25.0)
    assert metric("device_idle")(run()) is None


def test_busy_union_and_gap_labels():
    assert trace.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    cpu = [(0, 10, "hbench.decode"), (1, 4, "aten::mm"), (6, 9, "sync")]
    assert trace._innermost(cpu, [0.5, 2, 5, 7, 11]) == [
        "hbench.decode", "aten::mm", "hbench.decode", "sync",
        "no host operator"]


def test_counts():
    assert counts.window_pairs(5, None) == 15
    assert counts.window_pairs(5, 2) == 3 + 3 * 2
    nb, fl = counts.flash_decode(MODEL, 2, 9)
    assert fl == 4.0 * 2 * 4 * 16 * 10
    assert nb == (2 * 2 * 4 * 16 + 2 * 2 * 10 * 2 * 16) * 2 + 4


def test_a_metric_without_a_file_of_its_own_reads_with_its_base():
    spec = importlib.util.spec_from_file_location("run_for_metrics",
                                                  HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.metric_file("step_mfu") == HERE / "metrics" / "step_mfu.py"
    assert mod.metric_file("step_mfu.moe_decode") == \
        HERE / "metrics" / "step_mfu.py"
    ts = [task(0, 8, 8, 4.0, 4000.0)]
    r = run(release="backlog", tasks=ts, end_s=10.0)
    assert mod.read_metric("tokens_s.moe_decode", r) == \
        metric("tokens_s")(r)
