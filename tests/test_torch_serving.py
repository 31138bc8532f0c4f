"""Port executor, profiles, launcher and copied control plane, on the CPU.

The executor tests are the reference's (tests/test_realcompute.py), run on
the port's ``TorchExecutor`` with ``device="cpu"`` at reduced size: zero
cell builds after warmup, bucket and quota snapping, quota as serialized
passes, and an unchanged schedule digest with the executor attached.  The
control-plane test drives the reference's and the port's copies of the
ESG scheduler and emulator through the same scenarios and compares their
schedule digests.
"""
from __future__ import annotations

import json

import pytest
import torch


@pytest.fixture(scope="module")
def executor():
    from repro_torch.serving.executor import TorchExecutor
    ex = TorchExecutor("internlm2_1_8b", batch_lattice=(1, 2),
                       quotas=(1.0, 0.5), prompt_len=8, gen_len=2, seed=0,
                       reduced=True, dtype=torch.float32, device="cpu")
    ex.warmup()
    yield ex
    ex.shutdown()


class _FakeTask:
    _next = iter(range(10_000))

    def __init__(self, n_jobs, slices=4):
        from repro_torch.core.profiles import Config
        self.tid = next(self._next)
        self.func = "internlm2_1_8b"
        self.stage = "0:internlm2_1_8b"
        self.jobs = [None] * n_jobs
        self.config = Config(n_jobs, 1, 1)
        self.quota_slices = slices


def test_executor_zero_recompiles_after_warmup(executor):
    compiles_before = executor.compiles
    for n, slices in [(1, 4), (2, 4), (2, 2), (1, 2), (2, 4), (1, 4)]:
        executor.submit(_FakeTask(n, slices))
    executor.drain()
    assert executor.compiles == compiles_before      # zero new cell builds
    assert executor.cache_misses == 0
    assert executor.stats()["post_warmup_hit_rate"] == 1.0
    assert executor.stats()["nonfinite_passes"] == 0


def test_executor_bucketing_and_quota_snap(executor):
    assert executor.bucket_of(1) == 1
    assert executor.bucket_of(2) == 2
    assert executor.bucket_of(3) == 2                # clamps to max bucket
    assert executor.quota_of(_FakeTask(1, slices=4)) == 1.0
    assert executor.quota_of(_FakeTask(1, slices=2)) == 0.5
    assert executor.quota_of(_FakeTask(1, slices=3)) == 1.0  # nearest


def test_executor_quota_is_serialized_passes(executor):
    passes, steps = executor.prefill_passes, executor.decode_steps
    full = executor.measure(1, 1.0, reps=3)
    half = executor.measure(1, 0.5, reps=3)
    # a half-quota cell runs 2 serialized passes: counted exactly, and
    # strictly slower on the wall clock (loosely ~2x)
    assert executor.prefill_passes - passes == 3 * 1 + 3 * 2
    assert executor.decode_steps - steps == 9 * executor.gen_len
    assert half.wall_ms > full.wall_ms * 1.2


def test_sim_digest_unchanged_by_attached_executor(executor):
    from repro_torch.cluster.emulator import ClusterSim
    from repro_torch.core.profiles import ProfileTable
    from repro_torch.core.scheduler import ESGScheduler
    from repro_torch.core.workflows import Workflow
    from repro_torch.launch.profile_kernels import build_artifact
    from repro_torch.serving import Gateway, get_scenario

    art = build_artifact(executor, reps=1, log=lambda *_: None)
    assert art["schema"] == "repro.measured_profile.v1"
    assert art["backend"] == "cpu" and art["interpret"] is False
    assert art["roofline"] == []                     # no card, no bound
    json.dumps(art)

    arch = executor.arch
    digests = []
    for ex in (None, executor):
        table = ProfileTable.from_measured(art)
        apps = {arch: Workflow.pipeline(arch, [arch])}
        sched = ESGScheduler(apps, {arch: table}, risk_sigma=0.05)
        sim = ClusterSim(apps, {arch: table}, {arch: table.fn}, sched,
                         n_invokers=1, vcpus=8, vgpus=1,
                         noise_sigma=0.0, seed=0, count_overhead=False,
                         track_digest=True, executor=ex)
        gw = Gateway(sim)
        gw.inject(get_scenario("mmpp", app_names=[arch]), 6, seed=1,
                  slo_mult=8.0)
        tel = gw.run()
        digests.append(sim.run_digest())
        assert tel.summary()["profile_provenance"] == {arch: "measured"}
    executor.drain()
    assert digests[0] == digests[1]


def test_executor_defaults_to_cuda():
    from repro_torch.serving.executor import TorchExecutor
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchExecutor()


def test_serve_real_on_cpu_end_to_end(tmp_path):
    from repro_torch.launch.serve import serve_real
    out = tmp_path / "bench.json"
    bench = serve_real(n_requests=8, gen_len=2, prompt_len=8,
                       batches=(1, 2), quotas=(1.0, 0.5), reps=1,
                       reduced=True, dtype=torch.float32, device="cpu",
                       bench_out=str(out), log=lambda *_: None)
    assert json.loads(out.read_text())["schema"] == \
        "repro.realcompute_bench.v1"
    tel, ex = bench["telemetry"], bench["executor"]
    assert tel["completed"] + tel["shed"] == tel["injected"] == 8
    assert ex["executed"] == bench["dispatched_tasks"] > 0
    assert ex["post_warmup_hit_rate"] == 1.0
    assert bench["digest"]["with_executor"] == \
        bench["digest"]["without_executor"]
    assert bench["backend"] == "cpu"


def test_serve_cli_refuses_emulate_mode():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="ROADMAP"):
        main([])


# ---- roofline -------------------------------------------------------------

def test_device_peaks_by_name():
    from repro_torch.launch.roofline import device_peaks
    assert device_peaks("NVIDIA H100 80GB HBM3").name == "H100 SXM"
    assert device_peaks("NVIDIA H100 80GB HBM3").peak_flops == 989e12
    assert device_peaks("NVIDIA H100 80GB HBM3").hbm_bw == 3.35e12
    assert device_peaks("NVIDIA H100 PCIe").name == "H100 PCIe"
    assert device_peaks("NVIDIA H100 NVL").name == "H100 NVL"
    with pytest.raises(KeyError):
        device_peaks("NVIDIA A100-SXM4-80GB")


def test_roofline_terms_match_reference_arithmetic():
    """Same model arithmetic as the reference; only the peaks differ."""
    from repro.configs.registry import ShapeSpec as RefShape
    from repro.configs.registry import get_config as ref_cfg
    from repro.launch import roofline as ref_rl
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch import roofline as rl
    peaks = rl.device_peaks("NVIDIA H100 80GB HBM3")
    for kind, seq, b in (("prefill", 128, 8), ("decode", 1, 8)):
        shape = ShapeSpec("x", seq, b, kind)
        cfg = get_config("internlm2_1_8b")
        ref_shape = RefShape("x", seq, b, kind)
        assert rl.model_flops(cfg, shape) == ref_rl.model_flops(
            ref_cfg("internlm2_1_8b"), ref_shape)
        assert rl.analytic_memory_bytes(cfg, shape, 1) == \
            ref_rl.analytic_memory_bytes(ref_cfg("internlm2_1_8b"),
                                         ref_shape, 1)
        t = rl.roofline(cfg, shape, rl.model_flops(cfg, shape), 0.0, 0.0, 1,
                        peaks)
        assert t.compute_s == pytest.approx(rl.model_flops(cfg, shape)
                                            / 989e12)
    # decode at batch 8 reads every weight once: bound by bytes
    assert t.dominant == "memory"


# ---- the copied control plane ---------------------------------------------

def _artifact(arch):
    return {
        "schema": "repro.measured_profile.v1", "arch": arch,
        "backend": "cpu", "interpret": False, "prompt_len": 8, "gen_len": 2,
        "batch_lattice": [1, 2, 4], "quota_lattice": [1.0, 0.5],
        "cells": [
            {"batch": 1, "quota": 1.0, "e2e_ms": 10.0},
            {"batch": 2, "quota": 1.0, "e2e_ms": 14.0},
            {"batch": 4, "quota": 1.0, "e2e_ms": 22.0},
            {"batch": 2, "quota": 0.5, "e2e_ms": 26.0},
        ],
        "cold_ms": 100.0, "input_mb": 0.02,
    }


def _digest(pkg, scenario):
    import importlib
    emu = importlib.import_module(f"{pkg}.cluster.emulator")
    prof = importlib.import_module(f"{pkg}.core.profiles")
    sch = importlib.import_module(f"{pkg}.core.scheduler")
    wf = importlib.import_module(f"{pkg}.core.workflows")
    serving = importlib.import_module(f"{pkg}.serving")
    funcs = ["draft", "verify"]
    tables = {f: prof.ProfileTable.from_measured(_artifact(f)) for f in funcs}
    apps = {"two_stage": wf.Workflow.pipeline("two_stage", funcs),
            "one_stage": wf.Workflow.pipeline("one_stage", ["verify"])}
    sched = sch.ESGScheduler(apps, tables, risk_sigma=0.05)
    sim = emu.ClusterSim(apps, tables, {f: t.fn for f, t in tables.items()},
                         sched, n_invokers=2, noise_sigma=0.05, seed=3,
                         count_overhead=False, track_digest=True,
                         autoscaler=serving.get_autoscaler("ewma"))
    gw = serving.Gateway(sim)
    gw.inject(serving.get_scenario(scenario, app_names=list(apps)), 40,
              seed=4, slo_mult=2.0)
    s = gw.run().summary()
    return sim.run_digest(), s["completed"], s["shed"]


@pytest.mark.parametrize("scenario", ["mmpp", "flash-crowd"])
def test_copied_control_plane_replays_the_reference(scenario):
    ref = _digest("repro", scenario)
    port = _digest("repro_torch", scenario)
    assert port == ref
    assert ref[1] + ref[2] == 40
