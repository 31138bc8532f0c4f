"""Port executor, profiles, launcher and copied control plane, on the CPU.

The executor tests are the reference's (tests/test_realcompute.py), run on
the port's ``TorchExecutor`` with ``device="cpu"`` at reduced size, for each
ported family's serving arch (InternLM2, RWKV6, Hymba): zero cell builds after
warmup, bucket and quota snapping, quota as serialized
passes, and an unchanged schedule digest with the executor attached.  The
control-plane test drives the reference's and the port's copies of the
ESG scheduler and emulator through the same scenarios and compares their
schedule digests.
"""
from __future__ import annotations

import json

import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS


ARCHS = ["internlm2_1_8b", "rwkv6_1_6b", "hymba_1_5b"]


@pytest.fixture(scope="module", params=ARCHS)
def executor(request):
    from repro_torch.serving.executor import TorchExecutor
    ex = TorchExecutor(request.param, batch_lattice=(1, 2),
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
    # rounds of full and half interleaved, floor of each: a burst of load
    # on a shared host then cannot land on one quota's reps alone
    rounds = [(executor.measure(1, 1.0, reps=3).wall_ms,
               executor.measure(1, 0.5, reps=3).wall_ms) for _ in range(3)]
    full = min(f for f, _ in rounds)
    half = min(h for _, h in rounds)
    # a half-quota cell runs 2 serialized passes: counted exactly, and
    # strictly slower on the wall clock (loosely ~2x)
    assert executor.prefill_passes - passes == 3 * (3 * 1 + 3 * 2)
    assert executor.decode_steps - steps == 3 * 9 * executor.gen_len
    assert half > full * 1.2


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


def test_profile_kernels_smoke_lattice(tmp_path):
    """``--smoke``, as the reference's flag: batches (1, 2), quota 1.0 and
    one rep, whatever the lattice flags say."""
    from repro_torch.launch.profile_kernels import main
    out = tmp_path / "profile.json"
    art = main(["--reduced", "--device", "cpu", "--smoke", "--batches",
                "4", "8", "--reps", "3", "--out", str(out)])
    assert json.loads(out.read_text()) == art
    assert art["schema"] == "repro.measured_profile.v1"
    assert art["batch_lattice"] == [1, 2] and art["quota_lattice"] == [1.0]
    assert [(c["batch"], c["quota"], c["reps"]) for c in art["cells"]] == [
        (1, 1.0, 1), (2, 1.0, 1)]
    assert all(c["e2e_ms"] > 0 for c in art["cells"])
    assert art["quota_check"]["measured_exponent"] is None   # no q < 1
    assert art["roofline"] == []                             # no card


def test_executor_defaults_to_cuda():
    from repro_torch.serving.executor import TorchExecutor
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchExecutor()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_real_on_cpu_end_to_end(tmp_path, arch):
    from repro_torch.launch.serve import serve_real
    out = tmp_path / "bench.json"
    bench = serve_real(arch=arch, n_requests=8, gen_len=2, prompt_len=8,
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
    assert bench["backend"] == "cpu" and bench["arch"] == arch


def test_serve_cli_refuses_emulate_mode():
    """Emulate mode is the CLI's default now; it still refuses a mode it
    cannot run, as the reference's does: calibration needs ESG."""
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="requires the ESG scheduler"):
        main(["--scheduler", "infless", "--calibrate", "--n", "4"])


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
    """Same model arithmetic as the reference at its 16-wide model axis;
    only the peaks differ."""
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
        assert rl.analytic_memory_bytes(cfg, shape, 1, model_axis=16) == \
            ref_rl.analytic_memory_bytes(ref_cfg("internlm2_1_8b"),
                                         ref_shape, 1)
        t = rl.roofline(cfg, shape, rl.model_flops(cfg, shape), 0.0, 0.0, 1,
                        peaks, model_axis=1)
        assert t.compute_s == pytest.approx(rl.model_flops(cfg, shape)
                                            / 989e12)
    # decode at batch 8 reads every weight once: bound by bytes
    assert t.dominant == "memory"


def _state_terms(cfg, shape, n_chips, model_axis=16):
    """The prefill state the port charges and the KV write the reference
    charges the ssm family in its place (bytes)."""
    b_loc = max(shape.global_batch / min(n_chips, model_axis), 1)
    l = cfg.n_layers
    if cfg.family == "ssm":
        state = b_loc * cfg.n_heads * cfg.d_head * cfg.d_head * 4 * l
        ref_cache = b_loc * shape.seq_len * 2 * cfg.n_kv_heads * \
            cfg.d_head * 2 * l / n_chips * model_axis
        return state, ref_cache
    if cfg.family == "hybrid":
        return b_loc * cfg.d_model * cfg.ssm_state * 4 * l, 0.0
    return 0.0, 0.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_at_a_16_wide_model_axis_is_the_reference(arch):
    """Every kind of every arch at 1, 16 and 256 chips: the reference's
    bytes exactly, but for the prefill state the port adds (ssm: the WKV
    state in place of the reference's KV write; hybrid: the SSM state)."""
    from repro.configs.registry import SHAPES as REF_SHAPES
    from repro.configs.registry import get_config as ref_cfg
    from repro.launch import roofline as ref_rl
    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.launch import roofline as rl
    cfg = get_config(arch)
    kinds = set()
    for name, shape in SHAPES.items():
        kinds.add(shape.kind)
        for n_chips in (1, 16, 256):
            got = rl.analytic_memory_bytes(cfg, shape, n_chips,
                                           model_axis=16)
            want = ref_rl.analytic_memory_bytes(ref_cfg(arch),
                                                REF_SHAPES[name], n_chips)
            if shape.kind == "prefill":
                state, ref_cache = _state_terms(cfg, shape, n_chips)
                want = want - ref_cache + state
            assert got == pytest.approx(want, rel=1e-12), (name, n_chips)
            if shape.kind != "prefill" or cfg.family not in ("ssm",
                                                             "hybrid"):
                assert got == want, (name, n_chips)
    assert kinds == {"train", "prefill", "decode"}


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b",
                                  "llama4_maverick_400b_a17b"])
def test_roofline_on_one_card_charges_one_kv_write_per_prefill_token(arch):
    """One card (``model_axis=1``): a prefill writes each token's keys and
    values once and runs every MLP and projection activation whole; the
    16-wide axis charges the KV write 16 times."""
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch import roofline as rl
    cfg = get_config(arch)
    b, s = 8, 128
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    f_act = f * cfg.top_k if cfg.n_experts else f
    kv_write = b * s * 2 * cfg.n_kv_heads * cfg.d_head * 2 * l
    acts = b * s * (8 * d + 3 * f_act + 4 * cfg.n_kv_heads * cfg.d_head) \
        * 2 * l
    shape = ShapeSpec("x", s, b, "prefill")
    one = rl.analytic_memory_bytes(cfg, shape, 1, model_axis=1)
    assert one == pytest.approx(cfg.n_params * 2.0 + acts + kv_write)
    wide = rl.analytic_memory_bytes(cfg, shape, 1, model_axis=16)
    acts16 = b * s * (8 * d + 3 * f_act / 16
                      + 4 * cfg.n_kv_heads * cfg.d_head) * 2 * l
    assert wide == pytest.approx(cfg.n_params * 2.0 + acts16
                                 + 16 * kv_write)


def test_roofline_charges_hybrid_prefill_its_ssm_state():
    """Hymba's prefill writes its KV cache and, per layer, the SSM
    branch's fp32 state (B, d_inner = d_model, N); the state does not grow
    with the prompt."""
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch import roofline as rl
    cfg = get_config("hymba_1_5b")
    b, s = 8, 128
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    acts = b * s * (8 * d + 3 * f + 4 * cfg.n_kv_heads * cfg.d_head) * 2 * l
    kv_write = b * s * 2 * cfg.n_kv_heads * cfg.d_head * 2 * l
    state = b * d * cfg.ssm_state * 4 * l
    got = rl.analytic_memory_bytes(cfg, ShapeSpec("x", s, b, "prefill"), 1,
                                   model_axis=1)
    assert got == pytest.approx(cfg.n_params * 2.0 + acts + kv_write + state)
    longer = rl.analytic_memory_bytes(cfg, ShapeSpec("x", 2 * s, b,
                                                     "prefill"), 1,
                                      model_axis=1)
    assert longer - got == pytest.approx(acts + kv_write)


def test_roofline_charges_rwkv6_prefill_its_state_not_a_kv_cache():
    """An ssm prefill writes each layer's fp32 WKV state (B, H, K, V); the
    dense branch keeps the reference's KV-cache term."""
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch import roofline as rl
    cfg = get_config("rwkv6_1_6b")
    b, s = 8, 128
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    acts = b * s * (8 * d + 3 * f + 4 * cfg.n_kv_heads * cfg.d_head) \
        * 2 * l
    state = b * cfg.n_heads * cfg.d_head * cfg.d_head * 4 * l
    got = rl.analytic_memory_bytes(cfg, ShapeSpec("x", s, b, "prefill"), 1,
                                   model_axis=1)
    assert got == pytest.approx(cfg.n_params * 2.0 + acts + state)
    # the state does not grow with the prompt
    longer = rl.analytic_memory_bytes(cfg, ShapeSpec("x", 2 * s, b,
                                                     "prefill"), 1,
                                      model_axis=1)
    assert longer - got == pytest.approx(acts)


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
