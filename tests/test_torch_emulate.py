"""The port's emulate mode against the reference's, on the CPU.

Emulate mode runs on the host only: the paper's controller (ESG or one of
four baselines) schedules the zoo's LM pipelines over an emulated cluster
whose latencies come from analytic profiles.  The port's profiles are the
reference's TPU model term for term with the card's peaks; built with the
TPU v5e peaks instead (from the reference's ``launch/roofline.py``) they
must equal the reference's profiles (rel 1e-12), and emulate must then give
the reference's summaries exactly.

Both packages charge the planner's measured wall time into simulated time
by default; the parity runs turn that off (``count_overhead=False``) on
both sides and leave out the two wall-clock overhead statistics.  Orion
stops its plan search after 100 ms of wall time, so its plans depend on
the host's speed and load; both sides' Orion read a clock that advances
0.1 ms a reading instead, which makes its search the same on any host.
"""
from __future__ import annotations

import functools
import json

import pytest

import repro.launch.serve as ref_serve
from repro.cluster.emulator import ClusterSim as RefClusterSim
from repro.cluster.tpu_profiles import TPUFunctionProfile
from repro.configs.registry import get_config as ref_get_config
from repro.launch.roofline import HBM_BW, ICI_BW, PEAK_FLOPS
from repro_torch.cluster import gpu_profiles
from repro_torch.cluster.emulator import ClusterSim
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.profiles import BATCHES, VCPUS, VGPUS, Config
from repro_torch.launch import serve
from repro_torch.launch.roofline import DevicePeaks

V5E = DevicePeaks("TPU v5e", PEAK_FLOPS, HBM_BW, ICI_BW, 0.0, 16e9)
WALL_CLOCK_KEYS = {"mean_sched_overhead_ms", "p95_sched_overhead_ms"}
QUIET = dict(log=lambda *_: None)


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class _TickClock:
    """``perf_counter`` that advances a fixed step a reading."""

    def __init__(self, step_s: float = 1e-4):
        self.t, self.step_s = 0.0, step_s

    def perf_counter(self) -> float:
        self.t += self.step_s
        return self.t


@pytest.fixture(autouse=True)
def no_dryrun_records(tmp_path, monkeypatch):
    """The port's overhead calibration reads an empty directory, as the
    reference's (``benchmarks/results/dryrun/``) is absent in this tree:
    parity holds whatever dry-run records a local run has written."""
    monkeypatch.setattr(gpu_profiles, "DRYRUN_DIR", tmp_path / "dryrun")


@pytest.fixture
def v5e_emulate(monkeypatch):
    """Both emulators without wall time in simulated time or in Orion's
    search; the port's zoo tables built from the v5e peaks."""
    import repro.core.baselines.orion as ref_orion
    import repro_torch.core.baselines.orion as orion
    monkeypatch.setattr(ref_orion, "_walltime", _TickClock())
    monkeypatch.setattr(orion, "_walltime", _TickClock())
    monkeypatch.setattr(ref_serve, "ClusterSim",
                        functools.partial(RefClusterSim,
                                          count_overhead=False))
    monkeypatch.setattr(serve, "ClusterSim",
                        functools.partial(ClusterSim, count_overhead=False))
    monkeypatch.setattr(serve, "zoo_tables",
                        lambda: gpu_profiles.zoo_tables(peaks=V5E))


# ---- profiles -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_profile_with_v5e_peaks_equals_the_tpu_profile(arch):
    ref = TPUFunctionProfile(ref_get_config(arch))
    port = gpu_profiles.GPUFunctionProfile(get_config(arch), peaks=V5E)
    assert port.t1_ms == pytest.approx(ref.t1_ms, rel=1e-12)
    assert port.model_mb == pytest.approx(ref.model_mb, rel=1e-12)
    for b in BATCHES:
        for c in VCPUS:
            for g in VGPUS:
                cfg = Config(b, c, g)
                assert port.exec_ms(cfg) == pytest.approx(
                    ref.exec_ms(cfg), rel=1e-12)
                assert port.exec_ms(cfg, quota_vgpu=0.5 * g) == \
                    pytest.approx(ref.exec_ms(cfg, quota_vgpu=0.5 * g),
                                  rel=1e-12)


def test_h100_tables_cover_the_zoo_and_are_faster_than_v5e():
    tables = gpu_profiles.zoo_tables()
    assert set(tables) == set(ARCH_IDS)
    for arch, t in tables.items():
        fn = t.fn
        assert fn.provenance == "zoo" and fn._peaks.name == "H100 SXM"
        assert t.min_time > 0
        assert all(a <= b for a, b in zip(t.times, t.times[1:]))
        slow = gpu_profiles.GPUFunctionProfile(get_config(arch), peaks=V5E)
        assert fn.t1_ms < slow.t1_ms
    # chips speed one inference up; batches take longer in total, less
    # per job (the reference's test_tpu_profile_monotonicity)
    fp = gpu_profiles.GPUFunctionProfile(get_config("internlm2_20b"),
                                         overhead=1.5)
    t1 = fp.exec_ms(Config(1, 1, 1))
    assert fp.exec_ms(Config(1, 1, 8)) < t1 < fp.exec_ms(Config(8, 1, 1))
    assert fp.exec_ms(Config(8, 1, 1)) / 8 < t1


# ---- emulate ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"scheduler": "esg"}, {"scheduler": "infless"},
    {"scheduler": "fastgshare"}, {"scheduler": "orion"},
    {"scheduler": "aquatope"},
    {"scheduler": "esg", "scenario": "mmpp", "autoscaler": "ewma"},
], ids=lambda kw: "-".join(kw.values()))
def test_emulate_matches_reference(v5e_emulate, kw):
    ref = _flat(ref_serve.emulate(setting="relaxed-heavy", n=60, **kw,
                                  **QUIET))
    port = _flat(serve.emulate(setting="relaxed-heavy", n=60, **kw,
                               **QUIET))
    assert set(port) == set(ref)
    assert {k: port[k] for k in port if k not in WALL_CLOCK_KEYS} == \
        {k: ref[k] for k in ref if k not in WALL_CLOCK_KEYS}
    assert port["completed"] + port["shed"] == 60


def test_emulate_on_h100_profiles_serves_every_request():
    s = serve.emulate(setting="relaxed-heavy", n=60, **QUIET)
    assert s["completed"] == 60
    assert 0.5 < s["slo_hit_rate"] <= 1.0


def test_emulate_exports_pass_the_validator(tmp_path):
    from repro_torch.obs import validate
    paths = {k: str(tmp_path / name) for k, name in (
        ("trace_out", "trace.json"), ("metrics_out", "metrics.json"),
        ("audit_out", "audit.jsonl"), ("health_out", "health.jsonl"))}
    s = serve.emulate(setting="moderate-normal", n=40, scenario="mmpp",
                      autoscaler="ewma", calibrate=True, **paths, **QUIET)
    assert s["injected"] == 40
    assert validate.main(list(paths.values())) == 0
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


def test_cli_defaults_to_emulate(capsys):
    s = serve.main(["--n", "40"])
    assert s["completed"] + s["shed"] == 40
    assert "[serve-emulate] ESG" in capsys.readouterr().out


# ---- the sharded replay -------------------------------------------------

def _unsharded_digest(cfg) -> str:
    """The legacy path: one ClusterSim over the paper's apps."""
    from repro_torch.cluster import shard
    from repro_torch.core.profiles import PAPER_FUNCTIONS
    from repro_torch.core.scheduler import ESGScheduler
    from repro_torch.core.workflows import PAPER_APPS
    from repro_torch.serving import Gateway, get_autoscaler, get_scenario
    tables = shard.paper_tables()
    sched = ESGScheduler(dict(PAPER_APPS), tables, plan_cache=True,
                         vectorized=True)
    sim = ClusterSim(dict(PAPER_APPS), tables, PAPER_FUNCTIONS, sched,
                     n_invokers=cfg.n_invokers, noise_sigma=cfg.noise_sigma,
                     seed=cfg.seed, count_overhead=False,
                     autoscaler=get_autoscaler("ewma"), sparse=True,
                     retain="full", track_digest=True)
    gw = Gateway(sim)
    gw.inject(get_scenario(cfg.scenario, app_names=list(PAPER_APPS)), cfg.n,
              seed=cfg.seed + 1, slo_mult=cfg.slo_mult)
    sim.run()
    return sim.run_digest()


@pytest.mark.parametrize("scenario", ["mmpp", "azure-tail"])
def test_sharded_replay_digest_matches_unsharded_and_reference(scenario):
    from repro.cluster import shard as ref_shard
    from repro_torch.cluster import shard
    kw = dict(scenario=scenario, n=300, seed=7)
    cfg = shard.ReplayConfig(**kw)
    one = shard.run_shard(cfg, 0, 1)
    ref = ref_shard.run_shard(ref_shard.ReplayConfig(**kw), 0, 1)
    assert one.digest == _unsharded_digest(cfg) == ref.digest is not None
    assert one.summary["completed"] == ref.summary["completed"]
    two = shard.run_sharded(cfg, 2, workers=1)
    ref_two = ref_shard.run_sharded(ref_shard.ReplayConfig(**kw), 2,
                                    workers=1)
    assert two["digest"] == ref_two["digest"]
    assert two["completed"] == ref_two["completed"]
