"""Function profiles + the configuration lattice.

A *configuration* is (batch, vcpu, vgpu) — exactly the paper's 3-D space
(§1: the space grows from m^k to (m^k)^3 with sharable GPUs).  The default
lattice has 8 x 4 x 8 = 256 configurations per function, matching the
paper's overhead experiments ("each function has 256 configurations").

Profiles come from two sources:
  * the paper's Table 3 (six DNN image functions) via an analytical
    latency model calibrated to the measured minimum-config times;
  * the TPU model zoo, where the latency model is fed by roofline terms
    from the dry-run's ``cost_analysis`` (see repro/cluster/tpu_profiles.py).

The latency model satisfies the paper's qualitative structure:
  increasing in batch, decreasing in vcpu/vgpu, per-job time decreasing in
  batch (throughput), per-job cost decreasing in batch — producing the
  speed-cost tension the scheduler navigates.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Iterable, Optional

import numpy as np

from repro_torch.gpu.footprints import PAPER_MODEL_MB

# Pricing (paper §4.1, following AWS EC2):
VCPU_PRICE_PER_H = 0.034
VGPU_PRICE_PER_H = 0.67

# Fractional-quota slowdown exponent: a container whose compute quota is
# throttled to ``q`` vGPUs (q may be fractional, resized while running)
# sees its GPU part scale by (vgpu/q)^QUOTA_SLOWDOWN_EXP — slightly
# sub-linear because kernel launch gaps absorb part of the throttling
# (HAS-GPU reports near-linear throughput in the SM quota).
QUOTA_SLOWDOWN_EXP = 0.9

BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
VCPUS = (1, 2, 4, 8)
VGPUS = (1, 2, 3, 4, 5, 6, 7, 8)


@dataclasses.dataclass(frozen=True)
class Config:
    batch: int
    vcpu: int
    vgpu: int


@dataclasses.dataclass(frozen=True)
class FunctionProfile:
    """Per-function performance profile over the config lattice."""
    name: str
    t1_ms: float                 # exec time at (batch=1, 1 vCPU, 1 vGPU)
    cold_ms: float               # cold-start time
    input_mb: float              # stage input size (data-transfer model)
    cpu_frac: float = 0.2        # fraction of t1 spent on the CPU part
    model_mb: float = 0.0        # weight-checkpoint HBM footprint
    # intermediate-state checkpoint a preempted task can resume from
    # (0 => no checkpointing: a spot reclamation re-runs from scratch)
    checkpoint_mb: float = 0.0
    # where the numbers came from: "zoo" (hand-entered / analytical) or
    # "measured" (timed real-kernel execution, see launch/profile_kernels)
    # — threaded through Telemetry.summary() and the planner audit log so
    # every export names its latency ground truth
    provenance: str = "zoo"

    def quota_factor(self, c: Config, quota_vgpu: Optional[float]) -> float:
        """GPU-part slowdown when the running container's compute quota
        is ``quota_vgpu`` (fractional vGPUs) instead of the ``c.vgpu``
        it was configured for.  >1 when throttled below the config,
        <1 when granted surplus slices (vertical scale-up)."""
        if quota_vgpu is None or quota_vgpu == c.vgpu:
            return 1.0
        return (c.vgpu / max(quota_vgpu, 1e-9)) ** QUOTA_SLOWDOWN_EXP

    def exec_ms(self, c: Config,
                quota_vgpu: Optional[float] = None) -> float:
        """Deterministic latency model (noise added by the emulator).

        Multi-accelerator tasks both data-parallelise the batch
        (ceil(b/g) per unit) and tensor-parallelise each inference
        (g^-0.2 — the TPU-substrate adaptation: a pjit sub-mesh speeds up a
        single inference, unlike MIG; see DESIGN §2).  Efficiency loss from
        collectives is folded into the sub-linear exponents.

        ``quota_vgpu`` (fractional) overrides the *delivered* compute
        share when a running pool has been vertically resized away from
        its configured ``c.vgpu``."""
        t_serial = 0.05 * self.t1_ms                 # launch/framework floor
        t_cpu = self.cpu_frac * self.t1_ms
        t_gpu = (0.95 - self.cpu_frac) * self.t1_ms
        per_gpu_batch = int(np.ceil(c.batch / c.vgpu))
        cpu_part = t_cpu * (c.batch ** 0.2) / (c.vcpu ** 0.7)
        gpu_part = t_gpu * (per_gpu_batch ** 0.85) * (c.vgpu ** -0.12)
        gpu_part *= self.quota_factor(c, quota_vgpu)
        return t_serial + cpu_part + gpu_part

    def cost(self, c: Config) -> float:
        """$ for the whole task (batch of jobs) at config c."""
        rate = c.vcpu * VCPU_PRICE_PER_H + c.vgpu * VGPU_PRICE_PER_H
        return rate * self.exec_ms(c) / 3.6e6

    def job_cost(self, c: Config) -> float:
        return self.cost(c) / c.batch


@dataclasses.dataclass(frozen=True)
class MeasuredFunctionProfile(FunctionProfile):
    """Profile backed by a measured (batch, quota) latency lattice.

    ``lattice`` holds ``(batch, quota, exec_ms)`` triples timed on real
    kernel execution (``launch/profile_kernels.py``).  ``exec_ms``
    answers from the lattice instead of the analytical model: the batch
    rounds *up* to the nearest measured bucket — coherent with the
    real-compute executor, which pads dispatched batches to the same
    buckets so each (arch, stage, bucket, quota) cell compiles exactly
    once — and an unmeasured quota falls back to the measured full-quota
    cell scaled by the analytical ``quota_factor``.
    """
    lattice: tuple = ()          # ((batch, quota, exec_ms), ...)
    provenance: str = "measured"

    def __post_init__(self):
        cells = {(int(b), float(q)): float(ms) for b, q, ms in self.lattice}
        object.__setattr__(self, "_cells", cells)
        object.__setattr__(self, "_buckets",
                           tuple(sorted({b for b, _ in cells})))

    def _bucket(self, batch: int) -> int:
        for b in self._buckets:
            if batch <= b:
                return b
        return self._buckets[-1]

    def exec_ms(self, c: Config,
                quota_vgpu: Optional[float] = None) -> float:
        if not self._buckets:
            return super().exec_ms(c, quota_vgpu)
        bucket = self._bucket(c.batch)
        # waves beyond the largest measured bucket run back to back
        waves = int(np.ceil(c.batch / bucket)) if c.batch > bucket else 1
        q = (quota_vgpu / c.vgpu) if quota_vgpu is not None else 1.0
        ms = self._cells.get((bucket, round(q, 6)))
        if ms is None:
            base = self._cells.get((bucket, 1.0))
            if base is None:
                return super().exec_ms(c, quota_vgpu)
            ms = base * self.quota_factor(c, quota_vgpu)
        return ms * waves


# ---------------------------------------------------------------------------
# The six paper functions (Table 3)
# ---------------------------------------------------------------------------
_PAPER_T3 = {
    # name: (t1_ms, cold_ms, input_mb)
    "super_resolution": (86.0, 3503.0, 2.7),
    "segmentation": (293.0, 16510.0, 2.5),
    "deblur": (319.0, 22343.0, 1.1),
    "classification": (147.0, 18299.0, 0.147),
    "background_removal": (1047.0, 3729.0, 2.5),
    "depth": (828.0, 16479.0, 0.648),
}
PAPER_FUNCTIONS = {
    name: FunctionProfile(name, t1, cold, mb,
                          model_mb=PAPER_MODEL_MB[name])
    for name, (t1, cold, mb) in _PAPER_T3.items()
}


@dataclasses.dataclass
class ProfileTable:
    """Profiles for one function evaluated over the lattice, sorted by time."""
    fn: FunctionProfile
    configs: list[Config]
    times: np.ndarray            # ms, same order as configs
    job_costs: np.ndarray        # $ per job

    @classmethod
    def build(cls, fn: FunctionProfile,
              batches: Iterable[int] = BATCHES,
              vcpus: Iterable[int] = VCPUS,
              vgpus: Iterable[int] = VGPUS,
              max_batch: int | None = None) -> "ProfileTable":
        cfgs = [Config(b, c, g)
                for b, c, g in itertools.product(batches, vcpus, vgpus)
                if max_batch is None or b <= max_batch]
        times = np.array([fn.exec_ms(c) for c in cfgs])
        costs = np.array([fn.job_cost(c) for c in cfgs])
        order = np.argsort(times, kind="stable")
        return cls(fn,
                   [cfgs[i] for i in order],
                   times[order],
                   costs[order])

    @classmethod
    def from_measured(cls, artifact: dict) -> "ProfileTable":
        """Build a table from a measured-profile JSON artifact
        (``launch/profile_kernels.py`` schema ``repro.measured_profile.v1``).

        The config lattice is the measured batch lattice at (vcpu=1,
        vgpu=1) — the single-host serving shape the artifact was timed
        on; fractional quotas live on the profile's quota axis and are
        reached through ``exec_ms(c, quota_vgpu=...)``, mirroring how
        the emulator delivers vertical resizes."""
        cells = artifact["cells"]
        lattice = tuple((c["batch"], c["quota"], c["e2e_ms"])
                        for c in cells)
        full = {c["batch"]: c["e2e_ms"] for c in cells
                if c["quota"] == 1.0}
        if not full:
            raise ValueError("measured artifact has no quota=1.0 cells")
        fn = MeasuredFunctionProfile(
            name=artifact["arch"],
            t1_ms=full[min(full)],
            cold_ms=float(artifact.get("cold_ms", 0.0)),
            input_mb=float(artifact.get("input_mb", 0.01)),
            model_mb=float(artifact.get("model_mb", 0.0)),
            lattice=lattice)
        return cls.build(fn, batches=tuple(sorted(full)), vcpus=(1,),
                         vgpus=(1,))

    def restrict_batch(self, max_batch: int) -> "ProfileTable":
        keep = [i for i, c in enumerate(self.configs) if c.batch <= max_batch]
        return ProfileTable(self.fn,
                            [self.configs[i] for i in keep],
                            self.times[keep], self.job_costs[keep])

    def pareto(self) -> "ProfileTable":
        """(time, job_cost)-Pareto-optimal configs only.

        Beyond-paper optimisation: a dominated config can never appear in the
        cheapest feasible path (swap it for its dominator), so top-1 quality
        is preserved; ranks 2..K may differ (tests cover both modes)."""
        best = np.inf
        keep = []
        for i in range(len(self.configs)):      # already sorted by time
            if self.job_costs[i] < best - 1e-18:
                best = self.job_costs[i]
                keep.append(i)
        return ProfileTable(self.fn,
                            [self.configs[i] for i in keep],
                            self.times[keep], self.job_costs[keep])

    # -- cached per-config arrays (computed once; the table is immutable
    # after build, so these never go stale) ---------------------------------
    @functools.cached_property
    def rates(self) -> np.ndarray:
        """$-rate per config, aligned with ``times``/``job_costs``."""
        return np.array([c.vcpu * VCPU_PRICE_PER_H +
                         c.vgpu * VGPU_PRICE_PER_H for c in self.configs])

    @functools.cached_property
    def batch_sizes(self) -> np.ndarray:
        """Per-config batch size as floats, aligned with ``configs``."""
        return np.array([c.batch for c in self.configs], dtype=float)

    @functools.cached_property
    def batch_lattice(self) -> tuple[int, ...]:
        """Distinct batch sizes present, ascending — ``restrict_batch(n)``
        yields the same table for every ``n`` inside one lattice step, so
        callers can quantize batch caps to these buckets losslessly."""
        return tuple(sorted({c.batch for c in self.configs}))

    def priced_arrays(self, penalty_ms: float = 0.0
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(times, job_costs) with a start penalty priced in — the array
        form of ``with_penalty`` (no per-config Python objects, no new
        table).  Zero penalty returns the table's own arrays."""
        if penalty_ms <= 0.0:
            return self.times, self.job_costs
        return (self.times + penalty_ms,
                self.job_costs + self.rates * penalty_ms / 3.6e6
                / self.batch_sizes)

    def scaled(self, factor: float) -> "ProfileTable":
        """Multiplicative exec-time rescale — the online calibrator's
        priced-arrays-compatible hook (``repro.obs.calibrate``).  Every
        config's latency scales by ``factor`` and so does its per-job
        cost (billed cost is $-rate x exec time, so cost honestly
        tracks the corrected runtime).  A positive factor preserves the
        time sort order and the job-cost argmin, so ESG_1Q's dual-blade
        pruning, ``pareto()`` filtering and the dominator split all
        operate on the corrected table unchanged.  Factor 1.0 returns
        ``self`` — the uncalibrated fast path stays allocation-free."""
        if factor == 1.0:
            return self
        if factor <= 0.0:
            raise ValueError(f"scale factor must be positive, got {factor}")
        return ProfileTable(self.fn, list(self.configs),
                            self.times * factor, self.job_costs * factor)

    def preempt_priced(self, exec_factor: float = 1.0,
                       risk_per_ms: float = 0.0) -> "ProfileTable":
        """Price a heterogeneous/preemptible fleet into both blades.

        ``exec_factor`` is the fleet's mean exec-time multiplier (the
        slice-weighted inverse of the SKU exec rates — >1 on a fleet
        slower than the profiled baseline).  ``risk_per_ms`` is the
        expected preemption-loss coefficient: a task running for T ms
        on spot capacity expects ~``risk_per_ms * T`` reclamations'
        worth of rework, so its effective latency inflates by
        ``(1 + risk_per_ms * T)`` — longer configs are penalised
        superlinearly, which is exactly the pressure that steers the
        planner toward shorter stages under reclamation risk.  Cost
        inflates identically (rework is billed again).  Both transforms
        are monotone in T, so the time sort order and dual-blade
        pruning survive.  Neutral arguments return ``self``."""
        if exec_factor <= 0.0 or risk_per_ms < 0.0:
            raise ValueError(
                f"bad preemption pricing ({exec_factor}, {risk_per_ms})")
        if exec_factor == 1.0 and risk_per_ms == 0.0:
            return self
        times = self.times * exec_factor
        inflate = 1.0 + risk_per_ms * times
        return ProfileTable(self.fn, list(self.configs), times * inflate,
                            self.job_costs * exec_factor * inflate)

    def with_penalty(self, penalty_ms: float) -> "ProfileTable":
        """Price a per-stage start penalty (a Torpor-style weight swap-in
        the placement is predicted to pay) into both A* blades: every
        config's latency shifts by ``penalty_ms`` (sort order preserved)
        and its per-job cost absorbs the penalty window billed at that
        config's $-rate — so dual-blade pruning compares true latencies
        and true costs, not profile-only ones."""
        if penalty_ms <= 0.0:
            return self
        times, costs = self.priced_arrays(penalty_ms)
        return ProfileTable(self.fn, list(self.configs), times, costs)

    @property
    def min_time(self) -> float:
        return float(self.times[0])

    @property
    def min_job_cost(self) -> float:
        return float(self.job_costs.min())

    @property
    def fastest_cost(self) -> float:
        """Job cost when running the fastest config (for rscFastest)."""
        return float(self.job_costs[0])

    def mean_time(self) -> float:
        return float(self.times.mean())
