"""Serving telemetry: per-stage latency histograms, SLO attainment, cost,
utilization, GPU device-model metrics (slices, HBM, swap tiers), shed
precision, cold-start and shed counters.

``Telemetry`` is fed from two sides:
  * the gateway increments injection/admission/shed counters online (shed
    decisions are logged with budget + prediction for precision scoring);
  * after (or during) a run, ``collect(sim)`` derives per-stage queue/exec
    histograms, per-app SLO attainment, utilization, cost, the aggregated
    device-model counters (hot/warm hits, swap-ins, demotions, vertical
    resizes, HBM peak) and shed precision from the emulator's logs.

Shed precision: each shed is scored retrospectively — *true* if the
request was provably doomed (budget below the empty-cluster fastest
path) or the completed same-app request arriving nearest in time missed
that budget too; *false* if that neighbour made it; *unknown* when no
completed neighbour exists to compare against.

``summary()`` returns the structured dict the benchmarks consume;
``format_table(rows)`` renders a list of such dicts as the human-readable
sweep table.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Any, Optional

import numpy as np

from repro_torch.gpu import SLICES_PER_VGPU


class LatencyHistogram:
    """Log-bucketed latency histogram (0.01 ms .. ~28 h, 8 buckets/decade).

    Exact values are not retained; percentiles interpolate inside the
    matched bucket, which is plenty for serving dashboards and keeps the
    memory footprint O(1) in trace length.
    """

    def __init__(self, lo_ms: float = 1e-2, hi_ms: float = 1e8,
                 buckets_per_decade: int = 8):
        n = int(np.ceil(np.log10(hi_ms / lo_ms) * buckets_per_decade)) + 1
        self.bounds = lo_ms * 10 ** (np.arange(n) / buckets_per_decade)
        self.counts = np.zeros(n + 1, dtype=np.int64)
        self.total = 0.0
        self.n = 0
        self.max_ms = 0.0
        self._cum: Optional[np.ndarray] = None   # cumsum cache

    def record(self, ms: float):
        idx = int(np.searchsorted(self.bounds, ms, side="right"))
        self.counts[idx] += 1
        self.total += ms
        self.n += 1
        self.max_ms = max(self.max_ms, ms)
        self._cum = None

    def record_many(self, values) -> None:
        """Vectorized ``record`` over an array of samples: one
        searchsorted + bincount instead of a Python loop per sample
        (bucket counts come out identical; ``total`` may differ from the
        loop in the last ulp since the sum is reassociated)."""
        a = np.asarray(values, dtype=np.float64)
        if a.size == 0:
            return
        idx = np.searchsorted(self.bounds, a, side="right")
        self.counts += np.bincount(idx, minlength=self.counts.size)
        self.total += float(a.sum())
        self.n += int(a.size)
        self.max_ms = max(self.max_ms, float(a.max()))
        self._cum = None

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into this histogram in place (sharded-emulator
        aggregation): the result is exactly what recording the union of
        both sample streams would have produced.  Bucket layouts must
        match."""
        if self.bounds.shape != other.bounds.shape or \
                not np.array_equal(self.bounds, other.bounds):
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        self.counts += other.counts
        self.total += other.total
        self.n += other.n
        self.max_ms = max(self.max_ms, other.max_ms)
        self._cum = None
        return self

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def _cumsum(self) -> np.ndarray:
        # O(1) amortised across repeated percentile() calls (to_dict
        # alone takes three); invalidated by record()/merge()
        if self._cum is None:
            self._cum = np.cumsum(self.counts)
        return self._cum

    def percentile(self, p: float) -> float:
        """p in [0, 100]; linear interpolation within the hit bucket."""
        if not self.n:
            return 0.0
        rank = p / 100.0 * self.n
        cum = self._cumsum()
        idx = int(np.searchsorted(cum, rank, side="left"))
        idx = min(idx, len(self.counts) - 1)
        lo = self.bounds[idx - 1] if idx > 0 else 0.0
        hi = self.bounds[idx] if idx < len(self.bounds) else self.max_ms
        prev = cum[idx - 1] if idx > 0 else 0
        frac = (rank - prev) / max(self.counts[idx], 1)
        return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))

    def to_dict(self) -> dict[str, float]:
        return {"n": int(self.n), "mean_ms": self.mean,
                "p50_ms": self.percentile(50), "p95_ms": self.percentile(95),
                "p99_ms": self.percentile(99), "max_ms": self.max_ms}


@dataclasses.dataclass
class ShedRecord:
    """One load-shedding decision, kept for precision scoring."""
    t_ms: float
    app: str
    budget_ms: float
    need_ms: float               # fastest + predicted queueing at decision
    fastest_ms: float            # empty-cluster critical path


@dataclasses.dataclass
class StageStats:
    queue: LatencyHistogram = dataclasses.field(default_factory=LatencyHistogram)
    exec: LatencyHistogram = dataclasses.field(default_factory=LatencyHistogram)
    jobs: int = 0
    tasks: int = 0
    cold: int = 0


class Telemetry:
    """Aggregated serving metrics for one run."""

    def __init__(self):
        self.injected: dict[str, int] = defaultdict(int)
        self.admitted: dict[str, int] = defaultdict(int)
        self.shed: dict[str, int] = defaultdict(int)
        self.stage: dict[tuple[str, str], StageStats] = defaultdict(StageStats)
        self.e2e = LatencyHistogram()
        self.slo_hits = 0
        self.completed = 0
        self.cold_starts = 0
        self.total_cost = 0.0
        self.gpu_busy_ms = 0.0
        self.gpu_capacity_ms = 0.0
        self.horizon_ms = 0.0
        self.scheduler = ""
        self.autoscaler = ""
        self.scenario = ""
        self.gpu: dict[str, Any] = {}
        self.fastest_ms: dict[str, float] = {}   # set by the gateway
        self.shed_records: list[ShedRecord] = []
        self.shed_true = 0
        self.shed_false = 0
        self.shed_unknown = 0
        # planner-audit calibration (predicted vs realized per-stage
        # latency error quantiles, each block carrying its sample count
        # ``n`` — quantiles are None below 2 samples), filled by
        # collect() when the sim carries an enabled flight recorder
        # with an audit log
        self.predicted_vs_realized: dict[str, Any] = {}
        # online-calibrator factor state (repro.obs.calibrate) and SLO
        # health-engine alert summary (repro.obs.health), when attached
        self.calibration: dict[str, Any] = {}
        self.health: dict[str, Any] = {}
        # per-function profile provenance ("zoo" analytic tables vs
        # "measured" real-kernel artifacts) — surfaces which numbers
        # the planner trusted for each function this run
        self.profile_provenance: dict[str, str] = {}

    # ---- gateway-side ------------------------------------------------------
    def on_injected(self, app: str):
        self.injected[app] += 1

    def on_admitted(self, app: str):
        self.admitted[app] += 1

    def on_shed(self, app: str, t_ms: Optional[float] = None,
                budget_ms: Optional[float] = None,
                need_ms: Optional[float] = None,
                fastest_ms: Optional[float] = None):
        self.shed[app] += 1
        if budget_ms is not None:
            self.shed_records.append(ShedRecord(
                t_ms or 0.0, app, budget_ms, need_ms or 0.0,
                fastest_ms or 0.0))

    # ---- streaming collection (retain="stream" sims) -----------------------
    def attach_stream(self, sim) -> "Telemetry":
        """Subscribe to a ``retain="stream"`` ClusterSim: per-stage and
        end-to-end metrics accumulate online at task retirement /
        request completion, because a streaming sim does not keep the
        object lists ``collect`` would otherwise scan.  The hooks fire
        before the sim recycles tasks/jobs through its pools, so the
        records they read are still intact."""
        self._done_by_app: dict[str, tuple[list, list]] = {}
        sim.on_task_retire = self._on_task_retire
        sim.on_request_done = self._on_request_done
        return self

    def _on_task_retire(self, task) -> None:
        st = self.stage[(task.jobs[0].inst.app.name, task.stage)]
        st.tasks += 1
        st.jobs += len(task.jobs)
        st.cold += int(task.cold)
        st.exec.record(task.end_ms - task.start_ms)
        start = task.start_ms
        for j in task.jobs:
            st.queue.record(max(start - j.ready_ms, 0.0))

    def _on_request_done(self, inst) -> None:
        lat = inst.finish_ms - inst.arrival_ms
        self.e2e.record(lat)
        self.completed += 1
        self.slo_hits += int(lat <= inst.slo_ms)
        # (arrival, latency) per app, for retrospective shed scoring —
        # ~2 floats/request, the only per-request state stream mode keeps
        arr, lats = self._done_by_app.setdefault(inst.app.name, ([], []))
        arr.append(inst.arrival_ms)
        lats.append(lat)

    # ---- post-run collection ----------------------------------------------
    def collect(self, sim) -> "Telemetry":
        """Derive stage/app metrics from a finished (or paused) ClusterSim."""
        self.scheduler = sim.sched.name
        self.autoscaler = getattr(sim.autoscaler, "name", "?")
        self.cold_starts = sim.cold_starts
        self.total_cost = sim.total_cost
        if getattr(sim, "retain", "full") == "stream":
            # stage/e2e metrics already accumulated via attach_stream
            horizon = sim._horizon_ms
        else:
            horizon = max((t.end_ms for t in sim.tasks), default=0.0)
            horizon = max(horizon, max((i.finish_ms for i in sim.completed),
                                       default=0.0))
            for t in sim.tasks:
                key = (t.jobs[0].inst.app.name, t.stage)
                st = self.stage[key]
                st.tasks += 1
                st.jobs += len(t.jobs)
                st.cold += int(t.cold)
                st.exec.record(t.end_ms - t.start_ms)
                for j in t.jobs:
                    st.queue.record(max(t.start_ms - j.ready_ms, 0.0))
            for inst in sim.completed:
                lat = inst.finish_ms - inst.arrival_ms
                self.e2e.record(lat)
                self.completed += 1
                self.slo_hits += int(lat <= inst.slo_ms)
        self.horizon_ms = horizon
        # busy time integrates the *actual* fractional quota over time
        # (vertical resizes included), not the dispatched config
        self.gpu_busy_ms = sim.slice_busy_ms / SLICES_PER_VGPU
        cap = sum(inv.vgpus for inv in sim.invokers)
        self.gpu_capacity_ms = cap * horizon
        self.gpu = sim.gpu_summary()
        self._score_sheds(sim)
        rec = getattr(sim, "recorder", None)
        if rec is not None and getattr(rec, "enabled", False):
            if getattr(rec, "audit", None) is not None:
                self.predicted_vs_realized = rec.calibration()
            health = getattr(rec, "health", None)
            if health is not None:
                self.health = health.summary()
        cal = getattr(sim.sched, "calibrator", None)
        if cal is not None:
            self.calibration = cal.summary()
        self.profile_provenance = {
            n: getattr(p, "provenance", "zoo")
            for n, p in sim.profiles.items()}
        return self

    def _score_sheds(self, sim) -> None:
        """Classify each shed decision as true/false/unknown (see module
        docstring) against the realized latencies of admitted traffic."""
        by_app: dict[str, tuple[list[float], list[float]]] = {}
        if getattr(sim, "retain", "full") == "stream":
            # same (arrival, latency) pairs in the same completion order
            # as sim.completed would hold, so the stable sort yields
            # arrays identical to the full-retention scan below
            for app, (arr, lats) in getattr(self, "_done_by_app",
                                            {}).items():
                order = sorted(range(len(arr)), key=arr.__getitem__)
                by_app[app] = ([arr[i] for i in order],
                               [lats[i] for i in order])
        else:
            for inst in sorted(sim.completed, key=lambda i: i.arrival_ms):
                arr, lat = by_app.setdefault(inst.app.name, ([], []))
                arr.append(inst.arrival_ms)
                lat.append(inst.finish_ms - inst.arrival_ms)
        self.shed_true = self.shed_false = self.shed_unknown = 0
        for rec in self.shed_records:
            if rec.budget_ms < rec.fastest_ms:
                self.shed_true += 1      # provably doomed on an idle cluster
                continue
            arr_lat = by_app.get(rec.app)
            if not arr_lat or not arr_lat[0]:
                self.shed_unknown += 1
                continue
            arr, lat = arr_lat
            i = bisect.bisect_left(arr, rec.t_ms)
            if i > 0 and (i == len(arr) or
                          rec.t_ms - arr[i - 1] <= arr[i] - rec.t_ms):
                i -= 1                   # nearest completed arrival in time
            if lat[i] > rec.budget_ms:
                self.shed_true += 1
            else:
                self.shed_false += 1

    # ---- sharded aggregation ----------------------------------------------
    def merge(self, other: "Telemetry") -> "Telemetry":
        """Fold another shard's telemetry into this one in place.

        Every shard owns a disjoint app population and invoker
        sub-fleet, so counters/costs/busy-time add, histograms merge
        exactly (``LatencyHistogram.merge``), peaks take the max, and
        shed scoring — already exact per shard, since a shed's scoring
        neighbours are same-app completions and an app lives in exactly
        one shard — adds.  Per-shard diagnostic blocks
        (``predicted_vs_realized`` / ``calibration`` / ``health``) are
        not combined; consumers read those from the per-shard exports."""
        for mine, theirs in ((self.injected, other.injected),
                             (self.admitted, other.admitted),
                             (self.shed, other.shed)):
            for app, c in theirs.items():
                mine[app] += c
        for key, st in other.stage.items():
            m = self.stage[key]
            m.queue.merge(st.queue)
            m.exec.merge(st.exec)
            m.jobs += st.jobs
            m.tasks += st.tasks
            m.cold += st.cold
        self.e2e.merge(other.e2e)
        self.slo_hits += other.slo_hits
        self.completed += other.completed
        self.cold_starts += other.cold_starts
        self.total_cost += other.total_cost
        self.gpu_busy_ms += other.gpu_busy_ms
        self.gpu_capacity_ms += other.gpu_capacity_ms
        self.horizon_ms = max(self.horizon_ms, other.horizon_ms)
        if not self.scheduler:
            self.scheduler, self.autoscaler, self.scenario = \
                other.scheduler, other.autoscaler, other.scenario
        self.fastest_ms.update(other.fastest_ms)
        self.shed_records.extend(other.shed_records)
        self.shed_true += other.shed_true
        self.shed_false += other.shed_false
        self.shed_unknown += other.shed_unknown
        # device counters are fleet sums except the HBM peak (fleet max:
        # max over shard maxes == max over the union fleet)
        for k, v in other.gpu.items():
            if k == "hbm_peak_mb":
                self.gpu[k] = max(self.gpu.get(k, 0.0), v)
            elif isinstance(v, (int, float)):
                self.gpu[k] = self.gpu.get(k, 0) + v
            else:
                self.gpu.setdefault(k, v)
        return self

    def shed_precision(self) -> Optional[float]:
        """True sheds over scored sheds; None when nothing was scorable."""
        scored = self.shed_true + self.shed_false
        return self.shed_true / scored if scored else None

    def prefetch_hit_rate(self) -> Optional[float]:
        """Predictive-prefetch hits over issued copies (overlapped swap
        pipeline); None when no prefetch was ever issued — the analogue
        of shed precision for the transfer engine's speculation."""
        issued = self.gpu.get("prefetch_issued", 0)
        return self.gpu["prefetch_hits"] / issued if issued else None

    def penalty_hidden_frac(self) -> Optional[float]:
        """Fraction of the additive-model restart penalty the transfer
        engine hid behind execution/data transfer; None when no penalty
        was ever due."""
        full = self.gpu.get("penalty_full_ms", 0.0)
        return (self.gpu["penalty_hidden_ms"] / full) if full else None

    # ---- summaries ---------------------------------------------------------
    @property
    def n_injected(self) -> int:
        return sum(self.injected.values())

    @property
    def n_shed(self) -> int:
        return sum(self.shed.values())

    @property
    def n_admitted(self) -> int:
        return sum(self.admitted.values())

    def slo_attainment(self) -> float:
        """Hits over *offered* load: shed requests count as misses."""
        offered = self.n_injected if self.n_injected else self.completed
        return self.slo_hits / offered if offered else 0.0

    def cost_per_1k(self) -> float:
        done = self.completed
        return self.total_cost / done * 1000.0 if done else 0.0

    def utilization(self) -> float:
        return (self.gpu_busy_ms / self.gpu_capacity_ms
                if self.gpu_capacity_ms else 0.0)

    def summary(self) -> dict[str, Any]:
        return {
            "scheduler": self.scheduler,
            "autoscaler": self.autoscaler,
            "scenario": self.scenario,
            "injected": self.n_injected,
            "admitted": self.n_admitted,
            "shed": self.n_shed,
            "completed": self.completed,
            "slo_attainment": self.slo_attainment(),
            "cost_per_1k": self.cost_per_1k(),
            "total_cost": self.total_cost,
            "cold_starts": self.cold_starts,
            "utilization": self.utilization(),
            "shed_true": self.shed_true,
            "shed_false": self.shed_false,
            "shed_unknown": self.shed_unknown,
            "shed_precision": self.shed_precision(),
            "prefetch_hit_rate": self.prefetch_hit_rate(),
            "penalty_hidden_frac": self.penalty_hidden_frac(),
            "predicted_vs_realized": dict(self.predicted_vs_realized),
            "calibration": dict(self.calibration),
            "health": dict(self.health),
            "profile_provenance": dict(self.profile_provenance),
            "gpu": dict(self.gpu),
            "latency": self.e2e.to_dict(),
            "per_stage": {
                f"{app}/{stage}": {
                    "tasks": st.tasks, "jobs": st.jobs, "cold": st.cold,
                    "queue": st.queue.to_dict(), "exec": st.exec.to_dict(),
                }
                for (app, stage), st in sorted(self.stage.items())
            },
            "per_app": {
                app: {"injected": self.injected[app],
                      "admitted": self.admitted[app],
                      "shed": self.shed[app]}
                for app in sorted(set(self.injected) | set(self.admitted)
                                  | set(self.shed))
            },
        }


TABLE_COLS = [
    ("scenario", "scenario", "{}"),
    ("scheduler", "sched", "{}"),
    ("autoscaler", "scaler", "{}"),
    ("slo_attainment", "slo%", "{:.1%}"),
    ("cost_per_1k", "$/1k", "{:.4f}"),
    ("cold_starts", "cold", "{}"),
    ("shed", "shed", "{}"),
    ("completed", "done", "{}"),
    ("utilization", "util", "{:.1%}"),
    ("p95_ms", "p95_ms", "{:.0f}"),
]


def format_table(rows: list[dict[str, Any]],
                 extra_cols: Optional[list[tuple[str, str, str]]] = None) -> str:
    """Render summary dicts (see Telemetry.summary) as an aligned table."""
    cols = TABLE_COLS + (extra_cols or [])
    cells = [[hdr for _, hdr, _ in cols]]
    for r in rows:
        lat = r.get("latency") or {}
        flat = {**r, "p95_ms": lat.get("p95_ms", "")}
        row = []
        for key, _, fmt in cols:
            v = flat.get(key, "")
            # None metrics (e.g. shed_precision / prefetch_hit_rate with
            # nothing scorable) render as '-', same as missing keys —
            # "{:.1%}".format(None) would raise
            row.append(fmt.format(v) if v != "" and v is not None else "-")
        cells.append(row)
    widths = [max(len(c[i]) for c in cells) for i in range(len(cols))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths))
             for row in cells]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)
