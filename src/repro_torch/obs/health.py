"""SLO burn-rate health engine: online alerting over the metrics stream.

The flight recorder measures; this module *judges*.  A
:class:`HealthEngine` is fed the same online signals the recorder
samples into the metrics bus — request completions vs their SLOs, shed
decisions, per-window queue depth, cold starts, wasted prefetches, and
the audit stream's predicted-vs-realized records — and turns them into
structured, exportable :class:`AlertRecord` transitions that serving
components consume as early-warning signals:

  * **slo_burn_rate** (per app) — multi-window burn-rate alerting in
    the Google-SRE style.  Each app has an *error budget*: with an
    attainment target of ``slo_target`` (say 0.99), a fraction
    ``1 - slo_target`` of requests may miss their SLO.  The burn rate
    is the observed miss rate divided by that budget — burn 1.0 spends
    the budget exactly; burn 10 exhausts it 10x too fast.  An alert
    fires only when **both** a short and a long window burn above
    ``burn_threshold``: the long window keeps one transient blip from
    paging, the short window makes the alert *clear* quickly once the
    system recovers.  Shed requests count as misses — shedding protects
    the pool, not the SLO ledger.

  * **calibration_drift** (per app) — fast-vs-slow EWMA of the absolute
    predicted-vs-realized relative error from the planner audit stream.
    When the fast estimate pulls away from the slow baseline the
    profiles have *drifted* (as opposed to being merely wrong — a
    constant error calibrates away; drift means the world is changing
    faster than the calibrator's gate).

  * **queue_buildup** (cluster) — per-window queue-depth snapshots
    against an absolute depth threshold for ``sustain`` consecutive
    windows; clears on the first calm window.

  * **cold_start_spike** / **prefetch_waste_surge** (cluster) — a
    per-window count more than ``spike_mult`` x a trailing EWMA baseline
    (and above an absolute floor, so quiet runs cannot "spike" from 0 to
    2): keep-alive or the prefetch predictor has stopped matching the
    arrival pattern.

Consumers poll :meth:`firing` / :meth:`early_warning`; the gateway
inflates its predicted-queueing term under a firing burn-rate alert
(shedding doomed work *earlier* while the budget burns), and the
vertical autoscaler suppresses opportunistic quota grows so idle slices
stay free for the queued work the alert predicts.  Both hooks default
to ``health=None`` and change nothing when absent — the differential
replay tests stay bit-identical.

The engine runs on simulated time, uses no RNG, and is pure bookkeeping
— attaching it never changes a schedule unless a consumer is explicitly
wired to act on its alerts.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

from repro_torch.obs.audit import AuditLog, PlanRecord

FIRING = "firing"
CLEARED = "cleared"

# alert kinds (the taxonomy documented in the README)
SLO_BURN = "slo_burn_rate"
CAL_DRIFT = "calibration_drift"
QUEUE_BUILDUP = "queue_buildup"
COLD_SPIKE = "cold_start_spike"
PREFETCH_WASTE = "prefetch_waste_surge"

ALERT_KINDS = (SLO_BURN, CAL_DRIFT, QUEUE_BUILDUP, COLD_SPIKE,
               PREFETCH_WASTE)


@dataclasses.dataclass
class AlertRecord:
    """One alert state transition (firing or cleared)."""
    t_ms: float
    kind: str                    # one of ALERT_KINDS
    app: Optional[str]           # None for cluster-scoped kinds
    state: str                   # firing | cleared
    value: float                 # the measurement that crossed
    threshold: float             # what it crossed
    detail: str = ""


class _Windowed:
    """Rolling (total, bad) counts over a fixed trailing span of
    simulated time, bucketed so old samples age out exactly."""

    def __init__(self, span_ms: float, bucket_ms: float):
        self.span = span_ms
        self.bucket = bucket_ms
        self._cells: dict[int, list[float]] = {}   # bucket -> [total, bad]
        self._total = 0.0
        self._bad = 0.0

    def add(self, t_ms: float, bad: bool):
        b = int(t_ms // self.bucket)
        cell = self._cells.get(b)
        if cell is None:
            self._cells[b] = [1.0, 1.0 if bad else 0.0]
        else:
            cell[0] += 1.0
            if bad:
                cell[1] += 1.0
        self._total += 1.0
        if bad:
            self._bad += 1.0

    def rates(self, now_ms: float) -> tuple[float, float]:
        """(total, bad_fraction) over the trailing span; prunes.

        O(1) amortized: totals are maintained on ``add`` and cells are
        expired from the front of the (insertion- and therefore time-
        ordered, since feeds run on monotone simulated time) dict."""
        lo = int((now_ms - self.span) // self.bucket)
        cells = self._cells
        while cells:
            b = next(iter(cells))
            if b >= lo:
                break
            total, bad = cells.pop(b)
            self._total -= total
            self._bad -= bad
        total = self._total
        return total, (self._bad / total if total else 0.0)


class HealthEngine:
    """Multi-window SLO burn-rate tracking + drift/anomaly detectors.

    ``slo_targets`` maps app name -> attainment target (fraction of
    requests that must meet their SLO); unmapped apps use
    ``default_target``.  All feeds take the current simulated time —
    the engine has no clock of its own.
    """

    def __init__(self,
                 slo_targets: Optional[dict[str, float]] = None,
                 default_target: float = 0.99,
                 short_ms: float = 10_000.0,
                 long_ms: float = 60_000.0,
                 burn_threshold: float = 2.0,
                 min_requests: int = 10,
                 drift_fast_alpha: float = 0.3,
                 drift_slow_alpha: float = 0.03,
                 drift_threshold: float = 0.15,
                 drift_min_samples: int = 10,
                 queue_depth_limit: int = 64,
                 queue_sustain: int = 3,
                 spike_mult: float = 4.0,
                 spike_floor: float = 8.0):
        self.slo_targets = dict(slo_targets or {})
        self.default_target = default_target
        self.burn_threshold = burn_threshold
        self.min_requests = min_requests
        self.drift_fast_alpha = drift_fast_alpha
        self.drift_slow_alpha = drift_slow_alpha
        self.drift_threshold = drift_threshold
        self.drift_min_samples = drift_min_samples
        self.queue_depth_limit = queue_depth_limit
        self.queue_sustain = queue_sustain
        self.spike_mult = spike_mult
        self.spike_floor = spike_floor
        bucket = max(short_ms / 10.0, 1.0)
        self._mk_short = lambda: _Windowed(short_ms, bucket)
        self._mk_long = lambda: _Windowed(long_ms, bucket)
        self._short: dict[str, _Windowed] = {}
        self._long: dict[str, _Windowed] = {}
        self._budget: dict[str, float] = {}    # per-app error budget
        # per-app [fast, slow, n] |relative error| EWMAs + sample count
        self._drift: dict[str, list] = {}
        self._q_high = 0                       # consecutive deep windows
        self._spike_base: dict[str, float] = {}  # kind -> EWMA baseline
        # (kind, app) -> the AlertRecord currently firing
        self._active: dict[tuple[str, Optional[str]], AlertRecord] = {}
        self.alerts: list[AlertRecord] = []    # full transition history

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def attach_audit(self, audit: AuditLog) -> "HealthEngine":
        """Subscribe the calibration-drift detector to an audit log."""
        audit.subscribe(self.observe_calibration)
        return self

    # ------------------------------------------------------------------
    # alert bookkeeping
    # ------------------------------------------------------------------
    def _transition(self, now: float, kind: str, app: Optional[str],
                    fire: bool, value: float, threshold: float,
                    detail=""):
        """``detail`` may be a zero-arg callable: the engine is fed on
        every request/record/window but transitions are rare, so detail
        strings are only rendered when a record is actually emitted."""
        key = (kind, app)
        active = self._active.get(key)
        if fire == (active is not None):
            return
        if callable(detail):
            detail = detail()
        if fire:
            rec = AlertRecord(now, kind, app, FIRING, value, threshold,
                              detail)
            self._active[key] = rec
            self.alerts.append(rec)
        else:
            del self._active[key]
            self.alerts.append(AlertRecord(now, kind, app, CLEARED, value,
                                           threshold, detail))

    # ------------------------------------------------------------------
    # feeds (called by the Recorder hooks / audit subscription)
    # ------------------------------------------------------------------
    def on_request(self, app: str, now: float, ok: bool):
        """One finished (or shed) request: ``ok`` is SLO attainment."""
        short = self._short.get(app)
        if short is None:
            short = self._short[app] = self._mk_short()
            self._long[app] = self._mk_long()
            budget = 1.0 - self.slo_targets.get(app, self.default_target)
            if budget <= 0.0:
                budget = 1e-9                   # a 100% target burns instantly
            self._budget[app] = budget
        long = self._long[app]
        bad = not ok
        short.add(now, bad)
        long.add(now, bad)
        budget = self._budget[app]
        n_s, miss_s = short.rates(now)
        burn_s = miss_s / budget
        thr = self.burn_threshold
        if (SLO_BURN, app) not in self._active:
            # fire only on evidence in BOTH windows; the long window is
            # not even consulted until the short one burns — on a
            # healthy stream this is the whole evaluation
            if n_s < self.min_requests or burn_s < thr:
                return
            n_l, miss_l = long.rates(now)
            burn_l = miss_l / budget
            if burn_l < thr:
                return
            self._transition(
                now, SLO_BURN, app, True, max(burn_s, burn_l), thr,
                lambda: f"burn short={burn_s:.2f} long={burn_l:.2f} "
                        f"(n={n_s:.0f}/{n_l:.0f}, budget={budget:.4f})")
        elif burn_s < thr:
            # clear as soon as the short window recovers
            self._transition(
                now, SLO_BURN, app, False, burn_s, thr,
                lambda: f"burn short={burn_s:.2f} "
                        f"(n={n_s:.0f}, budget={budget:.4f})")

    def on_shed(self, app: str, now: float):
        """A shed request spends error budget like an SLO miss."""
        self.on_request(app, now, ok=False)

    def observe_calibration(self, rec: PlanRecord) -> None:
        """Audit-stream subscriber: fast-vs-slow |relative error| drift."""
        if rec.predicted_ms is None or rec.realized_ms is None \
                or rec.predicted_ms <= 0:
            return
        err = abs(rec.realized_ms - rec.predicted_ms) / rec.predicted_ms
        st = self._drift.get(rec.app)
        if st is None:
            st = self._drift[rec.app] = [err, err, 0]
        fa, sa = self.drift_fast_alpha, self.drift_slow_alpha
        fast = st[0] = (1.0 - fa) * st[0] + fa * err
        slow = st[1] = (1.0 - sa) * st[1] + sa * err
        n = st[2] = st[2] + 1
        if n < self.drift_min_samples:
            return
        gap = fast - slow
        fire = gap >= self.drift_threshold
        if fire or (CAL_DRIFT, rec.app) in self._active:
            self._transition(
                rec.t_ms, CAL_DRIFT, rec.app, fire,
                gap, self.drift_threshold,
                lambda: f"|err| ewma fast={fast:.3f} slow={slow:.3f} "
                        f"(n={n})")

    def on_window(self, now: float, queue_depth: float,
                  cold_starts: float, prefetch_wasted: float):
        """Per-metrics-window cluster snapshot (fed by the recorder)."""
        # queue buildup: sustained absolute depth
        if queue_depth >= self.queue_depth_limit:
            self._q_high += 1
        else:
            self._q_high = 0
        fire = self._q_high >= self.queue_sustain
        if fire or (QUEUE_BUILDUP, None) in self._active:
            self._transition(
                now, QUEUE_BUILDUP, None, fire,
                queue_depth, float(self.queue_depth_limit),
                lambda: f"depth {queue_depth:.0f} for "
                        f"{self._q_high} window(s)")
        # spike detectors: current window vs trailing EWMA baseline
        for kind, v in ((COLD_SPIKE, cold_starts),
                        (PREFETCH_WASTE, prefetch_wasted)):
            base = self._spike_base.get(kind, 0.0)
            limit = max(self.spike_mult * base, self.spike_floor)
            fire = v >= limit
            if fire or (kind, None) in self._active:
                self._transition(now, kind, None, fire, v, limit,
                                 lambda v=v, base=base:
                                     f"window={v:.0f} baseline={base:.2f}")
            self._spike_base[kind] = 0.8 * base + 0.2 * v

    # ------------------------------------------------------------------
    # consumer queries
    # ------------------------------------------------------------------
    def firing(self, kind: Optional[str] = None,
               app: Optional[str] = None) -> list[AlertRecord]:
        """Currently-active alerts, optionally filtered by kind/app."""
        return [a for a in self._active.values()
                if (kind is None or a.kind == kind)
                and (app is None or a.app == app)]

    def early_warning(self, app: Optional[str] = None) -> bool:
        """True when the app (or the cluster) should act defensively:
        its own burn-rate/drift alert is firing, or any cluster-scoped
        alert is."""
        for a in self._active.values():
            if a.app is None or app is None or a.app == app:
                return True
        return False

    def burn_rate(self, app: str, now: float) -> tuple[float, float]:
        """(short, long) burn rates for an app right now."""
        budget = 1.0 - self.slo_targets.get(app, self.default_target)
        if budget <= 0.0:
            budget = 1e-9
        short = self._short.get(app)
        if short is None:
            return 0.0, 0.0
        _, miss_s = short.rates(now)
        _, miss_l = self._long[app].rates(now)
        return miss_s / budget, miss_l / budget

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def summary(self) -> dict[str, Any]:
        counts: dict[str, int] = {}
        for a in self.alerts:
            counts[f"{a.kind}:{a.state}"] = \
                counts.get(f"{a.kind}:{a.state}", 0) + 1
        return {
            "alerts_total": len(self.alerts),
            "active": sorted(f"{a.kind}"
                             + (f"[{a.app}]" if a.app else "")
                             for a in self._active.values()),
            "transitions": counts,
        }

    def export_jsonl(self, path: str) -> int:
        """One JSON object per alert transition, in emission order."""
        n = 0
        with open(path, "w") as f:
            for a in self.alerts:
                f.write(json.dumps({"type": "alert",
                                    **dataclasses.asdict(a)},
                                   sort_keys=True) + "\n")
                n += 1
        return n
