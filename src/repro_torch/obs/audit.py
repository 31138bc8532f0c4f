"""Planner decision audit log.

One structured :class:`PlanRecord` per ``ESGScheduler.plan`` call —
which plan-cache budget regime served it (floor / budget-free / exact /
miss), how much work the A* search did (expansions, dual-blade prune
counts — zero on a cache hit), the chosen path's predicted latency/cost
against its G_SLO budget, and, back-filled when the dispatched task
completes, the realized stage latency next to the predicted one.  Plus
one :class:`SkipRecord` per event-sparse ``sparse_skips`` decision,
naming the plan-signature certificate that proved the retry futile, and
one :class:`RetryRecord` per retry decision taken after a spot
reclamation killed a running task (retry / resume-from-checkpoint /
shed, with attempt count, backoff and lost execution time).

This is the layer that makes a mispriced plan *visible*: the
``calibration()`` block aggregates per-stage predicted-vs-realized
error quantiles (surfaced through ``Telemetry.summary()``), and the
JSONL export lets a single bad decision be traced from its budget and
regime to the task it produced.

The audit log is also a *stream*: ``subscribe(fn)`` registers a
callback invoked once per plan record the moment its realized latency
back-fills at task completion.  That is the hook the online profile
calibrator (``repro.obs.calibrate``) and the SLO health engine's
calibration-drift detector (``repro.obs.health``) consume — they see
each predicted-vs-realized pair in simulated-time order, online, with
no post-hoc scan.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Any, Callable, Optional

# quantiles computed from a single sample are that sample, not a
# distribution — below this count the per-stage calibration block
# reports them as None so downstream consumers cannot mistake one
# noisy observation for a p90
MIN_QUANTILE_SAMPLES = 2

# per-(app, stage) cap on retained calibration error samples: beyond
# this the reservoir thins itself (keep-every-other, stride doubles), so
# a million-invocation run holds O(cap) floats per stage instead of
# O(invocations) while quantiles stay exact over a systematic 1-in-2^k
# subsample of the stream
CAL_RESERVOIR_CAP = 4096


class _ErrAcc:
    """Streaming predicted-vs-realized error accumulator for one
    (app, stage): exact count/sums, plus a deterministic
    systematic-thinning reservoir for quantiles.  No RNG — the kept
    subsample is every ``stride``-th observation, so replays reproduce
    it bit-for-bit."""
    __slots__ = ("n", "sum_err", "sum_abs", "samples", "stride", "_skip")

    def __init__(self):
        self.n = 0
        self.sum_err = 0.0
        self.sum_abs = 0.0
        self.samples: list[float] = []
        self.stride = 1
        self._skip = 0

    def add(self, err: float) -> None:
        self.n += 1
        self.sum_err += err
        self.sum_abs += abs(err)
        if self._skip:
            self._skip -= 1
            return
        self._skip = self.stride - 1
        self.samples.append(err)
        if len(self.samples) >= CAL_RESERVOIR_CAP:
            del self.samples[1::2]     # keep even ranks, double the step
            self.stride *= 2


@dataclasses.dataclass
class PlanRecord:
    """One ``plan()`` call and the dispatch it led to (if any)."""
    t_ms: float
    app: str
    stage: str
    n_jobs: int
    g_slo_ms: float                  # budget handed to ESG_1Q (0 when sunk)
    regime: str                      # floor|budget-free|exact|miss|nocache|sunk
    expansions: int                  # A* nodes expanded (0 on cache hits)
    pruned_time: int                 # time-blade prunes
    pruned_cost: int                 # cost-blade prunes
    est_time_ms: Optional[float]     # chosen path's predicted suffix latency
    est_job_cost: Optional[float]
    slack_ms: Optional[float]        # g_slo - est_time of the chosen path
    n_candidates: int
    # --- back-filled at dispatch / completion ---
    task_tid: Optional[int] = None
    config: Optional[Any] = None     # the dispatched Config (JSON: nested)
    predicted_ms: Optional[float] = None   # this stage, dispatched config
    realized_ms: Optional[float] = None    # start -> end, noise + resizes
    # raw (uncorrected) profile estimate of the exec component alone and
    # the realized exec span (exec_start -> end) — the multiplicative
    # signal the online calibrator learns from: realized_exec_ms /
    # predicted_raw_ms is the profile's error free of swap penalties and
    # of whatever correction the planner already applied
    predicted_raw_ms: Optional[float] = None
    realized_exec_ms: Optional[float] = None
    # where the stage's profile numbers came from: "zoo" (analytic
    # roofline tables) or "measured" (real-kernel timing artifact) —
    # lets audit consumers weight calibration trust accordingly
    provenance: Optional[str] = None


@dataclasses.dataclass
class SkipRecord:
    """One provably-futile retry skipped by the event-sparse emulator."""
    t_ms: float
    app: str
    stage: str
    certificate: str                 # the plan-signature token that proved it
    recheck: int                     # recheck counter at skip time


@dataclasses.dataclass
class RetryRecord:
    """One retry decision after a spot reclamation killed a running task.

    ``action`` is what the emulator decided for this job: ``retry``
    (re-run from scratch after ``backoff_ms``), ``resume`` (restart from
    the stage's checkpoint) or ``shed`` (retry budget exhausted, the
    request failed).  ``lost_ms`` is the execution time destroyed by the
    kill, attributed to every job of the killed task."""
    t_ms: float
    app: str
    stage: str
    uid: int                         # request the retried job belongs to
    invoker: int                     # reclaimed invoker
    attempt: int                     # 1-based attempt count for this stage
    action: str                      # retry|resume|shed
    backoff_ms: float                # delay before the re-queue (0 for shed)
    lost_ms: float                   # exec time destroyed by the kill


class AuditLog:
    def __init__(self):
        self.plans: list[PlanRecord] = []
        self.skips: list[SkipRecord] = []
        self.retries: list[RetryRecord] = []
        # most recent un-dispatched record per (app, stage): the emulator
        # calls plan() then dispatches at most one task from its result
        self._pending: dict[tuple[str, str], PlanRecord] = {}
        self._by_tid: dict[int, PlanRecord] = {}
        # realized-record stream: called once per record when its
        # realized latency back-fills (see module docstring)
        self._subscribers: list[Callable[[PlanRecord], None]] = []
        # streaming calibration state, fed at back-fill time so
        # calibration() never has to rescan (and retain) every record
        self._cal: dict[str, _ErrAcc] = {}

    def subscribe(self, fn: Callable[[PlanRecord], None]) -> None:
        """Register ``fn`` to receive each plan record the moment its
        realized latency is back-filled at task completion."""
        self._subscribers.append(fn)

    # ---- recording ---------------------------------------------------------
    def on_plan(self, rec: PlanRecord) -> PlanRecord:
        self.plans.append(rec)
        self._pending[(rec.app, rec.stage)] = rec
        return rec

    def on_dispatch(self, app: str, stage: str, tid: int, config: Any,
                    predicted_ms: float,
                    predicted_raw_ms: Optional[float] = None):
        rec = self._pending.pop((app, stage), None)
        if rec is None:
            return
        rec.task_tid = tid
        rec.config = config
        rec.predicted_ms = predicted_ms
        rec.predicted_raw_ms = predicted_raw_ms
        self._by_tid[tid] = rec

    def on_complete(self, tid: int, realized_ms: float,
                    realized_exec_ms: Optional[float] = None):
        rec = self._by_tid.pop(tid, None)
        if rec is None:
            return
        rec.realized_ms = realized_ms
        rec.realized_exec_ms = realized_exec_ms
        if rec.predicted_ms is not None and rec.predicted_ms > 0:
            err = (realized_ms - rec.predicted_ms) / rec.predicted_ms
            acc = self._cal.get(f"{rec.app}/{rec.stage}")
            if acc is None:
                acc = self._cal[f"{rec.app}/{rec.stage}"] = _ErrAcc()
            acc.add(err)
        for fn in self._subscribers:
            fn(rec)

    def on_skip(self, t_ms: float, app: str, stage: str, certificate: Any,
                recheck: int):
        self.skips.append(SkipRecord(t_ms, app, stage, str(certificate),
                                     recheck))

    def on_preempted(self, tid: int):
        """A running task was killed by a reclamation: drop its pending
        back-fill so the partial run never reaches the calibration stream
        (a kill is not a latency observation)."""
        self._by_tid.pop(tid, None)

    def on_retry(self, t_ms: float, app: str, stage: str, uid: int,
                 invoker: int, attempt: int, action: str,
                 backoff_ms: float, lost_ms: float) -> RetryRecord:
        rec = RetryRecord(t_ms, app, stage, uid, invoker, attempt, action,
                          backoff_ms, lost_ms)
        self.retries.append(rec)
        return rec

    # ---- analysis ----------------------------------------------------------
    @staticmethod
    def _quantile(xs: list[float], q: float) -> float:
        """Nearest-rank quantile without numpy (xs non-empty, sorted)."""
        i = min(int(q * (len(xs) - 1) + 0.5), len(xs) - 1)
        return xs[i]

    def calibration(self) -> dict[str, Any]:
        """Predicted-vs-realized per-stage latency error quantiles.

        Relative error is (realized - predicted) / predicted: positive
        means the plan was optimistic (exec noise, resizes, contention),
        negative pessimistic.  Per-(app, stage) plus an overall block.
        Every per-stage block carries its sample count ``n`` next to the
        quantiles, and below ``MIN_QUANTILE_SAMPLES`` the quantiles are
        reported as None — a "p90" of one sample is that sample, and
        consumers (the calibrator's warmup gate, dashboards) must be
        able to tell the difference.

        Counts and means come from exact streaming accumulators fed at
        back-fill time; quantiles come from each stage's bounded
        thinning reservoir (``CAL_RESERVOIR_CAP``), so this holds O(1)
        floats per stage regardless of trace length.
        """
        accs = self._cal
        if not accs and self.plans:
            # fallback for records whose realized_ms was set directly
            # instead of through on_complete (external tooling): one
            # bounded scan into throwaway accumulators
            accs = {}
            for rec in self.plans:
                if rec.predicted_ms is None or rec.realized_ms is None \
                        or rec.predicted_ms <= 0:
                    continue
                key = f"{rec.app}/{rec.stage}"
                acc = accs.get(key)
                if acc is None:
                    acc = accs[key] = _ErrAcc()
                acc.add((rec.realized_ms - rec.predicted_ms)
                        / rec.predicted_ms)
        out: dict[str, Any] = {}
        all_errs: list[float] = []
        n_total = 0
        sum_err = sum_abs = 0.0
        for key in sorted(accs):
            acc = accs[key]
            errs = sorted(acc.samples)
            all_errs.extend(errs)
            n_total += acc.n
            sum_err += acc.sum_err
            sum_abs += acc.sum_abs
            quantiled = acc.n >= MIN_QUANTILE_SAMPLES
            out[key] = {
                "n": acc.n,
                "mean_err": acc.sum_err / acc.n,
                "mean_abs_err": acc.sum_abs / acc.n,
                "p50_err": self._quantile(errs, 0.50) if quantiled else None,
                "p90_abs_err": self._quantile(sorted(abs(e) for e in errs),
                                              0.90) if quantiled else None,
            }
        all_errs.sort()
        return {
            "n": n_total,
            "mean_err": (sum_err / n_total) if n_total else 0.0,
            "mean_abs_err": (sum_abs / n_total) if n_total else 0.0,
            "p50_err": self._quantile(all_errs, 0.50) if all_errs else 0.0,
            "p90_abs_err": self._quantile(
                sorted(abs(e) for e in all_errs), 0.90) if all_errs else 0.0,
            "per_stage": out,
        }

    def regimes(self) -> dict[str, int]:
        counts: dict[str, int] = defaultdict(int)
        for rec in self.plans:
            counts[rec.regime] += 1
        return dict(counts)

    # ---- export ------------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """One JSON object per line: plan, then skip, then retry records."""
        n = 0
        with open(path, "w") as f:
            for rec in self.plans:
                f.write(json.dumps({"type": "plan",
                                    **dataclasses.asdict(rec)},
                                   sort_keys=True, default=str) + "\n")
                n += 1
            for skip in self.skips:
                f.write(json.dumps({"type": "skip",
                                    **dataclasses.asdict(skip)},
                                   sort_keys=True, default=str) + "\n")
                n += 1
            for retry in self.retries:
                f.write(json.dumps({"type": "retry",
                                    **dataclasses.asdict(retry)},
                                   sort_keys=True, default=str) + "\n")
                n += 1
        return n
