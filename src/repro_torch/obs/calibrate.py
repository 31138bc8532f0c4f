"""Online profile calibration: close the pricing loop over the audit stream.

ESG's dual-blade search and dominator-based SLO distribution price every
decision against ``ProfileTable`` latency estimates.  The paper assumes
those are offline-profiled and trustworthy; production profiles drift
(new kernels, contention, quantization, plain mis-measurement), and the
flight recorder already *measures* the resulting error online — one
predicted-vs-realized pair per dispatched stage in the planner audit
stream.  This module consumes that stream and feeds the error back:

  * :class:`ProfileCalibrator` subscribes to ``AuditLog`` realized
    records and maintains one **EWMA multiplicative correction factor**
    per (app, stage): the smoothed ratio of realized execution time to
    the *raw* (uncorrected) profile estimate.  The ratio is computed on
    the exec component alone (``realized_exec_ms / predicted_raw_ms``),
    so swap penalties and queueing — which the planner prices through
    separate, already-measured channels — never pollute the profile
    correction.

  * The factor is **sample-count-gated** (no correction is published
    before ``min_samples`` observations — a cold stage keeps factor 1.0
    and the planner stays bit-identical to an uncalibrated run) and
    **clamped** to ``clamp`` so one pathological record can never send
    the planner to a corner of the config lattice.

  * Publishing is **hysteretic**: the working EWMA updates on every
    record, but the *published* factor (the one the planner reads) only
    moves when the EWMA has drifted ``publish_rel_step`` away from it.
    Every publish bumps ``version`` — ``ESGScheduler`` folds the
    published factor tuple into its plan-cache keys, so a version bump
    is exactly a plan-cache invalidation for the affected stages and a
    stale cached plan can never survive a calibration step.  Hysteresis
    keeps those invalidations rare — and the defaults make "rare" mean
    *never on pure noise*: the warmup estimate is a running mean (so it
    leaves the gate carrying ``1/sqrt(min_samples)`` of the per-sample
    noise), and with ``alpha=0.1`` the steady-state EWMA wander under
    the emulator's default 5% execution noise is ~1.2%, putting the 5%
    deadband more than 4 sigma out.  An accurately profiled stage
    publishes nothing and the planner keeps its plan cache end to end;
    a genuinely mis-profiled stage still walks to its correction in a
    handful of coarse steps.  Deployments that want finer tracking (the
    calibration sweep pins 2% steps and a 5-sample warmup) buy it with
    more plan-cache invalidations.

The planner applies corrections through ``ProfileTable.scaled`` — a
priced-arrays-compatible multiplicative rescale of the stage's (times,
job_costs) — so the dual-blade search, the dominator SLO split and the
plan cache all see corrected estimates with no change to the search
machinery.  With no calibrator attached (the default everywhere), no
code path changes: the differential tests replay every serving scenario
bit-identically.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.obs.audit import AuditLog, PlanRecord

# one observed ratio outside this range is an outlier (a resize storm, a
# pathological noise draw), not a profile error — clip before the EWMA
# so a single record cannot drag the estimate far from the truth
RATIO_CLIP = (0.125, 8.0)


class ProfileCalibrator:
    """EWMA multiplicative per-(app, stage) exec-latency correction.

    ``factor(app, stage)`` is what the planner multiplies the stage's
    profile times (and, proportionally, job costs — billed cost scales
    with realized runtime) by.  It is 1.0 until ``min_samples`` records
    have been observed for the stage *and* the EWMA has moved at least
    ``publish_rel_step`` away from the last published value; it is
    always inside ``clamp``.
    """

    def __init__(self, alpha: float = 0.1, min_samples: int = 10,
                 clamp: tuple[float, float] = (0.25, 4.0),
                 publish_rel_step: float = 0.05,
                 headroom: float = 1.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if clamp[0] <= 0 or clamp[0] > 1.0 or clamp[1] < 1.0:
            raise ValueError(f"clamp must bracket 1.0 with a positive "
                             f"floor, got {clamp}")
        if headroom < 1.0:
            raise ValueError(f"headroom must be >= 1.0, got {headroom}")
        self.alpha = alpha
        self.min_samples = min_samples
        self.clamp = clamp
        self.publish_rel_step = publish_rel_step
        # conservative margin multiplied into every published factor:
        # calibration removes the padding a mis-profiled table happened
        # to provide, so deployments facing noisy executors can keep a
        # few percent of it on purpose.  1.0 (default) = pure correction.
        self.headroom = headroom
        # per-(app, stage) [n, ewma, published] — one dict lookup per
        # observed record; ``_published`` mirrors the published slot for
        # the planner's read side and is only written on a publish
        self._state: dict[tuple[str, str], list] = {}
        self._published: dict[tuple[str, str], float] = {}
        # bumped on every published change; the scheduler folds the
        # published factors into plan-cache keys and drops its scaled-
        # table cache when the version moves
        self.version = 0
        self.updates = 0          # published factor changes
        self.observations = 0     # realized records consumed

    # ---- wiring ------------------------------------------------------------
    def attach(self, audit: AuditLog) -> "ProfileCalibrator":
        """Subscribe to an audit log's realized-record stream."""
        audit.subscribe(self.observe)
        return self

    # ---- the stream consumer ----------------------------------------------
    def observe(self, rec: PlanRecord) -> None:
        raw = rec.predicted_raw_ms
        realized = rec.realized_exec_ms
        if raw is None or realized is None or raw <= 0.0 or realized < 0.0:
            return
        self.observations += 1
        ratio = realized / raw
        lo, hi = RATIO_CLIP
        ratio = lo if ratio < lo else hi if ratio > hi else ratio
        key = (rec.app, rec.stage)
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = [1, ratio, 1.0]
            n, ewma = 1, ratio
        else:
            n = st[0] = st[0] + 1
            prev = st[1]
            if n <= self.min_samples:
                # warmup: running mean, so the estimate leaving the gate
                # carries 1/sqrt(min_samples) of the per-sample noise —
                # an EWMA seeded on the first ratio alone keeps most of
                # one draw's variance and publishes right at warmup
                ewma = prev + (ratio - prev) / n
            else:
                ewma = (1.0 - self.alpha) * prev + self.alpha * ratio
            st[1] = ewma
        if n < self.min_samples:
            return
        lo, hi = self.clamp
        cand = ewma * self.headroom
        cand = lo if cand < lo else hi if cand > hi else cand
        pub = st[2]
        if abs(cand - pub) < self.publish_rel_step * pub:
            return
        st[2] = cand
        self._published[key] = cand
        self.version += 1
        self.updates += 1

    # ---- planner-side queries ----------------------------------------------
    @property
    def active(self) -> bool:
        """True once any correction has been published.  False for a
        cold or warmup-gated calibrator — the planner skips factor
        lookups entirely and stays on its uncorrected fast path."""
        return bool(self._published)

    def factor(self, app: str, stage: str) -> float:
        """Published multiplicative correction for (app, stage); 1.0
        during warmup and for never-observed stages."""
        return self._published.get((app, stage), 1.0)

    def factors(self, app: str, stages) -> tuple[float, ...]:
        """Published factors for a stage suffix, in order."""
        return tuple(self._published.get((app, s), 1.0) for s in stages)

    def samples(self, app: str, stage: str) -> int:
        st = self._state.get((app, stage))
        return st[0] if st else 0

    # ---- export ------------------------------------------------------------
    def summary(self) -> dict[str, Any]:
        """Structured state: published factors, working EWMAs, counts."""
        per_stage = {}
        for app, stage in sorted(set(self._state) | set(self._published)):
            st = self._state.get((app, stage))
            per_stage[f"{app}/{stage}"] = {
                "factor": self._published.get((app, stage), 1.0),
                "ewma": st[1] if st else None,
                "n": st[0] if st else 0,
            }
        return {
            "version": self.version,
            "updates": self.updates,
            "observations": self.observations,
            "alpha": self.alpha,
            "min_samples": self.min_samples,
            "clamp": list(self.clamp),
            "headroom": self.headroom,
            "per_stage": per_stage,
        }


def make_calibrator(recorder, scheduler,
                    **kw) -> Optional[ProfileCalibrator]:
    """Wire a calibrator between a recorder's audit stream and a
    scheduler that accepts one (``ESGScheduler``).  Returns the
    calibrator, or None when the recorder has no audit log or the
    scheduler has no ``calibrator`` attribute to accept it."""
    audit = getattr(recorder, "audit", None)
    if audit is None or not hasattr(scheduler, "calibrator"):
        return None
    cal = ProfileCalibrator(**kw).attach(audit)
    scheduler.calibrator = cal
    return cal
