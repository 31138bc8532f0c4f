"""Asynchronous per-device PCIe transfer engine (overlapped swap pipeline).

Replaces the additive-scalar restart-penalty model with an explicit
timeline of host->HBM weight copies, so the emulator can overlap a
stage's swap-in with its predecessor's execution (Torpor/FaaSwap's
pipelined swap, arXiv 2306.03622) and with predictive prefetch of the
pipeline's next stage.

Two traffic classes share one device's PCIe link:

  * **demand** copies sit on a task's critical path (the weights a start
    is waiting for).  They run on the reserved demand stream and take
    exactly their transfer duration from the moment they are issued —
    the same assumption the legacy additive model makes — so turning
    overlap on can never make an individual task *slower* than the
    additive accounting (the monotone-improvement invariant the
    differential tests pin).
  * **prefetch** copies are speculative background work (predicted
    next-stage weights, autoscaler re-promotions).  They serialize FIFO
    on the leftover bandwidth and *pause* whenever a demand copy holds
    the link, so background traffic never steals critical-path
    bandwidth.

A demand request for weights that already have a prefetch in flight
**promotes** the prefetch: only the remaining bytes are copied at demand
priority, and the bytes already landed are never re-transferred — every
byte of every movement is booked on the link exactly once (the
``busy_ms == demand_ms + prefetch_ms`` work-conservation invariant the
property tests walk).

The engine is lazily evaluated: simulated time is monotone and every
operation passes ``now``, so queue progress is materialised on access
(``_advance``) instead of via scheduled events — the emulator's event
loop never needs to know the engine exists.
"""
from __future__ import annotations

import dataclasses
import math

DEMAND = "demand"
PREFETCH = "prefetch"

_EPS = 1e-9


@dataclasses.dataclass(eq=False)
class Transfer:
    """One host->HBM weight copy on a device's PCIe link.

    ``eq=False``: queue membership (``in`` / ``remove``) must be by
    *identity* — two copies of the same checkpoint enqueued at the same
    instant are distinct pieces of work, not equal values."""
    func: str
    total_ms: float              # full copy duration (the additive penalty)
    remaining_ms: float          # work not yet performed
    kind: str                    # DEMAND | PREFETCH
    enq_ms: float                # when the copy was requested
    done_ms: float = math.inf    # completion time, once known

    def residual_ms(self, now: float) -> float:
        """Time until the copy completes, 0 if already done.  Only valid
        once ``done_ms`` is known (demand copies, drained prefetches);
        queued prefetches go through :meth:`TransferEngine.eta`."""
        return max(self.done_ms - now, 0.0)


class TransferEngine:
    """Serialized background-transfer queue with demand preemption."""

    def __init__(self):
        self.queue: list[Transfer] = []   # pending/in-flight prefetches, FIFO
        self.block_until = 0.0            # demand copies hold the link until
        self.last_ms = 0.0                # queue progress materialised up to
        # work-conserving accounting (ms of link time actually used)
        self.busy_ms = 0.0
        self.demand_ms = 0.0
        self.prefetch_ms = 0.0
        # flight recorder (repro.obs), set by Recorder.bind_sim; None
        # means unobserved — hooks are guarded so the unrecorded path
        # does no extra work
        self.recorder = None
        self.device_id = -1

    # ---- lazy queue progress ----------------------------------------------
    def _advance(self, now: float) -> None:
        """Materialise prefetch-queue progress up to ``now``.

        The queue only runs while no demand copy holds the link, i.e. in
        the window ``(max(last_ms, block_until), now]``.  ``block_until``
        only changes inside engine operations and every operation calls
        ``_advance`` first, so computing the window with the *current*
        value is exact."""
        t = max(self.last_ms, self.block_until)
        while self.queue and t < now - _EPS:
            head = self.queue[0]
            step = min(head.remaining_ms, now - t)
            head.remaining_ms -= step
            self.busy_ms += step
            self.prefetch_ms += step
            t += step
            if head.remaining_ms <= _EPS:
                head.remaining_ms = 0.0
                head.done_ms = t
                self.queue.pop(0)
        self.last_ms = max(self.last_ms, now)

    # ---- requests ----------------------------------------------------------
    def demand(self, func: str, dur_ms: float, now: float) -> Transfer:
        """Critical-path copy: runs on the reserved demand stream, takes
        exactly ``dur_ms`` from ``now``, and pauses the prefetch queue
        until it completes."""
        self._advance(now)
        tr = Transfer(func, dur_ms, 0.0, DEMAND, now, done_ms=now + dur_ms)
        self.busy_ms += dur_ms
        self.demand_ms += dur_ms
        self.block_until = max(self.block_until, tr.done_ms)
        if self.recorder is not None:
            self.recorder.on_transfer(self.device_id, tr, DEMAND)
        return tr

    def prefetch(self, func: str, dur_ms: float, now: float) -> Transfer:
        """Background copy: appended to the FIFO, drains whenever the
        link is demand-free.  Completion time is resolved lazily (a
        later demand copy may push it out); query :meth:`eta`."""
        self._advance(now)
        tr = Transfer(func, dur_ms, dur_ms, PREFETCH, now)
        self.queue.append(tr)
        if self.recorder is not None:
            self.recorder.on_transfer(self.device_id, tr, PREFETCH)
        return tr

    def promote(self, tr: Transfer, now: float) -> Transfer:
        """A start demands weights whose prefetch is still in flight:
        the remaining bytes finish at demand priority (the bytes already
        landed are not copied again)."""
        self._advance(now)
        if tr in self.queue:
            self.queue.remove(tr)
            rem = tr.remaining_ms
            tr.remaining_ms = 0.0
            tr.kind = DEMAND
            tr.done_ms = now + rem
            self.busy_ms += rem
            self.demand_ms += rem
            self.block_until = max(self.block_until, tr.done_ms)
            if self.recorder is not None:
                self.recorder.on_promote(self.device_id, tr.func, now)
        return tr

    def cancel(self, tr: Transfer) -> None:
        """Abandon a queued prefetch (its target was demoted or
        expired).  Work already performed stays booked — those bytes
        really crossed the link — but the remaining bytes never do."""
        if tr in self.queue:
            self.queue.remove(tr)
            tr.remaining_ms = 0.0
            tr.done_ms = math.inf

    # ---- queries ------------------------------------------------------------
    def eta(self, tr: Transfer, now: float) -> float:
        """Predicted completion time of ``tr`` given the current queue
        and demand blockage (later demand copies may still push a
        queued prefetch out further — the estimate is a lower bound,
        which keeps planners optimistic, never pessimistic)."""
        self._advance(now)
        if tr not in self.queue:
            return tr.done_ms
        t = max(now, self.block_until)
        for q in self.queue:
            t += q.remaining_ms
            if q is tr:
                break
        return t

    def residual_ms(self, tr: Transfer, now: float) -> float:
        """Time until ``tr``'s weights are usable, 0 once landed."""
        return max(self.eta(tr, now) - now, 0.0)

    def check(self) -> None:
        """Engine invariants (driven by the device model's ``check``)."""
        if any(t.remaining_ms < 0 for t in self.queue):
            raise AssertionError("negative remaining transfer work")
        if not math.isclose(self.busy_ms, self.demand_ms + self.prefetch_ms,
                            rel_tol=1e-9, abs_tol=1e-6):
            raise AssertionError(
                f"PCIe work double-booked: busy {self.busy_ms} != "
                f"demand {self.demand_ms} + prefetch {self.prefetch_ms}")
