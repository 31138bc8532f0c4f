"""Flight recorder: span tracing + streaming metrics + planner audit.

The whole observability layer hangs off one :class:`Recorder` facade the
emulator, gateway, scheduler and device model call into through narrow
``on_*`` hooks.  Three components fan out behind it:

  * :class:`~repro.obs.tracer.SpanTracer` — per-request span traces,
    exported as Chrome-trace/Perfetto JSON;
  * :class:`~repro.obs.metrics.MetricsBus` — windowed gauge/counter/hist
    time-series sampled online on simulated time;
  * :class:`~repro.obs.audit.AuditLog` — one structured record per
    ``plan()`` call and per sparse-skip decision, with predicted-vs-
    realized calibration back-filled at task completion.

The default is :data:`NULL_RECORDER`, a null object whose ``enabled``
flag is False: every instrumentation site guards with ``if
rec.enabled:`` so the disabled path allocates nothing, consumes no RNG,
and replays bit-identical to an uninstrumented build (the differential
tests in ``tests/test_observability.py`` pin all six serving scenarios).
Recording never feeds back into scheduling by itself — an enabled
recorder changes no decision, cost or SLO outcome.  Feedback is opt-in
and explicit: a :class:`~repro.obs.calibrate.ProfileCalibrator`
subscribed to the audit stream and handed to ``ESGScheduler``, and/or a
:class:`~repro.obs.health.HealthEngine` (``Recorder(health=...)``)
whose alerts the gateway and autoscaler may consume.  With neither
attached, recorded runs replay bit-identically.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.obs.audit import AuditLog, PlanRecord, RetryRecord, SkipRecord
from repro_torch.obs.calibrate import ProfileCalibrator
from repro_torch.obs.health import AlertRecord, HealthEngine
from repro_torch.obs.metrics import COUNTER, GAUGE, HIST, MetricsBus
from repro_torch.obs.tracer import SpanTracer, StepTracer

__all__ = ["Recorder", "NullRecorder", "NULL_RECORDER", "SpanTracer",
           "StepTracer",
           "MetricsBus", "AuditLog", "PlanRecord", "SkipRecord",
           "RetryRecord", "ProfileCalibrator", "HealthEngine",
           "AlertRecord"]


class NullRecorder:
    """Disabled recorder: one shared instance, no state, no overhead.

    Every hook site checks ``enabled`` before doing *any* work, so the
    null object needs no methods at all — it is a flag, not a stub."""
    enabled = False

    def __repr__(self):
        return "NullRecorder()"


NULL_RECORDER = NullRecorder()


class Recorder:
    """Enabled flight recorder wired through ``ClusterSim(recorder=...)``.

    Any of the three components can be switched off at construction
    (e.g. metrics-only sampling for a dashboard feed); the hooks skip
    absent components.
    """
    enabled = True

    def __init__(self, trace: bool = True, metrics: bool = True,
                 audit: bool = True, window_ms: float = 1000.0,
                 health: Optional[HealthEngine] = None):
        self.tracer: Optional[SpanTracer] = SpanTracer() if trace else None
        self.metrics: Optional[MetricsBus] = \
            MetricsBus(window_ms=window_ms) if metrics else None
        self.audit: Optional[AuditLog] = AuditLog() if audit else None
        # the health engine rides the streaming side of the bus: its
        # per-window feeds (queue depth, cold-start and prefetch-waste
        # counts) come out of the same snapshot the metrics gauges use
        if health is not None and self.metrics is None:
            raise ValueError("HealthEngine requires metrics=True (it is "
                             "fed from the metrics windows)")
        self.health: Optional[HealthEngine] = health
        if health is not None and self.audit is not None:
            health.attach_audit(self.audit)
        self._pf_wasted_seen = 0
        # delta trackers for cumulative emulator/engine counters sampled
        # per event into windowed counter series
        self._xfer_seen = (0.0, 0.0)     # (demand_ms, prefetch_ms)
        self._sheds_seen = 0
        # gauge sampling is throttled to one snapshot per metrics window
        # (the cluster-wide sums are O(invokers) — cheap once a second of
        # sim time, hot if taken on every event)
        self._last_win = -1
        # hot-path handles: the per-event/per-task hooks run inside the
        # emulator's inner loop, so they update the bus's window dicts
        # directly instead of going through inc()/observe() each time
        # (same cells, same math — just no per-call dispatch)
        self._evt_data: dict[str, dict] = {}
        # bind_sim fills these so the per-window snapshot walks plain
        # lists instead of attribute chains over the invoker fleet
        self._devices: list = []
        self._total_slices = 0
        if self.metrics:
            m = self.metrics
            self._wms = m.window_ms
            self._m_tasks = m._data("tasks", COUNTER)
            self._m_jobs = m._data("jobs", COUNTER)
            self._m_cold = m._data("cold_starts", COUNTER)
            self._m_plans = m._data("plans", COUNTER)
            self._m_qwait = m._data("queue_wait_ms", HIST)
            self._m_exec = m._data("exec_ms", HIST)
            gd = GAUGE
            self._g_depth = m._data("queue_depth", gd)
            self._g_running = m._data("running_tasks", gd)
            self._g_slices = m._data("slices_used", gd)
            self._g_util = m._data("slice_util", gd)
            self._g_hbm = m._data("hbm_used_mb", gd)
            self._m_xfer_d = m._data("xfer_demand_ms", COUNTER)
            self._m_xfer_p = m._data("xfer_prefetch_ms", COUNTER)

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def bind_sim(self, sim) -> "Recorder":
        """Attach to a ClusterSim: point every invoker's device + engine
        back at this recorder so transfer/demotion events land on the
        right device track."""
        for inv in sim.invokers:
            inv.device.recorder = self
            inv.device.device_id = inv.idx
            inv.device.engine.recorder = self
            inv.device.engine.device_id = inv.idx
        self._devices = [inv.device for inv in sim.invokers]
        self._total_slices = sum(d.total_slices for d in self._devices)
        return self

    # ------------------------------------------------------------------
    # gateway
    # ------------------------------------------------------------------
    def on_injected(self, app: str, now: float):
        if self.metrics:
            self.metrics.inc("injected", now)

    def on_admitted(self, inst, now: float):
        if self.tracer:
            self.tracer.begin_request(inst.uid, inst.app.name, now)
        if self.metrics:
            self.metrics.inc("admitted", now)

    def on_shed(self, inst, now: float, budget_ms: float, need_ms: float):
        if self.tracer:
            self.tracer.shed_request(inst.uid, inst.app.name, now,
                                     budget_ms, need_ms)
        if self.metrics:
            self.metrics.inc("shed", now)
        if self.health:
            self.health.on_shed(inst.app.name, now)

    # ------------------------------------------------------------------
    # emulator lifecycle
    # ------------------------------------------------------------------
    def on_dispatch(self, sim, task):
        now = sim.now
        if self.metrics:
            w = int(now // self._wms)
            d = self._m_tasks
            d[w] = d.get(w, 0.0) + 1.0
            d = self._m_jobs
            d[w] = d.get(w, 0.0) + len(task.jobs)
            if task.cold:
                d = self._m_cold
                d[w] = d.get(w, 0.0) + 1.0
            dq = self._m_qwait
            start = task.start_ms
            for job in task.jobs:
                v = start - job.ready_ms
                if v < 0.0:
                    v = 0.0
                cell = dq.get(w)
                if cell is None:
                    dq[w] = [1, v, v, v]
                else:
                    cell[0] += 1
                    cell[1] += v
                    if v < cell[2]:
                        cell[2] = v
                    if v > cell[3]:
                        cell[3] = v
        if self.audit:
            # predicted from the *controller's* view (the planner's
            # ProfileTable, which may diverge from the emulator's ground
            # truth under injected skew or drift), split into the raw
            # profile estimate and the planner's working prediction
            # (raw x the calibrator's published correction + penalty) —
            # identical when no calibrator is attached
            app_name = task.jobs[0].inst.app.name
            raw = sim.tables[task.func].fn.exec_ms(task.config)
            cal = getattr(sim.sched, "calibrator", None)
            f = cal.factor(app_name, task.stage) \
                if cal is not None and cal.active else 1.0
            self.audit.on_dispatch(
                app_name, task.stage, task.tid, task.config,
                predicted_ms=raw * f + task.penalty_ms,
                predicted_raw_ms=raw)

    def on_task_complete(self, sim, task):
        now = sim.now
        if self.metrics:
            w = int(now // self._wms)
            v = now - task.exec_start_ms
            de = self._m_exec
            cell = de.get(w)
            if cell is None:
                de[w] = [1, v, v, v]
            else:
                cell[0] += 1
                cell[1] += v
                if v < cell[2]:
                    cell[2] = v
                if v > cell[3]:
                    cell[3] = v
        if self.audit:
            self.audit.on_complete(task.tid, now - task.start_ms,
                                   realized_exec_ms=now - task.exec_start_ms)
        if self.health:
            for job in task.jobs:
                inst = job.inst
                if inst.done and inst.finish_ms == now:
                    ok = inst.finish_ms - inst.arrival_ms <= inst.slo_ms
                    self.health.on_request(inst.app.name, now, ok)
        if self.tracer:
            args = {"stage": task.stage, "func": task.func,
                    "config": task.config, "tier": task.tier,
                    "invoker": task.invoker,
                    "quota_slices": task.quota_slices,
                    "penalty_ms": task.penalty_ms,
                    "hidden_ms": task.full_penalty_ms - task.penalty_ms,
                    "cold": task.cold}
            for job in task.jobs:
                self.tracer.stage_spans(
                    job.inst.uid, task.stage, job.ready_ms, task.start_ms,
                    task.exec_start_ms, now, args)
                inst = job.inst
                if inst.done and inst.finish_ms == now:
                    self.tracer.end_request(inst.uid, now, inst.slo_ms)

    def on_resize(self, sim, task, old_slices: int, new_slices: int):
        now = sim.now
        if self.metrics:
            self.metrics.inc("resizes", now)
        if self.tracer:
            for job in task.jobs:
                self.tracer.resize_instant(job.inst.uid, now, task.invoker,
                                           old_slices, new_slices)

    def on_plan_result(self, rec: PlanRecord):
        if self.audit:
            self.audit.on_plan(rec)

    def on_sparse_skip(self, now: float, app: str, stage: str,
                       certificate: Any, recheck: int):
        if self.audit:
            self.audit.on_skip(now, app, stage, certificate, recheck)
        if self.metrics:
            self.metrics.inc("sparse_skips", now)

    def on_prefetch_issued(self, now: float, n: int):
        if self.metrics and n:
            self.metrics.inc("prefetch_enqueued", now, n)

    def on_retire(self, now: float):
        if self.metrics:
            self.metrics.inc("retires", now)

    # ------------------------------------------------------------------
    # preemptible fleet (spot reclamations)
    # ------------------------------------------------------------------
    def on_reclaim_warning(self, now: float, inv_idx: int):
        if self.metrics:
            self.metrics.inc("reclaim_warnings", now)
        if self.tracer:
            self.tracer.reclaim_instant(inv_idx, now, "reclaim_warning")

    def on_reclaim(self, now: float, inv_idx: int, n_killed: int):
        if self.metrics:
            self.metrics.inc("reclamations", now)
        if self.tracer:
            self.tracer.reclaim_instant(inv_idx, now, "reclaim",
                                        {"killed_tasks": n_killed})

    def on_recover(self, now: float, inv_idx: int):
        if self.metrics:
            self.metrics.inc("recoveries", now)
        if self.tracer:
            self.tracer.reclaim_instant(inv_idx, now, "recover")

    def on_preempt(self, sim, task, lost_ms: float):
        """A running task was killed mid-execution by a reclamation."""
        now = sim.now
        if self.metrics:
            self.metrics.inc("preemptions", now)
            if lost_ms > 0.0:
                self.metrics.inc("preempt_lost_ms", now, lost_ms)
        if self.audit:
            # the partial run must never back-fill calibration
            self.audit.on_preempted(task.tid)
        if self.tracer:
            args = {"stage": task.stage, "func": task.func,
                    "invoker": task.invoker, "config": task.config,
                    "lost_ms": lost_ms}
            for job in task.jobs:
                self.tracer.preempt_span(job.inst.uid, task.stage,
                                         task.start_ms, now, args)

    def on_retry_decision(self, now: float, app: str, stage: str, uid: int,
                          invoker: int, attempt: int, action: str,
                          backoff_ms: float, lost_ms: float):
        if self.audit:
            self.audit.on_retry(now, app, stage, uid, invoker, attempt,
                                action, backoff_ms, lost_ms)
        if self.metrics:
            self.metrics.inc(
                "preempt_shed" if action == "shed" else "retries", now)

    def on_migrate(self, now: float, inv_idx: int, moved: int):
        if self.metrics and moved:
            self.metrics.inc("migrations", now, moved)
        if self.tracer:
            self.tracer.reclaim_instant(inv_idx, now, "migrate",
                                        {"moved": moved})

    # ------------------------------------------------------------------
    # device / transfer engine
    # ------------------------------------------------------------------
    def on_transfer(self, device_id: int, transfer, issued_as: str):
        if self.tracer:
            self.tracer.note_transfer(device_id, transfer, issued_as)

    def on_promote(self, device_id: int, func: str, now: float):
        if self.tracer:
            self.tracer.promote_instant(device_id, func, now)

    def on_demotion(self, device_id: int, func: str, now: float):
        if self.tracer:
            self.tracer.demotion_instant(device_id, func, now)
        if self.metrics:
            self.metrics.inc("demotions", now)

    # ------------------------------------------------------------------
    # per-event sampling (the streaming side of the bus)
    # ------------------------------------------------------------------
    def on_event(self, sim, kind: str):
        m = self.metrics
        if m is None:
            return
        now = sim.now
        d = self._evt_data.get(kind)
        if d is None:
            d = self._evt_data[kind] = m._data("events." + kind, COUNTER)
        win = int(now // self._wms)
        d[win] = d.get(win, 0.0) + 1.0
        # cluster-wide gauges: first event of each window snapshots them
        if win == self._last_win:
            return
        prev_win = self._last_win
        self._last_win = win
        used = 0
        hbm = demand = pref = 0.0
        for dev in self._devices:
            used += dev.used_slices
            hbm += dev.hbm_used_mb
            eng = dev.engine
            demand += eng.demand_ms
            pref += eng.prefetch_ms
        total = self._total_slices
        depth = sum(len(q) for q in sim.queues.values())
        self._g_depth[win] = depth
        self._g_running[win] = len(sim.running)
        self._g_slices[win] = used
        self._g_util[win] = used / total if total else 0.0
        self._g_hbm[win] = hbm
        # transfer-link busy split: cumulative engine counters turned
        # into per-window deltas
        d0, p0 = self._xfer_seen
        if demand > d0:
            dd = self._m_xfer_d
            dd[win] = dd.get(win, 0.0) + (demand - d0)
        if pref > p0:
            dp = self._m_xfer_p
            dp[win] = dp.get(win, 0.0) + (pref - p0)
        self._xfer_seen = (demand, pref)
        if self.health is not None:
            # anomaly feeds: the just-closed window's cold-start count,
            # the wasted-prefetch delta since the last snapshot, and the
            # instantaneous queue depth
            wasted = sum(dev.stats.prefetch_wasted
                         for dev in self._devices)
            self.health.on_window(now, depth,
                                  self._m_cold.get(prev_win, 0.0),
                                  wasted - self._pf_wasted_seen)
            self._pf_wasted_seen = wasted

    def on_plan_timed(self, sim):
        if self.metrics:
            d = self._m_plans
            w = int(sim.now // self._wms)
            d[w] = d.get(w, 0.0) + 1.0

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def calibration(self) -> dict[str, Any]:
        return self.audit.calibration() if self.audit else {}

    def export(self, trace_path: Optional[str] = None,
               metrics_path: Optional[str] = None,
               audit_path: Optional[str] = None,
               health_path: Optional[str] = None) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if trace_path and self.tracer:
            out["trace"] = trace_path
            self.tracer.export_chrome_trace(trace_path)
        if metrics_path and self.metrics:
            out["metrics"] = metrics_path
            self.metrics.export(metrics_path)
        if audit_path and self.audit:
            out["audit"] = audit_path
            self.audit.export_jsonl(audit_path)
        if health_path and self.health:
            out["health"] = health_path
            self.health.export_jsonl(health_path)
        return out
