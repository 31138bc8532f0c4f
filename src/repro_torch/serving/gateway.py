"""Admission-control gateway: open-loop injection + load shedding.

The gateway fronts the cluster emulator the way an OpenWhisk controller's
edge fronts invokers: a scenario's request trace is injected open-loop
(arrivals do not wait for completions), and each request passes an
admission check *at its arrival time in simulated time*.  Requests that
are already doomed — their remaining SLO budget cannot cover even the
fastest possible execution plus the predicted queueing — are shed at the
door instead of wasting GPU time on a guaranteed miss (the
Torpor/FaaSwap observation that queueing doomed work poisons the pool).

The queueing predictor is a **per-stage queueing-delay EWMA**: realized
queue waits (task start minus job ready, observed as tasks dispatch) are
folded into one EWMA per (app, stage), and an arrival's predicted delay
is the critical-path sum of its stages' EWMAs.  This replaces the old
fleet-averaged backlog estimate, which smeared one hot stage's queue
over every invoker.  Every shed decision is logged with its budget and
prediction so telemetry can score *shed precision* after the run (true
sheds — requests that would indeed have missed — vs false sheds).

Admitted requests flow into the emulator's per-(app, stage) AFW queues
unchanged; the scheduler under test never sees shed traffic.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.cluster.workload import critical_path, min_config_latency
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.traces import Scenario


class Gateway:
    """Admission-control front end over a ``ClusterSim``.

    ``shed_doomed=False`` turns the gateway into a pure injector (every
    arrival admitted) — the ablation baseline.  ``backlog_aware=False``
    drops the queueing-delay term from the admission check (the doomed
    test then uses the empty-cluster fastest path only).
    """

    def __init__(self, sim, telemetry: Optional[Telemetry] = None,
                 shed_doomed: bool = True, backlog_aware: bool = True,
                 qdelay_alpha: float = 0.3, health=None,
                 health_headroom: float = 1.5):
        self.sim = sim
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.shed_doomed = shed_doomed
        self.backlog_aware = backlog_aware
        self.qdelay_alpha = qdelay_alpha
        # SLO health engine (repro.obs.health): while an alert relevant
        # to the arriving app is firing, the predicted-queueing term is
        # inflated by ``health_headroom`` — the EWMA lags exactly when
        # the burn-rate/queue-buildup detectors say conditions are
        # deteriorating, so admission turns pessimistic early instead
        # of queueing doomed work through the whole burn.  None (the
        # default) changes nothing.
        self.health = health
        self.health_headroom = health_headroom
        # per-(app, stage) EWMA of realized queueing delay
        self._qdelay: dict[tuple[str, str], float] = {}
        self._tasks_seen = 0
        # fastest possible end-to-end time per app: critical path with every
        # stage at its profile-lattice minimum latency
        self._fastest_ms = {
            name: critical_path(
                app, lambda s, a=app: float(sim.tables[a.func_of[s]].min_time))
            for name, app in sim.apps.items()
        }
        self.telemetry.fastest_ms = dict(self._fastest_ms)
        sim.admission = self._admit
        if getattr(sim, "retain", "full") == "stream":
            # a streaming sim keeps no task list to scan, so dispatches
            # reach the EWMAs through a feed the sim appends to at
            # dispatch time — only created when this gateway will
            # actually drain it (otherwise it would grow unboundedly)
            self.telemetry.attach_stream(sim)
            if self.backlog_aware and self.shed_doomed:
                from collections import deque
                sim.dispatch_feed = deque()

    # ---- queueing-delay model ----------------------------------------------
    def _ingest_dispatches(self) -> None:
        """Fold queue waits of tasks dispatched since the last admission
        decision into the per-stage EWMAs (``sim.tasks`` is appended in
        nondecreasing simulated time, so this is an online pass)."""
        feed = self.sim.dispatch_feed
        if feed is not None:
            # stream mode: the sim pushed (app, stage, wait) per job at
            # dispatch, in exactly the order the task-list scan below
            # would visit them — the EWMA folds are bit-identical
            a = self.qdelay_alpha
            qd = self._qdelay
            while feed:
                app, stage, wait = feed.popleft()
                key = (app, stage)
                prev = qd.get(key)
                qd[key] = wait if prev is None \
                    else (1.0 - a) * prev + a * wait
            return
        tasks = self.sim.tasks
        a = self.qdelay_alpha
        while self._tasks_seen < len(tasks):
            t = tasks[self._tasks_seen]
            self._tasks_seen += 1
            key = (t.jobs[0].inst.app.name, t.stage)
            for j in t.jobs:
                wait = max(t.start_ms - j.ready_ms, 0.0)
                prev = self._qdelay.get(key)
                self._qdelay[key] = wait if prev is None \
                    else (1.0 - a) * prev + a * wait

    def predicted_queueing_ms(self, app) -> float:
        """Critical-path sum of the per-stage queueing-delay EWMAs."""
        if not self.backlog_aware:
            return 0.0
        self._ingest_dispatches()
        return critical_path(
            app, lambda s: self._qdelay.get((app.name, s), 0.0))

    # ---- admission ---------------------------------------------------------
    def _admit(self, sim, inst) -> bool:
        self.telemetry.on_injected(inst.app.name)
        rec = getattr(sim, "recorder", None)
        recording = rec is not None and rec.enabled
        if recording:
            rec.on_injected(inst.app.name, sim.now)
        if self.health is not None and getattr(sim, "_has_spot", False):
            # While any burn-rate/queue-buildup alert is firing, steer new
            # placements off spot capacity: reclamation rework is the last
            # thing a burning SLO needs.  Clears itself when alerts clear.
            sim.prefer_on_demand = bool(self.health.early_warning())
        if self.shed_doomed:
            budget = inst.deadline_ms - sim.now
            fastest = self._fastest_ms[inst.app.name]
            queueing = self.predicted_queueing_ms(inst.app)
            if self.health is not None \
                    and self.health.early_warning(inst.app.name):
                queueing *= self.health_headroom
            need = fastest + queueing
            if need > budget:
                self.telemetry.on_shed(inst.app.name, t_ms=sim.now,
                                       budget_ms=budget, need_ms=need,
                                       fastest_ms=fastest)
                if recording:
                    rec.on_shed(inst, sim.now, budget, need)
                return False
        self.telemetry.on_admitted(inst.app.name)
        return True

    # ---- injection ---------------------------------------------------------
    def inject(self, scenario: Scenario, n: int, seed: int = 0,
               slo_mult: float = 1.0,
               app_names: Optional[Sequence[str]] = None,
               stream: bool = False) -> dict[str, float]:
        """Open-loop injection of ``n`` scenario arrivals.

        SLOs follow the paper's rule: ``slo_mult`` x the app's
        minimum-configuration end-to-end latency L.  Returns the SLO map.

        ``stream=True`` feeds arrivals lazily through
        ``sim.add_arrival_stream`` (one pending heap entry at a time,
        bit-identical replay) instead of materializing ``n``
        ``AppInstance`` objects up front — the day-scale path.
        """
        sim = self.sim
        app_names = list(app_names or sim.apps)
        slos = {a: slo_mult * min_config_latency(sim.apps[a], sim.profiles)
                for a in app_names}
        if stream:
            sim.add_arrival_stream(
                ((arr.app, arr.t_ms, slos[arr.app], arr.uid)
                 for arr in scenario.arrivals(app_names, n, seed)), n)
        else:
            for arr in scenario.arrivals(app_names, n, seed):
                sim.add_arrival(arr.app, arr.t_ms, slos[arr.app], arr.uid)
        return slos

    # ---- results -----------------------------------------------------------
    def run(self) -> Telemetry:
        """Drive the emulator to quiescence and collect telemetry."""
        self.sim.run()
        self.telemetry.collect(self.sim)
        return self.telemetry
