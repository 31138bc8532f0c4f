"""Orion [Mahgoub et al., OSDI'22] baseline, extended with vGPU (paper §4.2).

Best-first search over the joint per-stage configuration vector: the start
state is minimum config everywhere; each expansion bumps one dimension
(batch, vcpu or vgpu) of one stage; the goal is estimated P95 end-to-end
latency <= SLO; the cheapest goal state wins.  If the search exceeds the
cut-off time before reaching the goal, the state with latency closest to
the SLO is returned.

The whole-workflow plan is decided at the first stage's invocation and
never adapted (the paper's critique): later stages reuse the stored plan;
when the planned batch exceeds the queue length a *config miss* is recorded
(Table 4) and the batch is clipped.  Search runs once per (app, SLO) — the
result is deterministic — but its measured duration is charged to every
instance's first-stage latency, exactly what Fig 9 varies.
"""
from __future__ import annotations

import heapq
import itertools
import time as _walltime

import numpy as np

from repro_torch.core.profiles import (BATCHES, VCPUS, VGPUS, Config, ProfileTable,
                                 VCPU_PRICE_PER_H, VGPU_PRICE_PER_H)
from repro_torch.core.workflows import Workflow
from repro_torch.cluster.emulator import ClusterSim, Job, SchedulerPolicy

P95_Z = 1.645


class OrionScheduler(SchedulerPolicy):
    name = "Orion"
    placement = "locality"
    static_plan = True

    def __init__(self, apps: dict[str, Workflow],
                 tables: dict[str, ProfileTable],
                 cutoff_ms: float = 100.0, noise_sigma: float = 0.05,
                 k: int = 1):
        self.tables = tables
        self.cutoff_ms = cutoff_ms
        self.noise_sigma = noise_sigma
        self._plans: dict[tuple[str, float], tuple[dict, float]] = {}
        self._charged_insts: set[int] = set()
        self.charged_overhead_ms = 0.0

    # ---- search -----------------------------------------------------------
    def _p95(self, app: Workflow, cfgs: dict[str, Config]) -> float:
        t = sum(self.tables[app.func_of[s]].fn.exec_ms(cfgs[s])
                for s in app.stages)
        return t * (1.0 + P95_Z * self.noise_sigma)

    def _cost(self, app: Workflow, cfgs: dict[str, Config]) -> float:
        out = 0.0
        for s in app.stages:
            c = cfgs[s]
            rate = c.vcpu * VCPU_PRICE_PER_H + c.vgpu * VGPU_PRICE_PER_H
            out += rate * self.tables[app.func_of[s]].fn.exec_ms(c) / 3.6e6 / c.batch
        return out

    def _search(self, app: Workflow, slo_ms: float) -> tuple[dict, float]:
        t0 = _walltime.perf_counter()
        dims = {"batch": BATCHES, "vcpu": VCPUS, "vgpu": VGPUS}
        start = tuple((1, 1, 1) for _ in app.stages)
        seen = {start}
        tie = itertools.count()

        def to_cfgs(state):
            return {s: Config(*state[i]) for i, s in enumerate(app.stages)}

        def score(state):
            cfgs = to_cfgs(state)
            return self._p95(app, cfgs), self._cost(app, cfgs)

        p95_0, cost_0 = score(start)
        heap = [(cost_0, next(tie), start, p95_0)]
        # Orion's "three rights": sizing targets P95 <= SLO; *bundling*
        # prefers consolidating invocations — among near-cost-tied feasible
        # states it picks the largest batch.  That preference is what makes
        # its static plans miss at runtime when queues are shorter than the
        # planned batch (Table 4).
        best_near = (abs(p95_0 - slo_ms), 0.0, start)
        feasible: list[tuple[float, tuple]] = []
        if p95_0 <= slo_ms:
            feasible.append((cost_0, start))
        while heap:
            if (_walltime.perf_counter() - t0) * 1e3 > self.cutoff_ms:
                break
            cost, _, state, p95 = heapq.heappop(heap)
            for i in range(len(app.stages)):
                for d, opts in enumerate(dims.values()):
                    vals = list(opts)
                    cur = state[i][d]
                    if cur not in vals or vals.index(cur) + 1 >= len(vals):
                        continue
                    nxt = vals[vals.index(cur) + 1]
                    ns = list(map(list, state))
                    ns[i][d] = nxt
                    ns = tuple(map(tuple, ns))
                    if ns in seen:
                        continue
                    seen.add(ns)
                    p, c = score(ns)
                    if p <= slo_ms:
                        feasible.append((c, ns))
                    if abs(p - slo_ms) < best_near[0]:
                        best_near = (abs(p - slo_ms), c, ns)
                    heapq.heappush(heap, (c, next(tie), ns, p))
        if feasible:
            c_min = min(c for c, _ in feasible)
            near_tied = [(s, c) for c, s in feasible if c <= 1.15 * c_min]
            state = max(near_tied,
                        key=lambda sc: (sum(b for b, _, _ in sc[0]), -sc[1]))[0]
        else:
            state = best_near[2]
        elapsed = (_walltime.perf_counter() - t0) * 1e3
        return to_cfgs(state), elapsed

    # ---- policy ------------------------------------------------------------
    def plan(self, sim: ClusterSim, app: Workflow, stage: str,
             jobs: list[Job], now: float) -> list[Config]:
        slo = max(j.inst.slo_ms for j in jobs)
        key = (app.name, round(slo, 3))
        if key not in self._plans:
            self._plans[key] = self._search(app, slo)
        cfgs, search_ms = self._plans[key]
        # search latency charged once per instance, at its first stage
        self.charged_overhead_ms = 0.0
        if stage in app.roots:
            fresh = [j.inst.uid for j in jobs
                     if j.inst.uid not in self._charged_insts]
            if fresh:
                self._charged_insts.update(fresh)
                self.charged_overhead_ms = search_ms
        return [cfgs[stage]]
