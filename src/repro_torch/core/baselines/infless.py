"""INFless [Yang et al., ASPLOS'22] baseline (paper §4.2).

Per-function enumeration without inter-function relations: the app SLO is
distributed to stages proportionally to average service times (GrandSLAm
style, as the ESG paper does for it), then each stage independently picks —
among configs meeting its share — the one maximising *resource efficiency*
(throughput per $-rate).  Node selection minimises resource fragmentation
(handled by placement='fragmentation' in the emulator).
"""
from __future__ import annotations

from repro_torch.core.profiles import Config, ProfileTable
from repro_torch.core.workflows import Workflow
from repro_torch.cluster.emulator import ClusterSim, Job, SchedulerPolicy
from repro_torch.core.profiles import VCPU_PRICE_PER_H, VGPU_PRICE_PER_H


def service_time_shares(app: Workflow,
                        tables: dict[str, ProfileTable]) -> dict[str, float]:
    means = {s: tables[app.func_of[s]].mean_time() for s in app.stages}
    total = sum(means.values())
    return {s: m / total for s, m in means.items()}


class INFlessScheduler(SchedulerPolicy):
    name = "INFless"
    placement = "fragmentation"

    def __init__(self, apps: dict[str, Workflow],
                 tables: dict[str, ProfileTable], k: int = 5):
        self.tables = tables
        self.k = k
        self.shares = {n: service_time_shares(a, tables)
                       for n, a in apps.items()}

    def plan(self, sim: ClusterSim, app: Workflow, stage: str,
             jobs: list[Job], now: float) -> list[Config]:
        share = self.shares[app.name][stage]
        slo = max(j.inst.slo_ms for j in jobs)
        stage_slo = slo * share
        tbl = self.tables[app.func_of[stage]].restrict_batch(max(len(jobs), 1))
        # among stage-SLO-feasible configs, maximise throughput — INFless's
        # resource-efficiency metric prefers saturating one invoker, which
        # over-allocates ("highest resource costs", paper §5.1/§5.2)
        scored = []
        for i, c in enumerate(tbl.configs):
            if tbl.times[i] >= stage_slo:
                continue
            thr = c.batch / tbl.times[i]
            rate = c.vcpu * VCPU_PRICE_PER_H + c.vgpu * VGPU_PRICE_PER_H
            scored.append((thr / (1.0 + 0.02 * rate), -tbl.times[i], i))
        scored.sort(reverse=True)
        if not scored:                                   # infeasible: fastest
            return [tbl.configs[0]]
        return [tbl.configs[i] for _, _, i in scored[: self.k]]
