"""FaST-GShare [Gu et al. 2023] baseline (paper §4.2).

Enumeration-based scheduling on throughput performance metrics, no
inter-function relations (same GrandSLAm SLO split as INFless), GPU
fragmentation-minimising node selection.
"""
from __future__ import annotations

from repro_torch.core.profiles import Config, ProfileTable
from repro_torch.core.workflows import Workflow
from repro_torch.cluster.emulator import ClusterSim, Job, SchedulerPolicy
from repro_torch.core.baselines.infless import service_time_shares


class FaSTGShareScheduler(SchedulerPolicy):
    name = "FaST-GShare"
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
        scored = []
        for i, c in enumerate(tbl.configs):
            if tbl.times[i] >= stage_slo:
                continue
            thr = c.batch / tbl.times[i]                 # pure throughput
            scored.append((thr, -c.vgpu, i))
        scored.sort(reverse=True)
        if not scored:
            return [tbl.configs[0]]
        return [tbl.configs[i] for _, _, i in scored[: self.k]]
