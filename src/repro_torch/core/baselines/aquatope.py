"""Aquatope [Zhou et al., ASPLOS'23] baseline, extended with vGPU (paper §4.2).

Bayesian-optimisation-style offline training: 100 bootstrap samples, then
50 rounds x 5 candidates guided by a k-NN surrogate with a UCB acquisition,
optimising  cost + penalty * P(e2e > SLO)  under the noisy latency model.
Offline training assumes saturating traffic (batches always fill), which is
exactly why its static plans miss at runtime when actual queues are shorter
than the planned batch (paper Table 4: 59-86% misses).

Deployment is static: the learned per-stage configs are used unchanged;
misses are recorded and the batch clipped.  Training happens once per
(app, SLO); scheduling overhead at runtime is negligible (paper §5.2).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.profiles import (BATCHES, VCPUS, VGPUS, Config, ProfileTable,
                                 VCPU_PRICE_PER_H, VGPU_PRICE_PER_H)
from repro_torch.core.workflows import Workflow
from repro_torch.cluster.emulator import ClusterSim, Job, SchedulerPolicy

BOOTSTRAP = 100
ROUNDS = 50
PER_ROUND = 5
PENALTY = 10.0


class AquatopeScheduler(SchedulerPolicy):
    name = "Aquatope"
    placement = "locality"
    static_plan = True

    def __init__(self, apps: dict[str, Workflow],
                 tables: dict[str, ProfileTable],
                 noise_sigma: float = 0.05, seed: int = 0, k: int = 1):
        self.tables = tables
        self.noise_sigma = noise_sigma
        self.rng = np.random.default_rng(seed)
        self._plans: dict[tuple[str, float], dict[str, Config]] = {}

    # ---- noisy objective ---------------------------------------------------
    def _objective(self, app: Workflow, cfgs: dict[str, Config],
                   slo_ms: float, n_eval: int = 8) -> float:
        lat = np.zeros(n_eval)
        cost = 0.0
        for s in app.stages:
            c = cfgs[s]
            t = self.tables[app.func_of[s]].fn.exec_ms(c)
            lat += t * np.clip(
                1.0 + self.rng.normal(0.0, self.noise_sigma, n_eval), 0.5, 2.0)
            rate = c.vcpu * VCPU_PRICE_PER_H + c.vgpu * VGPU_PRICE_PER_H
            cost += rate * t / 3.6e6 / c.batch
        viol = float((lat > slo_ms).mean())
        return cost * 1e4 + PENALTY * viol

    def _vec(self, cfgs, app):
        return np.array([[np.log2(cfgs[s].batch), cfgs[s].vcpu, cfgs[s].vgpu]
                         for s in app.stages]).ravel()

    def _train(self, app: Workflow, slo_ms: float) -> dict[str, Config]:
        def sample():
            return {s: Config(int(self.rng.choice(BATCHES)),
                              int(self.rng.choice(VCPUS)),
                              int(self.rng.choice(VGPUS)))
                    for s in app.stages}

        xs, ys, cfg_list = [], [], []
        for _ in range(BOOTSTRAP):
            cfgs = sample()
            xs.append(self._vec(cfgs, app))
            ys.append(self._objective(app, cfgs, slo_ms))
            cfg_list.append(cfgs)
        for _ in range(ROUNDS):
            cands = [sample() for _ in range(PER_ROUND * 4)]
            # k-NN surrogate + UCB: predicted mean - beta * nn-distance
            x_arr = np.stack(xs)
            y_arr = np.array(ys)
            scores = []
            for cfgs in cands:
                v = self._vec(cfgs, app)
                d = np.linalg.norm(x_arr - v, axis=1)
                nn = np.argsort(d)[:5]
                wgt = 1.0 / (d[nn] + 1e-6)
                mean = float((y_arr[nn] * wgt).sum() / wgt.sum())
                scores.append(mean - 0.5 * float(d[nn].min()))
            picked = np.argsort(scores)[:PER_ROUND]
            for p in picked:
                cfgs = cands[int(p)]
                xs.append(self._vec(cfgs, app))
                ys.append(self._objective(app, cfgs, slo_ms))
                cfg_list.append(cfgs)
        return cfg_list[int(np.argmin(ys))]

    # ---- policy ------------------------------------------------------------
    def plan(self, sim: ClusterSim, app: Workflow, stage: str,
             jobs: list[Job], now: float) -> list[Config]:
        slo = max(j.inst.slo_ms for j in jobs)
        key = (app.name, round(slo, 3))
        if key not in self._plans:
            self._plans[key] = self._train(app, slo)
        return [self._plans[key][stage]]
