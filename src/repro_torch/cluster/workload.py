"""Workload generation (paper §4.1).

Job arrival intervals drawn uniformly from the paper's Azure-trace-derived
ranges: heavy [10, 16.8]ms, normal [20, 33.6]ms, light [40, 67.2]ms; each
arrival randomly picks one of the four applications.  SLO settings: strict
0.8 x L, moderate 1.0 x L, relaxed 1.2 x L, where L is the app's end-to-end
minimum-configuration latency.  The paper pairs them as strict-light,
moderate-normal and relaxed-heavy.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.profiles import Config, FunctionProfile
from repro_torch.core.workflows import Workflow

INTERVALS_MS = {
    "heavy": (10.0, 16.8),
    "normal": (20.0, 33.6),
    "light": (40.0, 67.2),
}
SLO_MULT = {"strict": 0.8, "moderate": 1.0, "relaxed": 1.2}
SETTINGS = {
    "strict-light": ("strict", "light"),
    "moderate-normal": ("moderate", "normal"),
    "relaxed-heavy": ("relaxed", "heavy"),
}


def critical_path(app: Workflow, stage_time) -> float:
    """Longest root->sink path with per-stage times from ``stage_time``."""
    memo: dict[str, float] = {}

    def longest(stage: str) -> float:
        if stage in memo:
            return memo[stage]
        t = stage_time(stage)
        succ = app.edges.get(stage, ())
        memo[stage] = t + (max(longest(s) for s in succ) if succ else 0.0)
        return memo[stage]

    return max(longest(r) for r in app.roots)


def min_config_latency(app: Workflow,
                       profiles: dict[str, FunctionProfile]) -> float:
    """L — end-to-end time alone at the minimum configuration (1,1,1)."""
    c = Config(1, 1, 1)
    return critical_path(app, lambda s: profiles[app.func_of[s]].exec_ms(c))


def generate(sim, setting: str, n_arrivals: int,
             profiles: dict[str, FunctionProfile],
             seed: int = 0):
    """Feed ``n_arrivals`` application invocations into the simulator."""
    slo_name, load_name = SETTINGS[setting]
    lo, hi = INTERVALS_MS[load_name]
    mult = SLO_MULT[slo_name]
    rng = np.random.default_rng(seed)
    app_names = list(sim.apps)
    slos = {a: mult * min_config_latency(sim.apps[a], profiles)
            for a in app_names}
    t = 0.0
    for uid in range(n_arrivals):
        t += rng.uniform(lo, hi)
        app = app_names[rng.integers(len(app_names))]
        sim.add_arrival(app, t, slos[app], uid)
    return slos
