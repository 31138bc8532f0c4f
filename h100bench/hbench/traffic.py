"""Arrival schedules for a traffic mix, made from the run's seed.

The one generator every mix file goes through.  A mix file
(``h100bench/traffic/<name>.json``) gives the process and its parameters;
``arrivals(mix, seconds, seed)`` returns the arrival times in ms on the
window's clock.

``mmpp`` is the 2-state Markov-modulated Poisson process of the program's
scenario engine, copied here unchanged (``MMPPScenario._interval``,
``src/repro_torch/serving/traces.py:155-164``, with the loop of
``Scenario.iter_arrivals``, lines 72-85): after each arrival the chain
flips between the quiet and the burst state with probability
``p_switch``, and the burst state runs ``burst_factor`` times the quiet
rate.

So that every seed offers the same work, the process is drawn once, from
the mix's own ``shape_seed``, and cut into its dwell segments (the runs of
arrivals in one state); the run's seed then only permutes the quiet
segments among the quiet places and the burst segments among the burst
places.  Every seed gets the same number of arrivals, the same set of gaps
and the same bursts, in another order.  The gaps are scaled so that the
mean rate is exactly ``mean_rate_rps`` over the window: the mix's
``load_of_knee`` times the knee in the cell's own file
(``run.load_cell``).
"""
from __future__ import annotations

import numpy as np


def mmpp_gaps(n: int, seed: int, burst_factor: float, p_switch: float,
              mean_interval_ms: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """(gaps in ms, state of each arrival): ``n`` draws of the copied
    MMPP at a quiet-state mean gap of ``mean_interval_ms``."""
    rng = np.random.default_rng(seed)
    state = 0
    gaps, states = np.empty(n), np.empty(n, dtype=np.int64)
    for i in range(n):
        if rng.random() < p_switch:
            state = 1 - state
        mean = mean_interval_ms / burst_factor if state else mean_interval_ms
        gaps[i] = max(float(rng.exponential(mean)), 1e-6)
        states[i] = state
        # the scenario engine draws the app of each arrival next; one app
        rng.choice(1, p=[1.0])
    return gaps, states


def segments(states: np.ndarray) -> list[tuple[int, int, int]]:
    """(state, first, end) of each run of equal states."""
    out, first = [], 0
    for i in range(1, len(states) + 1):
        if i == len(states) or states[i] != states[first]:
            out.append((int(states[first]), first, i))
            first = i
    return out


def arrivals(mix: dict, seconds: float, seed: int,
             rate_rps: float | None = None) -> np.ndarray:
    """Arrival times (ms, ascending, all inside ``[0, seconds)``) of the
    mix over a window of ``seconds``; ``rate_rps`` overrides the mix's
    mean rate (a knee sweep)."""
    if mix["process"] != "mmpp":
        raise ValueError(f"unknown arrival process {mix['process']!r}")
    rate = float(rate_rps if rate_rps is not None else mix["mean_rate_rps"])
    n = max(int(round(rate * seconds)), 1)
    gaps, states = mmpp_gaps(n, int(mix["shape_seed"]),
                             float(mix["burst_factor"]),
                             float(mix["p_switch"]))
    segs = segments(states)
    rng = np.random.default_rng(seed)
    order = list(range(len(segs)))
    for s in (0, 1):
        places = [i for i, g in enumerate(segs) if g[0] == s]
        shuffled = [places[j] for j in rng.permutation(len(places))]
        for place, src in zip(places, shuffled):
            order[place] = src
    gaps = np.concatenate([gaps[segs[i][1]:segs[i][2]] for i in order])
    # the last arrival lands one mean gap before the window closes
    scale = seconds * 1e3 / (gaps.sum() + gaps.mean())
    return np.cumsum(gaps * scale)
