"""Streaming metrics bus: windowed time-series sampled on simulated time.

Three series kinds, all bucketed into fixed windows of simulated
milliseconds (default 1 s):

  * **counter** — per-window sum of increments (tasks dispatched, plans
    run, sheds, PCIe demand/prefetch milliseconds, ...);
  * **gauge**   — last value observed in the window (queue depth, slice
    utilization, HBM occupancy, running tasks, ...);
  * **hist**    — per-window (count, sum, min, max) summary of observed
    values (queue waits, exec times, ...).

The bus is fed *online* from emulator/gateway/device hooks through the
flight recorder (``repro.obs.Recorder``) — no post-hoc scan of the run
— which is what a live dashboard, the ROADMAP's sharded-replay RSS
tracking and a Gym-style observation feed all need.  ``to_json`` /
``to_csv`` export the whole bus for dashboards;
``benchmarks/obs_overhead.py`` consumes it in CI.
"""
from __future__ import annotations

import csv
import json
import math
from typing import Any

COUNTER = "counter"
GAUGE = "gauge"
HIST = "hist"


class MetricsBus:
    def __init__(self, window_ms: float = 1000.0):
        if window_ms <= 0:
            raise ValueError(f"window_ms must be positive, got {window_ms}")
        self.window_ms = float(window_ms)
        # name -> (kind, {window_index -> value | [n, sum, min, max]})
        self.series: dict[str, tuple[str, dict[int, Any]]] = {}

    # ---- recording ---------------------------------------------------------
    def _win(self, t_ms: float) -> int:
        return int(t_ms // self.window_ms)

    def _data(self, name: str, kind: str) -> dict[int, Any]:
        got = self.series.get(name)
        if got is None:
            got = self.series[name] = (kind, {})
        elif got[0] != kind:
            raise ValueError(f"series {name!r} is a {got[0]}, not a {kind}")
        return got[1]

    def inc(self, name: str, t_ms: float, v: float = 1.0):
        d = self._data(name, COUNTER)
        w = self._win(t_ms)
        d[w] = d.get(w, 0.0) + v

    def gauge(self, name: str, t_ms: float, v: float):
        self._data(name, GAUGE)[self._win(t_ms)] = v

    def observe(self, name: str, t_ms: float, v: float):
        d = self._data(name, HIST)
        w = self._win(t_ms)
        cell = d.get(w)
        if cell is None:
            d[w] = [1, v, v, v]
        else:
            cell[0] += 1
            cell[1] += v
            cell[2] = min(cell[2], v)
            cell[3] = max(cell[3], v)

    # ---- queries -----------------------------------------------------------
    def total(self, name: str) -> float:
        """Sum of a counter across all windows (0.0 for unknown names)."""
        got = self.series.get(name)
        if got is None:
            return 0.0
        kind, d = got
        if kind != COUNTER:
            raise ValueError(f"series {name!r} is a {kind}, not a counter")
        return sum(d.values())

    def points(self, name: str) -> list[tuple[float, Any]]:
        """(window_start_ms, value) pairs in time order."""
        kind, d = self.series[name]
        return [(w * self.window_ms, d[w]) for w in sorted(d)]

    # ---- export ------------------------------------------------------------
    def as_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"window_ms": self.window_ms, "series": {}}
        for name in sorted(self.series):
            kind, _ = self.series[name]
            out["series"][name] = {
                "kind": kind,
                "points": [[t, v] if kind != HIST else [t, *v]
                           for t, v in self.points(name)],
            }
        return out

    def to_json(self, path: str) -> dict[str, Any]:
        doc = self.as_dict()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        return doc

    def to_csv(self, path: str) -> None:
        """Long-format CSV: one row per (series, window).  Hist windows
        fill count/sum/min/max, scalar kinds fill ``value``."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["series", "kind", "window_start_ms", "value",
                        "count", "sum", "min", "max"])
            for name in sorted(self.series):
                kind, _ = self.series[name]
                for t, v in self.points(name):
                    if kind == HIST:
                        w.writerow([name, kind, t, "", *v])
                    else:
                        w.writerow([name, kind, t, v, "", "", "", ""])

    def export(self, path: str):
        """Extension-dispatched export (.csv -> CSV, else JSON)."""
        if str(path).endswith(".csv"):
            return self.to_csv(path)
        return self.to_json(path)

    def rate_per_s(self, name: str) -> float:
        """Mean per-second rate of a counter over its observed span."""
        got = self.series.get(name)
        if not got or not got[1]:
            return 0.0
        kind, d = got
        span_ms = (max(d) - min(d) + 1) * self.window_ms
        return self.total(name) / span_ms * 1e3 if span_ms > 0 else math.inf
