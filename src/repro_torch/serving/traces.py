"""Trace-driven scenario engine (online-serving workloads).

Generalises ``cluster/workload.py`` beyond the paper's three
uniform-interval settings into a scenario library.  Every scenario is a
deterministic function of its seed: ``arrivals(app_names, n, seed)``
returns the same timestamped request stream on every call, so benchmark
sweeps and tests are exactly reproducible.

Catalogue (``SCENARIOS``):
  * ``uniform-{light,normal,heavy}`` — the paper's §4.1 Azure-derived
    uniform inter-arrival ranges (back-compat with ``workload.generate``).
  * ``diurnal``     — sinusoid-modulated Poisson process (day/night swing).
  * ``mmpp``        — 2-state Markov-modulated Poisson process (bursty
    traffic: quiet state / burst state with geometric dwell times).
  * ``flash-crowd`` — steady Poisson load with a sudden multi-x spike
    window (news-event traffic).
  * ``azure-tail``  — heavy-tailed (Lomax/Pareto-II) inter-arrivals, the
    shape reported for Azure Functions production traces.
  * ``skewed-mix``  — uniform arrivals but an 80/20 per-app traffic mix.
  * ``trace-replay`` — replay a recorded ``(t_ms, app)`` CSV (real
    Azure/production traces; see ``benchmarks/traces/``).
  * ``spot-storm``  — steady Poisson arrivals plus supply-side
    reclamation-storm windows for preemptible fleets.
  * ``hetero-mix``  — MMPP bursts aimed at a mixed-SKU fleet.

Add a scenario by subclassing ``Scenario`` (override ``_interval``, or
``arrivals`` for non-generative sources) and registering a factory in
``SCENARIOS``.
"""
from __future__ import annotations

import dataclasses
import gzip
import math
import zlib
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from repro_torch.cluster.workload import INTERVALS_MS


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of the injected trace."""
    uid: int
    t_ms: float
    app: str


class Scenario:
    """Base scenario: i.i.d. or state-dependent inter-arrival generator.

    ``app_weights`` maps app name -> relative traffic share (unknown apps
    are ignored, missing apps get weight 0 if any weight is given,
    otherwise the mix is uniform).
    """
    name = "base"

    def __init__(self, app_weights: Optional[dict[str, float]] = None):
        self.app_weights = app_weights

    # ---- subclass hooks ---------------------------------------------------
    def _reset(self, rng: np.random.Generator, n: int):
        """Called once per trace before interval generation."""

    def _interval(self, rng: np.random.Generator, i: int, t_ms: float) -> float:
        """Inter-arrival gap (ms) before request ``i`` at current time."""
        raise NotImplementedError

    # ---- public API -------------------------------------------------------
    def iter_arrivals(self, app_names: Sequence[str], n: int,
                      seed: int = 0):
        """Lazy generator form of ``arrivals`` — the identical sequence,
        one ``Arrival`` at a time (the day-scale streaming path: feed it
        to ``ClusterSim.add_arrival_stream`` and no arrival list is ever
        materialized)."""
        rng = np.random.default_rng(seed)
        self._reset(rng, n)
        probs = self._mix(app_names)
        t = 0.0
        for uid in range(n):
            t += max(float(self._interval(rng, uid, t)), 1e-6)
            app = app_names[int(rng.choice(len(app_names), p=probs))]
            yield Arrival(uid, t, app)

    def arrivals(self, app_names: Sequence[str], n: int,
                 seed: int = 0) -> list[Arrival]:
        return list(self.iter_arrivals(app_names, n, seed))

    def _mix(self, app_names: Sequence[str]) -> np.ndarray:
        if not self.app_weights:
            return np.full(len(app_names), 1.0 / len(app_names))
        w = np.array([max(float(self.app_weights.get(a, 0.0)), 0.0)
                      for a in app_names])
        if w.sum() <= 0:
            return np.full(len(app_names), 1.0 / len(app_names))
        return w / w.sum()


class UniformScenario(Scenario):
    """The paper's uniform-interval setting (workload.py semantics)."""
    name = "uniform"

    def __init__(self, lo_ms: float, hi_ms: float, **kw):
        super().__init__(**kw)
        self.lo_ms, self.hi_ms = lo_ms, hi_ms

    def _interval(self, rng, i, t_ms):
        return rng.uniform(self.lo_ms, self.hi_ms)


class DiurnalScenario(Scenario):
    """Poisson arrivals whose rate follows a sinusoid (diurnal swing).

    rate(t) = (1/mean_interval) * (1 + amplitude * sin(2*pi*t/period)),
    sampled via per-arrival exponential gaps at the current rate (a
    piecewise approximation of inhomogeneous-Poisson thinning that keeps
    generation O(n) and exactly seeded).
    """
    name = "diurnal"

    def __init__(self, mean_interval_ms: float = 30.0, amplitude: float = 0.8,
                 period_ms: float = 20_000.0, **kw):
        super().__init__(**kw)
        assert 0.0 <= amplitude < 1.0
        self.mean_interval_ms = mean_interval_ms
        self.amplitude = amplitude
        self.period_ms = period_ms

    def _interval(self, rng, i, t_ms):
        rate = (1.0 / self.mean_interval_ms) * (
            1.0 + self.amplitude * math.sin(2 * math.pi * t_ms / self.period_ms))
        return rng.exponential(1.0 / max(rate, 1e-9))


class MMPPScenario(Scenario):
    """2-state Markov-modulated Poisson process (quiet / burst).

    Dwell times are geometric in arrival counts: after each arrival the
    chain flips state with probability ``p_switch``.  The burst state runs
    ``burst_factor`` x the quiet rate, producing the clustered arrivals
    uniform settings cannot express.
    """
    name = "mmpp"

    def __init__(self, mean_interval_ms: float = 30.0,
                 burst_factor: float = 8.0, p_switch: float = 0.05, **kw):
        super().__init__(**kw)
        self.mean_interval_ms = mean_interval_ms
        self.burst_factor = burst_factor
        self.p_switch = p_switch
        self._state = 0

    def _reset(self, rng, n):
        self._state = 0

    def _interval(self, rng, i, t_ms):
        if rng.random() < self.p_switch:
            self._state = 1 - self._state
        mean = self.mean_interval_ms
        if self._state:
            mean = mean / self.burst_factor
        return rng.exponential(mean)


class FlashCrowdScenario(Scenario):
    """Steady Poisson load with one ``spike_mult``-x spike window.

    The spike covers arrivals in ``[spike_start_frac, spike_end_frac) * n``
    (index space so the spike always materialises regardless of n).
    """
    name = "flash-crowd"

    def __init__(self, mean_interval_ms: float = 40.0, spike_mult: float = 10.0,
                 spike_start_frac: float = 0.4, spike_end_frac: float = 0.6,
                 **kw):
        super().__init__(**kw)
        self.mean_interval_ms = mean_interval_ms
        self.spike_mult = spike_mult
        self.spike_start_frac = spike_start_frac
        self.spike_end_frac = spike_end_frac
        self._n = 0

    def _reset(self, rng, n):
        self._n = n

    def in_spike(self, i: int) -> bool:
        return (self.spike_start_frac * self._n <= i
                < self.spike_end_frac * self._n)

    def _interval(self, rng, i, t_ms):
        mean = self.mean_interval_ms
        if self.in_spike(i):
            mean = mean / self.spike_mult
        return rng.exponential(mean)


class HeavyTailScenario(Scenario):
    """Heavy-tailed (Lomax / Pareto-II) inter-arrivals, Azure-trace-like.

    ``alpha`` is the tail index (smaller = heavier tail; must be > 1 so the
    mean exists).  Scale is chosen so the mean inter-arrival equals
    ``mean_interval_ms``: mean = scale / (alpha - 1).
    """
    name = "azure-tail"

    def __init__(self, mean_interval_ms: float = 30.0, alpha: float = 1.5,
                 **kw):
        super().__init__(**kw)
        assert alpha > 1.0
        self.mean_interval_ms = mean_interval_ms
        self.alpha = alpha

    def _interval(self, rng, i, t_ms):
        scale = self.mean_interval_ms * (self.alpha - 1.0)
        return float(rng.pareto(self.alpha)) * scale


class TraceReplayScenario(Scenario):
    """Replay a recorded request trace of ``(t_ms, app)`` rows — the hook
    for injecting real Azure/production traces instead of synthetic
    processes.

    Sources (first match wins): ``rows`` (any iterable of ``(t_ms, app)``
    pairs, consumed once — generators welcome), ``csv_path`` (CSV with a
    ``t_ms,app`` header, as shipped under ``benchmarks/traces/``,
    streamed lazily via ``iter_csv``), else a small built-in bursty
    sample so the scenario is usable straight from the catalogue.

    Semantics:
      * rows are sorted by time; ``time_scale`` stretches/compresses the
        clock (2.0 = half the request rate) and ``speedup`` divides it
        (10.0 = replay a long trace 10x faster — the knob that fits the
        hour-scale Azure traces into smoke-test budgets);
      * an ``app`` name not in ``app_names`` (e.g. a hashed production
        function id, or the ``*`` wildcard) is remapped deterministically
        (crc32 of ``name/uid``) onto ``app_names`` — seeds do not change
        a replay, by design;
      * when ``n`` exceeds the trace length the trace wraps, shifted by
        one trace-period per lap (diurnal traces repeat day over day);
      * timestamps are forced strictly increasing and positive.
    """
    name = "trace-replay"

    def __init__(self, csv_path: Optional[str] = None,
                 rows: Optional[Iterable[tuple[float, str]]] = None,
                 time_scale: float = 1.0, speedup: float = 1.0,
                 presorted: bool = False, **kw):
        super().__init__(**kw)
        if not speedup > 0.0:          # also rejects NaN
            raise ValueError(
                f"trace-replay: speedup must be > 0 (it divides the "
                f"trace clock; 10.0 replays 10x faster), got {speedup!r}")
        self.csv_path = csv_path
        # presorted + csv_path: never materialize — each arrivals() lap
        # streams the file from disk (the day-scale path; the file must
        # already be in ``sorted((t_ms, app))`` order, as
        # ``convert_azure.py`` emits, and may be gzip-compressed)
        self.presorted = bool(presorted and csv_path is not None
                              and rows is None)
        if self.presorted:
            self.rows = None
        else:
            if rows is None and csv_path is not None:
                rows = self.iter_csv(csv_path)
            if rows is None:
                rows = DEFAULT_TRACE_ROWS
            # ``rows`` may be any iterable (including the lazy CSV
            # reader): it is consumed exactly once, straight into the
            # sorted trace
            self.rows = sorted((float(t), str(app)) for t, app in rows)
            if not self.rows:
                raise ValueError("trace-replay: empty trace")
        self.speedup = speedup
        self.time_scale = time_scale / speedup

    @staticmethod
    def iter_csv(path: str):
        """Stream a ``t_ms,app`` CSV (header required, extra cols
        ignored), yielding one ``(t_ms, app)`` tuple per row.

        Rows are parsed lazily — hour-long Azure traces never hold the
        file or a per-row dict list in memory beyond the single tuple
        list the caller builds.  Blank and whitespace-only rows — the
        trailing newline junk real trace exports ship with — are
        skipped; a row missing either value, or with an unparsable
        ``t_ms``, raises a ``ValueError`` naming the file and line
        instead of a bare ``KeyError``."""
        import csv as _csv
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt", newline="") as f:
            reader = _csv.DictReader(f)
            if reader.fieldnames is None or \
                    not {"t_ms", "app"} <= set(reader.fieldnames):
                raise ValueError(
                    f"{path}: trace CSV needs a 't_ms,app' header "
                    f"(extra columns are ignored), got {reader.fieldnames}")
            for r in reader:
                cells = [v for v in r.values() if v is not None]
                if all(not str(v).strip() for v in cells):
                    continue                       # blank/trailing line
                t_raw, app = r.get("t_ms"), r.get("app")
                if t_raw is None or not t_raw.strip() or \
                        app is None or not app.strip():
                    raise ValueError(
                        f"{path} line {reader.line_num}: row needs both "
                        f"'t_ms' and 'app' values, got {dict(r)!r}")
                try:
                    t = float(t_raw)
                except ValueError:
                    raise ValueError(
                        f"{path} line {reader.line_num}: t_ms must be a "
                        f"number, got {t_raw!r}") from None
                yield (t, app.strip())

    @staticmethod
    def read_csv(path: str) -> list[tuple[float, str]]:
        """Materialized form of ``iter_csv`` (back-compat helper)."""
        return list(TraceReplayScenario.iter_csv(path))

    def _lap_rows(self):
        """One pass over the trace: the materialized sorted rows, or —
        presorted streaming mode — a fresh lazy read of the CSV."""
        if self.rows is not None:
            return iter(self.rows)
        return self.iter_csv(self.csv_path)

    def iter_arrivals(self, app_names: Sequence[str], n: int,
                      seed: int = 0):
        """Identical to the materialized replay (seeds never matter, by
        design); in presorted mode the file is re-read per wrap lap and
        the wrap period falls out of lap 0's last row/count — exactly
        the ``rows[-1]``/``len(rows)`` the materialized path uses."""
        known = set(app_names)
        t_prev = 0.0
        uid = 0
        lap = 0
        span = 0.0                     # unused on lap 0
        while uid < n:
            count = 0
            prev_raw = -math.inf
            last_raw = 0.0
            for t_raw, app in self._lap_rows():
                if t_raw < prev_raw:
                    raise ValueError(
                        f"{self.csv_path}: presorted trace is not "
                        f"time-sorted (t_ms={t_raw} after {prev_raw})")
                prev_raw = last_raw = t_raw
                count += 1
                t = (t_raw + lap * span) * self.time_scale
                t = max(t, t_prev + 1e-6)             # strictly increasing
                t_prev = t
                if app not in known:
                    app = app_names[zlib.crc32(f"{app}/{uid}".encode())
                                    % len(app_names)]
                yield Arrival(uid, t, app)
                uid += 1
                if uid >= n:
                    return
            if count == 0:
                raise ValueError("trace-replay: empty trace")
            if lap == 0:
                span = last_raw + max(last_raw / count, 1.0)  # wrap period
            lap += 1


class SpotStormScenario(Scenario):
    """Steady exponential arrivals for preemptible-fleet stress tests.

    The arrival process itself is plain Poisson — the *storms* are on the
    supply side: ``storm_windows(horizon_ms)`` returns ``(t0, t1, mult)``
    windows during which spot reclamation rates should be multiplied
    (feed them to ``ClusterSim(reclaim_storms=...)``).  Two storms cover
    the middle of the horizon so retries, migration and backoff all get
    exercised while load is still arriving.  ``suggested_fleet(n)``
    mixes on-demand anchors with spot capacity (2 on-demand : 1 spot).
    """
    name = "spot-storm"

    def __init__(self, mean_interval_ms: float = 35.0,
                 storm_mult: float = 6.0, **kw):
        super().__init__(**kw)
        self.mean_interval_ms = mean_interval_ms
        self.storm_mult = storm_mult

    def _interval(self, rng, i, t_ms):
        return rng.exponential(self.mean_interval_ms)

    def storm_windows(self, horizon_ms: float) -> list[tuple[float, float, float]]:
        """Two reclamation storms in the middle half of the horizon."""
        return [
            (0.25 * horizon_ms, 0.40 * horizon_ms, self.storm_mult),
            (0.60 * horizon_ms, 0.75 * horizon_ms, self.storm_mult),
        ]

    @staticmethod
    def suggested_fleet(n_invokers: int) -> list[str]:
        """2 on-demand : 1 spot round-robin mix."""
        cycle = ("a100", "a100", "a100-spot")
        return [cycle[i % len(cycle)] for i in range(n_invokers)]


class HeteroMixScenario(MMPPScenario):
    """Bursty (MMPP) traffic aimed at a heterogeneous SKU mix.

    Arrival-side it is the 2-state MMPP process; the point of the
    scenario is ``suggested_fleet(n)``: a rotation over the whole SKU
    catalogue (fast H100s, baseline A100s, and the cheap spot tiers) so
    SKU-aware pricing, warm-up-from-zero and exec-rate scaling all see
    traffic in one run.
    """
    name = "hetero-mix"

    def __init__(self, mean_interval_ms: float = 35.0,
                 burst_factor: float = 6.0, p_switch: float = 0.04, **kw):
        super().__init__(mean_interval_ms=mean_interval_ms,
                         burst_factor=burst_factor, p_switch=p_switch, **kw)

    @staticmethod
    def suggested_fleet(n_invokers: int) -> list[str]:
        cycle = ("a100", "h100", "a100-spot", "a100", "a10g-spot")
        return [cycle[i % len(cycle)] for i in range(n_invokers)]


# Built-in sample: a quiet->burst->quiet day fragment (wildcard apps are
# remapped onto whatever app set the run serves).
DEFAULT_TRACE_ROWS: list[tuple[float, str]] = [
    (float(t), "*") for t in
    list(range(40, 2000, 70)) +          # quiet: ~14 req/s-equivalent spacing
    list(range(2000, 2600, 12)) +        # burst window: ~6x denser
    list(range(2600, 4600, 55))          # recovery
]


def _uniform_factory(load: str) -> Callable[..., Scenario]:
    lo, hi = INTERVALS_MS[load]
    return lambda **kw: UniformScenario(lo, hi, **kw)


SCENARIOS: dict[str, Callable[..., Scenario]] = {
    "uniform-light": _uniform_factory("light"),
    "uniform-normal": _uniform_factory("normal"),
    "uniform-heavy": _uniform_factory("heavy"),
    "diurnal": DiurnalScenario,
    "mmpp": MMPPScenario,
    "flash-crowd": FlashCrowdScenario,
    "azure-tail": HeavyTailScenario,
    "skewed-mix": lambda **kw: UniformScenario(
        20.0, 33.6, **{"app_weights": None, **kw}),
    "trace-replay": TraceReplayScenario,
    "spot-storm": SpotStormScenario,
    "hetero-mix": HeteroMixScenario,
}


def get_scenario(name: str, app_names: Optional[Sequence[str]] = None,
                 **overrides) -> Scenario:
    """Build a scenario by catalogue name.

    ``skewed-mix`` derives an 80/20 split over ``app_names`` when no
    explicit ``app_weights`` override is given.
    """
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}")
    if name == "skewed-mix" and "app_weights" not in overrides and app_names:
        hot, rest = app_names[0], app_names[1:]
        weights = {hot: 0.8}
        for a in rest:
            weights[a] = 0.2 / max(len(rest), 1)
        overrides["app_weights"] = weights
    return SCENARIOS[name](**overrides)
