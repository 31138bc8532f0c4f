"""Memoized dominator-budget plan cache for the ESG planner.

ESG re-plans at every stage dispatch (the paper's optimality-guided
adaptive behaviour), but the inputs of those ESG_1Q searches repeat
heavily: the same app keeps arriving, the dominator-based SLO
distribution hands every (app, stage) the same budget *fraction*, and
uncongested queues are planned at ``w == 0`` so even the absolute budget
repeats.  This cache memoizes search results keyed on

    (workflow, remaining-stage suffix, batch bucket, penalty signature)

— the scheduler appends a fifth axis, the online calibrator's published
correction-factor tuple, whenever calibration is active (any factor
!= 1.0), so every published calibration step makes previously cached
plans unreachable rather than stale — plus the G_SLO budget — and the budget axis is quantized into exactly
three *sound* buckets, derived from the structure of ESG_1Q's output as
a function of the budget (the result is a step function of G_SLO, and
two of its steps have certifiable extents):

  * **floor**       — ``g_slo <= t_min`` (the summed per-stage minimum
    latency): the search is infeasible and returns the best-effort
    fastest path.  One precomputed result serves the whole bucket.
  * **budget-free** — ``g_slo > t_max``, where ``t_max`` is the slowest
    path among the K cheapest *unconstrained* paths (searched once with
    an infinite budget): every unconstrained winner is feasible, and
    the K cheapest feasible paths of a superset-feasible search are the
    K cheapest overall — so the unconstrained result is provably the
    answer for every budget in the bucket.  This is the common case the
    dominator split makes common: per-group quotas put same-stage
    budgets in the same (wide) slack regime run after run.
  * **exact**       — the middle regime (``t_min < g_slo <= t_max``),
    where the K-best set genuinely depends on the budget: memoized per
    exact budget value (repeat hits still come from ``w == 0`` arrivals
    sharing one SLO), never across budgets.

Quantization soundness caveat: the budget-free bucket returns the same
*path set* as a fresh search; if two distinct paths tie exactly on
(cost, time) the tie is broken by heap insertion order, which an
infinite-budget search may visit differently.  Profile-model costs are
continuous products, so exact cross-path ties do not occur in practice
(the differential tests replay every serving scenario cache-on vs
cache-off and require bit-identical schedules).

Batch caps are quantized to the profile table's batch lattice
(``ProfileTable.batch_lattice``): ``restrict_batch(n)`` returns the same
table for every ``n`` inside one lattice step, so the bucket is lossless
by construction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Hashable, Optional, Sequence

from repro_torch.core.astar import PathResult, esg_1q
from repro_torch.core.profiles import ProfileTable


@dataclasses.dataclass
class CacheStats:
    hits_floor: int = 0
    hits_budget_free: int = 0
    hits_exact: int = 0
    misses: int = 0          # entry existed, budget fell in a new exact slot
    builds: int = 0          # prefix entry built (two searches)
    evictions: int = 0

    @property
    def hits(self) -> int:
        return self.hits_floor + self.hits_budget_free + self.hits_exact

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def as_dict(self) -> dict[str, Any]:
        return {**dataclasses.asdict(self), "hits": self.hits,
                "lookups": self.lookups,
                "hit_rate": self.hits / self.lookups if self.lookups else 0.0}


@dataclasses.dataclass
class _Entry:
    """Per-(suffix, bucket, penalties) memo: the two certified buckets
    plus an exact-budget dict for the middle regime."""
    tables: list[ProfileTable]
    penalties: Optional[tuple[float, ...]]
    t_min: float                    # summed per-stage minimum (priced) latency
    floor: list[PathResult]         # result for every g_slo <= t_min
    budget_free: list[PathResult]   # result for every g_slo > t_max
    t_max: float                    # slowest unconstrained winner
    exact: dict[float, list[PathResult]] = dataclasses.field(
        default_factory=dict)


class PlanCache:
    """Plan memo over ``esg_1q`` searches.  ``lookup`` is a drop-in for
    running the search directly — same results, engine chosen by
    ``vectorized`` — with dict hits in the three budget regimes."""

    def __init__(self, k: int = 5, vectorized: bool = True,
                 max_entries: int = 2048, max_exact: int = 512):
        self.k = k
        self.vectorized = vectorized
        self.max_entries = max_entries
        self.max_exact = max_exact
        self._entries: dict[Hashable, _Entry] = {}
        self.stats = CacheStats()
        # budget regime the most recent ``lookup`` resolved in
        # ("floor" | "budget-free" | "exact" | "miss") — read by the
        # planner-audit recorder right after the call
        self.last_regime = ""

    # -- entry lifecycle ----------------------------------------------------
    def peek(self, key: Hashable) -> Optional[_Entry]:
        return self._entries.get(key)

    def _build(self, key: Hashable, tables: list[ProfileTable],
               penalties: Optional[Sequence[float]]) -> _Entry:
        pen = tuple(penalties) if penalties is not None else None
        # the infeasible branch ignores how far below t_min the budget is,
        # so any certainly-infeasible budget yields the floor result
        floor = esg_1q(tables, -math.inf, k=self.k, penalties_ms=penalties,
                       vectorized=self.vectorized)
        unconstrained = esg_1q(tables, math.inf, k=self.k,
                               penalties_ms=penalties,
                               vectorized=self.vectorized)
        entry = _Entry(tables=tables, penalties=pen,
                       t_min=floor[0].est_time_ms, floor=floor,
                       budget_free=unconstrained,
                       t_max=max(r.est_time_ms for r in unconstrained))
        if len(self._entries) >= self.max_entries:
            self._entries.pop(next(iter(self._entries)))
            self.stats.evictions += 1
        self._entries[key] = entry
        self.stats.builds += 1
        return entry

    # -- the lookup ---------------------------------------------------------
    def lookup(self, key: Hashable, g_slo_ms: float,
               tables: Callable[[], list[ProfileTable]] | list[ProfileTable],
               penalties: Optional[Sequence[float]] = None,
               stats: Optional[Any] = None) -> list[PathResult]:
        """Results of ``esg_1q(tables, g_slo_ms, k, penalties)``.

        ``tables`` may be a list or a zero-arg factory (only called on an
        entry build).  ``key`` must capture everything that determines
        the search besides the budget: the stage suffix, the batch
        bucket and the penalty signature.  ``stats`` (a
        ``repro.core.astar.SearchStats``) is threaded into the miss-path
        search only — cache hits do no search work by definition."""
        entry = self._entries.get(key)
        if entry is None:
            if callable(tables):
                tables = tables()
            entry = self._build(key, tables, penalties)
        if g_slo_ms <= entry.t_min:        # esg_1q's min_t[0] >= g_slo branch
            self.stats.hits_floor += 1
            self.last_regime = "floor"
            return entry.floor
        if g_slo_ms > entry.t_max:
            self.stats.hits_budget_free += 1
            self.last_regime = "budget-free"
            return entry.budget_free
        cached = entry.exact.get(g_slo_ms)
        if cached is not None:
            self.stats.hits_exact += 1
            self.last_regime = "exact"
            return cached
        self.stats.misses += 1
        self.last_regime = "miss"
        result = esg_1q(entry.tables, g_slo_ms, k=self.k,
                        penalties_ms=entry.penalties,
                        vectorized=self.vectorized, stats=stats)
        if len(entry.exact) >= self.max_exact:
            entry.exact.pop(next(iter(entry.exact)))
            self.stats.evictions += 1
        entry.exact[g_slo_ms] = result
        return result

    def budget_free_token(self, key: Hashable,
                          g_slo_ms: float) -> Optional[Hashable]:
        """A token identifying the plan a lookup would return, or None.

        Non-None only in the budget-free regime of an already-built
        entry, where the result is provably independent of the budget:
        two calls returning the same token are certified to produce
        identical candidate lists.  The event-sparse emulator uses this
        to prove a blocked queue's retry futile without re-searching."""
        entry = self._entries.get(key)
        if entry is None or not g_slo_ms > entry.t_max:
            return None
        return (key, "budget-free")
