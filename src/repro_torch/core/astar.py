"""ESG_1Q — optimality-guided configuration search (paper §3.3, Alg. 1).

Finds the K cheapest configuration *paths* (one config per remaining stage of
the schedule group) whose summed latency meets the group SLO target, via
A*-search with the paper's dual-blade pruning:

  time blade:   prune prefix p when  tLow(p) >= G_SLO, where
                tLow = time(p) + sum of per-stage minimum times not in p.
                Config lists are sorted by latency, so the first pruned
                config ends the whole expansion loop (the paper's `break`).

  cost blade:   prune when  rscLow(p) >= minRSC[K-1], where
                rscLow = cost(p) + sum of per-stage minimum costs not in p,
                and minRSC holds the K best *upper bounds* seen so far —
                each new prefix contributes rscFastest(p) = cost(p) + cost of
                completing with every remaining stage at its fastest config
                (that completion is time-feasible whenever p survived the
                time blade, so the bound is achievable).

The heuristic (suffix minimum cost) is admissible and consistent, so nodes
pop in nondecreasing f = g + h order and the first K completed paths are
exactly the K cheapest feasible ones (verified against brute force in
tests/test_astar.py).

``penalties_ms`` (one entry per stage, optional) prices a predicted
placement start penalty — e.g. the Torpor-style weight swap-in a
memory-aware placement expects to pay — into the stage's table before
the search (``ProfileTable.with_penalty``): the time blade then prunes
against the *true* latency including the swap, and the cost blade bills
the penalty window at each config's $-rate.  A zero penalty leaves the
stage's table untouched, so memory-blind callers are bit-identical.
Under the overlapped swap pipeline the caller passes the *residual*
penalty left after the transfer engine hides the copy behind the
predecessor stage's execution (see ``ESGScheduler.plan``) — deeper
pipeline suffixes therefore price smaller penalties, which is exactly
the pipeline-conscious behaviour the paper's G_SLO distribution wants.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.profiles import Config, ProfileTable

# Bounded open list (vectorized engine): when the heap outgrows this, it is
# compacted by dropping entries whose cost lower bound already exceeds the
# current K-th upper bound — exactly the nodes the pop-time stale check
# would discard anyway, so compaction never changes the result.
OPEN_LIST_CAP = 32_768


def _priced(tables: list[ProfileTable],
            penalties_ms: Optional[Sequence[float]]) -> list[ProfileTable]:
    if penalties_ms is None:
        return tables
    if len(penalties_ms) != len(tables):
        raise ValueError(
            f"penalties_ms has {len(penalties_ms)} entries "
            f"for {len(tables)} stages")
    return [t.with_penalty(p) for t, p in zip(tables, penalties_ms)]


@dataclasses.dataclass(frozen=True)
class PathResult:
    configs: tuple[Config, ...]
    est_time_ms: float
    est_job_cost: float


@dataclasses.dataclass
class SearchStats:
    nodes_expanded: int = 0
    nodes_pushed: int = 0
    pruned_time: int = 0
    pruned_cost: int = 0


def esg_1q(tables: list[ProfileTable], g_slo_ms: float, k: int = 5,
           stats: Optional[SearchStats] = None,
           penalties_ms: Optional[Sequence[float]] = None,
           vectorized: bool = True) -> list[PathResult]:
    """K cheapest SLO-feasible config paths over ``tables`` (one per stage).

    ``vectorized=True`` (default) runs the array-based engine: per-stage
    numpy pricing/blade arithmetic, index paths instead of Config tuples,
    and a bounded open list.  It returns the same results as the legacy
    per-config loop (``vectorized=False``) — the dual blades prune lazily
    at pop instead of eagerly at push, which never changes which paths
    complete first (tests/test_planner_fastpath.py runs both engines over
    randomized tables).  ``SearchStats`` counters keep the same meaning
    but not the same values across engines (the vectorized engine pushes
    nodes the sequential loop pruned in-flight and prunes them at pop)."""
    if vectorized:
        return _esg_1q_vec(tables, g_slo_ms, k, stats, penalties_ms)
    return _esg_1q_legacy(tables, g_slo_ms, k, stats, penalties_ms)


def _esg_1q_legacy(tables: list[ProfileTable], g_slo_ms: float, k: int = 5,
                   stats: Optional[SearchStats] = None,
                   penalties_ms: Optional[Sequence[float]] = None
                   ) -> list[PathResult]:
    """Reference per-config search loop (the pre-fast-path implementation)."""
    tables = _priced(tables, penalties_ms)
    n = len(tables)
    if n == 0:
        return []
    # suffix bounds (suffix i = stages i..n-1)
    min_t = np.zeros(n + 1)
    min_c = np.zeros(n + 1)
    fast_c = np.zeros(n + 1)
    for i in range(n - 1, -1, -1):
        min_t[i] = min_t[i + 1] + tables[i].min_time
        min_c[i] = min_c[i + 1] + tables[i].min_job_cost
        fast_c[i] = fast_c[i + 1] + tables[i].fastest_cost

    if min_t[0] >= g_slo_ms:
        # infeasible even at the fastest configs: return the fastest path
        # (the controller treats it as a best-effort schedule)
        cfgs = tuple(t.configs[0] for t in tables)
        return [PathResult(cfgs, float(min_t[0]), float(fast_c[0]))]

    min_rsc = [float("inf")] * k
    results: list[PathResult] = []
    tie = itertools.count()
    # node: (f_cost, f_time, tie, stage_next, g_time, g_cost, path) —
    # the admissible time bound breaks cost ties toward faster paths
    # (matters when the cost curve is flat in resources, e.g. memory-bound
    # LM serving where latency ~ 1/chips and $-rate ~ chips)
    heap: list[tuple] = [(min_c[0], min_t[0], next(tie), 0, 0.0, 0.0, ())]

    def note_upper(bound: float):
        # min_rsc stays sorted, so displacing the worst entry is a pop +
        # O(log k) insort, not a full re-sort per insertion
        if bound < min_rsc[-1]:
            min_rsc.pop()
            bisect.insort(min_rsc, bound)

    note_upper(float(fast_c[0]))

    while heap and len(results) < k:
        f, _, _, i, g_time, g_cost, path = heapq.heappop(heap)
        if stats:
            stats.nodes_expanded += 1
        if i == n:
            results.append(PathResult(path, g_time, g_cost))
            continue
        if g_cost + min_c[i] > min_rsc[-1]:     # stale node (bound tightened)
            if stats:
                stats.pruned_cost += 1
            continue
        tbl = tables[i]
        for j in range(len(tbl.configs)):
            t_new = g_time + float(tbl.times[j])
            if t_new + min_t[i + 1] >= g_slo_ms:
                if stats:
                    stats.pruned_time += 1
                break                            # sorted by time: all later prune
            c_new = g_cost + float(tbl.job_costs[j])
            rsc_low = c_new + min_c[i + 1]
            if rsc_low > min_rsc[-1]:
                if stats:
                    stats.pruned_cost += 1
                continue
            note_upper(c_new + fast_c[i + 1])
            heapq.heappush(heap, (rsc_low, t_new + min_t[i + 1], next(tie),
                                  i + 1, t_new, c_new,
                                  path + (tbl.configs[j],)))
            if stats:
                stats.nodes_pushed += 1
    return results


def _esg_1q_vec(tables: list[ProfileTable], g_slo_ms: float, k: int = 5,
                stats: Optional[SearchStats] = None,
                penalties_ms: Optional[Sequence[float]] = None
                ) -> list[PathResult]:
    """Vectorized ESG_1Q engine.

    Same search, three structural changes:
      * stage tables are consumed as (times, job_costs) arrays with the
        penalty priced in via ``ProfileTable.priced_arrays`` — no Config
        objects or intermediate tables are built during the search;
      * one expansion evaluates both blades over the whole config list at
        once: the time blade is a prefix length (config lists are sorted
        by latency, so feasibility is monotone), the cost blade a boolean
        mask against the current K-th upper bound, and the K best upper
        bounds fold in via one partition instead of per-config insorts;
      * paths are tuples of config *indices* (materialized into Config
        tuples only for completed results) and the open list is bounded:
        past ``OPEN_LIST_CAP`` it is compacted by the same stale test the
        pop loop applies.

    The eager per-config bound-tightening of the sequential loop becomes
    lazy (a whole expansion prunes against the bound as of its start);
    nodes the legacy loop never pushed are pushed here and discarded by
    the pop-time stale check, which cannot change the completed-path
    order because the heap keys (cost lower bound, time lower bound) are
    computed with the same float arithmetic.
    """
    if penalties_ms is not None and len(penalties_ms) != len(tables):
        raise ValueError(
            f"penalties_ms has {len(penalties_ms)} entries "
            f"for {len(tables)} stages")
    n = len(tables)
    if n == 0:
        return []
    times: list[np.ndarray] = []
    costs: list[np.ndarray] = []
    for i, t in enumerate(tables):
        ts, cs = t.priced_arrays(
            0.0 if penalties_ms is None else penalties_ms[i])
        times.append(ts)
        costs.append(cs)
    # suffix bounds, accumulated in the same (reverse) order as the legacy
    # loop so the float sums are bitwise identical
    min_t = np.zeros(n + 1)
    min_c = np.zeros(n + 1)
    fast_c = np.zeros(n + 1)
    for i in range(n - 1, -1, -1):
        min_t[i] = min_t[i + 1] + float(times[i][0])
        min_c[i] = min_c[i + 1] + float(costs[i].min())
        fast_c[i] = fast_c[i + 1] + float(costs[i][0])

    def materialize(path: tuple[int, ...]) -> tuple[Config, ...]:
        return tuple(tables[s].configs[j] for s, j in enumerate(path))

    if min_t[0] >= g_slo_ms:
        return [PathResult(tuple(t.configs[0] for t in tables),
                           float(min_t[0]), float(fast_c[0]))]

    min_rsc = np.full(k, np.inf)
    results: list[PathResult] = []
    tie = itertools.count()
    heap: list[tuple] = [(float(min_c[0]), float(min_t[0]), next(tie),
                          0, 0.0, 0.0, ())]
    min_rsc[-1] = fast_c[0]
    min_rsc.sort()
    compact_floor = OPEN_LIST_CAP

    while heap and len(results) < k:
        f, _, _, i, g_time, g_cost, path = heapq.heappop(heap)
        if stats:
            stats.nodes_expanded += 1
        if i == n:
            results.append(PathResult(materialize(path), g_time, g_cost))
            continue
        bound = min_rsc[-1]
        if g_cost + min_c[i] > bound:        # stale node (bound tightened)
            if stats:
                stats.pruned_cost += 1
            continue
        m_next = min_t[i + 1]
        t_new = g_time + times[i]
        f_time = t_new + m_next
        # time blade: sorted by latency => feasibility is a prefix
        feas = f_time < g_slo_ms
        cut = int(feas.sum())
        if cut < len(feas):
            if stats:
                stats.pruned_time += 1
            if cut == 0:
                continue
        c_new = g_cost + costs[i][:cut]
        rsc_low = c_new + min_c[i + 1]
        keep = rsc_low <= bound              # cost blade (strict > prunes)
        kept = int(keep.sum())
        if stats:
            stats.pruned_cost += cut - kept
        if not kept:
            continue
        c_keep = c_new[keep]
        # fold the survivors' achievable upper bounds (rscFastest) into
        # the K best seen so far in one partition
        merged = np.concatenate((min_rsc, c_keep + fast_c[i + 1]))
        if merged.size > k:
            merged = np.partition(merged, k - 1)[:k]
        merged.sort()
        min_rsc = merged
        nxt = i + 1
        for j, rl, ft, tn, cn in zip(
                np.flatnonzero(keep).tolist(), rsc_low[keep].tolist(),
                f_time[:cut][keep].tolist(), t_new[:cut][keep].tolist(),
                c_keep.tolist()):
            heapq.heappush(heap, (rl, ft, next(tie), nxt, tn, cn,
                                  path + (j,)))
        if stats:
            stats.nodes_pushed += kept
        if len(heap) > compact_floor:
            bound = min_rsc[-1]
            slim = [nd for nd in heap if nd[0] <= bound]
            if len(slim) < len(heap):
                heap = slim
                heapq.heapify(heap)
            # if nothing was prunable, raise the floor so compaction
            # attempts stay amortized O(1) per push
            compact_floor = max(OPEN_LIST_CAP, 2 * len(heap))
    return results


def brute_force(tables: list[ProfileTable], g_slo_ms: float,
                k: int = 5,
                penalties_ms: Optional[Sequence[float]] = None
                ) -> list[PathResult]:
    """Reference enumeration (exponential) — test oracle + Fig 9 baseline."""
    tables = _priced(tables, penalties_ms)
    paths = []
    for combo in itertools.product(*[range(len(t.configs)) for t in tables]):
        t = sum(float(tables[i].times[j]) for i, j in enumerate(combo))
        if t >= g_slo_ms:
            continue
        c = sum(float(tables[i].job_costs[j]) for i, j in enumerate(combo))
        paths.append(PathResult(
            tuple(tables[i].configs[j] for i, j in enumerate(combo)), t, c))
    paths.sort(key=lambda p: (p.est_job_cost, p.est_time_ms))
    return paths[:k]
