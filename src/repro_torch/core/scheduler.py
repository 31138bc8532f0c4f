"""The ESG scheduling policy — the paper's contribution, wired together.

Per queue-scheduling call (paper Fig 2(d)):
  1. locate the stage's schedule group + SLO quota (dominator-based
     distribution, computed once per app),
  2. G_SLO = (deadline - now) x q̂, with q̂ the group quota normalised over
     the not-yet-finished groups (the paper's (SLO - w) x q with the quota
     re-normalised so early finishes benefit later stages; see DESIGN §1),
  3. ESG_1Q (A* + dual-blade pruning) over the remaining stages of the
     group, the current stage's batch capped by the queue length,
  4. return the top-K *current-stage* configs as the configuration priority
     queue — the emulator's dispatcher walks it (ESG_Dispatch), falling back
     through candidates, then to the recheck list.

ESG re-plans at *every* stage dispatch — the paper's optimality-guided
adaptive behaviour (vs Orion/Aquatope's static whole-workflow plans).
Those searches repeat heavily, so they run through a memoized
dominator-budget plan cache by default (``plan_cache=True``; see
``repro.core.plancache``) and the vectorized ESG_1Q engine
(``vectorized=True``) — both produce bit-identical plans to the legacy
per-call search, proven differentially in
``tests/test_planner_fastpath.py``.

``placement="memory"`` (weight-locality-aware mode, off by default) does
two things: the emulator's placement ranks fallback invokers by the
restart penalty their warm state implies (see ``ClusterSim._place``),
and the planner prices the *predicted* Torpor-style swap-in penalty of
each remaining stage into the A* search (``esg_1q(penalties_ms=...)``)
so dual-blade pruning compares true latencies.  With an online
calibrator attached (``calibrator=``, see ``repro.obs.calibrate``) the
suffix tables are additionally rescaled by the per-(app, stage) EWMA
correction factors learned from the audit stream, and the factor tuple
becomes an extra plan-cache key axis so no stale plan survives a
calibration step.  Only the swap component
is priced — when some invoker still holds the function's weights hot the
penalty is zero, and cold-start container provisioning stays out of the
plan exactly as in the legacy planner — so with unbounded HBM (where
nothing is ever demoted) memory-aware planning is bit-identical to the
default.  The baselines (Orion/Aquatope/INFless/FaST-GShare) stay
memory-blind for a fair fig6/fig7 contrast.
"""
from __future__ import annotations

import bisect
from typing import Optional

import numpy as np

from repro_torch.core.astar import SearchStats, esg_1q
from repro_torch.core.dominator import ScheduleGroup, distribute_slo
from repro_torch.core.plancache import PlanCache
from repro_torch.core.profiles import Config, ProfileTable
from repro_torch.core.workflows import Workflow
from repro_torch.cluster.emulator import ClusterSim, Job, SchedulerPolicy
from repro_torch.gpu import HOT, WARM, swap_in_ms
from repro_torch.obs import PlanRecord


# Expected rework per unit of reclamation hazard: a mid-task kill loses
# about half the run on average (uniform kill time), while a stage with a
# checkpoint resumes and loses only a small restore window.  These scale
# the fleet's ``risk_per_ms`` before it inflates the suffix tables.
PREEMPT_LOSS_FRAC = 0.5
CKPT_LOSS_FRAC = 0.1


class ESGScheduler(SchedulerPolicy):
    name = "ESG"
    placement = "locality"

    def __init__(self, apps: dict[str, Workflow],
                 tables: dict[str, ProfileTable],
                 k: int = 5, group_size: int = 3,
                 pareto: bool = False, risk_sigma: float = 0.0,
                 placement: str = "locality",
                 plan_cache: bool = True, vectorized: bool = True,
                 calibrator=None):
        if placement not in ("locality", "memory"):
            raise ValueError(f"ESG placement must be 'locality' or "
                             f"'memory', got {placement!r}")
        self.placement = placement
        self.tables = tables
        # online profile calibration (repro.obs.calibrate): when set,
        # every plan prices the suffix against per-stage corrected
        # tables and folds the published factor tuple into its plan-
        # cache key — None (the default) is the uncorrected legacy path
        self.calibrator = calibrator
        self._cal_version = -1
        self._scaled: dict[tuple, list[ProfileTable]] = {}
        # heterogeneous/preemptible fleets: suffix tables repriced per
        # (stage context, calibration factors, fleet signature) — the
        # signature also becomes a plan-cache key axis (see plan())
        self._spot_tables: dict[tuple, list[ProfileTable]] = {}
        self.k = k
        self.pareto = pareto
        self.vectorized = vectorized
        self.cache = PlanCache(k=k, vectorized=vectorized) \
            if plan_cache else None
        # plan against P95-ish estimates when the config lattice is coarse
        # (TPU-zoo serving: chip counts step latency ~2x, so mean-based
        # plans ride the budget edge and noise tips them over)
        self.time_inflation = 1.0 + 1.645 * risk_sigma
        self.groups: dict[str, dict[str, ScheduleGroup]] = {
            name: distribute_slo(app, tables, group_size)
            for name, app in apps.items()
        }
        # per-app stage order (topological) for suffix-quota normalisation
        self._stage_pos = {
            name: {s: i for i, s in enumerate(app.stages)}
            for name, app in apps.items()
        }
        # per-(app, stage) planning context — the group suffix, its tables
        # and the budget constants are pure functions of the constructor
        # inputs, so they are computed once instead of per dispatch
        self._ctx: dict[tuple[str, str], tuple] = {}
        self._restricted: dict[tuple[str, str, int], ProfileTable] = {}
        self._cheapest: dict[tuple[str, int], Config] = {}

    # -- quota of the remaining pipeline, for G_SLO normalisation ----------
    def _norm_quota(self, app: Workflow, group: ScheduleGroup,
                    stage: str) -> float:
        gmap = self.groups[app.name]
        pos = self._stage_pos[app.name]
        remaining_groups = {gmap[s].stages: gmap[s].slo_fraction
                            for s in app.stages if pos[s] >= pos[stage]}
        total = sum(remaining_groups.values())
        return group.slo_fraction / total if total > 0 else 1.0

    # -- predicted weight-swap penalty per stage (memory-aware planning) ---
    def _predicted_swap_ms(self, sim: ClusterSim, func: str) -> float:
        """Swap-in penalty the memory-aware placement is predicted to pay
        for ``func``: 0 when any invoker still holds the weights hot (the
        placement will steer there), ``swap_in_ms`` when the best warm
        state anywhere is host-staged weights, and 0 when the function is
        cold everywhere (container provisioning is not a swap cost and
        stays unpriced, as in the legacy planner — this also keeps
        unbounded-HBM runs, which never demote, bit-identical).

        Under the overlapped swap pipeline a "hot" invoker may still be
        waiting on an in-flight background copy, so the prediction is
        the best *residual* transfer time across hot invokers instead
        of a flat zero."""
        warm_somewhere = False
        best_residual = None
        for inv in sim.invokers:
            r = inv.residency(func, sim.now)
            if r == HOT:
                if not getattr(sim, "overlap", False):
                    return 0.0
                residual = inv.start_penalty_ms(func, None, sim.now)
                if residual <= 0.0:
                    return 0.0
                best_residual = (residual if best_residual is None
                                 else min(best_residual, residual))
            elif r == WARM:
                warm_somewhere = True
        if best_residual is not None:
            if warm_somewhere:
                # a host-staged copy elsewhere caps the price: placement
                # can always fall back to a fresh demand swap there
                return min(best_residual,
                           swap_in_ms(sim.invokers[0].model_mb(func)))
            return best_residual
        if warm_somewhere:
            return swap_in_ms(sim.invokers[0].model_mb(func))
        return 0.0

    # -- per-(app, stage) planning context ---------------------------------
    def _stage_ctx(self, app: Workflow, stage: str) -> tuple:
        key = (app.name, stage)
        ctx = self._ctx.get(key)
        if ctx is None:
            group = self.groups[app.name][stage]
            # stages of the group from the current one onward
            idx = group.stages.index(stage)
            stages = group.stages[idx:]
            # tuple: doubles as the "shape" axis of every planner memo
            # and plan-cache key below — cache entries are pure
            # functions of the profile-table contents, so apps sharing
            # a function suffix share entries (collapses an N-app
            # population of cloned workflows to a handful of shapes)
            funcs = tuple(app.func_of[s] for s in stages)
            base = [self.tables[f] for f in funcs]
            if self.pareto:
                base = [t.pareto() for t in base]
            # headroom for non-exec latency the profiles don't cover: data
            # transfer + dispatch/scheduling overhead per remaining stage
            # (the Controller "estimates the times with performance
            # profiles" — §3.3; transfer estimates are part of those)
            margin = sum(self.tables[f].fn.input_mb * 8.0 + 25.0
                         for f in funcs)
            quota = self._norm_quota(app, group, stage)
            ctx = (stages, funcs, base, margin, quota)
            self._ctx[key] = ctx
        return ctx

    # -- online calibration (repro.obs.calibrate) ---------------------------
    def _factors(self, app_name: str, stages) -> Optional[tuple]:
        """Published correction factors for the plan suffix, or None on
        the uncorrected path (no calibrator, or every factor 1.0 — the
        warmup gate keeps a cold calibrator bit-identical to none)."""
        cal = self.calibrator
        if cal is None:
            return None
        if cal.version != self._cal_version:
            # a published-factor change: drop memoized scaled tables so
            # the next plan rebuilds them against the new corrections
            self._cal_version = cal.version
            self._scaled.clear()
        if not cal.active:
            # nothing published yet: skip the per-plan factor-tuple
            # build — with accurate profiles this is every plan
            return None
        f = cal.factors(app_name, stages)
        return f if any(x != 1.0 for x in f) else None

    def _corrected(self, funcs: tuple, bucket: int,
                   tables: list[ProfileTable],
                   factors: tuple) -> list[ProfileTable]:
        key = (funcs, bucket, factors)
        got = self._scaled.get(key)
        if got is None:
            got = self._scaled[key] = [
                t.scaled(f) for t, f in zip(tables, factors)]
        return got

    # -- heterogeneous/preemptible fleet pricing ----------------------------
    @staticmethod
    def _fleet_sig(sim) -> Optional[tuple]:
        """The emulator's SKU/spot signature, or None on a homogeneous
        default fleet (and on sims that predate the fleet model)."""
        fn = getattr(sim, "sku_signature", None)
        return fn() if fn is not None else None

    def _spot_priced(self, funcs: tuple, bucket: int,
                     factors: Optional[tuple], sku_sig: tuple,
                     tables: list[ProfileTable]) -> list[ProfileTable]:
        """Suffix tables with SKU-scaled exec times and expected
        preemption loss priced into both ESG_1Q blades (memoized — the
        distinct signatures over a run are the fleet's up/down
        compositions, a handful)."""
        key = (funcs, bucket, factors, sku_sig)
        got = self._spot_tables.get(key)
        if got is None:
            exec_factor, risk = sku_sig
            got = self._spot_tables[key] = [
                t.preempt_priced(
                    exec_factor,
                    risk * (CKPT_LOSS_FRAC if t.fn.checkpoint_mb > 0.0
                            else PREEMPT_LOSS_FRAC))
                for t in tables]
        return got

    @staticmethod
    def _bucket(table: ProfileTable, n: int) -> int:
        """Quantize a batch cap to the table's lattice: restrict_batch is
        constant inside one lattice step, so the bucket is lossless."""
        lat = table.batch_lattice
        i = bisect.bisect_right(lat, n)
        return lat[i - 1] if i else 0

    def _prepared(self, funcs: tuple, base: list[ProfileTable],
                  bucket: int) -> list[ProfileTable]:
        key = (funcs[0], bucket)
        first = self._restricted.get(key)
        if first is None:
            first = base[0].restrict_batch(bucket)
            self._restricted[key] = first
        return [first] + base[1:]

    def _cheapest_config(self, func: str, n_jobs: int) -> Config:
        """Globally cost-optimal config of ``func`` at batch cap
        ``n_jobs`` (the sunk-deadline serve-at-min-cost path)."""
        bucket = self._bucket(self.tables[func], max(n_jobs, 1))
        cfg = self._cheapest.get((func, bucket))
        if cfg is None:
            tbl = self.tables[func].restrict_batch(bucket)
            cfg = tbl.configs[int(np.argmin(tbl.job_costs))]
            self._cheapest[(func, bucket)] = cfg
        return cfg

    def _penalties(self, sim: ClusterSim, funcs: list[str],
                   tables: list[ProfileTable]) -> Optional[list[float]]:
        """Memory-aware mode: predicted weight-swap penalty per remaining
        stage, residual-discounted under the overlapped swap pipeline."""
        if self.placement != "memory" or not getattr(sim, "invokers", None):
            return None
        penalties = [self._predicted_swap_ms(sim, f) for f in funcs]
        if getattr(sim, "overlap", False) and \
                getattr(sim, "prefetch_weights", False):
            # overlapped swap pipeline with predictive prefetch:
            # stage j's swap-in is enqueued when stage j-1
            # dispatches, so at least stage j-1's fastest execution
            # hides it — price only the residual, which shrinks
            # with pipeline depth (stage 0 pays what is left *now*)
            for j in range(1, len(penalties)):
                penalties[j] = max(
                    penalties[j] - tables[j - 1].min_time, 0.0)
        if not any(penalties):
            return None
        return penalties

    def plan(self, sim: ClusterSim, app: Workflow, stage: str,
             jobs: list[Job], now: float) -> list[Config]:
        # planner-decision audit (repro.obs): purely observational — the
        # stats object only exists when a recorder is attached, and no
        # decision below reads it
        rec = getattr(sim, "recorder", None)
        auditing = rec is not None and rec.enabled and rec.audit is not None
        stages, funcs, base, margin, quota = self._stage_ctx(app, stage)
        w = max(now - j.inst.arrival_ms for j in jobs)
        slo = max(j.inst.slo_ms for j in jobs)
        if w >= slo:
            # deadline already lost: the SLO miss is sunk — serve at the
            # globally cost-optimal config (paper's "ensure progress";
            # Config(1,1,1) would pin a 76B model to one chip for minutes)
            # (calibration is multiplicative per stage, so the job-cost
            # argmin — and hence this config — is factor-invariant)
            if auditing:
                rec.on_plan_result(PlanRecord(
                    t_ms=now, app=app.name, stage=stage, n_jobs=len(jobs),
                    g_slo_ms=0.0, regime="sunk", expansions=0,
                    pruned_time=0, pruned_cost=0, est_time_ms=None,
                    est_job_cost=None, slack_ms=None, n_candidates=1,
                    provenance=base[0].fn.provenance))
            return [self._cheapest_config(funcs[0], len(jobs))]
        remaining = max(slo - w, 1.0)
        g_slo = remaining * quota
        g_slo = max((g_slo - margin) / self.time_inflation, 1.0)

        bucket = self._bucket(base[0], max(len(jobs), 1))
        tables = self._prepared(funcs, base, bucket)
        # online calibration: plan against per-stage corrected tables;
        # the residual-penalty discount below then uses corrected
        # min_times too (the calibrated prediction of how much of a
        # prefetch the predecessor's execution hides)
        factors = self._factors(app.name, stages)
        if factors is not None:
            tables = self._corrected(funcs, bucket, tables, factors)
        # heterogeneous/preemptible fleet: reprice the suffix for SKU
        # speed and expected preemption loss (None on the default fleet,
        # leaving tables and cache keys untouched)
        sku_sig = self._fleet_sig(sim)
        if sku_sig is not None:
            tables = self._spot_priced(funcs, bucket, factors,
                                       sku_sig, tables)
        # memory-aware mode: price each remaining stage's predicted
        # weight-swap penalty into the search so the configPQ is ranked
        # by true (swap-inclusive) latency and cost
        penalties = self._penalties(sim, funcs, tables)
        stats = SearchStats() if auditing else None
        if self.cache is not None:
            pen_key = tuple(penalties) if penalties is not None else None
            # the factor tuple is a cache-key axis: a published
            # correction changes the key, so plans cached under the old
            # factors can never serve a calibrated lookup (stale-plan
            # invalidation by unreachability); the fleet signature is
            # another (a reclaim/recover changes the signature, making
            # plans priced for the old fleet unreachable, PR-7 style)
            key = (funcs, bucket, pen_key) if factors is None \
                else (funcs, bucket, pen_key, factors)
            if sku_sig is not None:
                key = key + ("sku", sku_sig)
            results = self.cache.lookup(
                key, g_slo, tables, penalties, stats=stats)
            regime = self.cache.last_regime
        else:
            results = esg_1q(tables, g_slo, k=self.k, penalties_ms=penalties,
                             vectorized=self.vectorized, stats=stats)
            regime = "nocache"
        out = [r.configs[0] for r in results]
        if len(out) == 1 and results[0].est_time_ms >= g_slo:
            # infeasible target: best-effort fastest path, with cheaper
            # fallbacks so the dispatcher can still place something
            out.append(Config(min(len(jobs), 8), 2, 2))
            out.append(Config(1, 1, 1))
        if auditing:
            best = results[0]
            rec.on_plan_result(PlanRecord(
                t_ms=now, app=app.name, stage=stage, n_jobs=len(jobs),
                g_slo_ms=g_slo, regime=regime,
                expansions=stats.nodes_expanded,
                pruned_time=stats.pruned_time,
                pruned_cost=stats.pruned_cost,
                est_time_ms=best.est_time_ms,
                est_job_cost=best.est_job_cost,
                slack_ms=g_slo - best.est_time_ms,
                n_candidates=len(out),
                provenance=base[0].fn.provenance))
        return out

    # -- event-sparse emulator hook ----------------------------------------
    def plan_signature(self, sim: ClusterSim, app: Workflow, stage: str,
                       jobs: list[Job], now: float):
        """Certified identity token for the candidate list ``plan`` would
        return right now, or None when no certificate is available.

        Only the plan cache's budget-free regime is certifiable (the
        result is provably independent of the exact G_SLO there); the
        sunk-deadline path, the floor/exact regimes and unbuilt cache
        entries all return None, forcing the emulator to re-plan."""
        if self.cache is None or not jobs:
            return None
        stages, funcs, base, margin, quota = self._stage_ctx(app, stage)
        w = max(now - j.inst.arrival_ms for j in jobs)
        slo = max(j.inst.slo_ms for j in jobs)
        if w >= slo:
            return None
        remaining = max(slo - w, 1.0)
        g_slo = max((remaining * quota - margin) / self.time_inflation, 1.0)
        bucket = self._bucket(base[0], max(len(jobs), 1))
        tables = self._prepared(funcs, base, bucket)
        # mirror plan() exactly: the certificate must be keyed under the
        # same factor axis, so a calibration step (new factors -> new
        # key) silently invalidates outstanding sparse-skip certificates
        factors = self._factors(app.name, stages)
        if factors is not None:
            tables = self._corrected(funcs, bucket, tables, factors)
        sku_sig = self._fleet_sig(sim)
        if sku_sig is not None:
            tables = self._spot_priced(funcs, bucket, factors,
                                       sku_sig, tables)
        penalties = self._penalties(sim, funcs, tables)
        pen_key = tuple(penalties) if penalties is not None else None
        key = (funcs, bucket, pen_key) if factors is None \
            else (funcs, bucket, pen_key, factors)
        if sku_sig is not None:
            key = key + ("sku", sku_sig)
        return self.cache.budget_free_token(key, g_slo)
