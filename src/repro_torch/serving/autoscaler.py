"""Pluggable warm-pool / vGPU autoscaler policies.

The cluster emulator used to hard-code its pre-warming behaviour (EWMA
inter-arrival prediction + reactive warm-on-cold + static initial pools).
That logic now lives here behind ``AutoscalerPolicy`` so serving runs can
swap policies without touching the event loop:

  * ``EwmaPrewarm``  — the paper-§4 default, bit-compatible with the old
    emulator behaviour (initial pools, reactive scale-up on a cold start,
    EWMA-timed pre-warm events).
  * ``FineGrained``  — HAS-GPU-style fine-grained scaling: per-function
    arrival-rate and service-time estimates drive a Little's-law target
    pool size; surplus containers are retired early (scale-down), deficits
    are pre-warmed immediately.
  * ``VerticalFineGrained`` — ``FineGrained`` plus HAS-GPU's *vertical*
    lever: fractional vGPU quotas of *running* pools are resized in
    place — grown into idle slices when no work is queued, shrunk (down
    to a floor) to admit queued work that would otherwise block.
  * ``NoPrewarm``    — cold-start-always baseline (no pools, no events).

Policies interact with the emulator through five hooks:
  ``seed_pools(sim)``                       once, after invokers exist;
  ``on_dispatch(sim, func, inv, cold, ms)`` after every task dispatch;
  ``on_complete(sim, task)``                after a task finishes (its
                                            successors already queued);
  ``on_congestion(sim, app, stage, cfgs)``  when no candidate config
                                            placed — return True after
                                            freeing capacity to retry;
  ``on_tick(sim, payload)``                 on ``autoscale`` timer events
                                            the policy scheduled itself.
Pre-warms are requested by pushing the emulator's generic ``prewarm``
event; scale-down manipulates invoker device pools directly; vertical
resizes go through ``sim.resize_task``.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.profiles import Config
from repro_torch.gpu import SLICES_PER_VGPU

AUTOSCALERS: dict[str, type] = {}


def _register(cls):
    AUTOSCALERS[cls.name] = cls
    return cls


class AutoscalerPolicy:
    """Warm-pool policy interface driven by the cluster emulator."""
    name = "base"
    # optional SLO health engine (repro.obs.health): policies may read
    # ``self.health.early_warning()`` as a congestion early-warning —
    # e.g. VerticalFineGrained withholds opportunistic quota grows
    # while an alert is firing.  None (the default) changes nothing.
    health = None

    def seed_pools(self, sim) -> None:
        """Populate initial warm pools (sim.invokers exist, sim.now == 0)."""

    def on_dispatch(self, sim, func: str, inv_idx: int, cold: bool,
                    service_ms: float) -> None:
        """Observe one task dispatch (cold tells whether a warm container
        was found); schedule pre-warms / scale down as the policy sees fit."""

    def on_tick(self, sim, payload) -> None:
        """Handle an ``autoscale`` event the policy scheduled earlier."""

    def on_complete(self, sim, task) -> None:
        """Observe a task completion (capacity was just released)."""

    def on_congestion(self, sim, app, stage, candidates) -> bool:
        """No candidate config could be placed.  Return True after
        freeing capacity (e.g. shrinking running quotas) so the emulator
        retries placement once; False to let the queue block."""
        return False

    def on_reclaim_warning(self, sim, inv_idx: int) -> None:
        """Drain-and-migrate: a spot invoker announced its reclamation.
        The default policy re-homes every live keep-alive container of
        the doomed invoker onto surviving invokers (spread order, which
        prefers on-demand SKUs while a burn-rate alert is firing) so the
        warm capacity — not the running tasks, those are killed at the
        reclaim — survives the outage.  Policies may override for
        smarter draining; the hook only fires on fleets with spot SKUs,
        so default runs never enter it."""
        from repro_torch.cluster.emulator import KEEPALIVE_MS
        doomed = sim.invokers[inv_idx]
        moved = 0
        for func in sorted(doomed.device.pools):
            entries = doomed.device.warm_entries(func, sim.now)
            if not entries:
                continue
            targets = [i for i in self.spread_order(sim, func)
                       if i.idx != inv_idx and not i.down
                       and not i.draining]
            if not targets:
                continue
            for j, _ in enumerate(entries):
                targets[j % len(targets)].add_warm(
                    func, sim.now + KEEPALIVE_MS, sim.now)
                moved += 1
        if moved:
            sim.migrations += moved
            rec = getattr(sim, "recorder", None)
            if rec is not None and rec.enabled:
                rec.on_migrate(sim.now, inv_idx, moved)

    def prefetch(self, sim, app, stage: str, inv_idx: int) -> int:
        """Predictive next-stage weight prefetch (the Torpor lever,
        called by the emulator when ``sim.prefetch_weights`` is on):
        when stage ``i`` of a pipeline dispatches on ``inv_idx``, the
        successor stages' weights are enqueued there as *background*
        PCIe copies — locality placement probes that invoker first, so
        the copy overlaps stage ``i``'s execution and the successor's
        start pays only the residual.  Returns the number of copies
        enqueued; policies may override the prediction."""
        inv = sim.invokers[inv_idx]
        issued = 0
        for succ in app.edges.get(stage, ()):
            issued += int(inv.prefetch(app.func_of[succ], sim.now))
        rec = getattr(sim, "recorder", None)
        if issued and rec is not None and rec.enabled:
            rec.on_prefetch_issued(sim.now, issued)
        return issued

    # ---- shared helpers ---------------------------------------------------
    @staticmethod
    def warm_count(sim, func: str) -> int:
        return sum(len(inv.device.warm_entries(func, sim.now))
                   for inv in sim.invokers)

    @staticmethod
    def spread_order(sim, func: str) -> list:
        """Invokers ordered for pre-warm placement: emptiest first; under
        a memory-aware scheduler, invokers where the function's weights
        are already resident come first (a pre-warm there maps the shared
        read-only weights instead of staging a new copy), with the legacy
        emptiest-first order breaking ties — memory-blind runs see the
        legacy order unchanged."""
        order = sorted(sim.invokers, key=lambda i: -i.free_vgpu)
        if getattr(sim.sched, "placement", None) == "memory":
            cold_ms = sim.profiles[func].cold_ms
            order.sort(key=lambda i: i.start_penalty_ms(func, cold_ms,
                                                        sim.now))
        if getattr(sim, "prefer_on_demand", False):
            # burn-rate alert firing: stable re-sort puts reliable
            # on-demand SKUs ahead of preemptible spot capacity (no-op
            # on homogeneous fleets — every key is False)
            order.sort(key=lambda i: i.sku.spot)
        return order


@_register
class NoPrewarm(AutoscalerPolicy):
    """Every container start is cold; keep-alive reuse still applies."""
    name = "none"


@_register
class EwmaPrewarm(AutoscalerPolicy):
    """EWMA inter-arrival pre-warming (paper §4) — the default policy.

    Replicates the emulator's original hard-coded behaviour exactly:
      * ``initial_warm`` containers per function on every invoker at t=0;
      * a cold start reactively warms one extra container on that invoker;
      * per function, an EWMA of the dispatch inter-arrival schedules the
        next pre-warm ``cold_ms`` ahead of the predicted next request.
    """
    name = "ewma"

    def __init__(self, initial_warm: int = 2, alpha: float = 0.3,
                 bootstrap_interval_ms: float = 1000.0):
        self.initial_warm = initial_warm
        self.alpha = alpha
        self.bootstrap_interval_ms = bootstrap_interval_ms
        self.ewma: dict[str, tuple[float, float]] = {}  # func -> (interval, last)

    def seed_pools(self, sim):
        if not self.initial_warm:
            return
        from repro_torch.cluster.emulator import KEEPALIVE_MS
        for inv in sim.invokers:
            for func in sim.profiles:
                for _ in range(self.initial_warm):
                    inv.add_warm(func, KEEPALIVE_MS)

    def on_dispatch(self, sim, func, inv_idx, cold, service_ms):
        from repro_torch.cluster.emulator import KEEPALIVE_MS
        if cold:
            # reactive scale-up: a cold start signals under-provisioned
            # capacity — warm an extra container alongside this one
            sim.invokers[inv_idx].add_warm(func, sim.now + KEEPALIVE_MS,
                                           sim.now)
        prev = self.ewma.get(func)
        if prev is None:
            self.ewma[func] = (self.bootstrap_interval_ms, sim.now)
            return
        interval, last = prev
        obs = sim.now - last
        interval = (1.0 - self.alpha) * interval + self.alpha * obs
        self.ewma[func] = (interval, sim.now)
        lead = sim.profiles[func].cold_ms
        when = sim.now + max(interval - lead, 0.0)
        sim.push_event(when, "prewarm", (func, inv_idx))


@_register
class FineGrained(AutoscalerPolicy):
    """HAS-GPU-style fine-grained scale-up/down (arXiv 2505.01968).

    Per function, a sliding window of dispatch timestamps estimates the
    arrival rate and an EWMA tracks the service time.  Little's law gives
    the target number of concurrently-needed containers::

        target = ceil(rate * service_ms * headroom)

    Deficits are pre-warmed immediately (spread over the least-loaded
    invokers); surpluses beyond ``target + slack`` are retired by dropping
    the latest-expiring warm entries (scale-down) — the lever uniform
    keep-alive pools lack.
    """
    name = "finegrained"

    def __init__(self, window: int = 16, headroom: float = 1.25,
                 slack: int = 1, initial_warm: int = 1):
        self.window = window
        self.headroom = headroom
        self.slack = slack
        self.initial_warm = initial_warm
        self._times: dict[str, list[float]] = {}
        self._service: dict[str, float] = {}
        self._pending: dict[str, int] = {}   # prewarms pushed, not yet applied

    def seed_pools(self, sim):
        if not self.initial_warm:
            return
        from repro_torch.cluster.emulator import KEEPALIVE_MS, home_invoker
        n = len(sim.invokers)
        seeded = set()
        # minimal footprint: seed each app's root-stage function on the
        # home invoker locality placement will actually probe first
        for app in sim.apps.values():
            for root in app.roots:
                func = app.func_of[root]
                idx = home_invoker(app.name, func, n)
                if (func, idx) in seeded:
                    continue
                seeded.add((func, idx))
                for _ in range(self.initial_warm):
                    sim.invokers[idx].add_warm(func, KEEPALIVE_MS)

    def _target(self, sim, func: str) -> Optional[int]:
        ts = self._times.get(func, ())
        if len(ts) < 2:
            return None
        span = ts[-1] - ts[0]
        if span <= 0:
            return None
        rate = (len(ts) - 1) / span                       # req / ms
        service = self._service.get(
            func, sim.profiles[func].exec_ms(Config(1, 1, 1)))
        return max(1, math.ceil(rate * service * self.headroom))

    def on_dispatch(self, sim, func, inv_idx, cold, service_ms):
        from repro_torch.cluster.emulator import KEEPALIVE_MS
        ts = self._times.setdefault(func, [])
        ts.append(sim.now)
        if len(ts) > self.window:
            del ts[0]
        prev = self._service.get(func)
        self._service[func] = (service_ms if prev is None
                               else 0.7 * prev + 0.3 * service_ms)
        target = self._target(sim, func)
        if target is None:
            if cold:  # bootstrap: behave reactively until the window fills
                sim.invokers[inv_idx].add_warm(func, sim.now + KEEPALIVE_MS,
                                               sim.now)
            return
        # count prewarms already in flight (pushed but not yet popped by
        # the event loop) or same-instant dispatches would re-push the
        # whole deficit each time and overshoot the target
        have = self.warm_count(sim, func) + self._pending.get(func, 0)
        if have < target:
            # scale up: pre-warm the deficit on the emptiest invokers
            # (weight-resident invokers first under a memory-aware
            # scheduler — see ``spread_order``)
            order = self.spread_order(sim, func)
            for j in range(target - have):
                inv = order[j % len(order)]
                sim.push_event(sim.now, "autoscale", (func, inv.idx))
                self._pending[func] = self._pending.get(func, 0) + 1
        elif have > target + self.slack:
            # scale down: retire the latest-expiring surplus containers
            surplus = have - target
            pools = sorted(
                ((c, inv) for inv in sim.invokers
                 for c in inv.device.warm_entries(func, sim.now)),
                key=lambda p: -p[0].expiry)
            rec = getattr(sim, "recorder", None)
            recording = rec is not None and rec.enabled
            for c, inv in pools[:surplus]:
                inv.device.retire(func, c)
                if recording:
                    rec.on_retire(sim.now)

    def on_tick(self, sim, payload):
        from repro_torch.cluster.emulator import KEEPALIVE_MS
        func, inv_idx = payload
        sim.invokers[inv_idx].add_warm(func, sim.now + KEEPALIVE_MS, sim.now)
        self._pending[func] = max(self._pending.get(func, 0) - 1, 0)


@_register
class VerticalFineGrained(FineGrained):
    """``FineGrained`` + vertical fractional-vGPU reallocation of
    *running* pools (HAS-GPU arXiv 2505.01968's actual lever).

    Two moves, both through ``sim.resize_task`` so latency, cost and the
    device slice ledger stay consistent:

      * **grow** — when a task completes (or a dispatch leaves slack)
        and *no work is queued*, idle slices are granted to the running
        tasks on that invoker, up to ``grow_cap`` x the dispatched
        quota; tasks finish early instead of the slices idling.
      * **shrink** — when a queued stage cannot be placed anywhere, the
        policy throttles running tasks (never below ``shrink_floor`` x
        the dispatched quota, and never below one slice) on the best
        candidate invoker until the blocked config fits, then the
        emulator retries placement.  Container-granularity scaling can
        only wait for a whole container to finish; this is the lever it
        lacks.
    """
    name = "vertical"

    def __init__(self, grow_cap: float = 2.0, shrink_floor: float = 0.5,
                 **kw):
        super().__init__(**kw)
        self.grow_cap = grow_cap
        self.shrink_floor = shrink_floor

    # ---- helpers ----------------------------------------------------------
    @staticmethod
    def _queued(sim) -> bool:
        return any(len(q) for q in sim.queues.values())

    def _floor(self, task) -> int:
        return max(1, math.ceil(task.config.vgpu * SLICES_PER_VGPU *
                                self.shrink_floor))

    def _cap(self, task) -> int:
        return max(1, int(task.config.vgpu * SLICES_PER_VGPU *
                          self.grow_cap))

    @staticmethod
    def _running_on(sim, inv_idx: int):
        return sorted((t for t in sim.running.values()
                       if t.invoker == inv_idx),
                      key=lambda t: (-t.end_ms, t.tid))

    # ---- grow -------------------------------------------------------------
    def _grow(self, sim, inv_idx: int):
        if self._queued(sim):
            return                      # queued work gets the slices instead
        if self.health is not None and self.health.early_warning():
            # a firing alert (SLO burn, queue buildup, cold-start spike)
            # predicts imminent queued work: keep the idle slices free
            # for it instead of granting them to running tasks — the
            # shrink path would only claw them back a resize later
            return
        inv = sim.invokers[inv_idx]
        free = inv.device.free_slices
        for task in self._running_on(sim, inv_idx):   # latest finisher first
            if free <= 0:
                break
            grant = min(free, self._cap(task) - task.quota_slices)
            if grant > 0 and sim.resize_task(task,
                                             task.quota_slices + grant):
                free -= grant

    def on_complete(self, sim, task):
        self._grow(sim, task.invoker)

    def on_dispatch(self, sim, func, inv_idx, cold, service_ms):
        super().on_dispatch(sim, func, inv_idx, cold, service_ms)
        self._grow(sim, inv_idx)

    # ---- shrink -----------------------------------------------------------
    def on_congestion(self, sim, app, stage, candidates) -> bool:
        func = app.func_of[stage]
        for cfg in candidates:
            if not sim.gpu_sharing:
                # mirror the emulator's ablation transform: the retried
                # placement will ask for the whole device, so freeing
                # less than that is pointless throttling
                cfg = Config(cfg.batch, cfg.vcpu, sim.invokers[0].vgpus)
            need = cfg.vgpu * SLICES_PER_VGPU
            for inv in sim.invokers:
                if inv.free_vcpu < cfg.vcpu:
                    continue
                if not inv.device.hbm_admits(inv.model_mb(func), func,
                                             sim.now):
                    continue            # memory, not compute, is the blocker
                deficit = need - inv.device.free_slices
                running = self._running_on(sim, inv.idx)
                headroom = sum(max(t.quota_slices - self._floor(t), 0)
                               for t in running)
                if deficit <= 0 or headroom < deficit:
                    continue
                # throttle the biggest donors first until the config fits
                for t in sorted(running,
                                key=lambda t: (self._floor(t) -
                                               t.quota_slices, t.tid)):
                    give = min(max(t.quota_slices - self._floor(t), 0),
                               deficit)
                    if give > 0 and sim.resize_task(
                            t, t.quota_slices - give):
                        deficit -= give
                    if deficit <= 0:
                        return True
        return False


def get_autoscaler(name: str, **kw) -> AutoscalerPolicy:
    if name not in AUTOSCALERS:
        raise KeyError(f"unknown autoscaler {name!r}; "
                       f"have {sorted(AUTOSCALERS)}")
    return AUTOSCALERS[name](**kw)
