"""First-class shareable-GPU device model.

Turns one invoker's accelerator into a sliceable device with three
coupled resources, replacing the scalar ``vgpus`` counter the emulator
used to carry:

  * a **fractional compute lattice** — capacity is ``vgpus *
    SLICES_PER_VGPU`` slices; every running container holds an
    :class:`Allocation` whose slice quota can be *resized without a
    restart* (HAS-GPU's vertical-scaling lever, arXiv 2505.01968);
  * **HBM accounting** — running containers pin their model weights in
    device memory; idle warm containers keep weights resident ("hot")
    until capacity pressure demotes them to host RAM ("warm" tier,
    Torpor/FaaSwap, arXiv 2306.03622) — see ``footprints.swap_in_ms``
    for the restart penalty each tier pays;
  * **two-tier warm pools** — the keep-alive pool entries the emulator's
    ``take_warm``/``add_warm`` used to store as bare expiry floats are
    now :class:`WarmContainer` objects carrying their tier and resident
    bytes.

``hbm_per_vgpu_mb=None`` (the default) models an *unbounded* HBM: usage
and peaks are still tracked, but nothing is ever demoted and every warm
container stays hot — this is exactly the pre-device-model emulator
behaviour, so legacy runs reproduce bit-for-bit.  Pass a finite value to
turn memory into a real constraint.

``shared_weights=True`` switches the HBM ledger to Torpor's read-only
weight sharing: all containers of one function on the device map the
same resident checkpoint, so N containers charge ``model_mb`` *once*,
refcounted in a per-function :class:`WeightSet` (running allocations pin
the set; idle keep-alive containers reference it but leave it demotable).
Demotion and swap-in then act on the whole function at once — every
sibling container flips tier together, because they share the bytes.
The default ``shared_weights=False`` keeps the PR-2 per-container-copy
accounting bit-for-bit.

``overlap=True`` replaces the additive restart-penalty scalars with an
asynchronous per-device PCIe :class:`~repro.gpu.transfer.TransferEngine`
timeline: ``start`` routes swap-ins and cold weight loads through the
engine and returns a *completion time* (``Allocation.ready_ms``) instead
of a synchronous charge, ``prefetch`` re-promotes demoted weights as
background copies that overlap the predecessor stage's execution, and
``swap_cost_ms`` becomes a query of the *residual* transfer time.  The
default ``overlap=False`` keeps the PR-3 additive accounting bit-exact.

Every mutation re-verifies the oversubscription invariants (slices,
HBM, refcounts, per-allocation floors) and raises
:class:`OversubscribedError` on violation — the property tests drive
random alloc/resize/release/swap sequences straight through the public
API.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import math
from collections import Counter, defaultdict
from typing import Optional

from repro_torch.gpu.footprints import (COLD, DEFAULT_SKU, HOT, WARM, GpuSKU,
                                  cold_components, swap_in_ms,
                                  tier_penalty_ms)
from repro_torch.gpu.transfer import Transfer, TransferEngine

# Quota lattice resolution: 1/4 vGPU.  The scheduler's integer-vGPU
# configuration lattice maps onto it as ``cfg.vgpu * SLICES_PER_VGPU``;
# vertical resizes move in single-slice steps.
SLICES_PER_VGPU = 4
MIN_SLICES = 1


class OversubscribedError(RuntimeError):
    """A device invariant (slice or HBM capacity) was violated."""


@dataclasses.dataclass
class Allocation:
    """One running container's share of the device."""
    aid: int
    func: str
    slices: int              # current compute quota
    initial_slices: int      # quota granted at dispatch (resize anchor)
    hbm_mb: float            # weights pinned while running
    # --- overlap mode (transfer-engine timeline) ---
    ready_ms: float = 0.0            # when the weights land (exec gate)
    full_penalty_ms: float = 0.0     # what the additive model would charge


@dataclasses.dataclass
class WarmContainer:
    """One keep-alive pool entry."""
    func: str
    expiry: float
    hbm_mb: float            # resident bytes (0 once demoted, or shared)
    tier: str                # HOT | WARM
    # overlap mode: in-flight background copy backing this container's
    # HOT tier (non-shared ledger only; shared residency lives on the
    # WeightSet), and whether it counts toward predictive-prefetch stats
    transfer: Optional[Transfer] = None
    prefetched: bool = False


@dataclasses.dataclass
class WeightSet:
    """Refcounted read-only weight residency for one function on one
    device (``shared_weights`` mode): N containers charge ``mb`` once.

    ``resident`` stays True even for 0-byte footprints so unknown
    functions behave exactly like the per-copy ledger; ``mb`` is the
    HBM actually charged (0 once demoted to host RAM).
    """
    func: str
    mb: float = 0.0
    resident: bool = False
    run_refs: int = 0        # running allocations pinning the set
    warm_refs: int = 0       # idle keep-alive containers referencing it
    # overlap mode: the copy currently backing residency (None once it
    # landed long ago) and the predictive-prefetch accounting flag
    transfer: Optional[Transfer] = None
    prefetched: bool = False


@dataclasses.dataclass
class DeviceStats:
    hot_hits: int = 0
    warm_hits: int = 0       # container found but weights were in host RAM
    cold_misses: int = 0
    swap_ins: int = 0
    swap_in_ms: float = 0.0
    demotions: int = 0       # hot -> warm evictions under HBM pressure
    resizes_up: int = 0
    resizes_down: int = 0
    hbm_peak_mb: float = 0.0
    shared_hits: int = 0     # starts that mapped weights a peer had pinned
    # overlap mode: predictive-prefetch outcome accounting
    prefetch_issued: int = 0
    prefetch_hits: int = 0   # a start consumed prefetched weights
    prefetch_wasted: int = 0  # prefetched weights demoted/expired unused


class DeviceModel:
    def __init__(self, vgpus: int,
                 hbm_per_vgpu_mb: Optional[float] = None,
                 slices_per_vgpu: int = SLICES_PER_VGPU,
                 shared_weights: bool = False,
                 overlap: bool = False,
                 sku: Optional[GpuSKU] = None,
                 validate: bool = True):
        self.sku = sku if sku is not None else DEFAULT_SKU
        # when False, check() is a no-op: invariants are still upheld by
        # construction, we just skip re-verifying the ledgers after every
        # mutation (the dominant cost at day-scale replay)
        self.validate = validate
        # per-SKU host->HBM bandwidth feeds every swap/cold-load figure
        self._gbps = self.sku.h2d_gbps
        self.vgpus = vgpus
        self.slices_per_vgpu = slices_per_vgpu
        self.total_slices = vgpus * slices_per_vgpu
        self.used_slices = 0
        self.hbm_total_mb = (math.inf if hbm_per_vgpu_mb is None
                             else vgpus * hbm_per_vgpu_mb)
        self.hbm_used_mb = 0.0
        self.shared_weights = shared_weights
        self.overlap = overlap
        self.engine = TransferEngine()
        self.weights: dict[str, WeightSet] = {}
        self._gc_now = -math.inf
        # earliest expiry across every pooled container (lower bound:
        # removals may leave it stale-low, which only costs one no-op
        # sweep) — lets the per-probe _gc skip the pool scan entirely
        # until simulated time actually crosses an expiry
        self._next_expiry = math.inf
        self.pools: dict[str, list[WarmContainer]] = defaultdict(list)
        self.allocs: dict[int, Allocation] = {}
        self._aid = itertools.count()
        self.stats = DeviceStats()
        # flight recorder (repro.obs), set by Recorder.bind_sim; None
        # means unobserved
        self.recorder = None
        self.device_id = -1

    # ---- capacity views ---------------------------------------------------
    @property
    def free_slices(self) -> int:
        return self.total_slices - self.used_slices

    @property
    def free_hbm_mb(self) -> float:
        return self.hbm_total_mb - self.hbm_used_mb

    def _capped(self, model_mb: float) -> float:
        """Oversize checkpoints (> device HBM) run in streaming mode and
        pin the whole device rather than making placement infeasible."""
        return min(model_mb, self.hbm_total_mb)

    def _swap_ms(self, model_mb: float) -> float:
        """``footprints.swap_in_ms`` at this device's SKU bandwidth."""
        return swap_in_ms(model_mb, self._gbps)

    # ---- warm-pool upkeep -------------------------------------------------
    def _gc(self, now: float) -> None:
        """Drop expired keep-alive containers, releasing resident HBM.

        Simulated time is monotone and new pool entries always expire in
        the future, so repeated sweeps at the same instant (placement
        probes every invoker x candidate) are skipped."""
        if now <= self._gc_now:
            return
        self._gc_now = now
        if now <= self._next_expiry:
            return                   # nothing can have expired yet
        nxt = math.inf
        for func, pool in self.pools.items():
            live, dropped = [], 0
            for c in pool:
                if c.expiry < now:
                    self.hbm_used_mb -= c.hbm_mb
                    dropped += 1
                    self._abandon_transfer(c)
                else:
                    live.append(c)
                    if c.expiry < nxt:
                        nxt = c.expiry
            if dropped:
                self.pools[func][:] = live
                if self.shared_weights:
                    self._drop_warm_refs(func, dropped)
        self._next_expiry = nxt

    # ---- transfer-engine bookkeeping (overlap mode) -----------------------
    def _abandon_transfer(self, owner) -> None:
        """The ``WeightSet``/``WarmContainer`` backing a copy went away
        (demotion, expiry, retire): cancel the remaining bytes and score
        a predictive prefetch that never served a start as wasted."""
        if owner.transfer is not None:
            self.engine.cancel(owner.transfer)
            owner.transfer = None
        if owner.prefetched:
            self.stats.prefetch_wasted += 1
            owner.prefetched = False

    def _in_flight(self, tr: Optional[Transfer], now: float) -> bool:
        return tr is not None and (tr in self.engine.queue
                                   or tr.done_ms > now)

    def _residual(self, tr: Optional[Transfer], now: float) -> float:
        """Time until a copy's weights are usable (0 for none/landed)."""
        if tr is None:
            return 0.0
        return self.engine.residual_ms(tr, now)

    # ---- shared-weights ledger helpers ------------------------------------
    def _ws(self, func: str) -> WeightSet:
        ws = self.weights.get(func)
        if ws is None:
            ws = self.weights[func] = WeightSet(func)
        return ws

    def _drop_warm_refs(self, func: str, k: int) -> None:
        """k idle containers of ``func`` went away; free the weight set
        once nothing references it any more."""
        ws = self.weights.get(func)
        if ws is None:
            return
        ws.warm_refs -= k
        if ws.run_refs <= 0 and ws.warm_refs <= 0:
            self.hbm_used_mb -= ws.mb
            self._abandon_transfer(ws)
            del self.weights[func]

    def _resident(self, func: str) -> bool:
        ws = self.weights.get(func)
        return ws is not None and ws.resident

    def _pool_min_expiry(self, func: str) -> float:
        return min((c.expiry for c in self.pools[func]), default=math.inf)

    def _load_shared(self, func: str, model_mb: float) -> None:
        """Charge ``func``'s shared weight set and (re-)promote every
        sibling keep-alive container — they map the same bytes."""
        ws = self._ws(func)
        need = self._capped(model_mb)
        self.hbm_used_mb += need
        ws.mb = need
        ws.resident = True
        for c in self.pools[func]:
            c.tier = HOT

    def _demotable_mb(self, exclude_func: Optional[str] = None) -> float:
        if self.shared_weights:
            return sum(ws.mb for ws in self.weights.values()
                       if ws.run_refs == 0 and ws.mb > 0
                       and ws.func != exclude_func)
        return sum(c.hbm_mb for func, pool in self.pools.items()
                   for c in pool
                   if c.tier == HOT and func != exclude_func)

    def _ensure_hbm(self, need_mb: float) -> None:
        """Demote idle hot containers (earliest-expiry ~ LRU first) until
        ``need_mb`` fits.  Caller must have verified feasibility.  In
        shared mode the victim is a whole weight set (no running pins):
        its resident bytes go to host and every sibling container flips
        to the warm tier together."""
        while self.free_hbm_mb < need_mb:
            if self.shared_weights:
                victims = [ws for ws in self.weights.values()
                           if ws.run_refs == 0 and ws.mb > 0]
                if not victims:
                    raise OversubscribedError(
                        f"need {need_mb:.0f} MB HBM, "
                        f"free {self.free_hbm_mb:.0f} MB, nothing demotable")
                ws = min(victims,
                         key=lambda w: self._pool_min_expiry(w.func))
                self.hbm_used_mb -= ws.mb
                ws.mb = 0.0
                ws.resident = False
                self._abandon_transfer(ws)
                for c in self.pools[ws.func]:
                    c.tier = WARM
                self.stats.demotions += 1
                if self.recorder is not None:
                    self.recorder.on_demotion(self.device_id, ws.func,
                                              self._gc_now)
                continue
            victims = [c for pool in self.pools.values() for c in pool
                       if c.tier == HOT and c.hbm_mb > 0]
            if not victims:
                raise OversubscribedError(
                    f"need {need_mb:.0f} MB HBM, "
                    f"free {self.free_hbm_mb:.0f} MB, nothing demotable")
            victim = min(victims, key=lambda c: c.expiry)
            self.hbm_used_mb -= victim.hbm_mb
            victim.hbm_mb = 0.0
            victim.tier = WARM
            self._abandon_transfer(victim)
            self.stats.demotions += 1
            if self.recorder is not None:
                self.recorder.on_demotion(self.device_id, victim.func,
                                          self._gc_now)

    def _hot(self, func: str):
        return [c for c in self.pools[func] if c.tier == HOT]

    # ---- admission --------------------------------------------------------
    def fits(self, slices: int, model_mb: float = 0.0,
             func: Optional[str] = None, now: float = 0.0) -> bool:
        """Can a container of ``slices`` quota for ``func`` start now?

        HBM feasibility counts weights already resident in a hot warm
        container for ``func`` (they would be reused, costing nothing)
        and idle hot containers of *other* functions (they can be
        demoted to host to make room).  With ``shared_weights`` the
        whole check runs against the refcounted weight ledger: resident
        weights admit any number of sibling containers for free."""
        self._gc(now)
        if slices > self.free_slices:
            return False
        return self._hbm_feasible(model_mb, func)

    def hbm_admits(self, model_mb: float, func: Optional[str] = None,
                   now: float = 0.0) -> bool:
        """HBM-only feasibility (compute slices ignored) — lets the
        vertical autoscaler avoid shrinking quotas for a placement that
        memory would reject anyway."""
        self._gc(now)
        return self._hbm_feasible(model_mb, func)

    def _hbm_feasible(self, model_mb: float, func: Optional[str]) -> bool:
        if func is not None:
            if self.shared_weights:
                if self._resident(func):
                    return True              # shared reuse: no new HBM
            elif any(c.tier == HOT for c in self.pools[func]):
                return True                  # hot reuse: no new HBM needed
        need = self._capped(model_mb)
        return need <= self.free_hbm_mb + self._demotable_mb(func)

    # ---- residency queries (memory-aware placement / planning) ------------
    def residency(self, func: str, now: float) -> str:
        """Warm-state tier the *next* container start of ``func`` would
        pay: HOT (a hot keep-alive container exists — free restart),
        WARM (a container exists but its weights live in host RAM —
        swap-in penalty), COLD (nothing — full cold start)."""
        self._gc(now)
        pool = self.pools.get(func, ())
        if any(c.tier == HOT for c in pool):
            return HOT
        if pool:
            return WARM
        return COLD

    def swap_cost_ms(self, func: str, model_mb: float, now: float,
                     cold_ms: Optional[float] = None) -> float:
        """Predicted restart penalty of starting ``func`` on this device
        right now (0 hot / ``swap_in_ms`` warm / ``cold_ms`` cold; with
        no ``cold_ms`` the weight-load lower bound is used for COLD).

        Shared-weights refinement: when the pool is empty but a *peer*
        container keeps the function's weights resident, a new container
        still cold-boots — yet its weight load is a free mapping, so the
        cold penalty is discounted by the weight-load component.  This
        is also what the emulator bills, and it is what makes
        memory-aware placement prefer weight-dense invokers even when
        every keep-alive container of the function is busy.

        Overlap mode turns this into a query of *residual* transfer
        time: a HOT tier backed by an in-flight copy costs the time
        until the bytes land, and a cold boot costs only the slower of
        container provisioning and the weight copy — the two overlap on
        the transfer-engine timeline instead of adding up."""
        tier = self.residency(func, now)
        if self.overlap:
            if tier == HOT:
                if self.shared_weights:
                    ws = self.weights.get(func)
                    return self._residual(ws.transfer if ws else None, now)
                res = [self._residual(c.transfer, now)
                       for c in self._hot(func)]
                return min(res) if res else 0.0
            if tier == WARM:
                return self._swap_ms(model_mb)   # demand copy from host RAM
            prov, w = cold_components(model_mb, cold_ms, self._gbps)
            if self.shared_weights and self._resident(func):
                # peer-resident weights: the boot waits only for
                # provisioning — or for the peer's copy still in flight
                ws = self.weights[func]
                return max(prov, self._residual(ws.transfer, now))
            return max(prov, w)
        if tier == COLD and self.shared_weights and self._resident(func):
            if cold_ms is None:
                return 0.0
            return max(cold_ms - self._swap_ms(model_mb), 0.0)
        return tier_penalty_ms(tier, model_mb, cold_ms, self._gbps)

    # ---- container lifecycle ---------------------------------------------
    def start(self, func: str, slices: int, model_mb: float,
              now: float,
              cold_ms: Optional[float] = None) -> tuple[Allocation, str]:
        """Start a container: pop the best warm-pool entry (hot before
        warm, earliest expiry first) and pin weights + quota.  Returns
        ``(allocation, tier)`` where tier tells the caller which restart
        penalty to charge (hot: 0, warm: ``swap_in_ms``, cold: full
        cold start).

        In overlap mode the penalty is a *timeline* instead of a scalar:
        swap-ins and cold weight loads are enqueued on the PCIe transfer
        engine and ``alloc.ready_ms`` carries the completion time the
        caller gates execution on (``exec_start = max(start, ready)``);
        ``alloc.full_penalty_ms`` records what the additive model would
        have charged, so the hidden portion is auditable.  ``cold_ms``
        (the function's full cold-start figure) is only consulted on the
        overlap path — the legacy path charges it at the emulator."""
        self._gc(now)
        if slices > self.free_slices:
            raise OversubscribedError(
                f"alloc {slices} slices > free {self.free_slices}")
        pool = self.pools[func]
        # the pool is expiry-sorted, so "min expiry within a tier" is
        # the first entry of that tier — one early-exit scan, no
        # per-tier list builds (day-scale pools run hundreds deep)
        hit: Optional[WarmContainer] = None
        if self.overlap and not self.shared_weights:
            # prefer a hot copy whose weights have landed over one
            # still in flight (legacy expiry order breaks ties);
            # settle the lazy queue first so a prefetch that
            # already arrived is not misread as in flight — but only
            # when a hot copy exists, as the legacy path did
            first_warm = advanced = None
            for c in pool:
                if c.tier == HOT:
                    if not advanced:
                        self.engine._advance(now)
                        advanced = True
                    if not self._in_flight(c.transfer, now):
                        hit = c
                        break
                    if hit is None:
                        hit = c              # earliest in-flight hot
                elif first_warm is None and c.tier == WARM:
                    first_warm = c
            if hit is None:
                hit = first_warm
        else:
            first_warm = None
            for c in pool:
                if c.tier == HOT:
                    hit = c
                    break
                if first_warm is None and c.tier == WARM:
                    first_warm = c
            if hit is None:
                hit = first_warm
        if hit is not None:
            pool.remove(hit)
        ready, full = now, 0.0
        if self.shared_weights:
            was_resident = self._resident(func)
            tier, hbm = self._attach_shared(func, model_mb, hit)
            if self.overlap:
                ready, full = self._shared_timeline(
                    func, model_mb, tier, was_resident, cold_ms, now)
        elif hit is not None and hit.tier == HOT:
            tier, hbm = HOT, hit.hbm_mb      # weights stay where they are
            self.stats.hot_hits += 1
            if self.overlap:
                ready, full = self._consume_hot(hit, now)
        else:
            need = self._capped(model_mb)
            self._ensure_hbm(need)
            self.hbm_used_mb += need
            hbm = need
            if hit is not None:
                tier = WARM
                self.stats.warm_hits += 1
                self.stats.swap_ins += 1
                self.stats.swap_in_ms += self._swap_ms(model_mb)
                if self.overlap:
                    full = self._swap_ms(model_mb)
                    ready = self.engine.demand(func, full, now).done_ms
            else:
                tier = COLD
                self.stats.cold_misses += 1
                if self.overlap:
                    # container provisioning (CPU-side) overlaps the
                    # weight copy on the PCIe engine
                    prov, w = cold_components(model_mb, cold_ms, self._gbps)
                    wdone = (self.engine.demand(func, w, now).done_ms
                             if w > 0.0 else now)
                    ready, full = max(now + prov, wdone), prov + w
        self.used_slices += slices
        alloc = Allocation(next(self._aid), func, slices, slices, hbm,
                           ready_ms=ready, full_penalty_ms=full)
        self.allocs[alloc.aid] = alloc
        self.stats.hbm_peak_mb = max(self.stats.hbm_peak_mb,
                                     self.hbm_used_mb)
        self.check()
        return alloc, tier

    # ---- overlap-mode start timelines -------------------------------------
    def _ready_of(self, owner, now: float,
                  count_hit: bool = True) -> tuple[float, float]:
        """(ready_ms, full_penalty_ms) of consuming ``owner``'s HOT
        weights.  An in-flight prefetch is *promoted* — only the
        remaining bytes finish at demand priority.  ``full`` rolls the
        warm state back to what the additive model (which has no
        background copies) would have seen: the copy's full duration
        while it is unconsumed/in flight, zero once it has genuinely
        served a start."""
        tr = owner.transfer
        ready, full = now, 0.0
        if tr is not None:
            if tr in self.engine.queue:
                self.engine.promote(tr, now)
            ready = max(tr.done_ms, now)
            if owner.prefetched or tr.done_ms > now:
                full = tr.total_ms
        if owner.prefetched:
            if count_hit:
                self.stats.prefetch_hits += 1
            owner.prefetched = False
        return ready, full

    def _consume_hot(self, hit: WarmContainer, now: float) -> tuple[float, float]:
        return self._ready_of(hit, now)

    def _shared_timeline(self, func: str, model_mb: float, tier: str,
                         was_resident: bool, cold_ms: Optional[float],
                         now: float) -> tuple[float, float]:
        """Overlap timeline of a shared-weights attach (runs after
        ``_attach_shared`` settled tier and HBM accounting)."""
        ws = self._ws(func)
        w_full = self._swap_ms(model_mb)
        if tier == HOT:
            return self._ready_of(ws, now)
        if tier == WARM:
            # demoted set re-loaded on the critical path: demand copy;
            # every sibling shares the completion time
            ws.prefetched = False
            ws.transfer = self.engine.demand(func, w_full, now)
            return ws.transfer.done_ms, w_full
        prov, w = cold_components(model_mb, cold_ms, self._gbps)
        if was_resident:
            # peer-resident weights (PR-3 discount): the cold boot waits
            # only for provisioning — or for the peer's copy in flight
            wready, wfull = self._ready_of(ws, now)
            return max(now + prov, wready), prov + wfull
        ws.prefetched = False
        if w > 0.0:
            ws.transfer = self.engine.demand(func, w, now)
            return max(now + prov, ws.transfer.done_ms), prov + w
        ws.transfer = None
        return now + prov, prov

    def _attach_shared(self, func: str, model_mb: float,
                       hit: Optional[WarmContainer]) -> tuple[str, float]:
        """Shared-weights attach: the new container maps the function's
        refcounted weight set instead of charging its own copy.  Returns
        ``(tier, alloc_hbm_mb)`` — the allocation itself carries 0 bytes,
        all residency lives on the :class:`WeightSet`."""
        ws = self._ws(func)
        if hit is not None:
            ws.warm_refs -= 1
        if ws.resident:
            # bytes still mapped by a *peer* (not just the popped hit):
            # the attach shares them instead of charging a copy
            if ws.run_refs > 0 or ws.warm_refs > 0:
                self.stats.shared_hits += 1
            if hit is not None:
                tier = HOT                   # container + weights both live
                self.stats.hot_hits += 1
            else:
                tier = COLD                  # container must still cold-boot
                self.stats.cold_misses += 1
        else:
            need = self._capped(model_mb)
            self._ensure_hbm(need)
            self._load_shared(func, model_mb)
            if hit is not None:
                # container survived, the shared set was demoted: one
                # swap-in re-promotes every sibling at once
                tier = WARM
                self.stats.warm_hits += 1
                self.stats.swap_ins += 1
                self.stats.swap_in_ms += self._swap_ms(model_mb)
            else:
                tier = COLD
                self.stats.cold_misses += 1
        ws.run_refs += 1
        return tier, 0.0

    def resize(self, aid: int, new_slices: int) -> bool:
        """Vertically resize a *running* allocation's compute quota
        without a restart.  Returns False (no-op) if the target is
        below the floor or the device lacks free slices to grow."""
        a = self.allocs.get(aid)
        if a is None or new_slices < MIN_SLICES:
            return False
        delta = new_slices - a.slices
        if delta == 0:
            return False
        if delta > 0 and delta > self.free_slices:
            return False
        self.used_slices += delta
        a.slices = new_slices
        if delta > 0:
            self.stats.resizes_up += 1
        else:
            self.stats.resizes_down += 1
        self.check()
        return True

    def stop(self, aid: int, expiry: float) -> WarmContainer:
        """Finish a container: free its quota and park it in the
        keep-alive pool *hot* — weights remain resident until expiry or
        demotion."""
        a = self.allocs.pop(aid)
        self.used_slices -= a.slices
        if self.shared_weights:
            ws = self._ws(a.func)
            ws.run_refs -= 1
            ws.warm_refs += 1
            # the running allocation pinned the set (_ensure_hbm never
            # demotes while run_refs > 0), so the weights are resident
            # and the container always parks hot
            c = WarmContainer(a.func, expiry, 0.0, HOT)
        else:
            c = WarmContainer(a.func, expiry, a.hbm_mb, HOT)
        pool = self.pools[a.func]
        bisect.insort(pool, c, key=lambda x: x.expiry)
        if c.expiry < self._next_expiry:
            self._next_expiry = c.expiry
        self.check()
        return c

    # ---- spot reclamation -------------------------------------------------
    def kill(self, aid: int) -> Allocation:
        """Reclamation kill: drop a *running* allocation without parking
        a keep-alive container — unlike :meth:`stop`, the container and
        its pinned weights die with the device.  In shared mode the run
        pin is released and the weight set is freed once nothing else
        references it."""
        a = self.allocs.pop(aid)
        self.used_slices -= a.slices
        if self.shared_weights:
            ws = self._ws(a.func)
            ws.run_refs -= 1
            if ws.run_refs <= 0 and ws.warm_refs <= 0:
                self.hbm_used_mb -= ws.mb
                self._abandon_transfer(ws)
                del self.weights[a.func]
        else:
            self.hbm_used_mb -= a.hbm_mb
        self.check()
        return a

    def reclaim(self) -> None:
        """The device vanished (spot reclamation): wipe every keep-alive
        pool, weight set and in-flight transfer.  Running allocations
        must have been :meth:`kill`-ed first; afterwards the HBM ledger
        reads zero and ``check()`` still holds, so a later recovery
        restarts from a genuinely cold device."""
        if self.allocs:
            raise OversubscribedError(
                f"reclaim() with {len(self.allocs)} live allocations")
        for pool in self.pools.values():
            for c in pool:
                self.hbm_used_mb -= c.hbm_mb
                self._abandon_transfer(c)
            pool.clear()
        for func in list(self.weights):
            ws = self.weights.pop(func)
            self.hbm_used_mb -= ws.mb
            self._abandon_transfer(ws)
        self.check()

    def empty(self, now: float) -> bool:
        """No running allocation and no live keep-alive container — the
        next start on a SKU with ``warmup_ms`` pays the warm-up-from-zero
        latency."""
        self._gc(now)
        return not self.allocs and \
            not any(pool for pool in self.pools.values())

    # ---- warm-pool API (autoscalers / emulator) ---------------------------
    def add_warm(self, func: str, expiry: float, model_mb: float,
                 now: float = 0.0) -> WarmContainer:
        """Pre-warm a container.  It comes up hot if HBM is free; under
        pressure it is provisioned warm (weights staged in host RAM) —
        pre-warming never demotes somebody else's resident weights."""
        self._gc(now)
        if self.shared_weights:
            ws = self._ws(func)
            if ws.resident:
                c = WarmContainer(func, expiry, 0.0, HOT)   # maps the peer's
            elif self._capped(model_mb) <= self.free_hbm_mb:
                # re-loading a previously-demoted set promotes every WARM
                # sibling at once; that H2D copy is a real swap-in and is
                # counted.  Legacy mode treats it as a free background
                # copy (no start ever pays its latency); overlap mode
                # puts it on the PCIe engine, so a start arriving before
                # the bytes land pays the honest residual.
                repromote = any(e.tier == WARM for e in self.pools[func])
                if repromote:
                    self.stats.swap_ins += 1
                    self.stats.swap_in_ms += self._swap_ms(model_mb)
                self._load_shared(func, model_mb)
                if self.overlap and repromote and self._swap_ms(model_mb) > 0:
                    self._ws(func).transfer = self.engine.prefetch(
                        func, self._swap_ms(model_mb), now)
                c = WarmContainer(func, expiry, 0.0, HOT)
                self.stats.hbm_peak_mb = max(self.stats.hbm_peak_mb,
                                             self.hbm_used_mb)
            else:
                c = WarmContainer(func, expiry, 0.0, WARM)
            ws.warm_refs += 1
        else:
            need = self._capped(model_mb)
            if need <= self.free_hbm_mb:
                self.hbm_used_mb += need
                c = WarmContainer(func, expiry, need, HOT)
                self.stats.hbm_peak_mb = max(self.stats.hbm_peak_mb,
                                             self.hbm_used_mb)
            else:
                c = WarmContainer(func, expiry, 0.0, WARM)
        bisect.insort(self.pools[func], c, key=lambda x: x.expiry)
        if c.expiry < self._next_expiry:
            self._next_expiry = c.expiry
        self.check()
        return c

    def prefetch(self, func: str, model_mb: float, now: float) -> bool:
        """Predictively re-promote ``func``'s demoted weights (WARM
        tier) as a *background* PCIe copy — Torpor's predicted-next
        prefetch: issued when the pipeline's previous stage dispatches,
        the copy overlaps that stage's execution so the successor's
        start finds the weights landed (or mostly landed).

        Speculative work never hurts bystanders: the copy only runs on
        link time no demand copy wants, and HBM is only taken when it
        is free — a guess never demotes somebody else's weights.
        Returns True when a copy was enqueued (overlap mode only)."""
        if not self.overlap:
            return False
        self._gc(now)
        if self.residency(func, now) != WARM:
            return False                 # nothing demoted to re-promote
        need = self._capped(model_mb)
        if need > self.free_hbm_mb:
            return False
        w = self._swap_ms(model_mb)
        if w <= 0.0:
            return False
        tr = self.engine.prefetch(func, w, now)
        if self.shared_weights:
            self._load_shared(func, model_mb)    # charges HBM, flips pool
            ws = self._ws(func)
            ws.transfer, ws.prefetched = tr, True
        else:
            # promote the longest-lived staged container (most useful)
            victim = max((c for c in self.pools[func] if c.tier == WARM),
                         key=lambda c: c.expiry)
            self.hbm_used_mb += need
            victim.hbm_mb = need
            victim.tier = HOT
            victim.transfer, victim.prefetched = tr, True
        self.stats.swap_ins += 1
        self.stats.swap_in_ms += w
        self.stats.prefetch_issued += 1
        self.stats.hbm_peak_mb = max(self.stats.hbm_peak_mb,
                                     self.hbm_used_mb)
        self.check()
        return True

    def has_warm(self, func: str, now: float) -> bool:
        return any(c.expiry >= now for c in self.pools[func])

    def warm_entries(self, func: str, now: float) -> list[WarmContainer]:
        return [c for c in self.pools[func] if c.expiry >= now]

    def retire(self, func: str, container: WarmContainer) -> None:
        """Scale-down: drop one keep-alive container, freeing HBM (in
        shared mode the weights stay until the last reference goes)."""
        self.pools[func].remove(container)
        self.hbm_used_mb -= container.hbm_mb
        self._abandon_transfer(container)
        if self.shared_weights:
            self._drop_warm_refs(func, 1)
        self.check()

    # ---- invariants -------------------------------------------------------
    def check(self) -> None:
        """Raise OversubscribedError if any invariant is violated."""
        if not self.validate:
            return
        used = sum(a.slices for a in self.allocs.values())
        if used != self.used_slices:
            raise OversubscribedError(
                f"slice ledger drift: {used} != {self.used_slices}")
        if not 0 <= self.used_slices <= self.total_slices:
            raise OversubscribedError(
                f"slices oversubscribed: {self.used_slices}"
                f"/{self.total_slices}")
        if any(a.slices < MIN_SLICES for a in self.allocs.values()):
            raise OversubscribedError("allocation below MIN_SLICES")
        if self.shared_weights:
            resident = sum(ws.mb for ws in self.weights.values())
            run_counts = Counter(a.func for a in self.allocs.values())
            referenced = set(run_counts) | \
                {f for f, p in self.pools.items() if p}
            if referenced != set(self.weights):
                raise OversubscribedError(
                    f"weight-set drift: ledger {sorted(self.weights)} vs "
                    f"referenced {sorted(referenced)}")
            for func, ws in self.weights.items():
                if ws.run_refs != run_counts.get(func, 0) or \
                        ws.warm_refs != len(self.pools.get(func, ())):
                    raise OversubscribedError(
                        f"refcount drift for {func}: runs {ws.run_refs}/"
                        f"{run_counts.get(func, 0)}, warms {ws.warm_refs}/"
                        f"{len(self.pools.get(func, ()))}")
                if ws.mb < 0 or (not ws.resident and ws.mb != 0):
                    raise OversubscribedError(
                        f"weight bytes drift for {func}: mb={ws.mb} "
                        f"resident={ws.resident}")
                if any((c.tier == HOT) != ws.resident
                       for c in self.pools.get(func, ())):
                    raise OversubscribedError(
                        f"tier desync for {func}: shared weights resident="
                        f"{ws.resident} but pool tiers disagree")
            if any(c.hbm_mb for pool in self.pools.values() for c in pool) \
                    or any(a.hbm_mb for a in self.allocs.values()):
                raise OversubscribedError(
                    "per-container HBM charged in shared-weights mode")
        else:
            resident = sum(a.hbm_mb for a in self.allocs.values()) + \
                sum(c.hbm_mb for pool in self.pools.values() for c in pool)
        if not math.isclose(resident, self.hbm_used_mb,
                            rel_tol=1e-9, abs_tol=1e-6):
            raise OversubscribedError(
                f"HBM ledger drift: {resident} != {self.hbm_used_mb}")
        if math.isfinite(self.hbm_total_mb) and \
                self.hbm_used_mb > self.hbm_total_mb + 1e-6:
            raise OversubscribedError(
                f"HBM oversubscribed: {self.hbm_used_mb:.0f}"
                f"/{self.hbm_total_mb:.0f} MB")
        # overlap mode: the transfer ledger is work-conserving and
        # prefetch flags only ever back resident (HOT) weights
        self.engine.check()
        if self.shared_weights:
            if any(ws.prefetched and not ws.resident
                   for ws in self.weights.values()):
                raise OversubscribedError(
                    "prefetched weight set not resident")
        elif any(c.prefetched and c.tier != HOT
                 for pool in self.pools.values() for c in pool):
            raise OversubscribedError("prefetched container not HOT")
