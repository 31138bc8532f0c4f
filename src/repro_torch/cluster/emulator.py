"""Discrete-event serverless-cluster emulator (paper §4 methodology).

Mirrors the paper's own evaluation setup: an OpenWhisk-like controller
driving emulated invokers, with
  * the (vcpu, vgpu) resource lattice per invoker (16 vCPU + 8 vTPU here —
    the TPU-host adaptation of "16 vCPUs + 1 A100 split into 7 MIGs"),
  * cold starts + 10-min keep-alive container pools,
  * pluggable warm-pool autoscaling (``repro.serving.autoscaler``; the
    default ``EwmaPrewarm`` policy is the paper-§4 EWMA pre-warming),
  * the local-vs-remote data-passing model (locality benefit),
  * Gaussian execution noise on top of the profile model,
  * measured scheduling overhead folded into simulated latency (this is
    what Fig 9 / Fig 10 measure).

Schedulers plug in via the ``SchedulerPolicy`` protocol; the event loop,
batching, dispatch bookkeeping, recheck list and accounting are shared so
comparisons isolate the scheduling algorithm (paper §4.2).  Warm-pool
policies plug in via the ``autoscaler`` argument, and an optional
``admission`` callback (see ``repro.serving.gateway``) may reject
arrivals at the door (load shedding).

The scheduling core is *event-sparse* by default (``sparse=True``):
queue retries only run when the triggering event could actually have
changed their placement feasibility or candidate configs, and placement
fallbacks walk a cached capacity-sorted invoker order.  The full-scan
reference behaviour (``sparse=False``) replays bit-identically — the
differential tests in ``tests/test_planner_fastpath.py`` pin it.

Day-scale replay additions (all bit-identical to the legacy paths, the
differential tests in ``tests/test_sharded_replay.py`` pin them):

  * the scheduling pass walks an *active ready set* (non-empty,
    non-blocked queues ordered by queue-creation index — exactly the
    dict-insertion order the full scan iterated) instead of scanning
    every queue key ever created per event;
  * ``retain="stream"`` drops the O(invocations) retention lists
    (``tasks``/``completed``/``shed``/``sched_overheads_ms``) in favour
    of streaming accumulators + log-bucketed histograms, and recycles
    ``Task``/``Job`` dataclasses through free-list pools (``gen`` keeps
    counting across reuses so stale resize/complete events can never
    match a recycled task);
  * ``add_arrival_stream`` feeds arrivals lazily from a generator while
    *reserving* their event sequence numbers up front, so the heap pops
    in exactly the order full pre-injection would have produced;
  * ``track_digest=True`` folds every retired task and completed
    request into a running blake2b digest — the cross-process,
    cross-mode schedule fingerprint the sharded replay engine
    (``repro.cluster.shard``) compares against the legacy emulator.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import math
import time as _walltime
import zlib
from collections import defaultdict, deque
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.profiles import (Config, FunctionProfile, ProfileTable,
                                 VCPU_PRICE_PER_H, VGPU_PRICE_PER_H)
from repro_torch.core.workflows import Workflow
from repro_torch.gpu import (COLD, DEFAULT_SKU, DeviceModel, GpuSKU,
                       SLICES_PER_VGPU, resolve_sku)
from repro_torch.obs import NULL_RECORDER

KEEPALIVE_MS = 600_000.0          # OpenWhisk 10-minute keep-alive
LOCAL_TRANSFER_MS = 1.0
REMOTE_TRANSFER_FIXED_MS = 20.0
REMOTE_TRANSFER_MS_PER_MB = 8.0   # ~125 MB/s remote store
RECHECK_LIMIT = 3
# free-list caps for ``retain="stream"`` (bounds pool memory; anything
# past the cap is simply left to the garbage collector)
TASK_POOL_CAP = 4096
JOB_POOL_CAP = 65536


def home_invoker(app_name: str, func: str, n_invokers: int) -> int:
    """Stable home-invoker choice for a root stage (shared with the
    autoscalers so seeded warm pools land where placement will look).
    Builtin str hash is per-process randomised, hence crc32."""
    return zlib.crc32(f"{app_name}/{func}".encode()) % n_invokers


# ---------------------------------------------------------------------------
# Jobs / instances
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AppInstance:
    app: Workflow
    uid: int
    arrival_ms: float
    slo_ms: float                     # end-to-end budget
    stage_invoker: dict = dataclasses.field(default_factory=dict)
    pending_preds: dict = dataclasses.field(default_factory=dict)
    done: bool = False
    finish_ms: float = -1.0
    plan: Any = None                  # Orion/Aquatope static plans
    # --- preemptible-fleet bookkeeping ---
    failed: bool = False              # shed mid-flight after repeated reclaims
    # stage -> fraction of exec completed at the last kill (stages with
    # ``checkpoint_mb`` resume from here instead of re-running from start)
    ckpt_frac: dict = dataclasses.field(default_factory=dict)

    @property
    def deadline_ms(self) -> float:
        return self.arrival_ms + self.slo_ms


@dataclasses.dataclass
class Job:
    inst: AppInstance
    stage: str
    ready_ms: float                   # when inputs became available


@dataclasses.dataclass
class Task:
    jobs: list[Job]
    stage: str
    func: str
    config: Config
    invoker: int
    start_ms: float
    end_ms: float
    cold: bool
    cost: float
    # --- device-model bookkeeping (fractional vGPU + swap tiers) ---
    tid: int = -1                # index into sim.tasks
    tier: str = COLD             # warm-state tier paid at start (hot/warm/cold)
    alloc_id: int = -1           # DeviceModel allocation id while running
    quota_slices: int = 0        # current compute quota (slices)
    exec_start_ms: float = 0.0   # start + residual restart penalty
    dispatch_ms: float = 0.0     # sim time the allocation was taken
    gen: int = 0                 # resize generation (stale-event guard)
    q_since: float = 0.0         # quota unchanged since (slice-ms account)
    # --- overlapped-swap accounting ---
    penalty_ms: float = 0.0      # restart penalty actually charged
    full_penalty_ms: float = 0.0  # what the additive model would charge
    # --- preemptible-fleet accounting ---
    preempted: bool = False      # killed mid-task by a spot reclamation

    @property
    def quota_vgpu(self) -> float:
        return self.quota_slices / SLICES_PER_VGPU


# ---------------------------------------------------------------------------
# Invokers
# ---------------------------------------------------------------------------
class Invoker:
    """One emulated host: a vCPU counter plus a sliceable accelerator
    (``repro.gpu.DeviceModel``) carrying the fractional-quota lattice,
    HBM accounting and two-tier keep-alive pools.  ``footprints`` maps
    function name -> model-weight MB (0 for unknown functions)."""

    def __init__(self, idx: int, vcpus: int, vgpus: int,
                 hbm_per_vgpu_mb: Optional[float] = None,
                 footprints: Optional[dict[str, float]] = None,
                 shared_weights: bool = False,
                 overlap: bool = False,
                 sku: Optional[GpuSKU] = None,
                 device_checks: bool = True):
        self.idx = idx
        self.vcpus = vcpus
        self.vgpus = vgpus
        self.free_vcpu = vcpus
        self.footprints = footprints or {}
        self.sku = sku if sku is not None else DEFAULT_SKU
        # exec times are divided by the SKU's throughput rate; the vGPU
        # billing component scales with its $/slice-hour factor.  Both
        # are 1.0 on the default SKU (bit-identical arithmetic).
        self.exec_slowdown = 1.0 / self.sku.exec_rate
        self.price_factor = self.sku.price_factor
        # spot lifecycle: draining between reclamation warning and the
        # kill, down during the post-reclaim outage
        self.down = False
        self.draining = False
        hbm = (self.sku.hbm_per_vgpu_mb
               if self.sku.hbm_per_vgpu_mb is not None else hbm_per_vgpu_mb)
        self.device = DeviceModel(vgpus, hbm_per_vgpu_mb=hbm,
                                  shared_weights=shared_weights,
                                  overlap=overlap, sku=self.sku,
                                  validate=device_checks)
        # optional sim hook observing new keep-alive expiries (the
        # event-sparse emulator's expiry watermark)
        self.note_expiry: Optional[Callable[[float], None]] = None

    @property
    def free_vgpu(self) -> float:
        """Free accelerator share in vGPU units (fractional once running
        pools have been vertically resized)."""
        return self.device.free_slices / SLICES_PER_VGPU

    def model_mb(self, func: str) -> float:
        return self.footprints.get(func, 0.0)

    def fits(self, c: Config, func: Optional[str] = None,
             now: float = 0.0) -> bool:
        if self.down or self.draining:
            return False
        return self.free_vcpu >= c.vcpu and self.device.fits(
            c.vgpu * SLICES_PER_VGPU,
            self.model_mb(func) if func else 0.0, func, now)

    def add_warm(self, func: str, expiry: float, now: float = 0.0):
        if self.down or self.draining:
            return               # nothing survives on a doomed device
        self.device.add_warm(func, expiry, self.model_mb(func), now)
        if self.note_expiry is not None:
            self.note_expiry(expiry)

    def has_warm(self, func: str, now: float) -> bool:
        return self.device.has_warm(func, now)

    def residency(self, func: str, now: float) -> str:
        """Warm-state tier a start of ``func`` would pay here (hot/warm/cold).
        ``now`` is required: querying stale pools without a GC sweep
        would report expired containers as live."""
        return self.device.residency(func, now)

    def start_penalty_ms(self, func: str, cold_ms: Optional[float],
                         now: float) -> float:
        """Predicted restart penalty of starting ``func`` on this invoker
        at ``now`` — the memory-aware placement/planning ranking term.
        Under the overlapped swap pipeline this is the *residual*
        transfer time (an in-flight prefetch shrinks it toward zero)."""
        return self.device.swap_cost_ms(func, self.model_mb(func), now,
                                        cold_ms)

    def prefetch(self, func: str, now: float) -> bool:
        """Enqueue a background PCIe copy re-promoting ``func``'s
        demoted weights (overlap mode; see ``DeviceModel.prefetch``)."""
        return self.device.prefetch(func, self.model_mb(func), now)


# ---------------------------------------------------------------------------
# Scheduler protocol
# ---------------------------------------------------------------------------
class SchedulerPolicy:
    """Interface the emulator drives.  ``plan`` returns a priority-ordered
    list of configs for the queue's *current* stage (paper: configPQ);
    ``placement`` is 'locality' (ESG/Orion/Aquatope), 'fragmentation'
    (INFless/FaST-GShare) or 'memory' (weight-locality-aware: the paper's
    locality order still leads — data transfer dominates — but the
    fallback ranks invokers by the restart penalty their warm state
    implies: hot weights > host-staged weights > cold, Torpor-style).
    With unbounded HBM no weights are ever demoted, every fallback
    candidate's penalty class collapses to has-warm/cold and 'memory'
    reproduces 'locality' bit-for-bit (the differential tests pin this).
    """
    name = "base"
    placement = "locality"
    charged_overhead_ms = 0.0

    def plan(self, sim: "ClusterSim", app: Workflow, stage: str,
             jobs: list[Job], now: float) -> list[Config]:
        raise NotImplementedError

    def plan_signature(self, sim: "ClusterSim", app: Workflow, stage: str,
                       jobs: list[Job], now: float):
        """Certified identity token for the candidate list ``plan`` would
        return right now, or None when the policy cannot certify one.
        The event-sparse emulator compares tokens across events to prove
        a blocked queue's retry futile without re-planning; returning
        None (the default) simply forces the full re-plan."""
        return None

    def on_arrival(self, sim: "ClusterSim", inst: AppInstance, now: float):
        pass


# ---------------------------------------------------------------------------
# The emulator
# ---------------------------------------------------------------------------
class ClusterSim:
    def __init__(self,
                 apps: dict[str, Workflow],
                 tables: dict[str, ProfileTable],
                 profiles: dict[str, FunctionProfile],
                 scheduler: SchedulerPolicy,
                 n_invokers: int = 16,
                 vcpus: int = 16,
                 vgpus: int = 8,
                 noise_sigma: float = 0.05,
                 seed: int = 0,
                 count_overhead: bool = True,
                 prewarm: bool = True,
                 batching: bool = True,
                 gpu_sharing: bool = True,
                 initial_warm: int = 2,
                 autoscaler: Any = None,
                 admission: Optional[Callable] = None,
                 hbm_per_vgpu_mb: Optional[float] = None,
                 shared_weights: bool = False,
                 overlap: bool = False,
                 prefetch: bool = False,
                 sparse: bool = True,
                 recorder: Any = None,
                 fleet: Optional[list] = None,
                 reclaim_storms: Optional[list[tuple]] = None,
                 max_retries: int = 4,
                 retry_backoff_ms: float = 250.0,
                 retain: str = "full",
                 track_digest: bool = False,
                 device_checks: bool = True,
                 executor: Any = None):
        if retain not in ("full", "stream"):
            raise ValueError(f"retain must be 'full' or 'stream', "
                             f"got {retain!r}")
        self.apps = apps
        self.tables = tables
        self.profiles = profiles
        self.sched = scheduler
        self.shared_weights = shared_weights
        # overlapped swap pipeline: restart penalties become completion
        # times on a per-device PCIe transfer engine; ``prefetch`` adds
        # the predicted-next-stage background copies.  Both default off:
        # legacy configurations replay bit-identically.
        if prefetch and not overlap:
            raise ValueError("prefetch=True requires overlap=True "
                             "(prefetch is a transfer-engine lever)")
        self.overlap = overlap
        self.prefetch_weights = prefetch
        # event-sparse scheduling core: prewarm events unblock only the
        # queues whose placement feasibility they could have changed
        # (same function, keep-alive expiry crossed, HBM freed by a
        # demotion overshoot), and placement fallbacks walk a cached
        # capacity-sorted invoker order instead of re-scanning the fleet.
        # ``sparse=False`` restores the full-scan reference behaviour;
        # both replay bit-identically (tests/test_planner_fastpath.py) —
        # the only observable difference is that provably-futile retry
        # attempts stop being timed into ``sched_overheads_ms``.
        self.sparse = sparse
        self.sparse_skips = 0                 # provably-futile retries skipped
        self._block_sig: dict[tuple[str, str], Any] = {}
        self._min_expiry = math.inf           # earliest live keep-alive expiry
        self._cap_order: list[int] = []
        self._cap_dirty = True
        footprints = {n: getattr(p, "model_mb", 0.0)
                      for n, p in profiles.items()}
        # heterogeneous / preemptible fleet: ``fleet`` is a list of SKU
        # names (or GpuSKU objects) assigned round-robin across the
        # invokers.  None — or any spelling that resolves to the neutral
        # DEFAULT_SKU everywhere, e.g. ["a100"] * n — keeps every code
        # path arithmetically identical to the homogeneous emulator.
        skus = ([resolve_sku(s) for s in fleet] if fleet
                else [DEFAULT_SKU])
        assigned = [skus[i % len(skus)] for i in range(n_invokers)]
        self._hetero = any(s != DEFAULT_SKU for s in assigned)
        self._has_spot = any(s.spot for s in assigned)
        self.invokers = [Invoker(i, vcpus, vgpus,
                                 hbm_per_vgpu_mb=hbm_per_vgpu_mb,
                                 footprints=footprints,
                                 shared_weights=shared_weights,
                                 overlap=overlap,
                                 sku=assigned[i],
                                 device_checks=device_checks)
                         for i in range(n_invokers)]
        for inv in self.invokers:
            inv.note_expiry = self._note_expiry
        # spot-reclamation machinery (inert without a spot SKU): seeded
        # reclaim schedule, retry policy, planner-facing fleet signature
        self.seed = seed
        self.reclaim_storms = [tuple(w) for w in (reclaim_storms or [])]
        self.max_retries = max_retries
        self.retry_backoff_ms = retry_backoff_ms
        self.prefer_on_demand = False
        self._sku_sig: Any = None
        self._reclaims_seeded = False
        self._retry_counts: dict[tuple[int, str], int] = {}
        # flight recorder (repro.obs): the default null object carries
        # only ``enabled = False`` and every hook site guards on it, so
        # the disabled path does no work and replays bit-identically
        self.recorder = NULL_RECORDER if recorder is None else recorder
        # stream retention recycles Task objects at completion; the flight
        # recorder holds per-task span state past that point, so the two
        # are mutually exclusive (record per shard in full mode instead)
        if retain == "stream" and self.recorder.enabled:
            raise ValueError("retain='stream' cannot be combined with an "
                             "enabled flight recorder (recorded runs keep "
                             "per-task spans; use retain='full')")
        if self.recorder.enabled:
            self.recorder.bind_sim(self)
        # real-compute bridge (repro.serving.executor): when set, every
        # dispatched task is additionally executed for real on-device,
        # asynchronously.  None (the default) is free and replays
        # bit-identically — the emulator's simulated clock never reads
        # the executor's wall clock.
        self.executor = executor
        self.noise_sigma = noise_sigma
        self.rng = np.random.default_rng(seed)
        self.count_overhead = count_overhead
        self.batching = batching
        self.gpu_sharing = gpu_sharing

        self.now = 0.0
        self._events: list[tuple] = []
        self._seq = itertools.count()
        self.queues: dict[tuple[str, str], deque[Job]] = defaultdict(deque)
        self.recheck: dict[tuple[str, str], int] = {}
        self._blocked: set[tuple[str, str]] = set()
        # active ready set: non-empty queue keys plus their creation
        # index — the scheduling pass iterates these in creation order,
        # which is exactly the dict-insertion order the legacy full scan
        # walked, without touching the (app x stage)-many idle keys
        self._nonempty: set[tuple[str, str]] = set()
        self._qorder: dict[tuple[str, str], int] = {}
        # lazy arrival stream (None = all arrivals pre-injected)
        self._arrival_iter = None
        self._arrival_seq = 0
        self._last_arrival_t = -math.inf
        # retention mode + streaming accumulators (kept in both modes so
        # digests and counters never depend on the mode)
        self.retain = retain
        self.n_tasks = 0
        self.n_completed = 0
        self.n_shed = 0
        self.slo_hits_n = 0
        self._lat_sum = 0.0
        self._ovh_sum = 0.0
        self._ovh_n = 0
        self._horizon_ms = 0.0
        self._task_pool: list[Task] = []
        self._job_pool: list[Job] = []
        self._lat_hist = self._ovh_hist = None
        if retain == "stream":
            from repro_torch.serving.telemetry import LatencyHistogram
            self._lat_hist = LatencyHistogram()
            self._ovh_hist = LatencyHistogram()
        # optional streaming hooks (set by Gateway/Telemetry in stream
        # mode): a deque of (app, stage, wait_ms) queue-delay samples the
        # gateway drains instead of scanning ``sim.tasks``, plus retire/
        # completion callbacks feeding telemetry online
        self.dispatch_feed: Optional[deque] = None
        self.on_task_retire: Optional[Callable[[Task], None]] = None
        self.on_request_done: Optional[Callable[[AppInstance], None]] = None
        # streaming schedule digest (see ``run_digest``)
        self._digest = (hashlib.blake2b(digest_size=16) if track_digest
                        else None)
        # warm-pool policy: the legacy prewarm/initial_warm knobs map onto
        # the default policies; pass ``autoscaler`` to swap in another
        if autoscaler is None:
            from repro_torch.serving.autoscaler import EwmaPrewarm, NoPrewarm
            autoscaler = (EwmaPrewarm(initial_warm=initial_warm) if prewarm
                          else NoPrewarm())
        self.autoscaler = autoscaler
        self.admission = admission    # callable(sim, inst) -> bool, or None
        # futile-retry skipping is only sound when the congestion hook has
        # no side effects: a policy overriding ``on_congestion`` (vertical
        # resizing) may free capacity, so its retries must always run
        from repro_torch.serving.autoscaler import AutoscalerPolicy
        self._congestion_noop = (type(autoscaler).on_congestion
                                 is AutoscalerPolicy.on_congestion)
        self.autoscaler.seed_pools(self)

        # metrics
        self.completed: list[AppInstance] = []
        self.shed: list[AppInstance] = []
        self.total_cost = 0.0
        self.tasks: list[Task] = []
        self.sched_overheads_ms: list[float] = []
        self.cold_starts = 0
        self.remote_transfers = 0
        self.config_misses = 0        # pre-planned config infeasible (Table 4)
        self.plan_uses = 0
        # device-model metrics
        self.running: dict[int, Task] = {}   # tid -> in-flight task
        self.resizes: list[tuple] = []       # (t, invoker, tid, old, new)
        self.slice_busy_ms = 0.0             # integral of quota over time
        # overlapped-swap accounting: penalty actually charged to task
        # starts vs what the additive model would have charged
        self.penalty_charged_ms = 0.0
        self.penalty_full_ms = 0.0
        # preemptible-fleet accounting
        self.reclaim_warnings = 0
        self.reclaims = 0
        self.recoveries = 0
        self.preemptions = 0          # running tasks killed mid-flight
        self.retries = 0              # retry/resume re-dispatches scheduled
        self.preempt_shed = 0         # instances shed after max_retries
        self.preempt_lost_ms = 0.0    # execution time lost to kills
        self.migrations = 0           # warm containers drained-and-migrated

    # ---- events ----------------------------------------------------------
    def push_event(self, t: float, kind: str, payload: Any):
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def add_arrival(self, app_name: str, t: float, slo_ms: float, uid: int):
        inst = AppInstance(self.apps[app_name], uid, t, slo_ms)
        self.push_event(t, "arrival", inst)

    def add_arrival_stream(self, arrivals, n: int) -> None:
        """Feed ``n`` arrivals lazily from an iterator of
        ``(app_name, t_ms, slo_ms, uid)`` tuples (time-sorted).

        Exactly one pending arrival event lives in the heap at a time;
        popping it pulls the next from the iterator.  The ``n`` event
        sequence numbers the pre-injection path would have handed the
        arrivals are *reserved* up front and runtime events start after
        them, so every heap comparison — and therefore the replay — is
        bit-identical to calling ``add_arrival`` ``n`` times before
        ``run()``, without materializing ``n`` ``AppInstance`` objects
        and heap entries."""
        if self._arrival_iter is not None:
            raise ValueError("an arrival stream is already attached")
        if self._has_spot:
            raise ValueError(
                "add_arrival_stream does not support spot fleets: the "
                "reclamation schedule needs the full trace horizon "
                "(pre-inject with add_arrival instead)")
        self._arrival_iter = iter(arrivals)
        base = next(self._seq)
        self._arrival_seq = base
        self._seq = itertools.count(base + n)
        self._push_next_arrival()

    def _push_next_arrival(self) -> None:
        nxt = next(self._arrival_iter, None)
        if nxt is None:
            self._arrival_iter = None
            return
        app_name, t, slo_ms, uid = nxt
        if t < self._last_arrival_t:
            raise ValueError(
                f"arrival stream must be time-sorted: got t={t} after "
                f"t={self._last_arrival_t}")
        self._last_arrival_t = t
        inst = AppInstance(self.apps[app_name], uid, t, slo_ms)
        heapq.heappush(self._events,
                       (t, self._arrival_seq, "arrival", inst))
        self._arrival_seq += 1

    # ---- queue bookkeeping ------------------------------------------------
    def _queue_push(self, key: tuple[str, str], job: Job) -> None:
        q = self.queues[key]
        if not q:
            self._nonempty.add(key)
            if key not in self._qorder:
                self._qorder[key] = len(self._qorder)
        q.append(job)

    def _new_job(self, inst: AppInstance, stage: str,
                 ready_ms: float) -> Job:
        pool = self._job_pool
        if pool:
            job = pool.pop()
            job.inst = inst
            job.stage = stage
            job.ready_ms = ready_ms
            return job
        return Job(inst, stage, ready_ms)

    # ---- main loop -------------------------------------------------------
    def run(self):
        if self._has_spot and not self._reclaims_seeded:
            self._seed_reclaims()
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            self.now = max(self.now, t)
            if kind == "arrival":
                self._on_arrival(payload)
                if self._arrival_iter is not None:
                    self._push_next_arrival()
            elif kind == "complete":
                task, gen = payload
                if gen != task.gen:
                    continue             # stale: task was resized since
                self._on_complete(task)
                self._blocked.clear()        # capacity changed: retry queues
            elif kind == "reclaim_warning":
                self._on_reclaim_warning(payload)
            elif kind == "reclaim":
                self._on_reclaim(payload)
                self._blocked.clear()        # capacity changed either way
            elif kind == "recover":
                self._on_recover(payload)
                self._blocked.clear()
            elif kind == "retry":
                self._on_retry(payload)
            elif kind == "prewarm":
                func, inv = payload
                dev = self.invokers[inv].device
                free_before = dev.free_hbm_mb
                self.invokers[inv].add_warm(func, self.now + KEEPALIVE_MS,
                                            self.now)
                if not self.sparse or dev.free_hbm_mb > free_before:
                    # a demotion overshoot (or expiry GC on this device)
                    # freed HBM: that is a capacity release, so every
                    # blocked queue could now be placeable
                    self._blocked.clear()
                else:
                    self._prewarm_unblock(func)
            elif kind == "autoscale":
                self.autoscaler.on_tick(self, payload)
                self._blocked.clear()
            self._cap_dirty = True
            if self.recorder.enabled:
                self.recorder.on_event(self, kind)
            self._schedule_pass()
        return self

    # ---- event-sparse bookkeeping ----------------------------------------
    def _note_expiry(self, expiry: float) -> None:
        if expiry < self._min_expiry:
            self._min_expiry = expiry

    def _refresh_min_expiry(self) -> None:
        now = self.now
        self._min_expiry = min(
            (c.expiry for inv in self.invokers
             for pool in inv.device.pools.values() for c in pool
             if c.expiry >= now), default=math.inf)

    def _prewarm_unblock(self, func: str) -> None:
        """Selective unblocking after a ``prewarm`` event (sparse mode).

        A warm-container add consumes HBM and touches no vCPUs or
        compute slices, so the only queues whose placement feasibility
        can have *improved* are (a) queues of the pre-warmed function
        itself (its weights just became resident) and (b) every queue if
        a keep-alive expiry was crossed since the last full retry (lazy
        GC frees capacity as a function of time, not of events).  Every
        other blocked queue is retried only if its candidate list could
        have drifted with the clock — the scheduler's ``plan_signature``
        certificate proves the common case (wide-slack budgets) did not,
        and the retry the full-scan emulator would run is then futile:
        it is accounted (recheck counter) but not executed."""
        if self.now >= self._min_expiry:
            self._blocked.clear()
            self._refresh_min_expiry()
            return
        for key in list(self._blocked):
            q = self.queues.get(key)
            if not q:
                continue        # empty queues take no part in a pass
            app = self.apps[key[0]]
            if app.func_of[key[1]] == func:
                self._blocked.discard(key)
                continue
            rec = self._block_sig.get(key)
            if rec is not None and self._congestion_noop:
                forced = self.recheck.get(key, 0) >= RECHECK_LIMIT
                sig = self.sched.plan_signature(self, app, key[1], list(q),
                                                self.now)
                if sig is not None and rec == (sig, forced):
                    # same certified candidates, non-improving capacity:
                    # mirror the futile retry's only lasting effect
                    self.recheck[key] = self.recheck.get(key, 0) + 1
                    self.sparse_skips += 1
                    if self.recorder.enabled:
                        self.recorder.on_sparse_skip(
                            self.now, key[0], key[1], sig,
                            self.recheck[key])
                    continue
            self._blocked.discard(key)

    # ---- spot reclamation -------------------------------------------------
    def _storm_mult(self, t: float) -> float:
        """Reclamation-rate multiplier at time ``t`` (storm windows are
        ``(t0_ms, t1_ms, mult)`` tuples; outside every window it is 1)."""
        for t0, t1, mult in self.reclaim_storms:
            if t0 <= t < t1:
                return max(float(mult), 1e-9)
        return 1.0

    def _seed_reclaims(self) -> None:
        """Draw each spot invoker's reclamation schedule up front from a
        dedicated seeded stream (never ``self.rng`` — its draw order is
        bit-identity-critical for dispatch noise).  Gaps are exponential
        with the SKU's mean, shrunk by the storm multiplier in effect at
        the gap's start; each reclaim announces itself ``warn_ms`` ahead.
        The horizon is bounded by the last already-queued event plus a
        tail margin, so the event loop always drains."""
        self._reclaims_seeded = True
        horizon = max((e[0] for e in self._events), default=0.0) + 60_000.0
        for inv in self.invokers:
            sku = inv.sku
            if not sku.spot or sku.reclaim_mean_s <= 0.0:
                continue
            rng = np.random.default_rng([self.seed, 7919, inv.idx])
            t = float(self.now)
            while True:
                mean_ms = sku.reclaim_mean_s * 1000.0 / self._storm_mult(t)
                t += float(rng.exponential(mean_ms))
                if t > horizon:
                    break
                self.push_event(max(t - sku.warn_ms, self.now),
                                "reclaim_warning", inv.idx)
                self.push_event(t, "reclaim", inv.idx)

    def sku_signature(self) -> Optional[tuple]:
        """Planner-facing fleet signature, folded into plan-cache keys
        and used to price SKU speed + preemption risk into both ESG_1Q
        blades.  None on a homogeneous default fleet (tables and cache
        keys stay untouched — the bit-identical replay guarantee);
        otherwise ``(exec_factor, risk_per_ms)`` over the currently-up
        invokers, recomputed lazily after every reclaim/warning/recover.

        ``exec_factor`` is the slice-weighted mean exec-time multiplier
        (1/exec_rate); ``risk_per_ms`` approximates the fleet-level
        reclamation hazard a dispatched task faces per running ms
        (spot capacity share x mean reclaim rate)."""
        if not self._hetero:
            return None
        sig = self._sku_sig
        if sig is not None:
            return sig
        up = [inv for inv in self.invokers
              if not inv.down and not inv.draining]
        if not up:
            up = list(self.invokers)
        total = sum(inv.device.total_slices for inv in up)
        eff = sum(inv.device.total_slices * inv.sku.exec_rate for inv in up)
        exec_factor = (total / eff) if eff > 0.0 else 1.0
        risk = 0.0
        if total:
            lam = sum(inv.device.total_slices /
                      (inv.sku.reclaim_mean_s * 1000.0)
                      for inv in up
                      if inv.sku.spot and inv.sku.reclaim_mean_s > 0.0)
            risk = lam / total
        sig = (round(exec_factor, 6), round(risk, 12))
        self._sku_sig = sig
        return sig

    def _on_reclaim_warning(self, inv_idx: int) -> None:
        inv = self.invokers[inv_idx]
        if inv.down or inv.draining:
            return
        inv.draining = True
        self.reclaim_warnings += 1
        self._sku_sig = None
        self._cap_dirty = True
        if self.recorder.enabled:
            self.recorder.on_reclaim_warning(self.now, inv_idx)
        # drain-and-migrate: the warm-pool policy re-homes the doomed
        # invoker's keep-alive containers before the kill lands
        self.autoscaler.on_reclaim_warning(self, inv_idx)

    def _on_reclaim(self, inv_idx: int) -> None:
        inv = self.invokers[inv_idx]
        if inv.down:
            return                   # already inside an outage
        inv.draining = False
        inv.down = True
        self.reclaims += 1
        self._sku_sig = None
        killed = sorted((t for t in self.running.values()
                         if t.invoker == inv_idx), key=lambda t: t.tid)
        for task in killed:
            self._kill_task(task, inv)
        inv.device.reclaim()
        inv.free_vcpu = inv.vcpus
        self._refresh_min_expiry()
        self.push_event(self.now + inv.sku.recover_ms, "recover", inv_idx)
        if self.recorder.enabled:
            self.recorder.on_reclaim(self.now, inv_idx, len(killed))

    def _on_recover(self, inv_idx: int) -> None:
        inv = self.invokers[inv_idx]
        if not inv.down:
            return
        inv.down = False
        inv.draining = False
        self.recoveries += 1
        self._sku_sig = None
        if self.recorder.enabled:
            self.recorder.on_recover(self.now, inv_idx)

    def _kill_task(self, task: Task, inv: Invoker) -> None:
        """Mid-task reclamation kill: stale the pending complete event,
        release compute + HBM, refund the unexecuted billing window,
        checkpoint progress for resumable stages, then schedule a retry
        with exponential backoff (or shed after ``max_retries``)."""
        now = self.now
        task.gen += 1                    # complete event goes stale
        self.running.pop(task.tid, None)
        inv.free_vcpu += task.config.vcpu
        self.slice_busy_ms += task.quota_slices * max(
            now - task.q_since, 0.0)
        inv.device.kill(task.alloc_id)
        # refund the window that will never run, billed like resize_task
        # at the current fractional-vGPU rate (SKU price factor included)
        pivot = max(now, task.exec_start_ms)
        unrun = max(task.end_ms - pivot, 0.0)
        rate = task.config.vcpu * VCPU_PRICE_PER_H + \
            task.quota_vgpu * VGPU_PRICE_PER_H * inv.price_factor
        refund = rate * unrun / 3.6e6
        task.cost -= refund
        self.total_cost -= refund
        span = task.end_ms - task.exec_start_ms
        frac = 0.0
        if span > 0.0 and now > task.exec_start_ms:
            frac = min((now - task.exec_start_ms) / span, 1.0)
        lost = max(min(now, task.end_ms) - task.exec_start_ms, 0.0)
        self.preemptions += 1
        self.preempt_lost_ms += lost
        task.end_ms = now
        task.preempted = True
        fp = self.profiles[task.func]
        resumable = fp.checkpoint_mb > 0.0 and frac > 0.0
        if self.recorder.enabled:
            self.recorder.on_preempt(self, task, lost)
        action = "resume" if resumable else "retry"
        for job in task.jobs:
            inst = job.inst
            if inst.done or inst.failed:
                continue
            if resumable:
                inst.ckpt_frac[task.stage] = max(
                    inst.ckpt_frac.get(task.stage, 0.0), frac)
            rkey = (inst.uid, task.stage)
            attempt = self._retry_counts.get(rkey, 0) + 1
            self._retry_counts[rkey] = attempt
            if attempt > self.max_retries:
                self._shed_inflight(inst, task.stage, task.invoker,
                                    attempt, lost)
                continue
            backoff = self.retry_backoff_ms * (2.0 ** (attempt - 1))
            self.retries += 1
            self.push_event(now + backoff, "retry",
                            self._new_job(inst, task.stage, now + backoff))
            if self.recorder.enabled:
                self.recorder.on_retry_decision(
                    now, inst.app.name, task.stage, inst.uid, task.invoker,
                    attempt, action, backoff, lost)
        self._retire_task(task)

    def _shed_inflight(self, inst: AppInstance, stage: str, inv_idx: int,
                       attempt: int, lost: float) -> None:
        """Give up on an instance whose stage was reclaimed more than
        ``max_retries`` times: purge its queued jobs and count it shed
        (with an audit record), so the event loop always terminates."""
        inst.failed = True
        self.preempt_shed += 1
        for skey, q in self.queues.items():
            if skey[0] != inst.app.name or not q:
                continue
            kept = [j for j in q if j.inst is not inst]
            if len(kept) != len(q):
                q.clear()
                q.extend(kept)
                if not q:
                    self._nonempty.discard(skey)
        self._shed_inst(inst)
        if self.recorder.enabled:
            self.recorder.on_retry_decision(
                self.now, inst.app.name, stage, inst.uid, inv_idx,
                attempt, "shed", 0.0, lost)

    def _on_retry(self, job: Job) -> None:
        if job.inst.done or job.inst.failed:
            return
        key = (job.inst.app.name, job.stage)
        self._queue_push(key, job)
        self._blocked.discard(key)

    # ---- handlers --------------------------------------------------------
    def _on_arrival(self, inst: AppInstance):
        if self.admission is not None and not self.admission(self, inst):
            self._shed_inst(inst)        # load-shed at the door
            return
        if self.recorder.enabled:
            self.recorder.on_admitted(inst, self.now)
        self.sched.on_arrival(self, inst, self.now)
        for s in inst.app.stages:
            inst.pending_preds[s] = len(inst.app.predecessors(s))
        for root in inst.app.roots:
            key = (inst.app.name, root)
            self._queue_push(key, self._new_job(inst, root, self.now))
            self._blocked.discard(key)

    def _shed_inst(self, inst: AppInstance) -> None:
        self.n_shed += 1
        if self.retain == "full":
            self.shed.append(inst)
        if self._digest is not None:
            self._fold(("shed", inst.uid, repr(inst.arrival_ms)))

    def _on_complete(self, task: Task):
        inv = self.invokers[task.invoker]
        inv.free_vcpu += task.config.vcpu
        self._cap_dirty = True
        # container returns to the keep-alive pool *hot*: weights stay in
        # HBM until expiry or demotion under memory pressure
        inv.device.stop(task.alloc_id, self.now + KEEPALIVE_MS)
        self._note_expiry(self.now + KEEPALIVE_MS)
        self.slice_busy_ms += task.quota_slices * max(
            self.now - task.q_since, 0.0)
        self.running.pop(task.tid, None)
        for job in task.jobs:
            inst = job.inst
            if inst.failed:
                continue             # shed mid-flight after reclamations
            if self._has_spot:
                inst.ckpt_frac.pop(task.stage, None)
                self._retry_counts.pop((inst.uid, task.stage), None)
            inst.stage_invoker[task.stage] = task.invoker
            succs = inst.app.edges.get(task.stage, ())
            if not succs and not inst.done:
                inst.done = True
                inst.finish_ms = self.now
                self._complete_inst(inst)
            for s in succs:
                inst.pending_preds[s] -= 1
                if inst.pending_preds[s] == 0:
                    skey = (inst.app.name, s)
                    self._queue_push(skey, self._new_job(inst, s, self.now))
                    self._blocked.discard(skey)
        if self.recorder.enabled:
            self.recorder.on_task_complete(self, task)
        # policy hook *after* successors are queued so the autoscaler sees
        # the true backlog (vertical policies grow idle pools here)
        self.autoscaler.on_complete(self, task)
        self._retire_task(task)

    # ---- streaming retention / digest -------------------------------------
    def _complete_inst(self, inst: AppInstance) -> None:
        self.n_completed += 1
        lat = inst.finish_ms - inst.arrival_ms
        if lat <= inst.slo_ms:
            self.slo_hits_n += 1
        if self.retain == "full":
            self.completed.append(inst)
        else:
            self._lat_sum += lat
            self._lat_hist.record(lat)
            self._horizon_ms = max(self._horizon_ms, inst.finish_ms)
        if self._digest is not None:
            self._fold(("done", inst.uid, repr(inst.arrival_ms),
                        repr(inst.finish_ms)))
        if self.on_request_done is not None:
            self.on_request_done(inst)

    def _retire_task(self, task: Task) -> None:
        """A task left the running set for good (completion or
        reclamation kill): fold it into the digest, feed the streaming
        hooks, then — in stream mode — recycle it and its jobs through
        the free-list pools instead of retaining them forever."""
        if self._digest is not None:
            self._fold_task(task)
        if self.on_task_retire is not None:
            self.on_task_retire(task)
        if self.retain == "full":
            return
        self._horizon_ms = max(self._horizon_ms, task.end_ms)
        task.gen += 1                 # stale any in-flight resize events
        jobs = task.jobs
        task.jobs = []
        pool = self._job_pool
        for job in jobs:
            if len(pool) < JOB_POOL_CAP:
                job.inst = None       # release the AppInstance
                pool.append(job)
        if len(self._task_pool) < TASK_POOL_CAP:
            self._task_pool.append(task)

    def _fold(self, payload: tuple) -> None:
        self._digest.update(repr(payload).encode())

    def _fold_task(self, task: Task) -> None:
        # everything schedule_digest-style comparisons care about, minus
        # ``gen`` (monotone across pool reuses, so mode-dependent)
        c = task.config
        self._fold(("task", task.tid, task.stage, task.func,
                    c.batch, c.vcpu, c.vgpu, task.invoker,
                    repr(task.start_ms), repr(task.end_ms),
                    repr(task.exec_start_ms), task.tier, task.cold,
                    repr(task.cost), task.quota_slices,
                    repr(task.penalty_ms), repr(task.full_penalty_ms),
                    task.preempted,
                    tuple(j.inst.uid for j in task.jobs)))

    def run_digest(self) -> str:
        """Hex digest of the streamed schedule: every retired task's
        placement/timing/cost tuple, every completion and shed, plus the
        run totals.  Identical across ``retain`` modes, arrival feeding
        modes and processes — the bit-identity fingerprint the sharded
        replay engine compares (requires ``track_digest=True``)."""
        if self._digest is None:
            raise ValueError("run_digest requires ClusterSim("
                             "track_digest=True)")
        h = self._digest.copy()
        h.update(repr(("totals", self.n_tasks, self.n_completed,
                       self.n_shed, self.slo_hits_n,
                       repr(self.total_cost), self.cold_starts,
                       self.remote_transfers, self.preemptions,
                       repr(self.slice_busy_ms),
                       repr(self.penalty_charged_ms))).encode())
        return h.hexdigest()

    # ---- scheduling pass ---------------------------------------------------
    def _schedule_pass(self):
        # active ready set: only queues currently holding jobs take part,
        # iterated in queue-creation order — exactly the dict-insertion
        # order the legacy `self.queues.items()` scan produced, without
        # the O(total queue keys)-per-event cost at day scale
        ready = self._nonempty - self._blocked
        if not ready:
            return
        qorder = self._qorder
        for key in sorted(ready, key=qorder.__getitem__):
            # round-robin over AFW queues, draining each (paper Fig 2d);
            # blocked queues wait for a capacity-changing event (the recheck
            # list retry is capacity-driven: within a pass capacity only
            # shrinks, so immediate retries are provably futile)
            while self.queues[key] and key not in self._blocked:
                if not self._try_queue(key):
                    break
            if not self.queues[key]:
                self._nonempty.discard(key)

    def _try_queue(self, key: tuple[str, str]) -> bool:
        """Dispatch from one AFW queue; returns True if a task was launched."""
        q = self.queues[key]
        if not q:
            self.recheck.pop(key, None)
            return False
        app_name, stage = key
        app = self.apps[app_name]
        jobs = list(q)

        t0 = _walltime.perf_counter()
        self.sched.charged_overhead_ms = 0.0
        candidates = self.sched.plan(self, app, stage, jobs, self.now)
        overhead_ms = (_walltime.perf_counter() - t0) * 1e3
        # schedulers may charge a (deterministic, pre-measured) overhead
        # instead of re-running an identical search per instance (Orion)
        charged = getattr(self.sched, "charged_overhead_ms", 0.0)
        if charged:
            overhead_ms = charged
        if self.retain == "full":
            self.sched_overheads_ms.append(overhead_ms)
        else:
            self._ovh_sum += overhead_ms
            self._ovh_n += 1
            self._ovh_hist.record(overhead_ms)
        if self.recorder.enabled:
            self.recorder.on_plan_timed(self)
        # scheduling overhead delays the task being scheduled (the controller
        # runs one proxy thread per queue — paper §4); it is charged to the
        # dispatched task's start below, not serialised on the global clock.
        overhead_charge = overhead_ms if self.count_overhead else 0.0

        forced = self.recheck.get(key, 0) >= RECHECK_LIMIT
        if forced:
            # stuck in recheck: force the cheapest config (ensures progress
            # without pinning huge models to a single accelerator)
            tbl = self.tables[app.func_of[stage]]
            cheapest = tbl.configs[int(np.argmin(tbl.job_costs))]
            candidates = (candidates or []) + [cheapest, Config(1, 1, 1)]

        def attempt() -> bool:
            for cfg in candidates:
                if not self.batching:
                    cfg = Config(1, cfg.vcpu, cfg.vgpu)
                if not self.gpu_sharing:
                    cfg = Config(cfg.batch, cfg.vcpu, self.invokers[0].vgpus)
                miss = cfg.batch > len(jobs)
                cfg = Config(min(cfg.batch, len(jobs)), cfg.vcpu, cfg.vgpu)
                inv = self._place(app, stage, jobs[: cfg.batch], cfg)
                if inv is not None:
                    if getattr(self.sched, "static_plan", False):
                        self.plan_uses += 1
                        self.config_misses += int(miss)
                    self._dispatch(key, jobs[: cfg.batch], cfg, inv,
                                   overhead_charge)
                    self.recheck.pop(key, None)
                    return True
            return False

        if attempt():
            return True
        # congestion hook: a vertical autoscaler may shrink the quotas of
        # running pools to make room, then the placement is retried once
        if self.autoscaler.on_congestion(self, app, stage, candidates) \
                and attempt():
            return True
        self.recheck[key] = self.recheck.get(key, 0) + 1
        self._blocked.add(key)
        if self.sparse and self._congestion_noop:
            # remember what this failed attempt planned against so later
            # prewarm events can prove a retry futile without re-planning
            sig = self.sched.plan_signature(self, app, stage, jobs, self.now)
            self._block_sig[key] = None if sig is None else (sig, forced)
        return False

    # ---- placement ---------------------------------------------------------
    def _locality_order(self, app: Workflow, stage: str,
                        jobs: list[Job]) -> list[int]:
        """Paper-§3.4 data-locality preference: the stable home invoker
        for root stages, else the predecessors' invokers by frequency."""
        preds = app.predecessors(stage)
        order: list[int] = []
        if not preds:
            order.append(home_invoker(app.name, app.func_of[stage],
                                      len(self.invokers)))
        else:
            pred_invs = [j.inst.stage_invoker.get(p)
                         for j in jobs for p in preds]
            pred_invs = [p for p in pred_invs if p is not None]
            if pred_invs:
                # kept verbatim from the pre-fast-path code: argsort's
                # default sort is unstable past 16 elements, so any
                # "equivalent" reimplementation can reorder count-tied
                # invokers on large fleets and break bit-identical replay
                vals, counts = np.unique(pred_invs, return_counts=True)
                order.extend(int(v) for v in vals[np.argsort(-counts)])
        return order

    def _capacity_order(self) -> list[int]:
        """Invoker indices, most free accelerator (then CPU) first —
        rebuilt lazily after capacity mutations so placement fallbacks
        walk one pre-sorted list instead of re-scanning the fleet."""
        if self._cap_dirty:
            invs = self.invokers
            self._cap_order = sorted(
                range(len(invs)),
                key=lambda i: (-invs[i].free_vgpu, -invs[i].free_vcpu, i))
            self._cap_dirty = False
        return self._cap_order

    def _place(self, app: Workflow, stage: str, jobs: list[Job],
               cfg: Config) -> Optional[int]:
        if self._has_spot and self.prefer_on_demand:
            # burn-rate alert firing: try the reliable partition first,
            # spill onto spot capacity only when on-demand is full
            got = self._place_any(app, stage, jobs, cfg, spot_ok=False)
            if got is not None:
                return got
        return self._place_any(app, stage, jobs, cfg)

    def _place_any(self, app: Workflow, stage: str, jobs: list[Job],
                   cfg: Config, spot_ok: bool = True) -> Optional[int]:
        func = app.func_of[stage]

        def ok(inv: Invoker) -> bool:
            return (spot_ok or not inv.sku.spot) and \
                inv.fits(cfg, func, self.now)

        if self.sched.placement == "fragmentation":
            # best-fit: minimise leftover GPU after placement (INFless/FaST)
            best, best_left = None, None
            for inv in self.invokers:
                if ok(inv):
                    left = inv.free_vgpu - cfg.vgpu
                    if best_left is None or left < best_left:
                        best, best_left = inv.idx, left
            return best
        # locality preference first (paper §3.4) — shared by the 'locality'
        # and 'memory' policies: avoiding a remote predecessor transfer is
        # worth more than any swap-in, and keeping this leg identical is
        # what lets 'memory' degrade to 'locality' bit-for-bit when HBM
        # is unbounded
        order = self._locality_order(app, stage, jobs)
        for idx in order:
            if ok(self.invokers[idx]):
                return idx
        if self.sched.placement == "memory":
            # weight-locality fallback: rank the remaining candidates by
            # the restart penalty their warm state implies (hot weights 0
            # < host-staged swap_in_ms < full cold start), breaking ties
            # exactly like the legacy warm/cold steps (most free first) —
            # the swap-in is paid once per attach, never per container,
            # when the device ledger shares read-only weights
            cold_ms = self.profiles[func].cold_ms
            rest = [i for i in self.invokers
                    if i.idx not in order and ok(i)]
            if not rest:
                return None
            return min(rest, key=lambda i: (
                i.start_penalty_ms(func, cold_ms, self.now),
                -i.free_vgpu, -i.free_vcpu, i.idx)).idx
        if self.sparse:
            # one walk over the capacity-sorted order replaces the two
            # full warm/cold scans: the first *fitting* invoker in that
            # order is exactly max((free_vgpu, free_vcpu)) over the
            # fitting set (ties resolve to the lowest index, as max()
            # did), and warm-over-cold preference is kept by remembering
            # the first fit while continuing to look for a warm one.
            # Locality-order invokers already failed fits above and are
            # skipped without re-probing.
            probed = set(order)
            first_fit = None
            for idx in self._capacity_order():
                if idx in probed:
                    continue
                inv = self.invokers[idx]
                if not ok(inv):
                    continue
                if inv.has_warm(func, self.now):
                    return idx
                if first_fit is None:
                    first_fit = idx
            return first_fit
        # other warm invokers
        warm = [i for i in self.invokers
                if i.has_warm(func, self.now) and ok(i)
                and i.idx not in order]
        if warm:
            return max(warm, key=lambda i: (i.free_vgpu, i.free_vcpu)).idx
        # cold invoker with most available resources
        cold = [i for i in self.invokers if ok(i)]
        if cold:
            return max(cold, key=lambda i: (i.free_vgpu, i.free_vcpu)).idx
        return None

    # ---- dispatch ----------------------------------------------------------
    def _dispatch(self, key: tuple[str, str], jobs: list[Job], cfg: Config,
                  inv_idx: int, overhead_ms: float = 0.0):
        app_name, stage = key
        app = self.apps[app_name]
        func = app.func_of[stage]
        inv = self.invokers[inv_idx]
        q = self.queues[key]
        for _ in jobs:
            q.popleft()
        if not q:
            self._nonempty.discard(key)

        # data transfer: remote if any predecessor output lives elsewhere
        transfer = 0.0
        for job in jobs:
            for p in app.predecessors(stage):
                src = job.inst.stage_invoker.get(p)
                if src is None:
                    continue
                if src == inv_idx:
                    transfer = max(transfer, LOCAL_TRANSFER_MS)
                else:
                    self.remote_transfers += 1
                    transfer = max(
                        transfer, REMOTE_TRANSFER_FIXED_MS +
                        REMOTE_TRANSFER_MS_PER_MB * self.profiles[func].input_mb)

        # warm-up-from-zero: the first start on a completely empty device
        # of a SKU with a bring-up latency pays it on top of the tier
        # penalty (the default SKU carries 0 and skips the probe)
        warmup_ms = 0.0
        if inv.sku.warmup_ms > 0.0 and inv.device.empty(self.now):
            warmup_ms = inv.sku.warmup_ms

        slices = cfg.vgpu * SLICES_PER_VGPU
        if self.overlap:
            # overlapped swap pipeline: the restart penalty is a
            # transfer-engine *completion time* (``alloc.ready_ms``),
            # not a scalar — execution gates on the weights landing,
            # so the swap-in hides behind data transfer, scheduling
            # overhead and any prefetch issued at the predecessor's
            # dispatch; only the residual is charged below
            alloc, tier = inv.device.start(
                func, slices, inv.model_mb(func), self.now,
                cold_ms=self.profiles[func].cold_ms)
        else:
            # the predicted restart penalty IS the billed one — hot: free;
            # warm: the Torpor-style swap-in transfer (weights were demoted
            # to host RAM), not a full cold start; cold: full cold start,
            # discounted by the weight-load component when shared weights
            # are already resident via a running peer (see
            # ``DeviceModel.swap_cost_ms``)
            penalty_ms = inv.start_penalty_ms(
                func, self.profiles[func].cold_ms, self.now)
            alloc, tier = inv.device.start(func, slices, inv.model_mb(func),
                                           self.now)
        cold = tier == COLD
        if cold:
            self.cold_starts += 1

        noise = float(np.clip(
            1.0 + self.rng.normal(0.0, self.noise_sigma), 0.5, 2.0))
        exec_ms = self.profiles[func].exec_ms(cfg) * noise
        if inv.exec_slowdown != 1.0:
            exec_ms *= inv.exec_slowdown       # SKU speed grade
        restore_ms = 0.0
        if self._has_spot:
            ck = self.profiles[func].checkpoint_mb
            if ck > 0.0:
                frac = min(j.inst.ckpt_frac.get(stage, 0.0) for j in jobs)
                if frac > 0.0:
                    # resume-from-checkpoint: skip the completed fraction
                    # of the batch's least-advanced job, pay the
                    # checkpoint restore copy instead of a full re-run
                    exec_ms *= (1.0 - frac)
                    restore_ms = inv.device._swap_ms(ck)
        start = self.now + overhead_ms + transfer
        if self.overlap:
            exec_start = max(start, alloc.ready_ms)
            charged = exec_start - start
            full = alloc.full_penalty_ms
        else:
            exec_start = start + penalty_ms
            charged = full = penalty_ms
        extra = warmup_ms + restore_ms
        if extra > 0.0:
            exec_start += extra
            charged += extra
            full += extra
        end = exec_start + exec_ms

        inv.free_vcpu -= cfg.vcpu
        self._cap_dirty = True
        rate = cfg.vcpu * VCPU_PRICE_PER_H + \
            cfg.vgpu * VGPU_PRICE_PER_H * inv.price_factor
        cost = rate * (charged + exec_ms) / 3.6e6
        self.total_cost += cost
        self.penalty_charged_ms += charged
        self.penalty_full_ms += full
        tid = self.n_tasks
        self.n_tasks += 1
        if self._task_pool:
            # free-list reuse (stream mode): every field is reassigned;
            # ``gen`` keeps counting from the previous life so stale
            # complete/resize events of that life can never match
            task = self._task_pool.pop()
            task.jobs = jobs
            task.stage = stage
            task.func = func
            task.config = cfg
            task.invoker = inv_idx
            task.start_ms = start
            task.end_ms = end
            task.cold = cold
            task.cost = cost
            task.tid = tid
            task.tier = tier
            task.alloc_id = alloc.aid
            task.quota_slices = slices
            task.exec_start_ms = exec_start
            task.dispatch_ms = self.now
            task.q_since = self.now
            task.penalty_ms = charged
            task.full_penalty_ms = full
            task.preempted = False
        else:
            task = Task(jobs, stage, func, cfg, inv_idx, start, end, cold,
                        cost, tid=tid, tier=tier, alloc_id=alloc.aid,
                        quota_slices=slices, exec_start_ms=exec_start,
                        dispatch_ms=self.now, q_since=self.now,
                        penalty_ms=charged, full_penalty_ms=full)
        if self.retain == "full":
            self.tasks.append(task)
        if self.dispatch_feed is not None:
            for job in jobs:
                self.dispatch_feed.append(
                    (app_name, stage, max(start - job.ready_ms, 0.0)))
        self.running[task.tid] = task
        self.push_event(end, "complete", (task, task.gen))
        if self.recorder.enabled:
            self.recorder.on_dispatch(self, task)
        if self.executor is not None:
            # real-compute bridge: run the dispatched batch on-device,
            # async — simulated time is never coupled to device wall time
            self.executor.submit(task)
        # warm-pool policy hook: reactive scale-up / pre-warm scheduling /
        # scale-down all live in repro.serving.autoscaler
        self.autoscaler.on_dispatch(self, func, inv_idx, cold,
                                    charged + exec_ms)
        if self.prefetch_weights:
            # predictive prefetch (Torpor): stage the successor stages'
            # weights on this invoker — locality placement probes it
            # first — so the copy overlaps this task's execution
            self.autoscaler.prefetch(self, app, stage, inv_idx)

    # ---- vertical reallocation ---------------------------------------------
    def resize_task(self, task: Task, new_slices: int) -> bool:
        """Vertically resize a *running* task's compute quota without a
        restart (HAS-GPU's lever).  The remaining execution is rescaled
        by the profile quota model, the completion event is re-scheduled
        (the old one goes stale via ``task.gen``), and the billed cost is
        adjusted to the new fractional-vGPU rate for the remaining time.
        Returns False if the task is not running, the target equals the
        current quota, or the device lacks free slices to grow."""
        if task.tid not in self.running or new_slices == task.quota_slices:
            return False
        inv = self.invokers[task.invoker]
        old = task.quota_slices
        if not inv.device.resize(task.alloc_id, new_slices):
            return False
        self._cap_dirty = True
        now = self.now
        fp = self.profiles[task.func]
        pivot = max(now, task.exec_start_ms)
        remaining = max(task.end_ms - pivot, 0.0)
        ratio = fp.exec_ms(task.config,
                           quota_vgpu=new_slices / SLICES_PER_VGPU) / \
            fp.exec_ms(task.config, quota_vgpu=old / SLICES_PER_VGPU)
        new_remaining = remaining * ratio
        # re-bill the remaining window at the new fractional-vGPU rate
        # (SKU price factor included, 1.0 on the default fleet)
        old_rate = task.config.vcpu * VCPU_PRICE_PER_H + \
            (old / SLICES_PER_VGPU) * VGPU_PRICE_PER_H * inv.price_factor
        new_rate = task.config.vcpu * VCPU_PRICE_PER_H + \
            (new_slices / SLICES_PER_VGPU) * VGPU_PRICE_PER_H \
            * inv.price_factor
        delta = (new_rate * new_remaining - old_rate * remaining) / 3.6e6
        task.cost += delta
        self.total_cost += delta
        # close the slice-time segment at the old quota
        self.slice_busy_ms += old * max(now - task.q_since, 0.0)
        task.q_since = max(now, task.q_since)
        task.end_ms = pivot + new_remaining
        task.quota_slices = new_slices
        task.gen += 1
        self.push_event(task.end_ms, "complete", (task, task.gen))
        self.resizes.append((now, task.invoker, task.tid, old, new_slices))
        if self.recorder.enabled:
            self.recorder.on_resize(self, task, old, new_slices)
        return True

    # ---- metrics -------------------------------------------------------------
    def slo_hit_rate(self) -> float:
        # counters are maintained in both retention modes (full mode
        # additionally keeps the instance list) — same arithmetic either way
        return self.slo_hits_n / self.n_completed if self.n_completed else 0.0

    def summary(self) -> dict[str, Any]:
        if self.retain == "full":
            lat = np.array([i.finish_ms - i.arrival_ms
                            for i in self.completed]) \
                if self.completed else np.array([0.0])
            ovh = np.array(self.sched_overheads_ms) \
                if self.sched_overheads_ms else np.array([0.0])
            lat_mean, lat_p95 = float(lat.mean()), float(np.percentile(lat, 95))
            ovh_mean, ovh_p95 = float(ovh.mean()), float(np.percentile(ovh, 95))
        else:
            # streaming accumulators: means are exact, percentiles come
            # from the log-bucketed histograms (O(1) memory)
            lat_mean = (self._lat_sum / self.n_completed
                        if self.n_completed else 0.0)
            lat_p95 = self._lat_hist.percentile(95)
            ovh_mean = self._ovh_sum / self._ovh_n if self._ovh_n else 0.0
            ovh_p95 = self._ovh_hist.percentile(95)
        return {
            "scheduler": self.sched.name,
            "autoscaler": getattr(self.autoscaler, "name", "?"),
            "completed": self.n_completed,
            "shed": self.n_shed,
            "slo_hit_rate": self.slo_hit_rate(),
            "total_cost": self.total_cost,
            "mean_latency_ms": lat_mean,
            "p95_latency_ms": lat_p95,
            "mean_sched_overhead_ms": ovh_mean,
            "p95_sched_overhead_ms": ovh_p95,
            "cold_starts": self.cold_starts,
            "remote_transfers": self.remote_transfers,
            "config_misses": self.config_misses,
            "plan_uses": self.plan_uses,
            "sparse_skips": self.sparse_skips,
            **self.gpu_summary(),
        }

    def gpu_summary(self) -> dict[str, Any]:
        """Device-model metrics aggregated over the invoker fleet."""
        devs = [inv.device for inv in self.invokers]
        return {
            "hot_hits": sum(d.stats.hot_hits for d in devs),
            "warm_hits": sum(d.stats.warm_hits for d in devs),
            "swap_ins": sum(d.stats.swap_ins for d in devs),
            "swap_in_ms": sum(d.stats.swap_in_ms for d in devs),
            "demotions": sum(d.stats.demotions for d in devs),
            "resizes_up": sum(d.stats.resizes_up for d in devs),
            "resizes_down": sum(d.stats.resizes_down for d in devs),
            "hbm_peak_mb": max((d.stats.hbm_peak_mb for d in devs),
                               default=0.0),
            "shared_hits": sum(d.stats.shared_hits for d in devs),
            # overlapped-swap pipeline observability
            "transfer_busy_ms": sum(d.engine.busy_ms for d in devs),
            "transfer_demand_ms": sum(d.engine.demand_ms for d in devs),
            "transfer_prefetch_ms": sum(d.engine.prefetch_ms for d in devs),
            "prefetch_issued": sum(d.stats.prefetch_issued for d in devs),
            "prefetch_hits": sum(d.stats.prefetch_hits for d in devs),
            "prefetch_wasted": sum(d.stats.prefetch_wasted for d in devs),
            "penalty_charged_ms": self.penalty_charged_ms,
            "penalty_full_ms": self.penalty_full_ms,
            "penalty_hidden_ms": self.penalty_full_ms
            - self.penalty_charged_ms,
            # preemptible-fleet observability
            "reclaim_warnings": self.reclaim_warnings,
            "reclamations": self.reclaims,
            "recoveries": self.recoveries,
            "preemptions": self.preemptions,
            "retries": self.retries,
            "preempt_shed": self.preempt_shed,
            "preempt_lost_ms": self.preempt_lost_ms,
            "migrations": self.migrations,
        }
