"""Sharded replay engine: partition the app population and invoker
fleet across worker processes, each running its own ``ClusterSim``, and
merge the results exactly.

The model is *topology partitioning*, the way a physical cluster is
split into cells: a shard owns a disjoint subset of the apps (stable
``crc32(app) % n_shards`` assignment) and a disjoint slice of the
invoker fleet, and placement inside a shard goes through the same
stable ``home_invoker`` hash over the shard's own fleet — shard-local
by construction, no cross-shard coordination ever needed.  That buys
three exact properties, each digest-verified in
``tests/test_sharded_replay.py`` / ``benchmarks/replay_bench.py``:

  * ``n_shards=1`` is **bit-identical** to the legacy single-process
    emulator on every scenario (the streaming retention, pooled
    allocations and lazy arrival feed change no arithmetic);
  * for a fixed shard count, the merged result is **independent of the
    worker count** — running the shards in N processes or sequentially
    in one yields the same per-shard digests and merged telemetry
    (workers are pure mechanism);
  * the merge is **exact**, not approximate: counters/costs/busy-time
    add, ``LatencyHistogram.merge`` folds bucket counts, shed scoring
    adds because a shed's scoring neighbours are same-app completions
    and an app lives in exactly one shard.

Different shard counts are different (all valid) cluster topologies —
the bench reports SLO attainment and $/1k next to wall-clock so the
fidelity of a partitioning is a number, not an assumption.

Day-scale machinery: each shard streams the *global* arrival sequence
(lazily — ``Scenario.iter_arrivals`` / a presorted on-disk trace) and
keeps only its own apps' slice, so no process ever materializes the
trace; sims run ``retain="stream"`` (Task/Job free-list pooling, O(1)
retained state) with telemetry fed online through the retire/complete
hooks.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import time
import zlib
from typing import Any, Optional

from repro_torch.cluster.emulator import ClusterSim
from repro_torch.cluster.workload import min_config_latency
from repro_torch.core.profiles import PAPER_FUNCTIONS, ProfileTable
from repro_torch.core.scheduler import ESGScheduler
from repro_torch.core.workflows import PAPER_APPS, Workflow


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ReplayConfig:
    """One replay experiment, picklable so worker processes can be
    handed the whole spec.  ``n_apps=None`` serves the paper's four
    apps verbatim (the legacy-comparison arm); an integer clones the
    paper pipelines into a population of that size."""
    scenario: str = "azure-tail"
    scenario_kw: dict = dataclasses.field(default_factory=dict)
    n: int = 10_000                  # total arrivals across all shards
    n_apps: Optional[int] = None
    n_invokers: int = 16
    vcpus: int = 16
    vgpus: int = 8
    seed: int = 0
    slo_mult: float = 1.0
    noise_sigma: float = 0.05
    retain: str = "stream"
    track_digest: bool = True
    stream_arrivals: bool = True
    shed_doomed: bool = True
    backlog_aware: bool = True
    device_checks: bool = False      # ledger re-verification off on the hot path
    sparse: bool = True
    fast_planner: bool = True
    record: bool = False             # per-shard flight recorder (full mode)


@dataclasses.dataclass
class ShardResult:
    """What one shard sends back to the merger (picklable)."""
    shard: int
    n_shards: int
    summary: dict
    telemetry: Any                   # repro.serving.telemetry.Telemetry
    digest: Optional[str]
    wall_s: float
    peak_rss_mb: float
    n_apps: int
    n_invokers: int
    n_arrivals: int
    exports: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------
def shard_of(app_name: str, n_shards: int) -> int:
    """Stable shard assignment — same hash family as ``home_invoker``,
    so the partition never depends on dict order or PYTHONHASHSEED."""
    return zlib.crc32(app_name.encode()) % n_shards


def fleet_split(n_invokers: int, n_shards: int) -> list[int]:
    """Invoker counts per shard: as even as possible, remainder to the
    low shards, every shard non-empty."""
    if n_shards > n_invokers:
        raise ValueError(f"cannot split {n_invokers} invokers across "
                         f"{n_shards} shards (empty shard fleets)")
    base, rem = divmod(n_invokers, n_shards)
    return [base + (1 if i < rem else 0) for i in range(n_shards)]


def shard_seed(seed: int, shard: int, n_shards: int) -> int:
    """Per-shard noise seed.  Shard 0 of 1 *is* the global seed, so the
    single-shard path replays the legacy emulator bit-for-bit."""
    return seed if n_shards == 1 else seed + 0x9E3779B1 * (shard + 1) % (2**31)


def make_apps(n_apps: Optional[int]) -> dict[str, Workflow]:
    """The replay app population: the paper's four pipelines verbatim
    (``n_apps=None``), or ``n_apps`` clones of them round-robin —
    cloned apps share function suffixes, so the shape-keyed plan cache
    collapses the population to a handful of entries."""
    if n_apps is None:
        return dict(PAPER_APPS)
    protos = list(PAPER_APPS.values())
    out: dict[str, Workflow] = {}
    for k in range(n_apps):
        proto = protos[k % len(protos)]
        funcs = [proto.func_of[s] for s in proto.stages]
        name = f"{proto.name}~{k:04d}"
        out[name] = Workflow.pipeline(name, funcs)
    return out


def paper_tables() -> dict[str, ProfileTable]:
    return {n: ProfileTable.build(p) for n, p in PAPER_FUNCTIONS.items()}


def _rss_mb(peak: bool = True) -> float:
    """Current (or high-watermark) RSS of this process in MB, from
    /proc/self/status — per-process, so forked shard workers report
    their own footprint."""
    field = "VmHWM" if peak else "VmRSS"
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    try:  # non-Linux fallback: high-watermark only
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except Exception:
        return 0.0


# ---------------------------------------------------------------------------
# one shard
# ---------------------------------------------------------------------------
def run_shard(cfg: ReplayConfig, shard: int, n_shards: int,
              export_dir: Optional[str] = None) -> ShardResult:
    """Run one shard's ``ClusterSim`` over its apps' slice of the
    global arrival stream and return the mergeable result."""
    from repro_torch.serving import Gateway, get_autoscaler, get_scenario

    apps_all = make_apps(cfg.n_apps)
    names_all = list(apps_all)
    if n_shards == 1:
        mine = apps_all
    else:
        mine = {a: w for a, w in apps_all.items()
                if shard_of(a, n_shards) == shard}
    tables = paper_tables()
    sched = ESGScheduler(mine, tables, plan_cache=cfg.fast_planner,
                         vectorized=cfg.fast_planner)
    recorder = None
    if cfg.record:
        if cfg.retain != "full":
            raise ValueError("record=True requires retain='full' "
                             "(the recorder keeps per-task spans)")
        from repro_torch.obs import Recorder
        recorder = Recorder()
    fleet_n = fleet_split(cfg.n_invokers, n_shards)[shard]
    sim = ClusterSim(mine, tables, PAPER_FUNCTIONS, sched,
                     n_invokers=fleet_n, vcpus=cfg.vcpus, vgpus=cfg.vgpus,
                     noise_sigma=cfg.noise_sigma,
                     seed=shard_seed(cfg.seed, shard, n_shards),
                     count_overhead=False,
                     autoscaler=get_autoscaler("ewma"),
                     sparse=cfg.sparse, recorder=recorder,
                     retain=cfg.retain, track_digest=cfg.track_digest,
                     device_checks=cfg.device_checks)
    gw = Gateway(sim, shed_doomed=cfg.shed_doomed,
                 backlog_aware=cfg.backlog_aware)
    # SLOs over the *global* app set (any shard computes the same map);
    # arrivals stream over the global sequence and keep this shard's
    # apps — uid/t/remap all global, so the union over shards is
    # exactly the unsharded trace
    slos = {a: cfg.slo_mult * min_config_latency(apps_all[a],
                                                 PAPER_FUNCTIONS)
            for a in names_all}
    sc = get_scenario(cfg.scenario, app_names=names_all,
                      **dict(cfg.scenario_kw))
    src = sc.iter_arrivals(names_all, cfg.n, seed=cfg.seed + 1)
    if n_shards > 1:
        src = (arr for arr in src if arr.app in mine)
    n_arrivals = 0
    t0 = time.perf_counter()
    if cfg.stream_arrivals:
        def _feed():
            nonlocal n_arrivals
            for arr in src:
                n_arrivals += 1
                yield (arr.app, arr.t_ms, slos[arr.app], arr.uid)
        # cfg.n is an upper bound on this shard's arrival count: the
        # reserved seq block is what the *unsharded* pre-injection path
        # would have used, which is exactly what single-shard
        # bit-identity needs (unused reservations are harmless)
        sim.add_arrival_stream(_feed(), cfg.n)
    else:
        for arr in src:
            n_arrivals += 1
            sim.add_arrival(arr.app, arr.t_ms, slos[arr.app], arr.uid)
    sim.run()
    gw.telemetry.collect(sim)
    wall = time.perf_counter() - t0
    exports: dict[str, str] = {}
    if recorder is not None and export_dir is not None:
        import pathlib
        d = pathlib.Path(export_dir)
        d.mkdir(parents=True, exist_ok=True)
        exports = recorder.export(
            trace_path=str(d / f"trace_shard{shard}.json"),
            metrics_path=str(d / f"metrics_shard{shard}.json"),
            audit_path=str(d / f"audit_shard{shard}.jsonl"))
    return ShardResult(
        shard=shard, n_shards=n_shards, summary=sim.summary(),
        telemetry=gw.telemetry,
        digest=sim.run_digest() if cfg.track_digest else None,
        wall_s=wall, peak_rss_mb=_rss_mb(peak=True),
        n_apps=len(mine), n_invokers=fleet_n, n_arrivals=n_arrivals,
        exports=exports)


def _run_shard_star(args) -> ShardResult:
    return run_shard(*args)


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------
def merge_digests(digests: list[Optional[str]]) -> Optional[str]:
    """Fleet digest: per-shard schedule digests folded in shard order.
    Worker-count independent by construction (shards are merged by
    index, not completion order)."""
    if any(d is None for d in digests):
        return None
    h = hashlib.blake2b(digest_size=16)
    for d in digests:
        h.update(d.encode())
    return h.hexdigest()


def merge_results(results: list[ShardResult]) -> dict[str, Any]:
    """Exact aggregate of a sharded run: merged telemetry summary,
    fleet digest, per-shard wall/RSS/size breakdown."""
    from repro_torch.serving.telemetry import Telemetry

    results = sorted(results, key=lambda r: r.shard)
    tel = Telemetry()
    for r in results:
        tel.merge(r.telemetry)
    total_wall = max(r.wall_s for r in results)   # parallel wall bound
    return {
        "n_shards": results[0].n_shards,
        "completed": tel.completed,
        "shed": tel.n_shed,
        "arrivals": sum(r.n_arrivals for r in results),
        "slo_attainment": tel.slo_attainment(),
        "cost_per_1k": tel.cost_per_1k(),
        "total_cost": tel.total_cost,
        "cold_starts": tel.cold_starts,
        "utilization": tel.utilization(),
        "latency": tel.e2e.to_dict(),
        "digest": merge_digests([r.digest for r in results]),
        "wall_s_max": total_wall,
        "wall_s_sum": sum(r.wall_s for r in results),
        "per_shard": [{
            "shard": r.shard, "apps": r.n_apps, "invokers": r.n_invokers,
            "arrivals": r.n_arrivals, "completed": r.summary["completed"],
            "wall_s": r.wall_s, "peak_rss_mb": r.peak_rss_mb,
            "digest": r.digest,
        } for r in results],
    }


def merged_telemetry(results: list[ShardResult]):
    """The merged ``Telemetry`` object itself (summary() for the dict)."""
    from repro_torch.serving.telemetry import Telemetry
    tel = Telemetry()
    for r in sorted(results, key=lambda r: r.shard):
        tel.merge(r.telemetry)
    return tel


# ---------------------------------------------------------------------------
# shard-tagged observability export concatenation
# ---------------------------------------------------------------------------
def merge_audit_jsonl(paths: list[str], out_path: str) -> int:
    """Concatenate per-shard audit JSONL exports, tagging every record
    with its shard id.  Returns the line count."""
    n = 0
    with open(out_path, "w") as out:
        for i, p in enumerate(paths):
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    rec["shard"] = i
                    out.write(json.dumps(rec, sort_keys=True) + "\n")
                    n += 1
    return n


def merge_metrics_json(paths: list[str], out_path: str) -> dict[str, Any]:
    """Concatenate per-shard metrics-bus exports into one document, each
    series renamed ``shard<i>/<name>`` (windows are on simulated time,
    which is per-shard — renaming keeps them distinguishable instead of
    pretending to interleave them)."""
    merged: dict[str, Any] = {"window_ms": None, "series": {}}
    for i, p in enumerate(paths):
        with open(p) as f:
            doc = json.load(f)
        if merged["window_ms"] is None:
            merged["window_ms"] = doc.get("window_ms")
        for name, series in doc.get("series", {}).items():
            merged["series"][f"shard{i}/{name}"] = series
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
        f.write("\n")
    return merged


def merge_chrome_traces(paths: list[str], out_path: str) -> dict[str, Any]:
    """Concatenate per-shard Chrome traces; each shard's pids are offset
    into their own block so Perfetto renders shards as separate process
    groups."""
    PID_BLOCK = 10_000
    events: list[dict] = []
    unit = "ms"
    for i, p in enumerate(paths):
        with open(p) as f:
            doc = json.load(f)
        unit = doc.get("displayTimeUnit", unit)
        for e in doc.get("traceEvents", []):
            e = dict(e)
            if "pid" in e:
                e["pid"] = int(e["pid"]) + i * PID_BLOCK
            events.append(e)
    doc = {"displayTimeUnit": unit, "traceEvents": events}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True, default=str)
        f.write("\n")
    return doc


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def run_sharded(cfg: ReplayConfig, n_shards: int,
                workers: Optional[int] = None,
                export_dir: Optional[str] = None) -> dict[str, Any]:
    """Run ``n_shards`` shard sims on ``workers`` processes (default:
    one per shard; 1 = sequential in-process) and merge.  The merged
    output is a pure function of (cfg, n_shards) — never of workers."""
    workers = n_shards if workers is None else workers
    jobs = [(cfg, i, n_shards, export_dir) for i in range(n_shards)]
    t0 = time.perf_counter()
    if workers <= 1 or n_shards == 1:
        results = [run_shard(*j) for j in jobs]
    else:
        ctx = multiprocessing.get_context("fork")
        with ctx.Pool(min(workers, n_shards)) as pool:
            results = pool.map(_run_shard_star, jobs)
    merged = merge_results(results)
    merged["wall_s"] = time.perf_counter() - t0
    merged["workers"] = min(workers, n_shards) if n_shards > 1 else 1
    if export_dir is not None and all(r.exports for r in results):
        results = sorted(results, key=lambda r: r.shard)
        import pathlib
        d = pathlib.Path(export_dir)
        merged["exports"] = {
            "audit": str(d / "audit_merged.jsonl"),
            "metrics": str(d / "metrics_merged.json"),
            "trace": str(d / "trace_merged.json"),
        }
        merge_audit_jsonl([r.exports["audit"] for r in results],
                          merged["exports"]["audit"])
        merge_metrics_json([r.exports["metrics"] for r in results],
                           merged["exports"]["metrics"])
        merge_chrome_traces([r.exports["trace"] for r in results],
                            merged["exports"]["trace"])
    return merged
