"""Per-request span tracing with a Chrome-trace/Perfetto exporter.

Every admitted request becomes one *trace*: a Chrome-trace "process"
(pid) whose track carries the request's end-to-end span plus one span
per lifecycle phase of every stage execution it took part in —

  * ``queue``  — job ready -> task start (per-stage queue wait),
  * ``xfer``   — task start -> exec start (the restart penalty window:
                 weight swap-in / cold provisioning, annotated with the
                 hot/warm/cold start class and, under the overlapped
                 swap pipeline, whether a prefetch hid part of it),
  * ``exec``   — exec start -> task end (annotated with the dispatched
                 config, the fractional slice quota and every vertical
                 resize applied while running),

with ``admit``/``shed`` instants from the gateway.  Each emulated
device gets its own process whose tracks carry the PCIe transfer
engine's copies (cat ``pcie``: demand vs prefetch, promotions) and HBM
demotion instants — exactly the two places FaaSTube-style hidden
transfer time can accumulate.

Spans are recorded as plain tuples during the run and materialised into
Chrome-trace JSON only at export, where partially-overlapping spans
(parallel DAG branches, concurrent copies) are assigned to
non-overlapping lanes (tids) so the file loads cleanly in
``ui.perfetto.dev`` / ``chrome://tracing``.

Timestamps are *simulated* milliseconds, written as the microsecond
``ts``/``dur`` fields the format requires.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Optional

# pid layout: requests get 10000+uid, devices 100+idx — disjoint for any
# realistic fleet, and stable across runs for diffable golden traces.
REQUEST_PID_BASE = 10_000
DEVICE_PID_BASE = 100

_US = 1e3   # ms -> us


@dataclasses.dataclass
class _Span:
    name: str
    cat: str
    t0_ms: float
    t1_ms: float
    pid: int
    args: Optional[dict] = None


@dataclasses.dataclass
class _Instant:
    name: str
    cat: str
    t_ms: float
    pid: int
    args: Optional[dict] = None


class SpanTracer:
    """Collects spans/instants; exports Chrome-trace JSON."""

    def __init__(self):
        self._spans: list[_Span] = []
        self._instants: list[_Instant] = []
        self._procs: dict[int, str] = {}
        # request span bookkeeping: uid -> (app, arrival_ms)
        self._open_requests: dict[int, tuple[str, float]] = {}
        # transfers are resolved lazily at export (a queued prefetch's
        # completion time is only known once the engine drains it)
        self._transfers: list[tuple[int, Any, str]] = []
        # stage lifecycles land as raw tuples on the hot path and are
        # expanded into queue/xfer/exec spans only at export
        self._stages: list[tuple] = []

    # ---- request lifecycle -------------------------------------------------
    @staticmethod
    def request_pid(uid: int) -> int:
        return REQUEST_PID_BASE + uid

    def begin_request(self, uid: int, app: str, t_ms: float):
        pid = self.request_pid(uid)
        self._procs[pid] = f"req {app}#{uid}"
        self._open_requests[uid] = (app, t_ms)
        self._instants.append(_Instant("admit", "gateway", t_ms, pid))

    def end_request(self, uid: int, t_ms: float, slo_ms: float):
        got = self._open_requests.pop(uid, None)
        if got is None:
            return               # already ended (multi-sink DAG completion)
        app, arr = got
        lat = t_ms - arr
        self._spans.append(_Span(
            f"{app}#{uid}", "request", arr, t_ms, self.request_pid(uid),
            {"latency_ms": lat, "slo_ms": slo_ms,
             "slo_hit": bool(lat <= slo_ms)}))

    def shed_request(self, uid: int, app: str, t_ms: float,
                     budget_ms: float, need_ms: float):
        pid = self.request_pid(uid)
        self._procs[pid] = f"req {app}#{uid} (shed)"
        self._instants.append(_Instant(
            "shed", "gateway", t_ms, pid,
            {"budget_ms": budget_ms, "need_ms": need_ms}))

    # ---- stage lifecycle ---------------------------------------------------
    def stage_spans(self, uid: int, stage: str, ready_ms: float,
                    start_ms: float, exec_start_ms: float, end_ms: float,
                    args: dict):
        """One request's share of a finished task, all three phases
        (recorded raw; expanded at export)."""
        self._stages.append((uid, stage, ready_ms, start_ms, exec_start_ms,
                             end_ms, args))

    def _expand_stages(self):
        for uid, stage, ready_ms, start_ms, exec_start_ms, end_ms, args \
                in self._stages:
            pid = self.request_pid(uid)
            if start_ms > ready_ms:
                yield _Span(f"queue:{stage}", "queue", ready_ms, start_ms,
                            pid)
            if exec_start_ms > start_ms:
                yield _Span(
                    f"{args.get('tier', '?')}-start:{stage}", "xfer",
                    start_ms, exec_start_ms, pid,
                    {k: args[k] for k in ("tier", "invoker", "penalty_ms",
                                          "hidden_ms") if k in args})
            yield _Span(f"exec:{stage}", "exec", exec_start_ms, end_ms,
                        pid, args)

    def preempt_span(self, uid: int, stage: str, t0_ms: float, t1_ms: float,
                     args: dict):
        """A stage execution killed by a spot reclamation: the span covers
        task start -> kill, so the lost work is visible on the request's
        track right where the retry's queue span begins."""
        self._spans.append(_Span(f"preempt:{stage}", "preempt", t0_ms,
                                 t1_ms, self.request_pid(uid), args))

    def reclaim_instant(self, device: int, t_ms: float, name: str,
                        args: Optional[dict] = None):
        """Reclamation lifecycle marker (warning / reclaim / recover) on
        the device's own track."""
        self._instants.append(_Instant(
            name, "reclaim", t_ms, self.device_pid(device), args))

    def resize_instant(self, uid: int, t_ms: float, invoker: int,
                       old_slices: int, new_slices: int):
        self._instants.append(_Instant(
            "resize", "resize", t_ms, self.request_pid(uid),
            {"invoker": invoker, "from": old_slices, "to": new_slices}))

    # ---- device tracks -----------------------------------------------------
    def device_pid(self, idx: int) -> int:
        pid = DEVICE_PID_BASE + idx
        if pid not in self._procs:
            self._procs[pid] = f"device {idx}"
        return pid

    def note_transfer(self, device: int, transfer, issued_as: str):
        self.device_pid(device)
        self._transfers.append((device, transfer, issued_as))

    def promote_instant(self, device: int, func: str, t_ms: float):
        self._instants.append(_Instant(
            f"promote:{func}", "pcie", t_ms, self.device_pid(device)))

    def demotion_instant(self, device: int, func: str, t_ms: float):
        self._instants.append(_Instant(
            f"demote:{func}", "hbm", t_ms, self.device_pid(device)))

    # ---- export ------------------------------------------------------------
    def _resolve_transfers(self):
        """Turn noted engine transfers into spans/instants (done copies
        get a span over their link lifetime, cancelled/still-pending
        copies an instant at enqueue)."""
        for device, tr, issued_as in self._transfers:
            pid = self.device_pid(device)
            if math.isfinite(tr.done_ms):
                promoted = issued_as != tr.kind
                yield _Span(
                    f"{tr.kind}:{tr.func}", "pcie", tr.enq_ms, tr.done_ms,
                    pid, {"issued_as": issued_as, "promoted": promoted,
                          "copy_ms": tr.total_ms})
            else:
                state = "cancelled" if tr.remaining_ms <= 0 else "pending"
                self._instants.append(_Instant(
                    f"{state}:{tr.func}", "pcie", tr.enq_ms, pid,
                    {"issued_as": issued_as}))

    @staticmethod
    def _assign_lanes(spans: list[_Span]) -> list[tuple[_Span, int]]:
        """Greedy interval partitioning: spans that overlap in time get
        distinct lanes (tids), so Perfetto never sees a slice that ends
        after a later-starting sibling began.  ``request``-cat spans
        contain everything on their pid and stay on lane 0 (contained
        slices nest correctly on the same track)."""
        out: list[tuple[_Span, int]] = []
        lanes: list[float] = []          # lane -> busy-until
        for s in sorted(spans, key=lambda s: (s.cat != "request",
                                              s.t0_ms, -s.t1_ms)):
            if s.cat == "request":
                out.append((s, 0))
                continue
            for i, busy in enumerate(lanes):
                if busy <= s.t0_ms + 1e-9:
                    lanes[i] = s.t1_ms
                    out.append((s, i))
                    break
            else:
                lanes.append(s.t1_ms)
                out.append((s, len(lanes) - 1))
        return out

    def events(self) -> list[dict]:
        """Chrome-trace event dicts, deterministic order."""
        spans = list(self._spans)
        spans.extend(self._expand_stages())
        spans.extend(self._resolve_transfers())
        by_pid: dict[int, list[_Span]] = {}
        for s in spans:
            by_pid.setdefault(s.pid, []).append(s)
        ev: list[dict] = []
        for pid in sorted(self._procs):
            ev.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": self._procs[pid]}})
        for pid in sorted(by_pid):
            for s, lane in self._assign_lanes(by_pid[pid]):
                e = {"ph": "X", "name": s.name, "cat": s.cat,
                     "ts": s.t0_ms * _US,
                     "dur": max(s.t1_ms - s.t0_ms, 0.0) * _US,
                     "pid": s.pid, "tid": lane}
                if s.args:
                    e["args"] = s.args
                ev.append(e)
        for i in sorted(range(len(self._instants)),
                        key=lambda i: (self._instants[i].pid,
                                       self._instants[i].t_ms, i)):
            s = self._instants[i]
            e = {"ph": "i", "name": s.name, "cat": s.cat, "ts": s.t_ms * _US,
                 "pid": s.pid, "tid": 0, "s": "t"}
            if s.args:
                e["args"] = s.args
            ev.append(e)
        return ev

    def export_chrome_trace(self, path: str) -> dict:
        # default=str: span args may hold rich values (Config objects)
        # recorded as-is on the hot path and stringified only here
        doc = {"displayTimeUnit": "ms", "traceEvents": self.events()}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        return doc
