"""Schema validation for every flight-recorder export format.

Used three ways: by the test suite's golden-fixture checks, by CI (the
obs smoke step runs ``python -m repro_torch.obs.validate`` over the exported
artifacts) and manually on any export.  Four formats are covered, and
``main`` dispatches on file extension + content instead of positional
roles, so any mix of artifacts can be passed in any order:

  * **Chrome trace** (``.json`` with ``traceEvents``) — the contract
    Perfetto actually relies on: every event carries
    ``ph``/``ts``/``pid``/``tid``, every complete slice ("X") carries
    ``dur``, and at least one complete span exists for each request
    lifecycle phase (request envelope, queue wait, exec; ``xfer``
    appears only when some start paid a restart penalty, so it is
    opt-in via ``required``);
  * **metrics bus** (``.json`` with ``series``, or the long-format
    ``.csv``) — known series kinds, well-formed points (scalar kinds
    carry one value, hist windows carry count/sum/min/max with
    min <= max <= sum consistency), strictly increasing window starts;
  * **planner audit** (``.jsonl`` of plan/skip/retry records) —
    required fields per record type, numeric sanity, realized >= 0,
    retry actions in retry|resume|shed with attempt >= 1;
  * **health alerts** (``.jsonl`` of alert records) — known alert
    kinds, firing/cleared states alternating per (kind, app) stream.

Every error names the offending file and record (``file: record i:``
or ``file: line i:``) so a CI failure points at the exact artifact.
"""
from __future__ import annotations

import csv
import json
import sys
from typing import Any, Iterable

REQUIRED_PHASES = ("request", "queue", "exec")

_METRIC_KINDS = ("counter", "gauge", "hist")
_AUDIT_PLAN_FIELDS = ("t_ms", "app", "stage", "n_jobs", "g_slo_ms",
                      "regime", "expansions")
_AUDIT_SKIP_FIELDS = ("t_ms", "app", "stage", "certificate", "recheck")
_AUDIT_RETRY_FIELDS = ("t_ms", "app", "stage", "uid", "invoker", "attempt",
                       "action", "backoff_ms", "lost_ms")
_RETRY_ACTIONS = ("retry", "resume", "shed")
_ALERT_FIELDS = ("t_ms", "kind", "app", "state", "value", "threshold")


def validate_trace(doc: dict[str, Any],
                   required: Iterable[str] = REQUIRED_PHASES) -> dict[str, int]:
    """Validate a Chrome-trace document; returns per-category X-span
    counts.  Raises ``ValueError`` with a precise message on the first
    violation."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a Chrome-trace document: missing traceEvents")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    counts: dict[str, int] = {}
    for i, e in enumerate(events):
        for field in ("ph", "pid", "tid"):
            if field not in e:
                raise ValueError(f"event {i} missing {field!r}: {e}")
        ph = e["ph"]
        if ph not in ("X", "i", "M"):
            raise ValueError(f"event {i} has unknown ph {ph!r}")
        if ph != "M" and "ts" not in e:
            raise ValueError(f"event {i} ({ph}) missing ts")
        if ph == "X":
            if "dur" not in e:
                raise ValueError(f"event {i} (complete span) missing dur")
            if e["dur"] < 0:
                raise ValueError(f"event {i} has negative dur {e['dur']}")
            counts[e.get("cat", "?")] = counts.get(e.get("cat", "?"), 0) + 1
    missing = [c for c in required if counts.get(c, 0) < 1]
    if missing:
        raise ValueError(
            f"no complete span for lifecycle phase(s) {missing}; "
            f"have {counts}")
    return counts


def validate_nesting(doc: dict[str, Any]) -> None:
    """Check stage spans sit inside their request envelope: on every
    request pid, each queue/xfer/exec slice's interval must be contained
    in the union of that pid's request-cat slices."""
    from repro_torch.obs.tracer import REQUEST_PID_BASE
    envelope: dict[int, list[tuple[float, float]]] = {}
    inner: dict[int, list[tuple[float, float, str]]] = {}
    for e in doc["traceEvents"]:
        if e["ph"] != "X" or e["pid"] < REQUEST_PID_BASE:
            continue
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        if e.get("cat") == "request":
            envelope.setdefault(e["pid"], []).append((t0, t1))
        else:
            inner.setdefault(e["pid"], []).append((t0, t1, e["name"]))
    eps = 1e-6
    for pid, spans in inner.items():
        envs = envelope.get(pid, [])
        for t0, t1, name in spans:
            if not any(a - eps <= t0 and t1 <= b + eps for a, b in envs):
                raise ValueError(
                    f"span {name!r} [{t0}, {t1}] on pid {pid} escapes its "
                    f"request envelope {envs}")


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_metrics(doc: dict[str, Any], path: str = "metrics") -> int:
    """Validate a MetricsBus JSON export; returns the series count.
    Errors name the file, series and point index."""
    if "window_ms" not in doc or "series" not in doc:
        raise ValueError(f"{path}: not a metrics export: "
                         f"missing window_ms/series")
    if not _num(doc["window_ms"]) or doc["window_ms"] <= 0:
        raise ValueError(f"{path}: window_ms must be a positive number, "
                         f"got {doc['window_ms']!r}")
    for name, s in doc["series"].items():
        kind = s.get("kind")
        if kind not in _METRIC_KINDS:
            raise ValueError(f"{path}: series {name!r} has bad kind "
                             f"{kind!r}")
        pts = s.get("points")
        if not isinstance(pts, list):
            raise ValueError(f"{path}: series {name!r} missing points list")
        width = 5 if kind == "hist" else 2
        prev_t = None
        for i, p in enumerate(pts):
            if not isinstance(p, list) or len(p) != width \
                    or not all(_num(x) for x in p):
                raise ValueError(
                    f"{path}: series {name!r} point {i}: expected "
                    f"{width} numbers, got {p!r}")
            if prev_t is not None and p[0] <= prev_t:
                raise ValueError(
                    f"{path}: series {name!r} point {i}: window start "
                    f"{p[0]} not after previous {prev_t}")
            prev_t = p[0]
            if kind == "hist":
                _, n, total, lo, hi = p
                if n < 1 or lo > hi:
                    raise ValueError(
                        f"{path}: series {name!r} point {i}: inconsistent "
                        f"hist window {p!r}")
    return len(doc["series"])


def validate_metrics_csv(path: str) -> int:
    """Validate a MetricsBus long-format CSV export; returns the row
    count.  Errors name the file and 1-based line number."""
    header = ["series", "kind", "window_start_ms", "value",
              "count", "sum", "min", "max"]
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows or rows[0] != header:
        raise ValueError(f"{path}: line 1: bad header {rows[0] if rows else []!r}, "
                         f"expected {header!r}")
    for i, row in enumerate(rows[1:], start=2):
        if len(row) != len(header):
            raise ValueError(f"{path}: line {i}: expected "
                             f"{len(header)} columns, got {len(row)}")
        name, kind, t, value, n, total, lo, hi = row
        if kind not in _METRIC_KINDS:
            raise ValueError(f"{path}: line {i}: series {name!r} has bad "
                             f"kind {kind!r}")
        try:
            float(t)
        except ValueError:
            raise ValueError(f"{path}: line {i}: bad window_start_ms "
                             f"{t!r}") from None
        filled, blank = ((n, total, lo, hi), (value,)) if kind == "hist" \
            else ((value,), (n, total, lo, hi))
        if any(c == "" for c in filled) or any(c != "" for c in blank):
            raise ValueError(
                f"{path}: line {i}: {kind} row must fill "
                f"{'count/sum/min/max' if kind == 'hist' else 'value'} "
                f"and leave the rest empty, got {row!r}")
        try:
            [float(c) for c in filled]
        except ValueError:
            raise ValueError(f"{path}: line {i}: non-numeric cell in "
                             f"{filled!r}") from None
    return len(rows) - 1


def _load_jsonl(path: str) -> list[dict[str, Any]]:
    records = []
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}: line {i}: not JSON: {e}") from None
    return records


def validate_audit(records: list[dict[str, Any]],
                   path: str = "audit") -> dict[str, int]:
    """Validate planner-audit JSONL records; returns per-type counts.
    Errors name the file and 0-based record index."""
    counts = {"plan": 0, "skip": 0, "retry": 0}
    fields_by_type = {"plan": _AUDIT_PLAN_FIELDS,
                      "skip": _AUDIT_SKIP_FIELDS,
                      "retry": _AUDIT_RETRY_FIELDS}
    for i, r in enumerate(records):
        t = r.get("type")
        if t not in counts:
            raise ValueError(f"{path}: record {i}: bad type {t!r} "
                             f"(want plan|skip|retry)")
        counts[t] += 1
        missing = [k for k in fields_by_type[t] if k not in r]
        if missing:
            raise ValueError(f"{path}: record {i}: {t} record missing "
                             f"{missing}")
        if not _num(r["t_ms"]) or r["t_ms"] < 0:
            raise ValueError(f"{path}: record {i}: bad t_ms {r['t_ms']!r}")
        if t == "plan":
            for k in ("realized_ms", "realized_exec_ms", "predicted_ms",
                      "predicted_raw_ms"):
                v = r.get(k)
                if v is not None and (not _num(v) or v < 0):
                    raise ValueError(f"{path}: record {i}: bad {k} {v!r}")
        elif t == "retry":
            if r["action"] not in _RETRY_ACTIONS:
                raise ValueError(
                    f"{path}: record {i}: bad retry action "
                    f"{r['action']!r} (want one of {_RETRY_ACTIONS})")
            if not isinstance(r["attempt"], int) or \
                    isinstance(r["attempt"], bool) or r["attempt"] < 1:
                raise ValueError(f"{path}: record {i}: bad attempt "
                                 f"{r['attempt']!r} (want int >= 1)")
            for k in ("backoff_ms", "lost_ms"):
                if not _num(r[k]) or r[k] < 0:
                    raise ValueError(f"{path}: record {i}: bad {k} "
                                     f"{r[k]!r}")
    return counts


def validate_health(records: list[dict[str, Any]],
                    path: str = "health") -> dict[str, int]:
    """Validate health-alert JSONL records; returns per-kind counts.
    Checks each (kind, app) stream alternates firing/cleared starting
    with firing.  Errors name the file and 0-based record index."""
    from repro_torch.obs.health import ALERT_KINDS, CLEARED, FIRING
    counts: dict[str, int] = {}
    state: dict[tuple[str, Any], str] = {}
    for i, r in enumerate(records):
        if r.get("type") != "alert":
            raise ValueError(f"{path}: record {i}: bad type "
                             f"{r.get('type')!r} (want alert)")
        missing = [k for k in _ALERT_FIELDS if k not in r]
        if missing:
            raise ValueError(f"{path}: record {i}: missing {missing}")
        if r["kind"] not in ALERT_KINDS:
            raise ValueError(f"{path}: record {i}: unknown alert kind "
                             f"{r['kind']!r}")
        if r["state"] not in (FIRING, CLEARED):
            raise ValueError(f"{path}: record {i}: bad state "
                             f"{r['state']!r}")
        for k in ("t_ms", "value", "threshold"):
            if not _num(r[k]):
                raise ValueError(f"{path}: record {i}: bad {k} {r[k]!r}")
        key = (r["kind"], r["app"])
        prev = state.get(key, CLEARED)
        if r["state"] == prev:
            raise ValueError(
                f"{path}: record {i}: {r['kind']}[{r['app']}] is "
                f"{r['state']!r} twice in a row (streams must alternate)")
        state[key] = r["state"]
        counts[r["kind"]] = counts.get(r["kind"], 0) + 1
    return counts


def _dispatch(path: str) -> str:
    """Validate one artifact, sniffing its format; returns a summary."""
    if path.endswith(".csv"):
        n = validate_metrics_csv(path)
        return f"metrics-csv OK: {n} rows"
    if path.endswith(".jsonl"):
        records = _load_jsonl(path)
        types = {r.get("type") for r in records}
        if types <= {"alert"}:
            counts = validate_health(records, path)
            return "health OK: " + (", ".join(
                f"{k}={n}" for k, n in sorted(counts.items()))
                or "0 alerts")
        counts = validate_audit(records, path)
        return (f"audit OK: {counts['plan']} plans, {counts['skip']} "
                f"skips, {counts['retry']} retries")
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "traceEvents" in doc:
        counts = validate_trace(doc)
        validate_nesting(doc)
        return "trace OK: " + ", ".join(
            f"{c}={n}" for c, n in sorted(counts.items()))
    if isinstance(doc, dict) and "series" in doc:
        n = validate_metrics(doc, path)
        return f"metrics OK: {n} series"
    raise ValueError(f"{path}: unrecognized artifact (want a Chrome "
                     f"trace, a metrics export, or a .jsonl/.csv)")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.validate ARTIFACT... "
              "(trace/metrics .json, metrics .csv, audit/health .jsonl)",
              file=sys.stderr)
        return 2
    for path in argv:
        print(f"[obs-validate] {path}: {_dispatch(path)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
