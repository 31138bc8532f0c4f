"""Where the device idles inside the program's steps, in a profiled slice.

The program's executor, given an ``obs.tracer.StepTracer``, stamps its
spans (``repro.task``, ``repro.prefill``, ``repro.decode``,
``repro.sync``, ``repro.check``) with ``time.time_ns``, the clock of
``torch.profiler``'s events.  The profiler's raw events
(``kineto_results``) carry absolute nanoseconds on that clock, from
``trace_start_ns()`` on, so the device's operations are laid against the
program's own stamps, not against its mirrored ranges.

The slice runs from the profiler's start to the end of its last event.
The device is idle in the slice wherever none of its operations runs:
the complement of their union.  A step counts where it starts inside the
slice and is cut at the slice's end (the profiler stops inside the
slice's last step).  The idle time's split clips every span to the slice;
a class of spans takes the idle time inside the union of its spans.
"""
from __future__ import annotations

import bisect
import dataclasses

# what the slice's idle time is split into, in order; the first class
# that holds a moment takes it
CLASSES = (("decode", ("repro.decode",)),
           ("prefill", ("repro.prefill",)),
           ("sync_check", ("repro.sync", "repro.check")),
           ("task_other", ("repro.task",)))


@dataclasses.dataclass
class StepSlice:
    """A profiled slice with the program's spans, all on ``time_ns``."""
    start_ns: int                   # the profiler's trace start
    end_ns: int                     # the end of its last event
    device: list                    # [(start, end, correlation)] of the card
    launches: dict                  # correlation -> host launch start
    spans: list                     # StepTracer's (name, t0, t1, task, step)


def capture(prof, spans: list) -> StepSlice:
    """The slice of a stopped ``torch.profiler.profile``: its device
    operations (the harness's and the program's ranges mirrored on the
    device's timeline left out, as ``hbench.trace.read`` leaves them out)
    and the host calls that launched them."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    res = prof.profiler.kineto_results
    start = res.trace_start_ns()
    end, device, launches = start, [], {}
    for e in res.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        end = max(end, b)
        name = e.name()
        if e.device_type() == cuda:
            if getattr(e, "is_user_annotation", lambda: False)() or \
                    name.startswith(("hbench.", "repro.")):
                continue
            device.append((a, b, e.correlation_id()))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = a
    return StepSlice(start, end, device, launches, list(spans))


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle(s: StepSlice) -> list[tuple[int, int]]:
    """The slice's idle intervals: where no device operation runs."""
    busy = _union((max(a, s.start_ns), min(b, s.end_ns))
                  for a, b, _ in s.device if b > s.start_ns and a < s.end_ns)
    out, at = [], s.start_ns
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if s.end_ns > at:
        out.append((at, s.end_ns))
    return out


def _overlap(xs: list, ys: list) -> int:
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _clipped(s: StepSlice, names) -> list[tuple[int, int]]:
    return _union((max(t0, s.start_ns), min(t1, s.end_ns))
                  for name, t0, t1, *_ in s.spans
                  if name in names and t1 > s.start_ns and t0 < s.end_ns)


def inside(s: StepSlice, name: str) -> tuple[int, int, int]:
    """(spans named ``name`` that start in the slice, device-idle ns
    inside them, ns they cover), each span cut at the slice's end."""
    mine = _union((t0, min(t1, s.end_ns)) for n, t0, t1, *_ in s.spans
                  if n == name and s.start_ns <= t0 < s.end_ns)
    n = sum(1 for sp in s.spans
            if sp[0] == name and s.start_ns <= sp[1] < s.end_ns)
    return n, _overlap(idle(s), mine), sum(b - a for a, b in mine)


def split(s: StepSlice) -> dict[str, int]:
    """The slice's idle ns by where the host was: inside a decode step,
    inside prefill, in a wait for the device or the finiteness check,
    elsewhere in a task, or outside any task (the device waiting for
    work)."""
    left = idle(s)
    out = {}
    for key, names in CLASSES:
        spans = _clipped(s, names)
        out[key] = _overlap(left, spans)
        left = _minus(left, spans)
    out["outside_tasks"] = sum(b - a for a, b in left)
    return out


def _minus(xs: list, ys: list) -> list[tuple[int, int]]:
    """The sorted disjoint ``xs`` less the sorted disjoint ``ys``."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while a < b:
            if k >= len(ys) or ys[k][0] >= b:
                out.append((a, b))
                break
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
    return out


def launches_in(s: StepSlice, name: str = "repro.decode") -> list:
    """(the span's first stamp, the host's launch, the device's start) of
    each device operation launched inside a span named ``name``, in ns.
    On one clock the three come in this order."""
    spans = sorted((t0, t1) for n, t0, t1, *_ in s.spans if n == name)
    starts = [t0 for t0, _ in spans]
    out = []
    for a, _, corr in s.device:
        at = s.launches.get(corr)
        if at is None:
            continue
        k = bisect.bisect_right(starts, at) - 1
        if k >= 0 and at <= spans[k][1]:
            out.append((spans[k][0], at, a))
    return out
