"""A profiled slice of the window and what is read from it.

The executor runs its tasks on a worker thread of its own, and
``torch.profiler`` records the host operators of the thread that starts
it only, so the slice is started and stopped on that thread
(``hbench.serve.Steps``).  The device's kernels are recorded whichever
thread launched them.

``busy_us`` is a frozen copy of ``_busy_us``
(``src/repro_torch/launch/profile_step.py:38-48``): the union of the
device intervals.
"""
from __future__ import annotations

import dataclasses


def busy_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclasses.dataclass
class Slice:
    """What a profiled slice of the window holds."""
    window_s: float                 # host seconds from start to stop
    busy_s: float                   # union of the device's intervals
    kernels: dict                   # name -> [launches, device seconds]
    idle_gaps: list                 # [[what the host did, seconds]], top 10
    tasks: list                     # bucket of each task profiled, in order
    gen_len: int
    prompt_len: int

    def kernel(self, part: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        ``part``."""
        n, s = 0, 0.0
        for name, (c, sec) in self.kernels.items():
            if part in name:
                n, s = n + c, s + sec
        return n, s

    def device_ops(self, top: int = 10) -> list:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])
        return [[name[:120], sec] for name, (_, sec) in rows[:top]]


def _innermost(cpu: list[tuple[float, float, str]], points: list[float]
               ) -> list[str]:
    """The innermost host operator running at each of the sorted
    ``points``; ``cpu`` holds one thread's (start, end, name), which
    nest."""
    cpu = sorted(cpu)
    out, stack, i = [], [], 0
    for p in points:
        while i < len(cpu) and cpu[i][0] <= p:
            while stack and stack[-1][1] <= cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "no host operator")
    return out


def read(prof, window_s: float, tasks: list, prompt_len: int,
         gen_len: int) -> Slice:
    """Reduce the profiler's events of the slice."""
    import torch

    events = prof.events()
    dev, cpu = [], []
    for e in events:
        tr = e.time_range
        if getattr(e, "is_user_annotation", False) \
                or e.name.startswith("hbench."):
            # the harness's own ranges, on the host and mirrored on the
            # device's timeline: no operation of the device
            if e.device_type != torch.autograd.DeviceType.CUDA:
                cpu.append((tr.start, tr.end, e.name))
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            cpu.append((tr.start, tr.end, e.name))
    kernels: dict[str, list] = {}
    for a, b, name in dev:
        row = kernels.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (b - a) * 1e-6
    gaps, end = [], None
    for a, b, _ in sorted(dev):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    labels = _innermost(cpu, [(a + b) / 2 for a, b in gaps])
    by_label: dict[str, float] = {}
    for (a, b), label in zip(gaps, labels):
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-6
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return Slice(window_s=window_s,
                 busy_s=busy_us([(a, b) for a, b, _ in dev]) * 1e-6,
                 kernels=kernels, idle_gaps=[[k[:120], v] for k, v in top],
                 tasks=list(tasks), gen_len=gen_len, prompt_len=prompt_len)
