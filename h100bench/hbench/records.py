"""What a run leaves for the metric readers (``h100bench/metrics``).

Times are seconds on the window's clock, whose 0 is the first release.
A request is due at its arrival time; its latency runs from then to the
end of its task on the card.  A request that was shed, or that was not
answered by the end of the run, is given the end of the run as its end.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    due_s: float
    admitted: bool
    tid: int | None = None          # the task that served it, if any
    done_s: float | None = None     # its task's end on the card


@dataclasses.dataclass
class Task:
    tid: int
    n_jobs: int
    bucket: int | None              # None: never ran
    release_s: float
    done_s: float | None
    wall_ms: float | None           # the executor's record of the task
    prefill_ms: float | None
    decode_ms: float | None
    predicted_ms: float             # the measured profile's prediction
    traced: bool = False            # ran inside the profiled slice


@dataclasses.dataclass
class Run:
    cell: str
    release: str                    # schedule | backlog
    seconds: float                  # the window
    end_s: float                    # end of the run on the window's clock
    slo_ms: float
    prompt_len: int
    gen_len: int
    model: dict
    device: str                     # torch.cuda.get_device_name or "cpu"
    setup_s: float
    requests: list
    tasks: list
    trace: object = None            # hbench.trace.Slice of a traced run

    def on_card(self) -> bool:
        return self.device != "cpu"

    def finished(self, untraced: bool = False) -> list:
        """Tasks completed in the window: every completed task where the
        window releases on a schedule, those done by its close in a
        backlog."""
        out = [t for t in self.tasks
               if t.done_s is not None and t.wall_ms is not None]
        if self.release == "backlog":
            out = [t for t in out if t.done_s <= self.seconds]
        if untraced:
            out = [t for t in out if not t.traced]
        return out

    def latencies_ms(self) -> np.ndarray:
        """Every request's latency, shed and unanswered ones to the end."""
        return np.array([((r.done_s if r.done_s is not None else self.end_s)
                          - r.due_s) * 1e3 for r in self.requests])


def build(tasks, runs, buckets, predicted, exec_records, traced_ids: set,
          arrivals_ms, admitted: dict) -> tuple[list, list, dict]:
    """(task rows, request rows, uid -> (tid, done s)) of a window: the
    planned tasks, as ``hbench.serve.run_window`` ran them, joined with the
    executor's records."""
    recs = {r.tid: r for r in exec_records}
    task_rows, done_of = [], {}
    for t, r, b, p in zip(tasks, runs, buckets, predicted):
        rec = recs.get(t.tid)
        task_rows.append(Task(
            tid=t.tid, n_jobs=len(t.jobs), bucket=b if rec else None,
            release_s=r.release_s, done_s=r.done_s if rec else None,
            wall_ms=rec.wall_ms if rec else None,
            prefill_ms=rec.prefill_ms if rec else None,
            decode_ms=rec.decode_ms if rec else None, predicted_ms=p,
            traced=t.tid in traced_ids))
        for uid in r.uids:
            done_of[uid] = (t.tid, r.done_s if rec and not r.error else None)
    reqs = [Request(uid, float(a) / 1e3, admitted.get(uid, False),
                    *done_of.get(uid, (None, None)))
            for uid, a in enumerate(arrivals_ms)]
    return task_rows, reqs, done_of
