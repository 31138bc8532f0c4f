"""The harness's spans: host-clock intervals around its calls into each
layer of the program, kept in memory and written out at the end of a run.

A span is (name, start s, end s, parent index, attributes) on
``time.perf_counter``; the parent is the span open on the same thread
when it started.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time


class Spans:
    def __init__(self):
        self.rows: list[list] = []
        self._open = threading.local()

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        row = [name, time.perf_counter(), None,
               stack[-1] if stack else -1, attrs]
        self.rows.append(row)
        stack.append(len(self.rows) - 1)
        try:
            yield row
        finally:
            row[2] = time.perf_counter()
            stack.pop()

    def total(self, name: str) -> float:
        return sum(r[2] - r[1] for r in self.rows
                   if r[0] == name and r[2] is not None)

    def dump(self, path) -> None:
        with open(path, "w") as f:
            json.dump([{"name": n, "start_s": a, "end_s": b, "parent": p,
                        **attrs} for n, a, b, p, attrs in self.rows], f)
