"""Measured profile: mean over every task completed in the window (the
profiled slice left out) of |predicted - measured| / measured, in %, the
prediction being the measured profile's latency of the task's bucket and
the measurement the executor's wall time of the task."""


def read(run):
    done = run.finished(untraced=True)
    if not done:
        return None
    return 100.0 * sum(abs(t.predicted_ms - t.wall_ms) / t.wall_ms
                       for t in done) / len(done)
