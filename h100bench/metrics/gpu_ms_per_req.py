"""Card time a request costs, in ms: the executor's wall time of every
task completed in the window, summed, over the requests those tasks
served."""


def read(run):
    done = run.finished(untraced=True)
    n = sum(t.n_jobs for t in done)
    if not n:
        return None
    return sum(t.wall_ms for t in done) / n
