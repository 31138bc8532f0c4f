"""ESG planner and gateway: real jobs over padded batch slots of the tasks
completed in the window, in % (a counter of the executor's records)."""


def read(run):
    done = run.finished()
    slots = sum(t.bucket for t in done)
    return 100.0 * sum(t.n_jobs for t in done) / slots if slots else None
