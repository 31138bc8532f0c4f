"""Device: share of the profiled slice in which no operation ran on the
card, in % (the union of the device's intervals in the trace)."""


def read(run):
    s = run.trace
    if s is None or not run.on_card() or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
