"""Model step: the device-idle time inside the program's decode steps of
the profiled slice, per step, in ms: the idle time (the complement of the
union of the device's operations) that lies inside the executor's
``repro.decode`` spans, placed on their own ``time_ns`` stamps
(``hbench.step_idle``), over the number of those spans.  It reads the
run's ``step_slice``, which only a run that handed the executor a
``StepTracer`` carries."""
from hbench import step_idle


def read(run):
    s = getattr(run, "step_slice", None)
    if s is None or not run.on_card():
        return None
    n, idle_ns, _ = step_idle.inside(s, "repro.decode")
    return idle_ns / n / 1e6 if n else None
