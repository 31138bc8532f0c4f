"""Whole step: useful operations of the real requests of the tasks
completed in the window (the profiled slice left out), over the tasks'
wall time, as a share of the H100's dense bf16 peak, in %.  Operations are
counted by ``hbench.counts.request_flops``."""
from hbench import counts


def read(run):
    if not run.on_card():
        return None
    done = run.finished(untraced=True)
    secs = sum(t.wall_ms for t in done) / 1e3
    if not secs:
        return None
    flops = sum(t.n_jobs for t in done) * counts.request_flops(
        run.model, run.prompt_len, run.gen_len)
    return 100.0 * flops / secs / counts.PEAK_BF16_FLOPS
