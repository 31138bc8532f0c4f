"""Kernel ``kernels/flash_attention`` (``fa_tc_kernel``): its least time on
the card over its device time, in %, summed over the launches of the
profiled slice.  The least time of a launch is the larger of its bytes over
HBM bandwidth and its operations over the bf16 peak
(``hbench.counts.flash_attention``).  Nothing is read where the slice
holds another number of launches than one a layer a task."""
from hbench import counts

KERNEL = "fa_tc_kernel"


def read(run):
    s = run.trace
    if s is None or not run.on_card() or not s.tasks:
        return None
    n, secs = s.kernel(KERNEL)
    layers = run.model["n_layers"]
    if n == 0 or n != layers * len(s.tasks) or secs <= 0:
        return None
    least = sum(layers * counts.bound_s(*counts.flash_attention(
        run.model, b, s.prompt_len)) for b in s.tasks)
    return 100.0 * least / secs
