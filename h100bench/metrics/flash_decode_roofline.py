"""Kernel ``kernels/flash_decode`` (``fd_cluster_kernel``): its least time
on the card over its device time, in %, summed over the launches of the
profiled slice; each launch's least time over its live slots
(``hbench.counts.flash_decode``).  Nothing is read where the slice holds
no launch, or another number than one a layer a decode step."""
from hbench import counts

KERNEL = "fd_cluster_kernel"


def read(run):
    s = run.trace
    if s is None or not run.on_card() or not s.tasks:
        return None
    n, secs = s.kernel(KERNEL)
    layers = run.model["n_layers"]
    if n == 0 or n != layers * s.gen_len * len(s.tasks) or secs <= 0:
        return None
    least = sum(layers * counts.bound_s(*counts.flash_decode(
        run.model, b, s.prompt_len + j))
        for b in s.tasks for j in range(s.gen_len))
    return 100.0 * least / secs
