"""95th percentile of the latency of every request due in the window, in
ms; a shed or unanswered request counts from its due time to the end of
the run.  Cells that release on a schedule only."""
import numpy as np


def read(run):
    if run.release != "schedule" or not run.requests:
        return None
    return float(np.percentile(run.latencies_ms(), 95))
