"""Share of the requests due in the window answered within the cell's SLO,
in %.  Shed requests and requests not answered by the end of the run
count as misses.  Cells that release on a schedule only."""


def read(run):
    if run.release != "schedule" or not run.requests:
        return None
    lat = run.latencies_ms()
    hits = sum(1 for r, ms in zip(run.requests, lat)
               if r.done_s is not None and ms <= run.slo_ms)
    return 100.0 * hits / len(run.requests)
