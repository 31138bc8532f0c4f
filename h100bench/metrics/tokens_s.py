"""Prompt and generated tokens of the real (unpadded) requests served in
the window, per second of the window.  A task still running when the
window closes counts for the share of its time inside the window.
Backlog cells only."""


def read(run):
    if run.release != "backlog":
        return None
    per_req = run.prompt_len + run.gen_len
    tokens = 0.0
    for t in run.tasks:
        if t.done_s is None or t.wall_ms is None:
            continue
        start = t.done_s - t.wall_ms / 1e3
        if t.done_s <= run.seconds:
            tokens += t.n_jobs * per_req
        elif start < run.seconds:
            tokens += t.n_jobs * per_req * (run.seconds - start) / (
                t.done_s - start)
    return tokens / run.seconds if tokens else None
