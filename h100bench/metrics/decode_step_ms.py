"""Model step, decode: the executor's decode time per decode step, over the
tasks completed in the window (the profiled slice left out)."""


def read(run):
    done = run.finished(untraced=True)
    steps = len(done) * run.gen_len
    return sum(t.decode_ms for t in done) / steps if steps else None
