"""Model step, prefill: the executor's prefill time per thousand padded
prompt tokens, over the tasks completed in the window (the profiled slice
left out)."""


def read(run):
    done = run.finished(untraced=True)
    ktok = sum(t.bucket * run.prompt_len for t in done) / 1e3
    return sum(t.prefill_ms for t in done) / ktok if ktok else None
