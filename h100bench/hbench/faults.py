"""Faults planted under the timed path, to show that the check sees them.

Each wraps the executor model's steps on its instance, as ``Steps`` does:

* ``stale_state``: a decode step returns its state unchanged (the
  position ``t`` is not advanced, so the next step writes over the same
  slot at the same position);
* ``half_batch``: half of the batch is left out (the rows of the second
  half get the logits of the first half's rows);
* ``altered_token``: the token a step produced is altered before it is
  served and fed back (installed above ``Steps``, so the check sees the
  altered token as the served one).

One chip serves every cell, so no exchange between chips can be left out.
"""
from __future__ import annotations

KINDS = ("stale_state", "half_batch", "altered_token")
ABOVE_STEPS = ("altered_token",)


def install(ex, kind: str, vocab: int) -> None:
    model = ex.model
    prefill, decode = model.prefill, model.decode
    if kind == "stale_state":
        def stale(params, cache, tokens):
            t = cache["t"].clone()
            logits, cache = decode(params, cache, tokens)
            cache["t"].copy_(t)
            return logits, cache
        model.decode = stale
    elif kind == "half_batch":
        def halve(logits):
            b = logits.shape[0]
            if b > 1:
                logits = logits.clone()
                logits[b // 2:] = logits[: b - b // 2]
            return logits

        def pre(params, batch, *a, **kw):
            logits, cache = prefill(params, batch, *a, **kw)
            return halve(logits), cache

        def dec(params, cache, tokens):
            logits, cache = decode(params, cache, tokens)
            return halve(logits), cache
        model.prefill, model.decode = pre, dec
    elif kind == "altered_token":
        def altered(params, cache, tokens):
            tokens.add_(1).remainder_(vocab)
            return decode(params, cache, tokens)
        model.decode = altered
    else:
        raise ValueError(f"unknown fault {kind!r}; known: {KINDS}")
