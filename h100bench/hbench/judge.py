"""What decides ``correct``.

Served logits: for a sample of the tasks the window ran (drawn from the
seed before the window opens: the first task of each bucket and one more),
the harness kept what the timed path produced at each served position:
the logits after the prompt and after each decode step, and the token fed
to each decode step.  The plain reference (``hbench.reference``) runs once
over each prompt with its served tokens, after the program has been freed:
over every row of a kept task of a MoE (whose capacity couples the rows
of a decode step) or of a batch of at most ``CHECK_ROWS``, and over
``CHECK_ROWS`` rows drawn from the seed of a larger dense batch.
The numbers that come of it (a cell's own file names those it
compares, each with its limit):

* ``gap_max`` / ``gap_p90``: the widest gap / its 90th percentile, over
  the sampled rows and served positions, by which a served token's
  reference logit lies below the reference's best (the served tokens:
  each token fed back, and the last step's greedy token);
* ``logit_rel_med`` / ``logit_rel_max``: the median / the largest over the
  sampled rows and served positions of |program logits - reference
  logits| / |reference logits| (L2 over the vocabulary).

Outputs against themselves (``output_errors``): ``token_errors`` counts
the served tokens that are not the greedy choice of the logits the program
produced at that step, ``row_errors`` the rows that answered with another
row's logits.  Their limits are 0.

State: ``state_errors`` counts the kept decode steps after which the
sequence's position had not moved on by exactly one (read from the
position the step handed back, kept on the device until the window
closes).  Its limit is 0.

Control plane: ``accounting_errors`` counts the requests that were neither
shed nor in exactly one dispatched task, the shed requests that were
dispatched, the released tasks that ran other than once, on another
bucket than the one their jobs pad to, or with another job count, errors
and passes with non-finite logits.  Its limit is 0.
"""
from __future__ import annotations

import random

import torch

from hbench import inputs, reference

CHECK_ROWS = 16


def choose_sample(buckets: list[int], n_expected: int, seed: int) -> set:
    """Task indices (in release order) whose outputs are kept: the first
    task of each bucket among the first ``n_expected``, and one more drawn
    from the seed."""
    first = {}
    for i, b in enumerate(buckets[:n_expected]):
        first.setdefault(b, i)
    out = set(first.values())
    if n_expected:
        out.add(random.Random(seed).randrange(n_expected))
    return out


def check_rows(bucket: int, seed: int, task: int, moe: bool) -> list:
    """The rows of a kept task that the reference recomputes: every row
    where the batch is small or a MoE's capacity couples its rows, else
    ``CHECK_ROWS`` drawn from the seed (a dense model's rows are
    independent requests)."""
    if moe or bucket <= CHECK_ROWS:
        return list(range(bucket))
    return sorted(random.Random(seed * 1_000_003 + task)
                  .sample(range(bucket), CHECK_ROWS))


def groups_of(kept: dict, seed: int, prompt_len: int, vocab: int, device,
              moe: bool = False):
    """[(bucket, program logits (B, P, V), served (B, P), tokens fed with
    the prompt (B, S + P - 1))] of the kept tasks' checked rows
    (``check_rows``), one entry for tasks that served the same tokens."""
    out, seen = [], set()
    for task, k in sorted(kept.items()):
        logits = torch.stack([t.float() for t in k["logits"]], dim=1)
        fed = (torch.cat([t.reshape(-1, 1) for t in k["fed"]], dim=1)
               if k["fed"] else logits.new_zeros((logits.shape[0], 0),
                                                 dtype=torch.long))
        served = torch.cat([fed.to(logits.device),
                            logits[:, -1].argmax(-1, keepdim=True)], dim=1)
        key = (k["bucket"], tuple(fed.reshape(-1).tolist()))
        if key in seen:
            continue
        seen.add(key)
        prompt = inputs.prompts(seed, k["bucket"], prompt_len, vocab, device)
        rows = check_rows(k["bucket"], seed, task, moe)
        full = torch.cat([prompt, fed.to(prompt.device)], dim=1)
        out.append((k["bucket"], logits[rows].cpu(), served[rows].cpu(),
                    full[rows]))
    return out


def compare(prog: torch.Tensor, served: torch.Tensor,
            ref: torch.Tensor) -> dict:
    """The two numbers of one group; all (B, P, V) / (B, P) on one device."""
    best = ref.max(-1).values
    at = ref.gather(-1, served[..., None].to(ref.device))[..., 0]
    rel = (prog.to(ref.device) - ref).norm(dim=-1) / ref.norm(dim=-1)
    return {"gap": (best - at).reshape(-1), "rel": rel.reshape(-1)}


def served_numbers(model: dict, seed: int, kept: dict, prompt_len: int,
                   dtype, device, quant: str | None = None) -> dict:
    """The compared numbers of the kept tasks (module doc).  With
    ``quant`` the reference in that precision takes the program's place:
    its greedy token at each position is the served one."""
    groups = groups_of(kept, seed, prompt_len, model["vocab"], device,
                       bool(model.get("n_experts")))
    if not groups:
        inf = float("inf")
        return {"gap_max": inf, "gap_p90": inf, "logit_rel_med": inf,
                "logit_rel_max": inf, "compared_rows": 0}
    ref = reference.served_logits(model, seed, [g[3] for g in groups],
                                  prompt_len, dtype, device)
    if quant is not None:
        low = reference.served_logits(model, seed, [g[3] for g in groups],
                                      prompt_len, dtype, device, quant)
        parts = [compare(lo, lo.argmax(-1), r) for lo, r in zip(low, ref)]
    else:
        parts = [compare(g[1], g[2], r) for g, r in zip(groups, ref)]
    gap = torch.cat([p["gap"] for p in parts]).double()
    rel = torch.cat([p["rel"] for p in parts]).double()
    return {"gap_max": float(gap.max()),
            "gap_p90": float(gap.quantile(0.9)),
            "logit_rel_med": float(rel.median()),
            "logit_rel_max": float(rel.max()),
            "compared_rows": sum(g[1].shape[0] for g in groups)}


def output_errors(kept: dict) -> dict:
    """Exact checks of the kept outputs against themselves:
    ``token_errors``, the served tokens that are not the greedy choice of
    the logits the program produced at that step; ``row_errors``, the rows
    whose logits after the prompt are a bitwise copy of another row's
    (every row has a prompt of its own)."""
    tokens = rows = 0
    for k in kept.values():
        logits = k["logits"]
        for j, fed in enumerate(k["fed"]):
            tokens += int((fed.reshape(-1) != logits[j].argmax(-1))
                          .sum())
        first = logits[0]
        for i in range(1, first.shape[0]):
            rows += int(any(torch.equal(first[i], first[r])
                            for r in range(i)))
    return {"token_errors": tokens, "row_errors": rows}


def state_errors(kept: dict, prompt_len: int) -> int:
    """Kept decode steps whose position is not the prompt's length plus
    the steps taken."""
    bad = 0
    for k in kept.values():
        for j, t in enumerate(k.get("t", [])):
            bad += int(t.reshape(-1)[0]) != prompt_len + j + 1
    return bad


def accounting_errors(tasks, runs, admitted: dict, records, bucket_of,
                      nonfinite: int) -> int:
    """Count of the control plane's faults (see the module's doc)."""
    errors = 0
    served: dict[int, int] = {}
    for t in tasks:
        for j in t.jobs:
            served[j.inst.uid] = served.get(j.inst.uid, 0) + 1
    for uid, ok in admitted.items():
        n = served.get(uid, 0)
        errors += (n != 1) if ok else (n != 0)
    errors += sum(1 for uid in served if uid not in admitted)
    by_tid: dict[int, list] = {}
    for r in records:
        by_tid.setdefault(r.tid, []).append(r)
    for t, r in zip(tasks, runs):
        recs = by_tid.get(t.tid, [])
        if r.cancelled and not recs:
            continue
        if len(recs) != 1 or r.error is not None:
            errors += 1
            continue
        rec = recs[0]
        if rec.n_jobs != len(t.jobs) or rec.bucket != bucket_of(len(t.jobs)):
            errors += 1
    return errors + int(nonfinite)
