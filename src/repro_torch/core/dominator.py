"""Dominator-based SLO distribution (paper §3.3).

Pipeline:
  1. dominator tree of the workflow DAG (Cooper-Harvey-Kennedy iterative
     algorithm — the graphs are tiny),
  2. label nodes with ANL (average normalised length) from the profiles,
  3. post-order reduction: parallel branches under a split collapse into a
     *reduced* unit whose ANL is the max over branches of the branch ANL sum,
  4. group ≤ g consecutive chain units (reduced units stay alone),
  5. distribute the end-to-end SLO proportionally to group ANLs, recursing
     into reduced units (each parallel branch inherits the unit's full quota,
     split inside the branch by ANL).

Output: for every stage, its ``ScheduleGroup`` (the stages ESG_1Q searches
over together) and the group's SLO fraction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.profiles import ProfileTable
from repro_torch.core.workflows import Workflow


# ---------------------------------------------------------------------------
# Dominator tree
# ---------------------------------------------------------------------------
def _topo_order(wf: Workflow) -> list[str]:
    indeg = {s: 0 for s in wf.stages}
    for s, succ in wf.edges.items():
        for t in succ:
            indeg[t] += 1
    queue = [s for s in wf.stages if indeg[s] == 0]
    out = []
    while queue:
        s = queue.pop(0)
        out.append(s)
        for t in wf.edges.get(s, ()):
            indeg[t] -= 1
            if indeg[t] == 0:
                queue.append(t)
    if len(out) != len(wf.stages):
        raise ValueError(f"workflow {wf.name} has a cycle")
    return out


def dominator_tree(wf: Workflow) -> dict[str, Optional[str]]:
    """stage -> immediate dominator (idom); root maps to None."""
    order = _topo_order(wf)
    roots = wf.roots
    # virtual root if several entry stages
    virtual = len(roots) > 1
    root = "<root>" if virtual else roots[0]
    preds = {s: wf.predecessors(s) for s in wf.stages}
    if virtual:
        for r in roots:
            preds[r] = preds[r] + [root]
        order = [root] + order
    idx = {s: i for i, s in enumerate(order)}
    idom: dict[str, Optional[str]] = {root: root}

    def intersect(a, b):
        while a != b:
            while idx[a] > idx[b]:
                a = idom[a]
            while idx[b] > idx[a]:
                b = idom[b]
        return a

    changed = True
    while changed:
        changed = False
        for s in order:
            if s == root:
                continue
            ps = [p for p in preds.get(s, []) if p in idom]
            if not ps:
                continue
            new = ps[0]
            for p in ps[1:]:
                new = intersect(new, p)
            if idom.get(s) != new:
                idom[s] = new
                changed = True
    idom[root] = None
    if virtual:
        # re-root: children of the virtual root become roots
        del idom[root]
        for r in roots:
            if idom.get(r) == "<root>":
                idom[r] = None
    return idom


# ---------------------------------------------------------------------------
# ANL labels
# ---------------------------------------------------------------------------
def anl_labels(wf: Workflow, tables: dict[str, ProfileTable]) -> dict[str, float]:
    """ANL(f_i) = mean_c [ t_{f_i}(c) / sum_j t_{f_j}(c) ] (paper §3.3)."""
    mats = []
    for s in wf.stages:
        mats.append(tables[wf.func_of[s]].times)
    n = min(len(m) for m in mats)
    mat = np.stack([m[:n] for m in mats])       # (stages, configs)
    norm = mat / mat.sum(axis=0, keepdims=True)
    return {s: float(norm[i].mean()) for i, s in enumerate(wf.stages)}


# ---------------------------------------------------------------------------
# Reduction + grouping
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Unit:
    """A chain element: one stage, or a reduced parallel region."""
    stages: tuple[str, ...]            # the single stage, or all subsumed ones
    anl: float
    branches: Optional[list[list["Unit"]]] = None   # set for reduced units

    @property
    def reduced(self) -> bool:
        return self.branches is not None


def _reaches(wf: Workflow, a: str, b: str, memo: dict) -> bool:
    key = (a, b)
    if key in memo:
        return memo[key]
    stack, seen = [a], {a}
    found = False
    while stack:
        s = stack.pop()
        if s == b:
            found = True
            break
        for t in wf.edges.get(s, ()):
            if t not in seen:
                seen.add(t)
                stack.append(t)
    memo[key] = found
    return found


def reduce_chain(wf: Workflow, anl: dict[str, float]) -> list[Unit]:
    """Serialise the DAG into a chain of Units via dominator-tree reduction."""
    idom = dominator_tree(wf)
    children: dict[str, list[str]] = {s: [] for s in wf.stages}
    roots = []
    for s, d in idom.items():
        if d is None:
            roots.append(s)
        else:
            children[d].append(s)
    topo = {s: i for i, s in enumerate(_topo_order(wf))}
    memo: dict = {}

    def region(node: str) -> list[Unit]:
        chain = [Unit((node,), anl[node])]
        kids = sorted(children[node], key=lambda s: topo[s])
        i = 0
        while i < len(kids):
            # collect a maximal parallel group of mutually-unreachable kids
            group = [kids[i]]
            j = i + 1
            while j < len(kids) and all(
                    not _reaches(wf, g, kids[j], memo) and
                    not _reaches(wf, kids[j], g, memo) for g in group):
                group.append(kids[j])
                j += 1
            if len(group) == 1:
                chain.extend(region(group[0]))
            else:
                branches = [region(g) for g in group]
                sums = [sum(u.anl for u in br) for br in branches]
                stages = tuple(s for br in branches for u in br for s in u.stages)
                chain.append(Unit(stages, max(sums), branches))
            i = j
        return chain

    if len(roots) == 1:
        return region(roots[0])
    branches = [region(r) for r in sorted(roots, key=lambda s: topo[s])]
    sums = [sum(u.anl for u in br) for br in branches]
    stages = tuple(s for br in branches for u in br for s in u.stages)
    return [Unit(stages, max(sums), branches)]


@dataclasses.dataclass(frozen=True)
class ScheduleGroup:
    stages: tuple[str, ...]           # consecutive pipeline stages
    slo_fraction: float               # share of the end-to-end SLO


def distribute_slo(wf: Workflow, tables: dict[str, ProfileTable],
                   group_size: int = 3) -> dict[str, ScheduleGroup]:
    """stage -> its ScheduleGroup.  Fractions along any root->sink path
    sum to ~1 (parallel branches share their region's quota)."""
    anl = anl_labels(wf, tables)
    chain = reduce_chain(wf, anl)
    out: dict[str, ScheduleGroup] = {}

    def assign(chain: list[Unit], quota: float):
        # group <= g consecutive simple units; reduced units stay alone
        groups: list[list[Unit]] = []
        cur: list[Unit] = []
        for u in chain:
            if u.reduced:
                if cur:
                    groups.append(cur)
                    cur = []
                groups.append([u])
            else:
                cur.append(u)
                if len(cur) == group_size:
                    groups.append(cur)
                    cur = []
        if cur:
            groups.append(cur)
        total = sum(u.anl for g in groups for u in g)
        for g in groups:
            g_anl = sum(u.anl for u in g)
            g_quota = quota * (g_anl / total if total > 0 else 1 / len(groups))
            if len(g) == 1 and g[0].reduced:
                for br in g[0].branches:
                    assign(br, g_quota)      # parallel branches: full quota each
            else:
                stages = tuple(s for u in g for s in u.stages)
                sg = ScheduleGroup(stages, g_quota)
                for s in stages:
                    out[s] = sg
    assign(chain, 1.0)
    return out
