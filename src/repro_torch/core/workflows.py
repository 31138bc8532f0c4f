"""Application workflows (DAGs of serverless DNN functions).

The paper's four evaluation applications are linear pipelines (§4.1); the
dominator machinery also supports general DAGs with splits/joins, which the
tests exercise with synthetic graphs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Workflow:
    """DAG over stage names.  ``edges[i]`` = successors of stage i.

    ``stages`` are (unique) stage ids; ``func_of[stage]`` = function name so
    one function can appear at multiple stages (AFW queues are per
    (app, stage), exactly the paper's per-app Deblur queues)."""
    name: str
    stages: tuple[str, ...]
    func_of: dict[str, str]
    edges: dict[str, tuple[str, ...]]

    @property
    def roots(self) -> list[str]:
        has_pred = {s for succ in self.edges.values() for s in succ}
        return [s for s in self.stages if s not in has_pred]

    @property
    def sinks(self) -> list[str]:
        return [s for s in self.stages if not self.edges.get(s)]

    def predecessors(self, stage: str) -> list[str]:
        return [s for s, succ in self.edges.items() if stage in succ]

    @classmethod
    def pipeline(cls, name: str, funcs: list[str]) -> "Workflow":
        stages = tuple(f"{i}:{f}" for i, f in enumerate(funcs))
        func_of = {s: f for s, f in zip(stages, funcs)}
        edges = {stages[i]: (stages[i + 1],) for i in range(len(stages) - 1)}
        edges[stages[-1]] = ()
        return cls(name, stages, func_of, edges)


# The paper's four applications (§4.1)
PAPER_APPS = {
    "image_classification": Workflow.pipeline(
        "image_classification",
        ["super_resolution", "segmentation", "classification"]),
    "depth_recognition": Workflow.pipeline(
        "depth_recognition",
        ["deblur", "super_resolution", "depth"]),
    "background_elimination": Workflow.pipeline(
        "background_elimination",
        ["super_resolution", "deblur", "background_removal"]),
    "expanded_image_classification": Workflow.pipeline(
        "expanded_image_classification",
        ["deblur", "super_resolution", "background_removal",
         "segmentation", "classification"]),
}
