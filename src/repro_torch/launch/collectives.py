"""Collective recorder and wire-byte model: the counterpart of the
reference's optimized-HLO collective parser.

The reference reads every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute out of an SPMD module's text and walks
its ``while`` bodies to multiply each by its trip count.  A torch program
has no such text: :class:`CollectiveRecorder`, a ``TorchDispatchMode``,
records each collective the program runs, from the c10d ops
(``dist.all_reduce`` and friends) and from the functional ops of
DTensor's redistributions.  A collective inside a loop is recorded
each time it runs, so a count is exact by construction.

Each record keeps the reference's op name, the bytes of the collective's
**result** (for the list form of ``dist.all_gather``, the sum of the
parts) and the size of the process group it runs over.

Wire-byte model (per device, bidirectional ring), the reference's:
  all-reduce        2 (S-1)/S x bytes(result)
  all-gather        (S-1)/S x bytes(result)
  reduce-scatter    (S-1)   x bytes(result)      (= (S-1)/S x operand)
  all-to-all        (S-1)/S x bytes(result)
  collective-permute  1.0   x bytes(result)
where S = the participating group size.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

WIRE_FACTOR = {
    "all-reduce": lambda s: 2.0 * (s - 1) / s,
    "all-gather": lambda s: (s - 1) / s,
    "reduce-scatter": lambda s: float(s - 1),
    "all-to-all": lambda s: (s - 1) / s,
    "collective-permute": lambda s: 1.0,
}

# c10d op -> reference op name; the op's first argument holds the result
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
}
# c10d ops that move no payload (a send is counted by its matching recv)
_C10D_FREE = {"barrier", "monitored_barrier_", "send", "recv_any_source_"}

# functional op -> reference op name; the result is the op's return value
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCTIONAL_FREE = {"wait_tensor"}


@dataclasses.dataclass
class Collective:
    op: str
    bytes_result: float
    group_size: int
    count: float = 1.0

    @property
    def wire_bytes(self) -> float:
        return WIRE_FACTOR[self.op](max(self.group_size, 2)) \
            * self.bytes_result * self.count


def _tensor_bytes(x) -> float:
    """Bytes of the tensors in ``x`` (a tensor or nested lists of them)."""
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(e) for e in x)
    return 0.0


def _group_size(args, kwargs) -> int:
    """Size of the process group a c10d op names (a ``ProcessGroup``
    script object among its arguments)."""
    from torch.distributed import ProcessGroup

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith(".ProcessGroup"):
            return int(ProcessGroup.unbox(a).size())
    raise ValueError("c10d op without a process group argument")


def _functional_group_size(args, kwargs) -> int:
    """Size of the group a functional op names by its registered name."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = kwargs.get("group_name", args[-1] if args else None)
    if not isinstance(name, str):
        raise ValueError(f"functional collective without a group name: "
                         f"{args!r}")
    return int(_resolve_process_group(name).size())


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective run under it as a :class:`Collective`
    with count 1, in order (``self.items``).

    Ops on DTensors are handed back (``NotImplemented``) so that DTensor
    desugars them first: the collectives of its redistributions then come
    through this mode as functional ops.  A collective op this module
    does not know raises, so none is dropped silently."""

    def __init__(self) -> None:
        super().__init__()
        self.items: list[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns = getattr(func, "namespace", "")
        name = func._schema.name.split("::", 1)[-1] \
            if hasattr(func, "_schema") else ""
        if ns == "c10d":
            if name in _C10D:
                self.items.append(Collective(
                    _C10D[name], _tensor_bytes(args[0]),
                    _group_size(args, kwargs)))
            elif name not in _C10D_FREE:
                raise NotImplementedError(f"collective c10d.{name} has no "
                                          f"wire-byte model")
        elif ns in ("_c10d_functional", "_c10d_functional_autograd"):
            if name in _FUNCTIONAL:
                self.items.append(Collective(
                    _FUNCTIONAL[name], _tensor_bytes(out),
                    _functional_group_size(args, kwargs)))
            elif name not in _FUNCTIONAL_FREE:
                raise NotImplementedError(f"collective {ns}.{name} has no "
                                          f"wire-byte model")
        return out

    def summary(self) -> dict:
        """The reference's return dict of ``parse_collectives``:
        {'total_wire_bytes', 'by_op', 'n_collectives', 'items'}."""
        by_op: dict[str, float] = defaultdict(float)
        for c in self.items:
            by_op[c.op] += c.wire_bytes
        return {
            "total_wire_bytes": float(sum(c.wire_bytes for c in self.items)),
            "by_op": dict(by_op),
            "n_collectives": len(self.items),
            "items": [(c.op, c.bytes_result, c.group_size, c.count)
                      for c in self.items],
        }
