"""Per-rank cost of a torch step from the aten ops it runs: the
counterpart of the reference's ``hlo_analysis.py``.

The reference re-derives FLOPs and HBM traffic from the optimized HLO
text, multiplying the instructions inside ``while`` bodies by their trip
counts.  A torch program has no HLO: it runs eagerly, loop by loop, so the
ops are counted as they run (here on fake tensors, so no device is
touched), and every op inside a loop is counted each time it runs.

FLOPs:  ``torch.utils.flop_counter.FlopCounterMode``, which counts the
products only (mm, bmm, addmm, baddbmm, convolution, attention): the
reference's dot-only convention.  Elementwise FLOPs are ignored.

Bytes:  the operand plus result sizes of each aten op that writes memory:
one that returns a new storage, or one that writes into an argument in
place.  Views and metadata ops count 0.  An eager upper bound, in the
spirit of the reference's per-instruction count (eager PyTorch fuses
nothing, so each op reads its operands from memory and writes its
result).

Memory (the reference's ``memory_analysis()`` fields, per rank):
  argument_bytes  the step's inputs: each rank's blocks;
  output_bytes    its outputs' blocks, aliased ones included;
  alias_bytes     the outputs that are inputs updated in place (the
                  ``donate`` arguments of ``launch/steps.py``);
  temp_bytes      the peak of the storages the step creates and has alive
                  at once, less the outputs it creates;
so ``peak_bytes_est = argument + output + temp - alias`` (the reference's
formula) is the inputs plus the peak of the storages alive at once: what
``torch.cuda.max_memory_allocated`` reads on a card when the inputs are
the only memory held before the step.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


def _local(t):
    """The tensor that holds ``t``'s bytes on this rank (a DTensor's
    local block)."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a nested args / outputs tree, DTensors as their
    local blocks."""
    return [_local(x) for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _unique_bytes(ts) -> int:
    """Bytes of the distinct storages the tensors ``ts`` lie in."""
    seen = {}
    for t in ts:
        seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


class OpBytes(TorchDispatchMode):
    """Counts each op's bytes (module docstring) and tracks the storages
    the ops create, other than those of ``inputs`` (the tensors that exist
    before the step): their bytes alive now and at the peak.

    Ops on DTensors are handed back (``NotImplemented``) so DTensor
    desugars them into ops on the local blocks, which come through this
    mode and are counted at their per-rank sizes."""

    def __init__(self, inputs) -> None:
        super().__init__()
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self._alive: dict[int, int] = {}
        self._inputs = {_storage_key(t) for t in inputs}

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def _track(self, t: torch.Tensor) -> bool:
        """Start tracking ``t``'s storage if it is new; True if it was."""
        key = _storage_key(t)
        if key in self._alive or key in self._inputs:
            return False
        storage = t.untyped_storage()
        n = storage.nbytes()
        self._alive[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [x for x in tree_leaves((args, kwargs))
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        in_keys = {_storage_key(t) for t in ins}
        created = [self._track(t) for t in outs
                   if _storage_key(t) not in in_keys]
        schema = getattr(func, "_schema", None)
        mutates = schema is not None and any(
            a.alias_info is not None and a.alias_info.is_write
            for a in schema.arguments)
        if any(created) or mutates:
            self.bytes += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
        return out


@contextlib.contextmanager
def analyzing(args):
    """Counts FLOPs and bytes and tracks memory of what runs inside, with
    ``args`` (a tree of tensors) the step's inputs.  Yields a dict that
    :func:`finish` completes."""
    inputs = _tensors(args)
    rec = OpBytes(inputs)
    flops = FlopCounterMode(display=False)
    state = {"flops": flops, "bytes": rec, "args": inputs}
    with flops, rec:
        yield state


def finish(state: dict, outputs) -> dict:
    """{'flops', 'bytes', 'memory': {...}} of a step traced under
    :func:`analyzing` that returned ``outputs``."""
    rec = state["bytes"]
    arg_keys = {_storage_key(t) for t in state["args"]}
    outs = _tensors(outputs)
    aliased = [t for t in outs if _storage_key(t) in arg_keys]
    arg_b = _unique_bytes(state["args"])
    out_b = _unique_bytes(outs)
    alias_b = _unique_bytes(aliased)
    temp_b = rec.peak - (out_b - alias_b)
    return {
        "flops": float(state["flops"].get_total_flops()),
        "bytes": float(rec.bytes),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": alias_b,
            "peak_bytes_est": arg_b + out_b + temp_b - alias_b,
        },
    }
