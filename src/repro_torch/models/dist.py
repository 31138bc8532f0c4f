"""Per-rank blocks of a tensor laid out by a partition spec on a
``DeviceMesh``, and the differentiable collectives of the sharded paths.

A spec is a sequence with one entry per tensor dim (a shorter one leaves
the remaining dims replicated): None, an axis name, or a tuple of axis
names laid out major to minor, as JAX's ``PartitionSpec``.  The rank at
mesh coordinates c holds, along a dim whose entry is (a1, ..., ak), block
number c[a1] * |a2| * ... * |ak| + ... + c[ak] of |a1| * ... * |ak| equal
blocks.  :func:`local_block` cuts that block out of a full tensor;
:func:`gather` rebuilds the full tensor from the blocks with all-gathers.

Gradients.  Every rank runs the same program on its batch block: ranks
that differ only in a non-batch ("model") coordinate compute the same
values, and the global objective is the sum of the per-batch-block
objectives.  Each collective's backward keeps that contract, as
Megatron's conjugate pairs do:

  * :func:`unshard` -- all-gather forward; backward all-reduces the
    gradient over the batch axes and keeps the rank's own block (the
    reference's all_gather <-> psum_scatter);
  * :func:`copy_to` -- identity forward, all-reduce backward (a
    replicated input feeding a tensor-parallel product);
  * :func:`reduce_from` -- all-reduce forward, identity backward (partial
    sums of a row-parallel product; psum <-> identity);
  * :func:`gather_from` / :func:`scatter_to` -- all-gather / keep-own-chunk
    along one dim over one axis, each the other's backward.

Tensor parallelism (:class:`Split`) breaks the first sentence above along
'model': each rank of that axis computes its share of every product, so
a replicated activation that feeds a split product passes through
:func:`copy_to` (or :func:`unshard` over 'model', when each rank reads a
different part of it), and partial products leave through
:func:`reduce_from`.  Vocab-parallel cross-entropy adds a maximum over
'model' (:func:`max_from`, a constant shift with no gradient) and sums
its partial exponentials and label logits with :func:`reduce_from`.

A backward that all-reduced where its forward had already summed
(``torch.distributed.nn.functional.all_reduce`` does) would multiply the
gradient by the axis size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def _block(mesh, entry) -> tuple[int, int]:
    """(block number, number of blocks) of this rank along an entry."""
    idx, n = 0, 1
    for a in _axes(entry):
        size = axis_size(mesh, a)
        idx, n = idx * size + axis_index(mesh, a), n * size
    return idx, n


def local_block(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` (a view)."""
    out = full
    for dim, entry in enumerate(spec):
        idx, n = _block(mesh, entry)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split into {n} equal blocks ({entry!r})")
        size = out.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def _all_gather(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Concatenation along ``dim`` of ``t`` over the ranks of ``axis``,
    in coordinate order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group(axis))
    return torch.cat(parts, dim)


def all_reduce(t: torch.Tensor, mesh, axes, op=SUM):
    """``t`` reduced in place over each of ``axes``; returns it."""
    for a in axes:
        if axis_size(mesh, a) > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


def gather(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor of which ``local`` is this rank's block: minor
    axes first, so each all-gather joins adjacent blocks."""
    out = local
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            out = _all_gather(out, dim, mesh, a)
    return out


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, spec, mesh, sum_axes):
        ctx.spec, ctx.mesh, ctx.sum_axes = spec, mesh, sum_axes
        return gather(local, spec, mesh)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce(grad.contiguous().clone(), ctx.mesh, ctx.sum_axes)
        return (local_block(grad, ctx.spec, ctx.mesh).contiguous(),
                None, None, None)


def unshard(local: torch.Tensor, spec, mesh, sum_axes=()) -> torch.Tensor:
    """:func:`gather`, differentiable: the gradient of the full tensor is
    summed over ``sum_axes`` (the axes carrying the batch) and cut to this
    rank's block."""
    return _Unshard.apply(local, tuple(spec), mesh, tuple(sum_axes))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.mesh,
                          (ctx.axis,)), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous().clone(), mesh, (axis,))

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _own_chunk(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own_chunk(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.mesh, ctx.axis), None, None, None


def _own_chunk(x, mesh, axis, dim):
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} {axis!r} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axis) * size, size).contiguous()


def max_from(x, mesh, axis: str):
    """Elementwise maximum over ``axis``, as a constant: no gradient flows
    through it.  It is the shift of a logsumexp, whose gradient through
    the shift cancels exactly (``torch.logsumexp`` detaches it too)."""
    return all_reduce(x.detach().clone(), mesh, (axis,), MAX)


def gather_parts(x, mesh, axis: str, dim: int, parts) -> torch.Tensor:
    """The whole tensor of which rank r of ``axis`` holds the slice
    ``parts[r] = (lo, hi)`` along ``dim``; the parts cover [0, n) in
    order and may overlap or be empty (an uneven head split).  Each
    element is taken from the first rank that holds it.  No gradient."""
    dim %= x.dim()
    width = max(hi - lo for lo, hi in parts)
    if x.shape[dim] < width:
        pad = list(x.shape)
        pad[dim] = width - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    blocks = _all_gather(x, dim, mesh, axis).split(width, dim)
    out, covered = [], 0
    for (lo, hi), block in zip(parts, blocks):
        if hi > covered:
            out.append(block.narrow(dim, covered - lo, hi - covered))
            covered = hi
    return torch.cat(out, dim)


class Split:
    """This rank's share of the 'model' axis of a mesh that splits the
    compute (tensor parallelism).  Of n heads, channels or rows, rank r
    of the axis's ``size`` takes ``part(n)`` = [floor(r n / size),
    floor((r + 1) n / size)): the even block when size divides n, whole
    heads otherwise (some ranks one more, some none)."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.size, self.rank = axis_size(mesh, axis), axis_index(mesh, axis)

    def part(self, n: int, rank: int | None = None) -> tuple[int, int]:
        r = self.rank if rank is None else rank
        return n * r // self.size, n * (r + 1) // self.size

    def parts(self, n: int) -> list[tuple[int, int]]:
        return [self.part(n, r) for r in range(self.size)]

    def copy_to(self, x):
        return copy_to(x, self.mesh, self.axis)

    def reduce_from(self, x):
        return reduce_from(x, self.mesh, self.axis)

    def gather_from(self, x, dim: int = -1):
        return gather_from(x, self.mesh, self.axis, dim)

    def gather_read(self, x, dim: int = -1):
        """Concatenation over the axis along ``dim`` of a tensor of which
        each rank then reads a different part: the backward sums the
        gradient over the axis and keeps this rank's chunk."""
        spec = [None] * x.dim()
        spec[dim % x.dim()] = self.axis
        return unshard(x, spec, self.mesh, (self.axis,))


def copy_to(x, mesh, axis: str):
    """Identity; the backward all-reduces over ``axis``."""
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis: str):
    """Sum over ``axis`` (in x's dtype); the backward is the identity."""
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x, mesh, axis: str, dim: int = -1):
    """Concatenation over ``axis`` along ``dim``; the backward keeps this
    rank's chunk."""
    return _GatherFrom.apply(x, mesh, axis, dim % x.dim())


def scatter_to(x, mesh, axis: str, dim: int = -1):
    """This rank's chunk along ``dim``; the backward all-gathers."""
    return _ScatterTo.apply(x, mesh, axis, dim % x.dim())
