"""Elastic scaling: re-mesh + reshard a training/serving state.

When ranks join or fail permanently, the job restarts on a new mesh
shape; ``reshard_state`` moves the state onto the new mesh with each
leaf's partition spec (the checkpoint layer restores through the same
path, ``checkpointing.restore(..., shardings=, mesh=)``, so scale-up/down
is a restore onto a different mesh, with no format change).

``shrink_mesh`` models a failure: it drops trailing slices along one
axis; the surviving ranks form the new mesh (the global batch is re-split
by the deterministic data pipeline, so the training stream is kept).
Building a mesh creates its process groups, a collective call: every
rank of the world calls these functions, those outside the new mesh
included (they hold empty blocks).
"""
from __future__ import annotations

import math

import torch


def make_mesh_from_devices(devices, shape: tuple[int, ...],
                           axes: tuple[str, ...], device_type: str = "cuda"):
    """A mesh of ``shape`` over the first prod(shape) of ``devices`` (the
    global ranks), row-major."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.as_tensor(list(devices)[: math.prod(shape)]).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def shrink_mesh(mesh, axis: str, new_size: int):
    """Drop trailing slices along ``axis`` (simulated node failure)."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh.narrow(names.index(axis), 0, new_size)
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=tuple(names))


def reshard_state(state, pspecs, new_mesh):
    """Every leaf (a DTensor, or a tensor the same on every rank) onto
    ``new_mesh`` with its spec; a dict of specs matches a dict of leaves."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.shardings import distribute

    def move(leaf, spec):
        if isinstance(leaf, dict):
            return {k: move(leaf[k], spec[k]) for k in leaf}
        full = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        return distribute(full, spec, new_mesh)

    return move(state, pspecs)
