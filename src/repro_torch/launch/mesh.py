"""Device meshes over an initialised ``torch.distributed`` process group.

Defined as functions (never module-level constants), so importing this
module creates no process group and touches no device: the caller
initialises the group (its address, world size and rank) and then asks for
a mesh over it.

``mesh_axes`` and ``dp_axes`` take a ``DeviceMesh`` or a plain ``{axis:
size}`` mapping, so the sharding rules can be evaluated at production
sizes (16 x 16, 2 x 16 x 16) without that many ranks.  The production
mesh itself waits for a fake process group of that size.
"""
from __future__ import annotations

import math
from collections.abc import Mapping


def make_test_mesh(shape=(1, 1), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the process group the caller
    has initialised; its world size must be ``prod(shape)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} names {len(axes)} "
                         f"axes {tuple(axes)}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    want = math.prod(shape)
    if dist.get_world_size() != want:
        raise ValueError(f"a {tuple(shape)} mesh needs {want} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch (pod + data when multi-pod)."""
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
