"""Device meshes over an initialised ``torch.distributed`` process group.

Defined as functions (never module-level constants), so importing this
module creates no process group and touches no device: the caller
initialises the group (its address, world size and rank) and then asks for
a mesh over it.

``mesh_axes`` and ``dp_axes`` take a ``DeviceMesh`` or a plain ``{axis:
size}`` mapping, so the sharding rules can be evaluated at production
sizes (16 x 16, 2 x 16 x 16) without that many ranks.  The production
mesh is a real ``DeviceMesh`` over a *fake* process group of 256 or 512
ranks (:func:`fake_process_group`), whose collectives move no data: the
dry-run (``launch/dryrun.py``) traces a step on it, on fake tensors, in
one process that touches no device.
"""
from __future__ import annotations

import contextlib
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


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod, over the
    (fake) process group the caller has initialised; a CPU mesh, since
    the dry-run that uses it touches no device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, device_type="cpu")


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A process group of ``world_size`` ranks, this process rank 0, on
    torch's fake backend: every collective returns at once and moves no
    data.  Destroyed on exit, also when the body raises.  Refuses to run
    beside a group already initialised (a process has one default
    group)."""
    import torch
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "fake group needs a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"torch {torch.__version__} has no "
                           f"fake process group backend "
                           f"(torch.testing._internal.distributed.fake_pg): "
                           f"{e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch (pod + data when multi-pod)."""
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
