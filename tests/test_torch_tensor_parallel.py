"""The port's sharded steps split their compute over 'model' as the
reference's GSPMD does: per-rank FLOPs against the reference's, on the CPU.

One subprocess (``JAX_PLATFORMS=cpu``, 4 forced host devices) compiles the
reference's ``launch.steps.build_step`` for a reduced config of each
family x train / prefill / decode (S = 64, global batch 4) on meshes
(1, 1), (2, 2) and (1, 4), and counts each device's FLOPs with
``hlo_analysis`` (~40 s, once a session).  The port's dry-run
(``launch/dryrun.trace_step``) traces the same cell on a fake process
group of the same shape, as rank 0.  Bounds:

  * (1, 1): the reference's count within FLOP_RTOL (its own tolerance,
    tests/test_hlo_analysis.py);
  * (2, 2), where every head count of the reduced configs divides: at
    most SPLIT_RTOL over the reference's per-device count;
  * (1, 4), where the reduced configs' 2 kv heads do not divide (each
    rank computes the kv head its q head reads): at most UNEVEN_RTOL over;
  * on both, at least EVEN_FLOOR of the port's own (1, 1) count over 4:
    nothing a rank must compute is left out.

Where GSPMD splits evenly (dense and hybrid in every kind, Mixtral in
train and prefill) the two bounds pin the port within 2% at (2, 2).
The values of the split are held on gloo groups,
``tests/test_torch_distribution.py``.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs.registry import ShapeSpec, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group, make_test_mesh
from repro_torch.models.model import RunOptions

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["internlm2_1_8b", "hymba_1_5b", "mixtral_8x22b", "rwkv6_1_6b"]
KINDS = ["train", "prefill", "decode"]
MESHES = [(1, 1), (2, 2), (1, 4)]
SEQ, BATCH = 64, 4
FLOP_RTOL = 0.02          # tests/test_hlo_analysis.py:28
SPLIT_RTOL, UNEVEN_RTOL, EVEN_FLOOR = 1.02, 1.15, 0.98

_REFERENCE = f"""
import json, sys
import jax
from repro.configs.registry import ShapeSpec, get_config, reduced
from repro.launch import hlo_analysis, steps
from repro.launch.mesh import make_test_mesh
from repro.models.model import RunOptions

out = {{}}
for arch in {ARCHS!r}:
    cfg = reduced(get_config(arch))
    for mesh_shape in {MESHES!r}:
        mesh = make_test_mesh(tuple(mesh_shape))
        for kind in {KINDS!r}:
            fn, in_sh, out_sh, specs, donate = steps.build_step(
                cfg, ShapeSpec("tp", {SEQ}, {BATCH}, kind), mesh,
                RunOptions())
            with mesh:
                compiled = jax.jit(fn, in_shardings=in_sh,
                                   out_shardings=out_sh,
                                   donate_argnums=donate).lower(
                                       *specs).compile()
            key = f"{{arch}}|{{kind}}|{{mesh_shape[0]}}x{{mesh_shape[1]}}"
            out[key] = hlo_analysis.analyze(compiled.as_text())["flops"]
print(json.dumps(out))
"""


def _key(arch, kind, mesh_shape) -> str:
    return f"{arch}|{kind}|{mesh_shape[0]}x{mesh_shape[1]}"


def _reference_flops() -> dict:
    """{arch|kind|mesh: the reference's per-device FLOPs}, from one
    interpreter with 4 forced CPU devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def reference_flops() -> dict:
    return _reference_flops()


@pytest.fixture(autouse=True)
def clean_group():
    """No process group before a test, and none left after it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a test left a process group initialised")


_PORT: dict = {}


def _port_flops(arch, kind, mesh_shape) -> float:
    """The port's per-rank FLOPs of the cell on a fake group of the
    mesh's shape (rank 0), memoised."""
    key = _key(arch, kind, mesh_shape)
    if key not in _PORT:
        with fake_process_group(math.prod(mesh_shape)):
            mesh = make_test_mesh(mesh_shape, device_type="cpu")
            _PORT[key] = dryrun.trace_step(
                reduced(get_config(arch)), ShapeSpec("tp", SEQ, BATCH, kind),
                mesh, RunOptions())["flops"]
    return _PORT[key]


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=["x".join(map(str, m)) for m in MESHES])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_flops_match_the_references_split(reference_flops, arch,
                                                   kind, mesh_shape):
    ref = reference_flops[_key(arch, kind, mesh_shape)]
    port = _port_flops(arch, kind, mesh_shape)
    assert ref > 0 and port > 0
    if mesh_shape == (1, 1):
        assert port == pytest.approx(ref, rel=FLOP_RTOL)
        return
    upper = SPLIT_RTOL if mesh_shape == (2, 2) else UNEVEN_RTOL
    assert port <= upper * ref, (port / ref, upper)
    even = _port_flops(arch, kind, (1, 1)) / math.prod(mesh_shape)
    assert port >= EVEN_FLOOR * even, (port / even, EVEN_FLOOR)


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_tensor_parallel.py: each
    # cell's per-rank FLOPs, port over reference, and port over a quarter
    # of its own (1, 1) count
    ref = _reference_flops()
    for arch in ARCHS:
        for mesh_shape in MESHES[1:]:
            cells = []
            for kind in KINDS:
                port = _port_flops(arch, kind, mesh_shape)
                even = _port_flops(arch, kind, (1, 1)) / 4
                over = port / ref[_key(arch, kind, mesh_shape)]
                cells.append(f"{kind} {over:.4f} ({port / even:.4f})")
            print(arch, "x".join(map(str, mesh_shape)), ", ".join(cells))
