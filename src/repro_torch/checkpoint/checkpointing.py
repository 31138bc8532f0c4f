"""Checkpoints in the reference's format: one ``manifest.json`` (leaf
names, shapes, dtypes, step) plus one ``.npy`` per leaf, in a
``step_XXXXXXXX/`` directory published by an atomic rename; the newest
``keep`` are kept.

A state is a nested dict of tensors (``None`` entries hold no leaves);
each leaf is named by the '/'-joined path of its keys.  The port's flat
parameter names (``layers/wq``) sit under ``params/`` and ``opt/m`` like
the reference's tree paths, so ``params/layers/wq`` names the same leaf
on both sides and each package reads the other's files.

numpy has no bfloat16: a bf16 leaf is written as its 2-byte bit patterns
under the header the reference's files carry (``<V2``; plain numpy loads
it as a void array) and recorded as ``"bfloat16"`` in the manifest;
restore reinterprets every leaf by the manifest's dtype.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.models.convert import flat_items

_BF16_DESCR = "<V2"       # what np.save writes for an ml_dtypes bfloat16


def _flatten(tree) -> list[tuple[str, torch.Tensor]]:
    return [(n, v) for n, v in flat_items(tree) if v is not None]


def _unflatten_like(tree, leaves: dict, prefix: str = ""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out[key] = _unflatten_like(val, leaves, f"{name}/")
        else:
            out[key] = None if val is None else leaves[name]
    return out


def _save_leaf(path: pathlib.Path, t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        arr = t.numpy()
        np.save(path, arr)
        return str(arr.dtype)
    bits = t.view(torch.int16).numpy()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(bits.shape)})
        f.write(bits.tobytes())
    return "bfloat16"


def _load_leaf(path: pathlib.Path, dtype: str) -> torch.Tensor:
    arr = np.array(np.load(path))           # a writable, C-ordered copy
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype, copy=False))


def save(ckpt_dir, step: int, tree, keep: int = 3) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _flatten(tree):
        fname = name.replace("/", "__") + ".npy"
        dtype = _save_leaf(tmp / fname, leaf)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(leaf.shape), "dtype": dtype}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic publish
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for p in ckpt_dir.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


def restore(ckpt_dir, tree_like, shardings=None, step: Optional[int] = None,
            device=None, mesh=None):
    """Restore into the structure of ``tree_like`` (its leaves give the
    names; their values are not read).  Each leaf comes back in the
    manifest's dtype, on ``device`` (default: the CPU).  With
    ``shardings`` (a matching tree of partition specs) and ``mesh``, each
    leaf comes back as a DTensor on ``mesh`` holding this rank's block.
    Returns (tree, step)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    if shardings is not None and mesh is None:
        raise ValueError("restoring onto shardings needs their mesh")
    d = ckpt_dir / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    specs = dict(_flatten(shardings)) if shardings is not None else {}
    leaves = {}
    for name, _ in _flatten(tree_like):
        info = manifest["leaves"][name]
        t = _load_leaf(d / info["file"], info["dtype"])
        if list(t.shape) != info["shape"]:
            raise ValueError(f"{d / info['file']}: shape {list(t.shape)}, "
                             f"manifest {info['shape']}")
        t = t.to(device) if device is not None else t
        if name in specs:
            from repro_torch.launch.shardings import distribute
            t = distribute(t, specs[name], mesh)
        leaves[name] = t
    return _unflatten_like(tree_like, leaves), manifest["step"]


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(int(m.group(1)) for p in ckpt_dir.iterdir()
                   if (m := re.fullmatch(r"step_(\d+)", p.name)))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
