"""Build the port's CUDA kernels and load them through ctypes.

Every ``kernels/<name>/csrc/<name>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``build/repro_torch_kernels/`` at the repository
root.  The library's file name carries a hash of its source and flags, so
an edited source is rebuilt at its next use and an unchanged one never is.
``build_all`` starts one ``nvcc`` per stale source, all at once.

The wrappers pass tensors as ``data_ptr()`` integers and PyTorch's current
stream as ``cuda_stream``; every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on a
nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, pathlib.Path]:
    """name -> CUDA source, for every ``kernels/*/csrc/*.cu``."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> pathlib.Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=None, verbose: bool = False) -> dict[str, dict]:
    """Compile every stale library in parallel.

    Returns ``{name: {"seconds": s, "cached": bool, "log": text}}``;
    ``verbose`` adds ``-Xptxas=-v`` so the log lists each kernel's
    registers, shared memory and spills.  Raises if any compile fails."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists() and not verbose:
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                     "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if it is stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, prefix: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix}: CUDA error {err}: "
                           f"{fn(err).decode()}")
