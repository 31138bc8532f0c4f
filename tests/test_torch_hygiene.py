"""The port stands alone: it imports neither JAX nor the reference package.

``repro_torch`` keeps its own copy of the numpy control plane, so a fresh
interpreter that imports every port module (and ``chip_smoke.py``) must
end with no ``jax`` and no ``repro`` module loaded; a source scan backs
the runtime check up for imports inside functions.
"""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = f"""
import importlib, json, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
for name in {_port_modules()!r} + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps(bad))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s)|import_module\(f?[\"']repro\.)", re.M)


def test_port_sources_name_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_every_kernel_source_has_a_wrapper_and_a_plain_version():
    for cu in sorted(PORT.glob("kernels/*/csrc/*.cu")):
        pkg = cu.parent.parent
        assert (pkg / "ops.py").exists() and (pkg / "ref.py").exists()
        text = cu.read_text()
        assert "Replaces the TPU kernel" in text   # the note of its origin
        assert "Bound on this card" in text
    assert {p.stem for p in PORT.glob("kernels/*/csrc/*.cu")} == {
        "flash_attention", "flash_decode"}


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory (or on a host without CUDA) the smoke script
    exits nonzero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
