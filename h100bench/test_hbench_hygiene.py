"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Top-level module names are
compared whole: ``repro_torch`` begins with ``repro``."""
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = """
import json, sys
sys.path.insert(0, {here!r})
{body}
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def top_level_after(body: str) -> set:
    code = PROBE.format(here=str(HERE), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_no_program_and_no_jax():
    mods = top_level_after(
        "from hbench import reference, inputs, judge, counts, traffic")
    assert not mods & (FORBIDDEN | {"repro_torch"}), mods & (
        FORBIDDEN | {"repro_torch"})


def test_a_run_loads_no_jax():
    body = (
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('r', {str(HERE / 'run.py')!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "rc = m.main(['--workload', 'mixtral_8x22b_l12-p2048g2-backlog',"
        " '--seed', '9', '--seconds', '1', '--device', 'cpu', '--reduced',"
        " '--rate-rps', '40'])\n"
        "assert rc == 0, rc\n")
    mods = top_level_after(body)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_harness_alone_refuses_to_run(tmp_path):
    """In a directory with only the benchmark's own files there is no
    program: the run exits nonzero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "internlm2_1_8b-p2048g8-open", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--device", "cpu", "--reduced"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
