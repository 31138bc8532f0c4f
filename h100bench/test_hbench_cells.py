"""The benchmark's files: every cell resolves to its files, every name and
unit keeps to the allowed characters, a traffic mix holds traffic alone,
and the traffic generator gives every seed the same work."""
import json
import pathlib
import re
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from hbench import traffic  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert w["chips"] == 1
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]
    for key in cfg["reduced"]:
        assert key in cfg and key in cfg["published"]
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    assert mix["release"] in ("schedule", "backlog")
    own = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert own["knee_rps"] > 0 and own["profile_reps"] >= 3
    assert own["batch_lattice"] == sorted(own["batch_lattice"])
    assert ("slo_ms" in mix) != ("slo_of_t1" in mix)
    assert "slo_ms" in mix or own["t1_ms"] > 0
    for exact in ("accounting_errors", "state_errors", "token_errors",
                  "row_errors"):
        assert own["limits"][exact] == 0
    reported_e2e = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", [cell])]
    assert "setup_s" in {m["name"] for m in reported_e2e}
    assert len(reported_e2e) >= 2
    reported = [m for m in BENCH["per_layer"]
                if cell in m.get("workloads", [cell])]
    assert reported
    e2e = {m["name"] for m in reported_e2e}
    for m in reported:
        assert m["moves"] in e2e
    for m in reported_e2e + reported:
        base = m["name"].split(".", 1)[0]
        assert (HERE / "metrics" / f"{m['name']}.py").is_file() or (
            HERE / "metrics" / f"{base}.py").is_file()


def test_metric_workloads_name_cells():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= set(CELLS)


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (HERE / "traffic").glob("*.json")))
def test_every_seed_gets_the_same_arrivals_in_another_order(name):
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    # traffic alone: what follows from a model (its knee, its B = 1 task,
    # the check's limits, the batch lattice) is in the cell's own file
    assert not {"knee_rps", "mean_rate_rps", "t1_ms", "limits",
                "batch_lattice"} & set(mix)
    rate = 12.0 * mix["load_of_knee"]
    a = traffic.arrivals(mix, 30.0, 2 ** 31 + 7, rate)
    b = traffic.arrivals(mix, 30.0, 12345, rate)
    assert len(a) == len(b) == round(rate * 30.0)
    assert 0 < a[0] and a[-1] < 30e3 and np.all(np.diff(a) > 0)
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0.0)),
                               np.sort(np.diff(b, prepend=0.0)))
    assert not np.allclose(a, b)
    np.testing.assert_array_equal(a, traffic.arrivals(mix, 30.0,
                                                      2 ** 31 + 7, rate))


def test_mmpp_copy_draws_as_the_program_does():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.serving.traces import MMPPScenario
    arr = MMPPScenario(mean_interval_ms=1.0, burst_factor=8.0,
                       p_switch=0.05).arrivals(["a"], 200, seed=3)
    gaps, _ = traffic.mmpp_gaps(200, 3, 8.0, 0.05)
    np.testing.assert_allclose(np.cumsum(gaps), [x.t_ms for x in arr])
