"""A run of each cell on the CPU at a tiny size (``--device cpu
--reduced``): the port's plain path against the plain reference, the
check's faults and its control."""
import importlib.util
import json
import pathlib
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT / "src"))

from hbench import faults, judge, reference, serve  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def load_run():
    spec = importlib.util.spec_from_file_location("h100bench_run_test",
                                                  HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # a test worker has the other test files' imports (JAX among them)
    # loaded; test_hbench_hygiene.py runs the harness in a fresh
    # interpreter and holds it to the check this skips
    mod.forbidden_modules = lambda: []
    return mod


def dry(capsys, cell, seed, trace=0, faults=(), rate=60.0, seconds=1.5):
    rc = load_run().main(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace),
                          "--device", "cpu", "--reduced", "--rate-rps",
                          str(rate)], faults=faults)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_is_correct(capsys, cell):
    res, err = dry(capsys, cell, 2 ** 31 + 11)
    assert res["correct"] is True, err[-2000:]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    own = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    assert set(res["checks"]) == set(own["limits"])


def test_traced_dry_run_reports_host_layers(capsys):
    cell = "internlm2_1_8b-p2048g8-open"
    res, err = dry(capsys, cell, 7, trace=1, rate=60.0)
    assert res["correct"] is True, err[-2000:]
    assert {"batch_fill", "profile_err",
            "decode_step_ms.open"} <= set(res["metrics"])
    assert "window_s" in res["device"] and "breakdown" in res


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(capsys, cell, kind):
    # a backlog samples the tasks its measured profile puts inside the
    # window; on a loaded CPU the profile's B = 1 pass has read over 1.3 s,
    # so the window is long enough for a full batch to be among them
    res, err = dry(capsys, cell, 5, faults=(kind,), rate=400.0, seconds=3.0)
    assert res["correct"] is False, err[-2000:]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    """The reference in fp8 in the program's place fails one of the cell's
    numbers: the cell's family at 4 layers of width 256, 3 seeds, on the
    CPU (on the card the control is read at the cell's own size by
    ``calibrate.py --control``)."""
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    own = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    model = dict(cfg["model"], n_layers=4, d_model=256, n_heads=4,
                 n_kv_heads=2, d_head=64, d_ff=512, vocab=1024)
    for seed in (1, 2, 3):
        g = torch.Generator().manual_seed(seed)
        toks = torch.randint(0, model["vocab"], (8, 64 + mix["gen_len"]),
                             generator=g)
        ref, = reference.served_logits(model, seed, [toks], 64,
                                       torch.bfloat16, "cpu")
        low, = reference.served_logits(model, seed, [toks], 64,
                                       torch.bfloat16, "cpu", "fp8")
        same = judge.compare(ref, ref.argmax(-1), ref)
        ctl = judge.compare(low, low.argmax(-1), ref)
        read = {"logit_rel_med": lambda p: p["rel"].median(),
                "logit_rel_max": lambda p: p["rel"].max()}
        limits = {k: v for k, v in own["limits"].items() if k in read}
        assert limits
        assert all(float(read[k](same)) == 0.0 for k in limits)
        assert any(float(read[k](ctl)) > v for k, v in limits.items())


def test_reference_moe_drops_past_capacity_as_the_port_does():
    """The reference's routing against the port's ``moe_ffn`` where the
    capacity drops assignments (capacity factor 1.0, 8 experts, top 2)."""
    from repro_torch.models.moe import moe_ffn
    g = torch.Generator().manual_seed(0)
    d, f, e, t = 32, 48, 8, 40
    x = torch.randn(3, t, d, generator=g)
    w = {"router": torch.randn(d, e, generator=g),
         "moe_w1": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "moe_w2": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "moe_w3": torch.randn(e, f, d, generator=g) / f ** 0.5}
    want, _ = moe_ffn(x, w["router"], w["moe_w1"], w["moe_w2"], w["moe_w3"],
                      n_experts=e, top_k=2, capacity_factor=1.0)
    flat = torch.arange(3 * t).view(3, t)
    got = reference.moe(reference._Math(None), x.reshape(-1, d), w,
                        [flat[r] for r in range(3)], 2, 1.0)
    torch.testing.assert_close(got.view(3, t, d), want, rtol=1e-5,
                               atol=1e-5)
    probs = torch.softmax(x.reshape(-1, d) @ w["router"], -1)
    kept = reference.route(probs, [flat[r] for r in range(3)], 2, 1.0)[0]
    assert len(kept) < 3 * t * 2          # the capacity dropped some


def test_the_control_in_the_programs_place_is_not_correct():
    """A whole run of an InternLM2 cell, reduced on the CPU, with the
    reference in fp8 standing in for the program in the served numbers:
    the run's own ``correct`` comes out false, as ``calibrate.py
    --control`` reads it at each cell's size on the card.  (At the reduced
    width of Mixtral's cells fp8's error stays under their limits; every
    cell's limits are held against the control at width 256 above.)"""
    mod = load_run()
    got = mod.run_cell(mod.parse([
        "--workload", "internlm2_1_8b-p2048g8-open", "--seed",
        str(2 ** 31 + 21), "--seconds", "1.5", "--device", "cpu",
        "--reduced", "--rate-rps", "60"]), stand_in="fp8")
    assert got["rc"] == 0 and got["numbers"]["compared_rows"] > 0
    assert got["result"]["correct"] is False, got["numbers"]


def test_checked_rows_of_a_large_dense_batch_are_drawn_from_the_seed():
    rows = judge.check_rows(64, 2 ** 31 + 3, 5, moe=False)
    assert len(rows) == judge.CHECK_ROWS == len(set(rows))
    assert rows == sorted(rows) and rows[-1] < 64
    assert rows == judge.check_rows(64, 2 ** 31 + 3, 5, moe=False)
    assert rows != judge.check_rows(64, 2 ** 31 + 4, 5, moe=False)
    assert judge.check_rows(64, 1, 5, moe=True) == list(range(64))
    assert judge.check_rows(8, 1, 5, moe=False) == list(range(8))
