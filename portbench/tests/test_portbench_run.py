"""A run of each cell end to end on the CPU at a small size (the harness's
look for a card skipped; the program's plain versions): the result's
keys, the traced segment, the control coming out as not correct, and the
timed path broken underneath making ``correct`` false. ``test_on_the_card``
runs the command itself on the card."""
import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 12345  # seeds run past 32 bits


def small_spec(cell):
    spec = harness.load_spec(cell)
    spec.config.update(spec.config["test_sizes"]["small"])
    spec.cell["trace_calls"] = min(spec.cell["trace_calls"], 3)
    return spec


def run_small(spec, trace=False, seconds=0.3):
    return harness.run(spec, seed=SEED, seconds=seconds, trace=trace, device=CPU,
                       t0=time.perf_counter(), log=lambda line: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_prints_the_result_line(cell, trace):
    spec = small_spec(cell)
    res = run_small(spec, trace)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == want + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    named = {m["name"] for m in (spec.per_layer if trace else spec.end_to_end)}
    assert set(res["metrics"]) <= named
    if not trace:  # every end-to-end metric reads on the CPU too
        assert set(res["metrics"]) == named
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res["checks"]) == list(spec.cell["checks"])
    for c in res["checks"].values():
        assert c["compared"] >= 1 and c["value"] <= c["limit"]
    json.dumps(res, allow_nan=False)


def test_the_same_seed_gives_the_same_inputs():
    from portbench import inputs

    spec = small_spec("er100k.solve1")
    a, b = (inputs.make_matrix(spec.config, SEED) for _ in range(2))
    assert all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ("indptr", "indices", "data"))
    c = inputs.make_matrix(spec.config, SEED + 1)
    assert np.array_equal(a.indices, c.indices) and not np.array_equal(a.data, c.data)
    driver = harness.load_module("traffic", spec.traffic["driver"])
    p = driver.make_pool(spec.traffic, 50, SEED, CPU)
    assert torch.equal(p, driver.make_pool(spec.traffic, 50, SEED, CPU))


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    spec = small_spec(cell)
    got = control.control_reading(spec, SEED, 2, CPU)
    assert got["checks"]  # the control fails one of the cell's numbers on every call
    assert all(any(c["values"][k] > c["limit"] for c in got["checks"].values())
               for k in range(2))


def _broken(fault=None, **attrs):
    """The program's entry with its answer passed through ``fault``, or
    with ``attrs`` set on it after its set-up."""
    real = harness.load_module

    def load(kind, name):
        mod = real(kind, name)
        if kind != "systems":
            return mod

        class Broken(mod.System):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.__dict__.update(attrs)

            def call(self, rhs):
                out = super().call(rhs)
                return fault(out, rhs) if fault else out

        return types.SimpleNamespace(System=Broken)

    return load


def unchanged(out, rhs):  # the state handed back as it came
    return rhs.clone()


def half_batch(out, rhs):  # half of the right-hand sides left out
    out = out.clone()
    out[:, out.shape[1] // 2:] = 0.0
    return out


def altered(out, rhs):  # one answer altered where it is produced
    out = out.clone()
    out.view(-1)[out.numel() // 3] += out.abs().max()
    return out


def small_row(out, rhs):  # a 1% error in the row of the median |x|
    out = out.clone()
    flat = out.view(-1)
    i = int(flat.abs().argsort()[flat.numel() // 2])
    flat[i] *= 1.01
    return out


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    spec = small_spec(cell)
    if fault is half_batch and spec.traffic["rhs"] == 1:
        pytest.skip("one right-hand side a call: no batch to halve")
    monkeypatch.setattr(harness, "load_module", _broken(fault))
    res = run_small(spec)
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("cell", [c for c in CELLS if "x_berr" in harness.load_spec(c).cell["checks"]])
def test_an_error_in_a_small_row_is_not_correct(cell, monkeypatch):
    spec = small_spec(cell)
    monkeypatch.setattr(harness, "load_module", _broken(small_row))
    res = run_small(spec)
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["x_berr"]["value"] > res["checks"]["x_berr"]["limit"]
    if spec.config.get("values") == "seed":
        # under the paper's values |x| spans orders of magnitude (max over
        # median 1e4-1e5 on ER): max |x - x_ref| / max |x_ref| cannot see
        # it, the componentwise error does. Values that keep |x| near max
        # |b| (a dominant diagonal) let both see it.
        assert res["checks"]["x_err"]["value"] <= res["checks"]["x_err"]["limit"]


@pytest.mark.parametrize("cell", [c for c in CELLS if "cg" in harness.load_spec(c).config])
def test_cg_stopped_early_is_not_correct(cell, monkeypatch):
    spec = small_spec(cell)
    monkeypatch.setattr(harness, "load_module", _broken(tol=1e-3))
    res = run_small(spec)
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert res["checks"]["cg_relres"]["value"] > res["checks"]["cg_relres"]["limit"]
    assert "pcg_s" not in res["metrics"]  # no converged solve, no time to one


def test_x_berr_reads_a_row_of_zeros_as_exact():
    from portbench import inputs

    spec = small_spec("er100k.solve1")
    m = inputs.make_matrix(spec.config, SEED)
    solve = harness.load_module("checks", "x_err").control  # any near answer
    b = torch.randn(m.n, generator=torch.Generator().manual_seed(0))
    b[0] = 0.0  # row 0 reads only itself: x_0 = 0 too
    x = solve(m, [b], {"dtype": "float32"}, CPU)[0]
    x[0] = 0.0
    check = harness.load_module("checks", "x_berr")
    run = types.SimpleNamespace(matrix=m, device=CPU, kept=[(0, b, x)])
    got = check.compare(run)[0]
    assert 0 < got < 0.1  # finite: the bfloat16 answer's own error
    x[0] = float("nan")
    assert check.compare(run)[0] == float("inf")


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0


def test_each_reader_on_a_traced_segment_made_by_hand():
    from portbench import devtrace, inputs, peaks

    seg = devtrace.Segment(calls=4, window_s=0.01, busy_s=0.008, ops_per_call=[3, 3, 2, 3],
                           device_ops=[["k", 0.008]], idle_gaps=[["h", 0.002]], device_events=11)
    for cell in CELLS:
        spec = small_spec(cell)
        m = inputs.make_matrix(spec.config, SEED)
        ctx = types.SimpleNamespace(
            setup_s=1.0, window_s=2.0, calls=8, call_ms=[0.5] * 8,
            counters={"plan_s": 0.5, "levels": 7, "iters": [10, 12], "relres": [1e-7, 2e-7]},
            traced_counters={"iters": [11] * 4}, segment=seg, matrix=m,
            rhs_cols=spec.traffic["rhs"], peak=peaks.peaks("NVIDIA H100 80GB HBM3"),
            config=spec.config, traffic=spec.traffic)
        for metric in spec.end_to_end + spec.per_layer:
            reader = harness.load_reader(metric["name"])
            value = reader.read(ctx)
            assert value is not None and value > 0, metric["name"]
            if metric["unit"] == "%":
                assert value <= 100
            if hasattr(reader, "detail"):
                d = reader.detail(ctx)
                assert d["bound_by"] in ("bytes", "operations") and d["computed_bytes"] > 0
