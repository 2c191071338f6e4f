"""``BENCHMARK.json`` keeps to the benchmark's format (keys, names, units,
bounds, paths, the metrics each cell reports), and every cell,
configuration, traffic mix, check, system and metric it names is a file
that loads by name."""
import json
import re
import subprocess
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(line_ok(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/")
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:  # never a width
            assert not k.endswith(("_dim", "_rank", "_size"))


def test_workloads():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def _metrics_of(cell):
    e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", CELLS)]
    return e2e, layer


def test_metrics():
    all_metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in all_metrics]
    assert len(set(names)) == len(names)
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e_names
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e_names and line_ok(m["layer"])
        for cell in m.get("workloads", []):  # each listed cell reports what it moves
            assert cell in CELLS
            assert m["moves"] in {e["name"] for e in _metrics_of(cell)[0]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one spelling a layer
    for m in all_metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        for cell in m.get("workloads", []):
            assert cell in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    e2e, layer = _metrics_of(cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    spec = harness.load_spec(cell)
    assert spec.workload["name"] == cell
    harness.load_module("systems", spec.config["system"]).System
    assert set(spec.cell) == {"sample", "checks", "trace_calls"} and spec.cell["sample"] >= 1
    checks = [harness.load_module("checks", name) for name in spec.cell["checks"]]
    assert all(callable(c.compare) for c in checks)
    assert any(callable(getattr(c, "control", None)) for c in checks)  # the cell's control
    assert all(limit > 0 for limit in spec.cell["checks"].values())
    driver = harness.load_module("traffic", spec.traffic["driver"])
    assert callable(driver.make_pool) and callable(driver.drive) and callable(driver.rhs)
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.load_reader(m["name"]).read)


def test_a_cg_cell_is_held_to_its_stated_tolerance():
    for cell in CELLS:
        spec = harness.load_spec(cell)
        if "cg" in spec.config:
            assert spec.cell["checks"]["cg_relres"] == spec.config["cg"]["tol"]


def test_nothing_of_the_benchmark_is_ignored_by_git():
    files = [str(p.relative_to(ROOT)) for p in (ROOT / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    files.append("BENCHMARK.json")
    out = subprocess.run(["git", "check-ignore", "--no-index", *files], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.stdout.strip() == ""
