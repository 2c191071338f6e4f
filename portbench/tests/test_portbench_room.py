"""A configuration comes in as files and ``BENCHMARK.json`` entries alone.

``tests/room/`` holds one that no file of the benchmark names: its own
generator (``reference/generators/``), value rule (``reference/values/``),
float64 and test sizes, its configuration and cell files, and the entries
it adds (``entries.json``). The test copies the benchmark into a
temporary checkout, adds those files and entries, and runs one cell of it
through ``harness.run`` on the CPU from there, with and without a trace, in
a process whose loaders find their files in that checkout."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import HERE, inputs

ROOT = HERE.parent
ROOM = HERE / "tests" / "room"
ENTRIES = json.loads((ROOM / "entries.json").read_text())
ROOM_FILES = sorted(p.relative_to(ROOM) for p in ROOM.rglob("*")
                    if p.is_file() and p.name != "entries.json"
                    and "__pycache__" not in p.parts)
SEED = 2**31 + 777

RUN = r"""
import json, sys, time
sys.path[0:0] = [sys.argv[1], sys.argv[2]]
import torch
from portbench import HERE, harness, inputs
assert HERE.parent.samefile(sys.argv[1]), HERE
cell, seed, cpu, out = sys.argv[3], int(sys.argv[4]), torch.device("cpu"), {}
for trace in (False, True):
    spec = harness.load_spec(cell)
    spec.config.update(spec.config["test_sizes"]["small"])
    spec.cell["trace_calls"] = min(spec.cell["trace_calls"], 3)
    out[str(trace)] = harness.run(spec, seed=seed, seconds=0.3, trace=trace, device=cpu,
                                  t0=time.perf_counter(), log=lambda line: None)
m = inputs.make_matrix(spec.config, seed)
driver = harness.load_module("traffic", spec.traffic["driver"])
out["pool_dtype"] = str(driver.make_pool(spec.traffic, m.n, seed, cpu,
                                         getattr(torch, spec.config["dtype"])).dtype)
out["diagonal"] = sorted(set(m.data[m.indices == m.row_of_entry()].tolist()))
out["n"] = m.n
print(json.dumps(out))
"""


def checkout_with_the_room(dest: Path) -> Path:
    """The benchmark as committed, plus the room's files and entries."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(HERE, dest / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    for rel in ROOM_FILES:
        (dest / "portbench" / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOM / rel, dest / "portbench" / rel)
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"] += ENTRIES["configs"]
    bench["workloads"] += ENTRIES["workloads"]
    cells = [w["name"] for w in ENTRIES["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ENTRIES["reports"]:
            m["workloads"] = m["workloads"] + cells
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return dest


def test_the_rooms_files_are_new_and_named_by_no_file_of_the_benchmark():
    for rel in ROOM_FILES:
        assert not (HERE / rel).exists(), rel
    names = [c["name"] for c in ENTRIES["configs"]] + [w["name"] for w in ENTRIES["workloads"]]
    names += [p.stem for p in ROOM_FILES if p.suffix == ".py"]
    files = [ROOT / "BENCHMARK.json"] + [p for p in HERE.rglob("*") if p.is_file()
                                         and "tests" not in p.relative_to(HERE).parts
                                         and "__pycache__" not in p.parts]
    for f in files:
        text = f.read_text(errors="replace")
        assert not [n for n in names if n in text], f


def test_a_configuration_of_new_files_alone_runs_correct(tmp_path):
    root = checkout_with_the_room(tmp_path)
    cell = ENTRIES["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "-c", RUN, str(root), str(ROOT / "src"), cell,
                          str(SEED)], cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    config = json.loads((ROOM / "configs" / f"{ENTRIES['configs'][0]['name']}.json").read_text())
    assert got["n"] == config["test_sizes"]["small"]["n"]
    assert got["pool_dtype"] == "torch.float64"
    assert got["diagonal"] == [1.0]  # the room's own value rule made the values
    for trace in ("False", "True"):
        res = got[trace]
        assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
        assert list(res["checks"]) == ["x_err", "x_berr"]
        assert all(c["compared"] >= 1 and c["value"] <= c["limit"]
                   for c in res["checks"].values())
    assert set(got["False"]["metrics"]) == {"solve_ms", "solve_p95_ms", "setup_s"}
    assert set(got["True"]["metrics"]) <= set(ENTRIES["reports"])
    assert {"busy_s", "window_s"} <= set(got["True"]["device"])


def test_a_generator_is_found_once(tmp_path, monkeypatch):
    assert inputs.generator("erdos_renyi_lower") is not None
    with pytest.raises(ValueError):
        inputs.generator("no_such_generator")
    with pytest.raises(ValueError):
        inputs.generator("csr_from_coo")  # in matrices.py, but no generator
    (tmp_path / "reference" / "generators").mkdir(parents=True)
    (tmp_path / "reference" / "generators" / "erdos_renyi_lower.py").write_text("")
    monkeypatch.setattr(inputs, "HERE", tmp_path)
    with pytest.raises(ValueError):  # in both places
        inputs.generator("erdos_renyi_lower")


def test_a_value_rule_of_the_wrong_length_is_refused(tmp_path, monkeypatch):
    (tmp_path / "reference" / "values").mkdir(parents=True)
    (tmp_path / "reference" / "values" / "short.py").write_text(
        "import numpy as np\n\ndef draw(rng, m):\n    return np.ones(m.nnz - 1)\n")
    monkeypatch.setattr(inputs, "HERE", tmp_path)
    monkeypatch.setattr("portbench.HERE", tmp_path)
    spec = {"generator": "poisson2d_matrix", "generator_args": {"nx": "nx"}, "nx": 4,
            "values": "short"}
    with pytest.raises(ValueError):
        inputs.make_matrix(spec, 1)
    with pytest.raises(ValueError):
        inputs.make_matrix({**spec, "values": "no_such_rule"}, 1)
    assert np.array_equal(inputs.make_matrix({**spec, "values": "fixed"}, 1).data,
                          inputs.make_matrix({**spec, "values": "fixed"}, 2).data)
