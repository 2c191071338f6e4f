"""The port's verification CLIs and the inspector's oracle, on the CPU:

  * ``python -m repro_torch.launch.check --smoke --mutate --json`` exits 0,
    every cell clean with codes equal to ``python -m repro.launch.check
    --smoke``'s cell for cell, the mutation harness over five families with
    nothing missed, and the same exit rule (non-zero on a finding);
  * ``python -m repro_torch.launch.check_overhead --smoke`` runs and writes
    its rows (no gate on timing here: CPU seconds of a shared host);
  * ``_reference_compile_plan`` (the per-row compiler, kept as the oracle)
    is bitwise ``compile_plan`` over the corpus x the seven strategies x
    lower / upper, as ``tests/test_plan_vectorized.py`` holds the JAX pair.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.autotune import corpus_entry, corpus_names
from repro_torch.core.plan import _reference_compile_plan, compile_plan, plans_bitwise_equal
from repro_torch.launch import check
from repro_torch.pipeline import available_strategies, schedule
from repro_torch.sparse import dag_from_lower_csr, transpose_csr
from repro_torch.sparse.csr import permute_symmetric

REPO = Path(__file__).resolve().parents[1]
_KEYS = ("matrix", "strategy", "orientation", "mode", "n_shards")


def _run(module, *args, tmp):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], env=env, cwd=tmp,
                          capture_output=True, text=True, timeout=240)


def test_check_cli_smoke_equals_jax(tmp_path):
    out = _run("repro_torch.launch.check", "--smoke", "--mutate", "--json", "port.json",
               tmp=tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    jout = _run("repro.launch.check", "--smoke", "--no-lint", "--json", "jax.json",
                tmp=tmp_path)
    assert jout.returncode == 0, jout.stderr[-2000:]
    port = json.loads((tmp_path / "port.json").read_text())
    jax = json.loads((tmp_path / "jax.json").read_text())
    assert len(port["cells"]) == len(jax["cells"]) == 3 * 2 * 2 * 2 * 2
    for p, j in zip(port["cells"], jax["cells"]):
        assert [p[k] for k in _KEYS] == [j[k] for k in _KEYS]
        assert (p["ok"], p["codes"], p["error"]) == (j["ok"], j["codes"], j["error"]), p
        assert p["ok"] and not p["codes"]
    assert port["lint"] == []
    mut = port["mutation"]
    assert mut["missed"] == [] and mut["families"] == 5 and mut["operators"] == 22
    assert {d["family"] for d in mut["per_operator"].values()} == {
        "schedule", "plan", "elastic", "rowshard", "levels"}


def test_check_exit_rule(monkeypatch, capsys):
    """A cell with a finding fails the sweep (and a crash is a finding)."""
    def corrupt(*a, **k):
        raise RuntimeError("inspector crashed")

    monkeypatch.setattr(check, "build_artifacts", corrupt)
    monkeypatch.setattr(check, "SMOKE_MATRICES", ("chain",))
    monkeypatch.setattr(check, "SMOKE_STRATEGIES", ("serial",))
    assert check.main(["--smoke", "--no-lint"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_check_overhead_smoke_writes_rows(tmp_path):
    out = _run("repro_torch.launch.check_overhead", "--smoke", "--json", "ov.json",
               tmp=tmp_path)
    data = json.loads((tmp_path / "ov.json").read_text())
    # the gate is a timing bound: report it, never assert it here
    assert out.returncode == (0 if data["accept_fast_ratio"] else 1), out.stderr
    assert [r["name"] for r in data["rows"]] == ["er_sparse.10k", "band_narrow.10k"]
    for r in data["rows"]:
        assert r["n"] == 10_000 and r["levels"] >= 1
        for key in ("compile_seconds", "verify_fast_seconds", "verify_full_seconds",
                    "level_order_seconds", "level_check_fast_seconds",
                    "level_check_full_seconds"):
            assert r[key] > 0, key
        assert r["fast_ratio"] == pytest.approx(r["verify_fast_seconds"] / r["compile_seconds"])
    assert data["gate_size"] == 10_000 and data["budget"] == 0.30


def _mirror(a):
    outer = np.arange(a.n_rows, dtype=np.int64)[::-1].copy()
    return permute_symmetric(a, outer)


@pytest.mark.parametrize("name", corpus_names())
def test_reference_compile_plan_bitwise(name):
    L = corpus_entry(name).matrix()
    for m in (L, _mirror(transpose_csr(L))):
        dag = dag_from_lower_csr(m)
        for strategy in available_strategies():
            if strategy == "auto":
                continue
            s = schedule(dag, 8, strategy=strategy)
            for kw in ({}, {"width": 2, "dtype": np.float64}):
                vec = compile_plan(m, s, **kw)
                ref = _reference_compile_plan(m, s, **kw)
                assert plans_bitwise_equal(vec, ref), (name, strategy, kw)
