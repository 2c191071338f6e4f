"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: the analytic counts of every cell exactly equal, the cell list
equal; an SpTRSV cell through the same ``run_sptrsv_cell`` body at a small
size on a CPU mesh; an LM cell counted at full width on ``meta``; the
counts of ``meta`` and CPU runs equal op by op; the report table."""
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_cells as jax_all_cells
from repro.configs import get_config as jax_config
from repro.configs import shape_applicable as jax_applicable
from repro.launch import roofline as jroof
from repro_torch.backends import get_backend
from repro_torch.configs import ARCH_IDS, SHAPES, all_cells, get_config, get_reduced, \
    shape_applicable
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.inputs import make_train_batch
from repro_torch.launch.op_analysis import count_ops
from repro_torch.models import init_params, param_specs, prefill


def _jax_dryrun():
    """The JAX dry-run module without its 512-device ``XLA_FLAGS``: JAX is
    initialized first (so this process keeps its devices) and the variable
    is put back as it was for whatever runs after."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdry


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_jax(arch, multi_pod):
    jdry = _jax_dryrun()
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert dryrun._param_counts(cfg) == jdry._param_counts(jcfg)
    n_params, n_active = dryrun._param_counts(cfg)
    chips = 512 if multi_pod else 256
    for name, shape in SHAPES.items():
        js = JAX_SHAPES[name]
        mb = dryrun._microbatches_for(cfg, shape)
        assert mb == jdry._microbatches_for(jcfg, js)
        assert roofline.model_flops(cfg, shape, n_params, n_active) == \
            jroof.model_flops(jcfg, js, n_params, n_active)
        assert roofline.essential_bytes(cfg, shape, n_params, chips, microbatches=mb, tp=16) \
            == jroof.essential_bytes(jcfg, js, n_params, chips, microbatches=mb, tp=16)
        assert shape_applicable(cfg, shape) == jax_applicable(jcfg, js)


def test_cells_equal_jax():
    assert all_cells() == jax_all_cells()
    assert len(all_cells()) == len(ARCH_IDS) * len(SHAPES)


def test_roofline_terms():
    t = roofline.RooflineTerms(flops=989e12, bytes_accessed=3.35e12, collective_bytes=None,
                               chips=2)
    d = t.as_dict()
    assert d["t_compute_s"] == pytest.approx(0.5) and d["t_memory_s"] == pytest.approx(0.5)
    assert d["t_collective_s"] is None and d["dominant"] in ("compute", "memory")
    t = roofline.RooflineTerms(flops=1.0, bytes_accessed=1.0, collective_bytes=900e9, chips=1)
    assert t.dominant == "collective" and t.t_collective == pytest.approx(2.0)


def test_sptrsv_cell_on_a_cpu_mesh(tmp_path, monkeypatch):
    """The cell's body at n = 2,000 on a (2, 4) CPU mesh: every field, comm
    equal to describe()'s exchange, the answer bitwise the CPU kernel
    backend's (the body checks it and raises otherwise)."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    for name in dryrun.SPTRSV_SHAPES:
        rec = dryrun.run_sptrsv_cell(name, device="cpu", mesh_shape=(2, 4), n=2000, p=2e-3,
                                     batch=4)
        assert rec["status"] == "OK" and rec["bitwise_vs_kernel_backend"] and rec["x_finite"]
        for key in ("mesh", "chips", "roofline", "supersteps", "shard", "comm", "plan",
                    "binding", "nnz", "model_flops", "launches_per_solve", "ms", "bind_s"):
            assert key in rec, key
        ex = rec["binding"]["exchange"]
        assert rec["comm"]["exchange_rounds"] == ex["rounds"]
        for key in ("mode", "comm_values_per_solve", "comm_bytes_per_solve"):
            assert rec["comm"][key] == ex[key]
        assert rec["launches_per_solve"] == rec["binding"]["launches_per_solve"]["mrhs"]
        assert rec["launches_counted"] is None  # the CPU runs the plain version
        assert rec["shard"] == ("rows" if name.endswith("_rows") else "model")
        assert rec["mesh"] == {"data": 2, "model": 4} and rec["chips"] == 8
        r = rec["roofline"]
        assert r["t_collective_s"] == pytest.approx(
            ex["comm_bytes_per_solve"] * 4 / roofline.NVLINK_BW)
        # the bound is the card's own: the exchange read and written in HBM
        assert r["card_bytes"] == r["bytes_accessed"] + 2 * ex["comm_bytes_per_solve"] * 4
        card = {"operations": r["flops"] / roofline.FP32_FLOPS,
                "bytes": r["card_bytes"] / roofline.HBM_BW}
        assert r["bound_by"] == max(card, key=card.get)
        assert r["bound_ms"] == pytest.approx(max(card.values()) * 1e3)
        assert rec["bound_share"] == pytest.approx(r["bound_ms"] / rec["ms"])
        saved = json.loads((tmp_path / f"sptrsv.{name}.json").read_text())
        assert saved["supersteps"] == rec["supersteps"]
    rec = dryrun.run_sptrsv_cell("solve_er100k", device="cpu", mesh_shape=(2, 4), n=2000,
                                 p=2e-3, batch=4, multi_pod=True, save=False)
    assert rec["mesh"] == {"pod": 2, "data": 2, "model": 4} and rec["chips"] == 16
    assert "multi_pod_note" in rec


def test_sptrsv_cell_answer_is_the_kernel_backends(monkeypatch):
    """The check inside the body fires: a mesh solve that differs from the
    kernel backend's answer raises."""
    real = get_backend("kernel").bind

    def skewed(plan, **kw):
        bound = real(plan, **kw)
        solve = bound.solve
        bound.solve = lambda b: solve(b) * (1 + 2 ** -20)
        return bound

    monkeypatch.setattr(get_backend("kernel"), "bind", skewed)
    with pytest.raises(RuntimeError, match="kernel backend"):
        dryrun.run_sptrsv_cell("solve_er100k", device="cpu", mesh_shape=(2, 4), n=500,
                               p=5e-3, batch=2, save=False)


def test_sptrsv_cell_needs_the_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_sptrsv_cell("solve_er100k", save=False, n=200)


def test_lm_cell_full_width_on_meta(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    t0 = time.perf_counter()
    rec = dryrun.run_cell("granite_3_2b", "decode_32k")
    assert time.perf_counter() - t0 < 20
    assert rec["status"] == "OK" and rec["chips"] == 256
    r = rec["roofline"]
    assert r["collective_bytes"] is None and r["t_collective_s"] is None
    assert r["dominant"] in ("compute", "memory")
    assert r["flops"] * 256 == pytest.approx(r["flops_total"])
    assert r["t_memory_lb_s"] == pytest.approx(r["essential_bytes"] / roofline.HBM_BW)
    assert rec["n_params"] == dryrun._param_counts(get_config("granite_3_2b"))[0]
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert 0 < rec["useful_flops_ratio"] < 1
    rules = rec["activation_rules"]  # decode never shards the sequence
    assert rules["seq_sharded"] is False and rules["installed"]["residual"] == ("data", None, None)
    skip = dryrun.run_cell("granite_3_2b", "long_500k")
    assert skip["status"] == "SKIP" and "sub-quadratic" in skip["reason"]
    lines = report.table(report.load(False, tmp_path))
    assert len(lines) == 4 and "| granite_3_2b.decode_32k | OK |" in lines[2]
    assert "| - |" in lines[2] and "SKIP" in lines[3]  # t_coll is "-"


def test_lm_cell_error_records_where(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)

    def broken(*a, **k):
        raise AssertionError("pad kv length to a multiple of kv_chunk")

    monkeypatch.setattr(dryrun, "cell_program", broken)
    rec = dryrun.run_cell("granite_3_2b", "prefill_32k")
    assert rec["status"] == "ERROR" and "kv_chunk" in rec["error"]
    assert rec["where"].startswith("tests/test_torch_dryrun.py:")


@pytest.mark.parametrize("arch", ["granite_3_2b", "deepseek_moe_16b", "rwkv6_7b",
                                  "recurrentgemma_2b", "seamless_m4t_large_v2"])
def test_meta_count_equals_cpu_count_op_by_op(arch):
    """A reduced prefill counted on ``meta`` (the memoized path) and on real
    CPU tensors: the same ops, flops and bytes, in the same order."""
    cfg = get_reduced(arch)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    batch = make_train_batch(cfg, batch=2, seq_len=64, seed=0, device="cpu")
    meta = {k: v.to("meta") for k, v in batch.items()}
    meta_params = {k: v for k, v in _to_meta(params).items()}
    _, c_cpu = count_ops(lambda: prefill(cfg, params, batch, max_len=72), log=True)
    _, c_meta = count_ops(lambda: prefill(cfg, meta_params, meta, max_len=72), log=True)
    assert c_meta.costed() == c_cpu.costed() and c_meta.dots == c_cpu.dots
    assert c_meta.peak_live_bytes == c_cpu.peak_live_bytes


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return tree.to("meta")


def test_cli_writes_records(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    dryrun.main(["--arch", "granite_3_2b", "--shape", "decode_32k", "--multi-pod"])
    rec = json.loads((tmp_path / "granite_3_2b.decode_32k.mp.json").read_text())
    assert rec["mesh"] == {"pod": 2, "data": 16, "model": 16} and rec["chips"] == 512
    assert "[OK] granite_3_2b.decode_32k.mp" in capsys.readouterr().out
    assert np.isclose(rec["roofline"]["flops"] * 512, rec["roofline"]["flops_total"])
