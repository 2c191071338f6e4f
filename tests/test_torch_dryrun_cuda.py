"""The dry run's SpTRSV cells on the card: ``run_sptrsv_cell`` at n =
2,000 on a (2, 4) mesh of cuda:0 positions, against the same cell on a CPU
mesh, bit for bit; the range launches a solve counted on the card equal
``describe()``'s.

Marked ``cuda``: every test here skips on a host without a CUDA device (it
adds no pass there). On the card run it with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dryrun_cuda.py

``chip_smoke.py``'s ``dryrun`` phase runs the cells at full size.
"""
import pytest
import torch

from repro_torch.launch import dryrun

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cell(name, device):
    out = {}

    def keep(solve):
        out["x"] = solve().cpu()
        return {}

    rec = dryrun.run_sptrsv_cell(name, device=device, mesh_shape=(2, 4), n=2000, p=2e-3,
                                 batch=4, save=False, probe=keep)
    return rec, out["x"]


@pytest.mark.parametrize("name", list(dryrun.SPTRSV_SHAPES))
def test_sptrsv_cell_on_the_card_is_the_cpu_cell(cuda, name):
    rec, x = _cell(name, cuda)
    rec_cpu, x_cpu = _cell(name, "cpu")
    assert torch.equal(x.view(torch.int32), x_cpu.view(torch.int32))
    assert rec["bitwise_vs_kernel_backend"] and rec["x_finite"]
    assert rec["launches_counted"] == rec["launches_per_solve"] > 0
    assert rec["comm"] == rec_cpu["comm"] and rec["supersteps"] == rec_cpu["supersteps"]
    assert rec["ms_clock"] == "CUDA events" and rec["nvidia_smi"]
