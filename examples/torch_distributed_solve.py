"""Distributed SpTRSV on the PyTorch port: the BSP schedule executed
across a mesh of card positions, the counterpart of
``examples/distributed_solve.py``. One ``TriangularSolver.plan`` call with
``backend="distributed"`` takes the matrix to a plan bound on a (2, 4)
mesh: ``shard="model"`` puts one schedule core on each of the 4 model
positions and ends every superstep in an all-gather; ``shard="rows"``
partitions the rows into 4 shards and exchanges only the halo values.
Each position walks its share of each round with one launch of the level
kernel; the right-hand sides split over the 2 data positions.

    PYTHONPATH=src python examples/torch_distributed_solve.py               # the card
    PYTHONPATH=src python examples/torch_distributed_solve.py --device cpu  # plain versions

Without ``--device`` every position sits on the first CUDA device (the
counterpart of XLA's forced host device count) and it raises where CUDA
is not available; ``--device cpu`` puts them on the CPU, where the
kernels' plain versions run. Checked against scipy.
"""
import argparse

import numpy as np

from repro_torch import TriangularSolver
from repro_torch.device import resolve_device
from repro_torch.mesh import make_mesh
from repro_torch.solver import solve_lower_scipy
from repro_torch.sparse import erdos_renyi_lower

K_DEVICES = 4  # 'model' axis: schedule cores = positions
BATCH = 2  # right-hand sides over 'data'


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args()
    device = resolve_device(args.device)
    mesh = make_mesh((2, K_DEVICES), devices=device)

    L = erdos_renyi_lower(2000, 1e-3, seed=7)
    b = np.random.default_rng(0).standard_normal((L.n_rows, BATCH))
    for shard in ("model", "rows"):
        solver = TriangularSolver.plan(
            L, strategy="growlocal", backend="distributed", k=K_DEVICES, mesh=mesh,
            shard=shard)
        ex = solver.bound.describe()["exchange"]
        print(f"shard={shard}: n={L.n_rows} nnz={L.nnz} supersteps={solver.n_supersteps} "
              f"exchange rounds={ex['rounds']} ({ex['mode']}, "
              f"{ex['comm_values_per_solve']} values a solve) mesh={dict(mesh.shape)} "
              f"device={device}")
        x = solver.solve(b).double().cpu().numpy()
        for i in range(BATCH):
            ref = solve_lower_scipy(L, b[:, i])
            err = np.abs(x[:, i] - ref).max() / np.abs(ref).max()
            print(f"  rhs {i}: rel err {err:.2e}")
            assert err < 1e-3
    print("OK")


if __name__ == "__main__":
    main()
