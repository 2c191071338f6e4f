"""Mesh-sharded serving on the port — the distributed backend behind
``SolveService``, a mirror of ``tests/test_serve_distributed.py`` on a CPU
mesh in this process (``make_mesh(..., devices="cpu")``: every position
takes the level kernel's plain version).

  * every served result is bitwise its ``direct_reference`` on the pinned
    plan version at the recorded (width, position), through the mesh
    executor, and bitwise the JAX package's scan ``direct_reference`` of
    the same plan;
  * the worker loop aligns dispatch widths to the mesh's ``data`` axis
    (3 here: pow2 widths 2 and 4 round up to 3 and 6), and ``stats()``
    reports the alignment and the mesh shape;
  * a live ``numeric_update`` works against the sharded binding;
  * ``close()`` joins the workers and releases every plan pin;
  * the CLI serves ``--backend distributed --mesh DATAxMODEL``.
"""
import threading

import numpy as np
import pytest

import repro.sparse as jsparse
from repro.pipeline import TriangularSolver as JSolver
from repro.serve import direct_reference as jdirect_reference
from repro_torch.launch import solver_serve
from repro_torch.mesh import make_mesh
from repro_torch.serve import SolveService, direct_reference
from repro_torch.sparse.generators import erdos_renyi_lower


@pytest.mark.parametrize("shard", ["model", "rows"])
def test_distributed_serve(shard):
    # data axis 3: pow2 dispatch widths (2, 4) must round UP to the axis
    # multiple (3, 6) — the non-trivial alignment case
    mesh = make_mesh((3, 2), devices="cpu")
    mats = [erdos_renyi_lower(120, 0.03, seed=101), erdos_renyi_lower(160, 0.02, seed=102)]
    svc = SolveService(
        max_batch=4, max_wait_us=50_000, n_workers=2, strategy="growlocal", k=2,
        backend="distributed", mesh=mesh, shard=shard, device="cpu",
    )
    try:
        fps = [svc.register(m) for m in mats]
        ns = {fp: m.n_rows for fp, m in zip(fps, mats)}
        snap = svc.stats()
        assert snap["serving"]["batch_align"] == 3, snap["serving"]
        assert snap["serving"]["mesh"] == {"data": 3, "model": 2}
        for fp in fps:
            binding = snap["patterns"][fp]["binding"]
            assert binding["backend"] == "distributed" and binding["shard"] == shard
            assert binding["mesh"] == {"data": 3, "model": 2}

        # concurrent clients over both routes; every wait has a timeout
        out_lists = [[] for _ in range(4)]

        def client(ci):
            rng = np.random.default_rng(500 + ci)
            for j in range(3):
                fp = fps[(ci + j) % 2]
                b = rng.standard_normal(ns[fp]).astype(np.float32)
                t = svc.submit(fp, b)
                out_lists[ci].append((t, b, t.result(120)))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()

        jref = {fp: JSolver.plan(jsparse.erdos_renyi_lower(n, p, seed=seed),
                                 strategy="growlocal", k=2, backend="scan")
                for fp, (n, p, seed) in zip(fps, [(120, 0.03, 101), (160, 0.02, 102)])}
        served = [s for c in out_lists for s in c]
        assert len(served) == 12
        for ticket, b, x in served:
            # widths aligned to the data axis, never the raw pow2
            assert ticket.batch_width % 3 == 0, ticket.batch_width
            ref = direct_reference(ticket.served_by, b, ticket.batch_width,
                                   ticket.batch_position)
            assert np.array_equal(x.view(np.uint32), ref.view(np.uint32)), (
                ticket.fingerprint[:8], ticket.batch_width, ticket.batch_position)
            jx = np.asarray(jdirect_reference(jref[ticket.fingerprint], b, ticket.batch_width,
                                              ticket.batch_position))
            assert np.array_equal(x.view(np.uint32), jx.view(np.uint32))

        # live refactorization against the sharded binding
        v = svc.numeric_update(fps[0], mats[0].data * 2.0)
        assert v == 1
        b = np.ones(ns[fps[0]], np.float32)
        t = svc.submit(fps[0], b)
        x = t.result(120)
        assert t.version == 1
        assert np.array_equal(
            x, direct_reference(t.served_by, b, t.batch_width, t.batch_position))
        snap = svc.stats()
        assert snap["completed"] == 13 and snap["failed"] == 0
    finally:
        report = svc.close(timeout=120)
    assert report["workers_alive"] == []
    assert report["pins_released"] == 2


def test_cli_serves_on_a_mesh(capsys):
    solver_serve.main(["--backend", "distributed", "--mesh", "3x2", "--device", "cpu",
                       "--mix", "width", "--strategy", "wavefront",
                       "--clients", "2", "--requests", "3", "--validate"])
    out = capsys.readouterr().out
    assert "backend=distributed" in out and "bitwise_mismatches=0" in out
    with pytest.raises(SystemExit, match="DATAxMODEL"):
        solver_serve.main(["--backend", "distributed", "--mesh", "2by4", "--device", "cpu"])
