"""Production meshes, as in the JAX package's ``launch/mesh.py``.

A mesh here is a grid of positions (``repro_torch.mesh.make_mesh``), and
``devices`` must be given: ``"meta"`` for the dry run's counting, where no
position runs anything, ``"cuda:0"`` to put every position on one card
(the SpTRSV dry-run cells), or ``"cpu"``. ``make_mesh(devices=None)``
needs one card per position and rightly raises on one card, so nothing
here relies on that default.
"""
from __future__ import annotations

from repro_torch.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, devices) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 (2 pods, 512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def make_local_mesh(model: int = 1, data: int = 1, *, devices) -> Mesh:
    """Small (data, model) mesh for tests and examples."""
    return make_mesh((data, model), ("data", "model"), devices=devices)
