"""A mesh of card positions: the port's counterpart of ``jax.make_mesh`` /
``jax.sharding.Mesh`` as the JAX package uses them.

The JAX package drives its mesh from one process: ``jax.make_mesh`` lays a
grid of ``(data, model)`` positions over the host's devices (on the CPU
forced to several by ``XLA_FLAGS``), and ``shard_map`` runs one program per
position. The port keeps that model. A ``Mesh`` is a grid of positions,
each on a ``torch.device``, driven by one process:

  * on a host with several cards the positions sit on different cards;
  * on one card they may all share it (``devices="cuda:0"``), the
    counterpart of XLA's forced host device count: every position's work
    and every exchange still run on the card.

There is no ``torch.distributed`` and no process group. An exchange is a
tensor copy between positions (``index_select`` / ``index_copy_``, with a
``.to`` where the devices differ). Each position on a card launches on a
CUDA stream of its own, and an exchange waits on its sources' events, so
positions that share a card run concurrently, as a mesh's devices do. The
stream helpers (``fork``, ``join``, ``on``, ``mark``, ``wait``, ``hold``,
``move``) are no-ops or plain copies for positions on the CPU, whose work
runs in program order.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

Position = Tuple[int, ...]


class Mesh:
    """A grid of positions over ``torch.device``s.

    ``shape`` is an ordered mapping from axis name to size, so
    ``mesh.shape["data"]`` and ``dict(mesh.shape)`` read as in JAX;
    ``devices`` is an object array of ``torch.device`` shaped by the axes;
    ``axis_names`` names them. Build one with ``make_mesh``.

    The executors name a position ``(data, model)`` whatever the order of
    the axes: ``device``, ``stream`` and the helpers below take it so, and
    ``device`` finds it in ``devices`` by axis name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names) or devices.size < 1:
            raise ValueError(
                f"devices {devices.shape} do not fit the axes {tuple(axis_names)}"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)
        # where each axis of `devices` takes its index from in a (data,
        # model) position; None for a mesh without exactly those two axes
        self._take = (tuple(("data", "model").index(a) for a in self.axis_names)
                      if sorted(self.axis_names) == ["data", "model"] else None)
        self._streams = {}  # position -> torch.cuda.Stream, made at first use
        self._lock = threading.Lock()  # solves on several threads share the mesh

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def device(self, pos: Position) -> torch.device:
        """The device of ``pos``, a ``(data, model)`` position."""
        if self._take is None:
            raise ValueError(f"positions are (data, model); the mesh's axes are {self.axis_names}")
        return self.devices[tuple(pos[i] for i in self._take)]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.ravel()})
        return f"Mesh({dict(self.shape)}, devices={devs})"

    # ------------------------------------------------------------ streams
    def stream(self, pos: Position):
        """The CUDA stream of ``pos`` (None for a position on the CPU)."""
        dev = self.device(pos)
        if dev.type != "cuda":
            return None
        with self._lock:
            s = self._streams.get(pos)
            if s is None:
                s = self._streams[pos] = torch.cuda.Stream(device=dev)
            return s

    def on(self, pos: Position):
        """Context: work issued inside runs on ``pos``'s stream."""
        s = self.stream(pos)
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)

    def mark(self, pos: Position):
        """An event recorded on ``pos``'s stream now (None on the CPU)."""
        s = self.stream(pos)
        if s is None:
            return None
        ev = torch.cuda.Event()
        ev.record(s)
        return ev

    def wait(self, pos: Position, events: Iterable) -> None:
        """``pos``'s stream waits on ``events`` (from ``mark``)."""
        s = self.stream(pos)
        if s is None:
            return
        for ev in events:
            if ev is not None:
                s.wait_event(ev)

    def hold(self, t: torch.Tensor, pos: Position) -> None:
        """Tell the caching allocator that ``pos``'s stream uses ``t``, a
        tensor made on another stream of the same card."""
        s = self.stream(pos)
        if s is not None and t.device == s.device:
            t.record_stream(s)

    def move(self, t: torch.Tensor, src: Position, dst: Position) -> torch.Tensor:
        """``t`` (made on ``src``'s stream, which ``dst`` has waited on)
        as a tensor ``dst`` may read: the same tensor where the devices are
        the same, else a copy issued on both positions' streams."""
        dev = self.device(dst)
        if t.device == dev:
            self.hold(t, dst)
            return t
        with self.on(src), self.on(dst):
            return t.to(dev)

    def fork(self, positions: Iterable[Position]) -> None:
        """Every position's stream waits on the current stream of its card:
        the inputs a solve made there are ready before any position reads
        them."""
        for pos in positions:
            s = self.stream(pos)
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(s.device))

    def join(self, positions: Iterable[Position]) -> None:
        """The current stream of every card waits on every position's
        stream: what the positions wrote is ready for the caller."""
        streams = [s for s in (self.stream(p) for p in positions) if s is not None]
        for dev in {s.device for s in streams}:
            cur = torch.cuda.current_stream(dev)
            for s in streams:
                cur.wait_stream(s)


def make_mesh(shape, axis_names=("data", "model"), devices=None) -> Mesh:
    """A mesh of ``shape`` positions over ``axis_names``.

    ``devices=None`` puts one position on each visible CUDA device, in
    order, and raises when there are fewer devices than positions (as
    ``jax.make_mesh`` does) or no CUDA at all. A single device
    (``"cuda:0"``, ``"cpu"``, a ``torch.device``) puts every position on
    it; a sequence gives one device per position, in row-major order.
    Nothing falls back to the CPU."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} must give a size >= 1 for each of {axis_names}")
    size = int(np.prod(shape))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < size:
            raise RuntimeError(
                f"a {'x'.join(map(str, shape))} mesh needs {size} CUDA devices and "
                f"{have} are visible; pass devices='cuda:0' to put every position "
                "on one card, or devices='cpu'"
            )
        devs = [torch.device("cuda", i) for i in range(size)]
    elif isinstance(devices, (str, torch.device)):
        devs = [torch.device(devices)] * size
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != size:
            raise ValueError(f"{len(devs)} devices for {size} mesh positions")
    for d in set(devs):
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d}: CUDA is not available")
    # "cuda" names the current card: give it its index, so positions,
    # tensors and streams compare equal
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    grid = np.empty(size, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), axis_names)


def mesh_fingerprint(mesh) -> tuple | None:
    """Structural mesh identity for cache keys: the axes with their sizes
    and the devices as strings. Not ``id()``: a rebuilt identical mesh hits
    the same entry, whatever the order of its axes."""
    if mesh is None:
        return None
    names, grid = mesh.axis_names, mesh.devices
    if sorted(names) == ["data", "model"]:  # the devices by (data, model) position
        grid = grid.transpose([names.index(a) for a in ("data", "model")])
    return (
        tuple(sorted(mesh.shape.items())),
        tuple(str(d) for d in grid.ravel()),
    )
