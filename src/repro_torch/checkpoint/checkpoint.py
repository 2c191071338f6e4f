"""Checkpoints in the JAX package's on-disk format, so that each package
restores the other's (``checkpoint/checkpoint.py`` there):

  * every leaf its own ``leaf_{i:05d}.npy``, in JAX's flatten order (dict
    keys sorted; a ``TrainState``'s params, then its opt_state);
  * a ``manifest.json`` with each leaf's path, file, dtype, shape and the
    CRC32 of its bytes, written last in a ``.tmp`` directory that is then
    renamed: a crashed save never leaves a loadable checkpoint;
  * the paths are JAX's key strings: ``['layers']`` for a dict key, ``[0]``
    for a list or tuple index, and ``[<flat index 0>]`` / ``[<flat index
    1>]`` for a ``TrainState``'s params / opt_state (JAX registers it
    without keys), joined by ``/``.

``restore_checkpoint`` places the leaves on one device; the JAX package's
``shardings=`` (a placement on a new mesh) has no single-card meaning and
is left out. ``AsyncCheckpointer`` copies the tree to the host at
``save`` and writes it in a thread, overlapping the write with training.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train.train_loop import TrainState

Pytree = Any

_MANIFEST = "manifest.json"


def _flatten_with_paths(tree: Pytree, prefix: Tuple[str, ...] = ()):
    """[(JAX path string, leaf)] in JAX's flatten order."""
    if isinstance(tree, TrainState):
        return (_flatten_with_paths(tree.params, prefix + ("[<flat index 0>]",))
                + _flatten_with_paths(tree.opt_state, prefix + ("[<flat index 1>]",)))
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_paths(tree[k], prefix + (f"[{k!r}]",))]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in _flatten_with_paths(x, prefix + (f"[{i}]",))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _unflatten(template: Pytree, leaves) -> Pytree:
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, TrainState):
        return TrainState(params=_unflatten(template.params, leaves),
                          opt_state=_unflatten(template.opt_state, leaves))
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, leaves) for x in template)
    if template is None:
        return None
    return next(leaves)


def _to_host(leaf, copy: bool) -> np.ndarray:
    """The leaf as a numpy array; ``copy`` makes sure it shares no memory
    with the leaf (``.numpy()`` of a CPU tensor does)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy).numpy()
    return np.array(leaf, copy=copy) if copy else np.asarray(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def save_checkpoint(path: str | Path, tree: Pytree, *, step: int = 0,
                    extra: Optional[dict] = None) -> None:
    """Atomic checkpoint save (tmp dir + rename; manifest written last)."""
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    entries = []
    for i, (p, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = _to_host(leaf, copy=False)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        entries.append({
            "path": p,
            "file": fname,
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        })
    manifest = {
        "step": step,
        "paths": [e["path"] for e in entries],
        "entries": entries,
        "extra": extra or {},
    }
    (tmp / _MANIFEST).write_text(json.dumps(manifest))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)


def restore_checkpoint(
    path: str | Path,
    *,
    template: Optional[Pytree] = None,
    device=None,
) -> Tuple[Pytree, dict]:
    """Load a checkpoint onto ``device`` (the card unless ``device="cpu"``).
    With ``template`` the tree structure comes from it, and each leaf is
    found by its path and checked against the template's shape; without
    one, a nested dict is rebuilt from the paths by the JAX package's rule
    (whose keys keep the ``/`` that joined them). Returns (tree, meta)."""
    dev = resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / _MANIFEST).read_text())
    arrays = []
    for e in manifest["entries"]:
        arr = np.load(path / e["file"])
        crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
        if crc != e["crc32"]:
            raise IOError(f"checkpoint corruption in {e['path']}: crc {crc} != {e['crc32']}")
        arrays.append(arr)

    def tensor(a):
        return torch.from_numpy(a).to(dev)

    if template is not None:
        by_path = dict(zip(manifest["paths"], arrays))
        ordered = []
        for p, t in _flatten_with_paths(template):
            if p not in by_path:
                raise KeyError(f"checkpoint missing leaf {p}")
            a = by_path[p]
            if tuple(a.shape) != _shape(t):
                raise ValueError(f"shape mismatch for {p}: ckpt {a.shape} vs template "
                                 f"{_shape(t)}")
            ordered.append(tensor(a))
        tree = _unflatten(template, iter(ordered))
    else:
        tree = {}
        for p, a in zip(manifest["paths"], arrays):
            node = tree
            parts = [s for s in p.replace("[", ".").replace("]", "").replace("'", "")
                     .split(".") if s]
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = tensor(a)
    meta = {"step": manifest["step"], **manifest.get("extra", {})}
    return tree, meta


@dataclasses.dataclass
class AsyncCheckpointer:
    """Overlap checkpoint IO with compute: snapshot to host RAM
    synchronously, write in a daemon thread; keep the newest ``keep``."""

    directory: str
    keep: int = 3

    def __post_init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, tree: Pytree, *, step: int) -> None:
        self.wait()  # one in-flight save at a time
        # a copy: the next train step writes the parameters in place
        leaves = iter([_to_host(leaf, copy=True) for _, leaf in _flatten_with_paths(tree)])
        host_tree = _unflatten(tree, leaves)

        def _write():
            try:
                save_checkpoint(Path(self.directory) / f"step_{step:08d}", host_tree,
                                step=step)
                self._gc()
            except Exception as e:  # noqa: BLE001  (raised by wait())
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _steps(self) -> list:
        d = Path(self.directory)
        if not d.exists():
            return []
        return sorted(p for p in d.iterdir()
                      if p.name.startswith("step_") and (p / _MANIFEST).exists())

    def latest(self) -> Optional[Path]:
        cands = self._steps()
        return cands[-1] if cands else None

    def _gc(self):
        for old in self._steps()[: -self.keep]:
            shutil.rmtree(old)
