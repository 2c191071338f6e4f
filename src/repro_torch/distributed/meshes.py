"""Logical-axis -> physical-mesh sharding resolution, as in the JAX
package's ``distributed/meshes.py``.

Model code declares logical axes ('tp', 'fsdp', 'batch', None); this module
maps them onto whatever mesh is in play:

  single pod  (data=16, model=16):  tp->'model', fsdp->'data', batch->('data',)
  multi-pod   (pod=2, data=16, model=16): batch->('pod','data'); params stay
              FSDP-sharded *within* a pod and replicated across pods.

Divisibility guard: a logical axis is dropped (replicated) for a dimension
the mesh cannot divide evenly — e.g. 8 kv-heads over 16 'model' positions.

The port has no ``PartitionSpec`` and no DTensor, and places nothing. A
spec is a plain tuple with one entry per leading dimension: an axis name,
a tuple of names, or ``None``. ``resolve_spec`` trims trailing ``None``s,
as the JAX package's does, and a one-name tuple reads as the name, as
``PartitionSpec`` normalizes it, so ``tuple(jax_spec)`` compares equal.
The dry run reads specs as data: the bytes each chip holds
(``tree_shard_bytes``).
Only ``mesh.axis_names`` and ``mesh.shape`` are read, so any object with
those two (``repro_torch.mesh.Mesh``) will do.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

Pytree = Any
Spec = Tuple[Any, ...]


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _physical(mesh, logical: Optional[str]):
    if logical is None:
        return None
    if logical == "tp":
        return "model" if "model" in mesh.axis_names else None
    if logical == "fsdp":
        return "data" if "data" in mesh.axis_names else None
    if logical == "batch":
        ax = batch_axes(mesh)
        return ax if ax else None
    raise ValueError(f"unknown logical axis {logical!r}")


def _axis_size(mesh, phys) -> int:
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        out = 1
        for a in phys:
            out *= mesh.shape[a]
        return out
    return mesh.shape[phys]


def entry(phys):
    """A spec entry as ``PartitionSpec`` holds it: a one-name tuple is
    the name."""
    return phys[0] if isinstance(phys, tuple) and len(phys) == 1 else phys


def _trim(entries: list) -> Spec:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def resolve_spec(mesh, logical: Tuple[Optional[str], ...], shape: Tuple[int, ...]) -> Spec:
    """The spec of one array, dropping non-divisible placements."""
    entries = []
    for dim, log in zip(shape, logical):
        phys = _physical(mesh, log)
        if phys is not None and dim % _axis_size(mesh, phys) == 0:
            entries.append(entry(phys))
        else:
            entries.append(None)
    return _trim(entries)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, str) or e is None for e in x)


def _zip_map(fn, logical_tree: Pytree, shape_tree: Pytree) -> Pytree:
    """``fn(logical, leaf)`` over two trees of the same dict structure; a
    logical tuple is a leaf."""
    if isinstance(logical_tree, dict):
        return {k: _zip_map(fn, logical_tree[k], shape_tree[k]) for k in sorted(logical_tree)}
    if not _is_spec(logical_tree):
        raise TypeError(f"not a logical spec: {logical_tree!r}")
    return fn(logical_tree, shape_tree)


def shardings_for(mesh, logical_tree: Pytree, shape_tree: Pytree) -> Pytree:
    """Spec tree for (logical specs, matching tensors)."""
    return _zip_map(lambda log, arr: resolve_spec(mesh, log, tuple(arr.shape)),
                    logical_tree, shape_tree)


def logical_to_shardings(mesh, logical_tree: Pytree, abstract: Pytree) -> Pytree:
    return shardings_for(mesh, logical_tree, abstract)


def activation_spec(mesh, *, seq_sharded: bool = False) -> Spec:
    """[B, S, D] residual-stream spec; seq_sharded=True = Megatron-SP style
    (sequence over 'model' between blocks)."""
    b = entry(batch_axes(mesh)) or None
    if seq_sharded and "model" in mesh.axis_names:
        return (b, "model", None)
    return (b, None, None)


def shard_count(mesh, spec: Spec) -> int:
    """How many ways ``spec`` splits an array: the product of the sizes of
    the axes its entries name."""
    return math.prod(_axis_size(mesh, e) for e in spec)


def tree_shard_bytes(mesh, specs: Pytree, tensors: Pytree) -> float:
    """The bytes one chip holds of a tree of tensors under a matching tree
    of specs: each leaf's bytes over its ``shard_count`` (the divisibility
    guard makes every split even)."""
    if isinstance(tensors, dict):
        return sum(tree_shard_bytes(mesh, specs[k], tensors[k]) for k in sorted(tensors))
    return tensors.numel() * tensors.element_size() / shard_count(mesh, specs)
