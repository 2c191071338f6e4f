"""Backend registry of the port — the single source of truth for its
execution backends (``kernel``, ``scan`` and ``distributed`` built in). Separate from the
JAX package's registry, which it never touches."""
from __future__ import annotations

import threading
from typing import Dict, Tuple

from repro_torch.backends.base import Backend, BoundSolve

_LOCK = threading.Lock()
_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend_cls):
    """Class decorator (or plain call) registering a ``Backend``. The
    class is instantiated once; its ``name`` attribute is the registry
    key. Duplicate names are rejected — shadowing an existing backend
    silently would change what every consumer binds."""
    instance = backend_cls() if isinstance(backend_cls, type) else backend_cls
    name = getattr(instance, "name", None)
    if not name or not isinstance(name, str):
        raise ValueError("backend must define a non-empty string `name`")
    with _LOCK:
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = instance
    return backend_cls


def unregister_backend(name: str) -> None:
    """Remove a registry entry (tests cleaning up custom backends)."""
    with _LOCK:
        _REGISTRY.pop(name, None)


def get_backend(name: str) -> Backend:
    with _LOCK:
        backend = _REGISTRY.get(name)
    if backend is None:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {available_backends()}"
        )
    return backend


def available_backends() -> Tuple[str, ...]:
    """Registered backend names, in registration order."""
    with _LOCK:
        return tuple(_REGISTRY)


def backends_with(capability: str) -> Tuple[str, ...]:
    """Registered backend names advertising ``capability`` (see
    ``Backend.capabilities``) — e.g. ``backends_with("grouped")`` names
    the backends the serve layer can width-class-batch across patterns."""
    with _LOCK:
        entries = list(_REGISTRY.items())
    return tuple(name for name, be in entries if capability in be.capabilities())


def bind(name: str, exec_plan, **params) -> BoundSolve:
    """Convenience: ``get_backend(name).bind(exec_plan, **params)``; with
    no ``device`` the plan goes to the card (raises without CUDA)."""
    return get_backend(name).bind(exec_plan, **params)
