"""Build the CUDA sources of this package with ``nvcc`` and load them.

Each ``csrc/*.cu`` file is compiled on first use into a shared library with
a plain C interface, bound with ``ctypes``. The library goes into
``build/repro_torch/`` at the root of the checkout, named by a hash of the
source and the flags, so an edited source builds anew and an unchanged one
is reused. A missing ``nvcc`` or a failed build raises: nothing falls back.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/lib<name>_<hash>.so <src>
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# never --use_fast_math: the kernels' bits rest on IEEE fma/sub/div
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[Path, ctypes.CDLL] = {}
_LOGS: Dict[Path, str] = {}


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the one under ``CUDA_HOME`` (default
    ``/usr/local/cuda``); raises if neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME); the CUDA "
        "kernels of repro_torch are built from source at first use"
    )


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless its library exists; returns the library
    path and the compiler's messages (ptxas register and spill report)."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders agree on one file
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    source = CSRC / f"{name}.cu"
    with _LOCK:
        path = library_path(source)
        lib = _LIBS.get(path)
        if lib is None:
            path, log = build(source)
            lib = _LIBS[path] = ctypes.CDLL(str(path))
            _LOGS[path] = log
        return lib


def build_log(name: str) -> str:
    """The compiler messages of this process's build of ``name`` (empty
    when the library was already on disk)."""
    return _LOGS.get(library_path(CSRC / f"{name}.cu"), "")
