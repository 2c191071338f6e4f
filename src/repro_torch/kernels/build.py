"""Build the CUDA sources of this package with ``nvcc`` and load them.

Each ``csrc/*.cu`` file is compiled on first use into a shared library with
a plain C interface, bound with ``ctypes``. The library goes into
``build/repro_torch/`` at the root of the checkout, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source builds anew and an unchanged one is reused. A missing ``nvcc`` or a
failed build raises: nothing falls back. ``build`` takes no lock, so
several sources can be compiled at once (``chip_smoke.py`` does).

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
_LIBS: Dict[str, ctypes.CDLL] = {}  # loaded libraries by source name


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
    """The library of ``source``, named by a hash of the source, the
    headers beside it (``*.cuh``, which it may include) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


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
    """Build (if needed) and load ``csrc/<name>.cu``. Cached per process by
    name, so a launch pays no hashing of the sources (which costs a
    millisecond or more on a slow file system); a source edited while a
    process runs is built by the next process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path, _ = build(CSRC / f"{name}.cu")
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
