"""The benchmark of ``repro_torch`` on one H100: ``python3 portbench/run.py``.

Everything that measures lives here (traffic, the reduction of traces to
metrics, the peaks, the byte counts, the plain reference and the check that
decides ``correct``); the program under test is ``src/repro_torch``.
"""
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` (``kind`` may be a nested folder such
    as ``reference/generators``, names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind.replace('/', '.')}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
