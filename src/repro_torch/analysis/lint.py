"""Determinism lint — AST rules over the port's solver and kernel source.

The JAX package's ``analysis/lint.py``, retargeted at torch. Bitwise
determinism of the solve depends on every lane reduction being a
*fixed-order* left-to-right fold (``acc = torch.addcmul(acc, v[:, w],
x[cols[:, w]])`` for ``w`` in order, ``rn::fma`` in the kernels). Library
reductions (``torch.sum`` / ``dot`` / ``matmul`` / ``einsum`` / ...) may
reassociate the adds, so one row can round differently at different
widths or on different devices; and the scatter accumulations
(``index_add_``, ``scatter_add_``, ``scatter_reduce_``, ``index_reduce_``,
``index_put_(..., accumulate=True)``) add in an unspecified order on CUDA,
where they use atomics, so one input can give different bits from run to
run.

Rule (scoped to ``src/repro_torch/solver/`` and
``src/repro_torch/kernels/``):

  * ``LINT_NONDET_REDUCTION`` — a call to a reassociating reduction
    (``sum``, ``dot``, ``matmul``, ``einsum``, ``vdot``, ``inner``,
    ``tensordot``, ``prod``, ``mm``, ``bmm``, ``mv``) on ``torch`` / ``np``
    / ``numpy`` or as a tensor method, or to a scatter accumulation
    (``index_add(_)``, ``scatter_add(_)``, ``scatter_reduce(_)``,
    ``index_reduce(_)``, and ``index_put(_)`` with ``accumulate=True``)
    in either form.

The JAX lint's second rule, ``LINT_JIT_MUTABLE_CAPTURE`` (a jitted
function closing over mutable module state), has no counterpart here: the
port traces no function, and its ctypes kernels take every argument
explicitly at each launch.

Blessing: a reduction that is *proven* safe (validated against a
fixed-order oracle, exact in any order like an integer count, or
deliberately outside the bitwise contract) carries a pragma comment on
its line or in the comment block directly above::

    total = int(lens.sum())  # repro: blessed-reduction — <why>

The lint never blesses implicitly — every escape is a visible, grep-able
pragma.

Run standalone: ``python -m repro_torch.analysis.lint [paths...]``.
"""
from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List, Sequence

from repro_torch.analysis.findings import Finding, finding

CHECK = "lint"

REDUCTION_NAMES = frozenset({
    "sum", "dot", "matmul", "einsum", "vdot", "inner", "tensordot",
    "prod", "mm", "bmm", "mv",
})
# the reductions that are also tensor methods; restricted to these names
# so that unrelated objects' methods are not flagged
METHOD_REDUCTIONS = frozenset({
    "sum", "dot", "matmul", "vdot", "inner", "prod", "mm", "bmm", "mv",
})
SCATTER_NAMES = frozenset({
    "index_add", "index_add_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_reduce", "index_reduce_",
})
ACCUMULATE_PUT = frozenset({"index_put", "index_put_"})
NUMERIC_MODULES = frozenset({"torch", "np", "numpy"})
PRAGMA_REDUCTION = "repro: blessed-reduction"


def default_lint_roots() -> List[str]:
    """The executor surface the determinism contract covers."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [os.path.join(pkg, "solver"), os.path.join(pkg, "kernels")]


def _blessed(lines: Sequence[str], node: ast.AST, pragma: str) -> bool:
    """Pragma on any line the node spans, or anywhere in the contiguous
    comment block directly above it (multi-line justifications).  For
    decorated defs the block sits above the *first decorator*, which is
    where a human writes it."""
    lo = min(
        [node.lineno]
        + [d.lineno for d in getattr(node, "decorator_list", [])]
    )
    hi = getattr(node, "end_lineno", node.lineno)
    if any(pragma in ln for ln in lines[lo - 1:hi]):
        return True
    i = lo - 2  # 0-based index of the line above
    while i >= 0 and lines[i].lstrip().startswith("#"):
        if pragma in lines[i]:
            return True
        i -= 1
    return False


def _is_numeric_base(node: ast.expr) -> bool:
    return isinstance(node, ast.Name) and node.id in NUMERIC_MODULES


def _accumulates(call: ast.Call) -> bool:
    """``accumulate=`` given and not the literal ``False``."""
    for kw in call.keywords:
        if kw.arg == "accumulate":
            v = kw.value
            return not (isinstance(v, ast.Constant) and v.value is False)
    return False


def _hazard(call: ast.Call) -> str | None:
    """Why ``call`` may not be deterministic, or ``None``."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    is_module = _is_numeric_base(call.func.value)
    if attr in REDUCTION_NAMES and (is_module or attr in METHOD_REDUCTIONS):
        return "reduction may reassociate across lanes"
    if attr in SCATTER_NAMES:
        return "scatter accumulation adds in an unspecified order on CUDA"
    if attr in ACCUMULATE_PUT and _accumulates(call):
        return (
            "accumulating put adds in an unspecified order on CUDA"
        )
    return None


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    """Lint one source string; returns findings (empty = clean)."""
    out: List[Finding] = []
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        out.append(finding(
            CHECK, "LINT_SYNTAX", f"cannot parse: {e}",
            file=filename, line=e.lineno or 0,
        ))
        return out
    lines = src.splitlines()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        why = _hazard(node)
        if why is None or _blessed(lines, node, PRAGMA_REDUCTION):
            continue
        out.append(finding(
            CHECK, "LINT_NONDET_REDUCTION",
            f"{filename}:{node.lineno}: `{node.func.attr}` {why} — use a "
            f"fixed-order fold or bless with `# {PRAGMA_REDUCTION}`",
            file=filename, line=node.lineno,
        ))
    return sorted(out, key=lambda f: int(dict(f.where)["line"]))


def lint_paths(paths: Iterable[str] | None = None) -> List[Finding]:
    """Lint every ``.py`` file under ``paths`` (files or directories);
    defaults to the solver + kernels trees."""
    roots = list(paths) if paths else default_lint_roots()
    files: List[str] = []
    for root in roots:
        if os.path.isfile(root):
            files.append(root)
            continue
        for dirpath, _, names in sorted(os.walk(root)):
            files.extend(
                os.path.join(dirpath, f)
                for f in sorted(names) if f.endswith(".py")
            )
    out: List[Finding] = []
    for f in files:
        with open(f, "r", encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), filename=f))
    return out


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint",
        description="determinism lint over the port's solver/kernel source",
    )
    p.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: solver + kernels)",
    )
    args = p.parse_args(argv)
    found = lint_paths(args.paths or None)
    for f in found:
        print(f"{f.code}  {f.message}")
    n_files = len(args.paths) if args.paths else 2
    print(
        f"determinism lint: {len(found)} finding(s) over "
        f"{n_files} root(s)"
    )
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
