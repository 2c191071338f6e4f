"""The port's determinism lint (``repro_torch.analysis.lint``), retargeted at
torch: each rule's forms are flagged (module and tensor-method
reductions, the scatter accumulations that add in an unspecified order on
CUDA, ``index_put_(..., accumulate=True)``), fixed-order folds and
unrelated names stay clean, the ``# repro: blessed-reduction`` pragma
blesses on the line or in the comment block directly above and nowhere
else, the port's solver + kernels trees lint clean, and the CLI exits
0 / 1."""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.lint import default_lint_roots, lint_paths, lint_source

REPO = Path(__file__).resolve().parents[1]


def _codes(src):
    return sorted(f.code for f in lint_source(textwrap.dedent(src)))


@pytest.mark.parametrize("call", [
    "torch.sum(v * x[cols], dim=1)",
    "torch.dot(v, x)",
    "torch.matmul(a, b)",
    "torch.einsum('rw,rw->r', v, x[cols])",
    "torch.vdot(v, x)",
    "torch.inner(v, x)",
    "torch.tensordot(a, b, dims=1)",
    "torch.prod(v)",
    "torch.mm(a, b)",
    "torch.bmm(a, b)",
    "torch.mv(a, x)",
    "np.sum(v)",
    "numpy.dot(v, x)",
])
def test_module_reductions_flagged(call):
    found = lint_source(f"import torch\nimport numpy as np\ny = {call}\n", filename="m.py")
    assert [f.code for f in found] == ["LINT_NONDET_REDUCTION"]
    assert call.split("(")[0].split(".")[1] in found[0].message
    assert dict(found[0].where) == {"file": "m.py", "line": "3"}


@pytest.mark.parametrize("call", [
    "(v * x).sum(dim=1)", "v.dot(x)", "a.matmul(b)", "a.mm(b)", "a.bmm(b)",
    "a.mv(x)", "v.prod()", "v.vdot(x)", "v.inner(x)",
])
def test_method_reductions_flagged(call):
    assert _codes(f"y = {call}\n") == ["LINT_NONDET_REDUCTION"]


@pytest.mark.parametrize("call", [
    "x.index_add_(0, idx, v)", "x.index_add(0, idx, v)",
    "torch.index_add(x, 0, idx, v)",
    "x.scatter_add_(0, idx, v)", "torch.scatter_add(x, 0, idx, v)",
    "x.scatter_reduce_(0, idx, v, reduce='sum')",
    "torch.scatter_reduce(x, 0, idx, v, 'sum')",
    "x.index_reduce_(0, idx, v, 'prod')", "x.index_reduce(0, idx, v, 'mean')",
    "x.index_put_((idx,), v, accumulate=True)",
    "torch.index_put(x, (idx,), v, accumulate=acc)",
])
def test_scatter_accumulations_flagged(call):
    found = lint_source(f"y = {call}\n")
    assert [f.code for f in found] == ["LINT_NONDET_REDUCTION"]
    assert "unspecified order on CUDA" in found[0].message


@pytest.mark.parametrize("src", [
    # the executor's fixed-order fold
    """
    def fold(acc, vals, x, cols, W):
        for w in range(W):
            acc = torch.addcmul(acc, vals[:, w], x[cols[:, w]])
        return acc
    """,
    # moves bits only
    "x.index_put_((idx,), v)\n",
    "x.index_put_((idx,), v, accumulate=False)\n",
    "x.scatter_(0, idx, v)\ny = torch.gather(x, 0, idx)\nz = x.index_select(0, idx)\n",
    # names that are not reductions, or not calls of one
    "z = totals.product\nw = obj.summary()\nq = sum(rows)\nr = obj.einsum(v)\n",
    "y = torch.cumsum(v, 0)\nz = torch.linalg.norm(v)\n",
])
def test_clean_forms(src):
    assert _codes(src) == []


def test_pragma_same_line_and_block_above():
    src = """
        a = torch.dot(v, x)  # repro: blessed-reduction — convergence-bounded
        # repro: blessed-reduction — an integer count:
        # exact in any order
        n = int(lens.sum())
        x.index_add_(0, i, v)  # repro: blessed-reduction — host-only tally
    """
    assert _codes(src) == []


def test_pragma_does_not_leak():
    src = """
        # repro: blessed-reduction — covers the next statement only
        a = torch.dot(v, x)

        b = torch.dot(v, x)
        c = v.sum()  # an ordinary comment
    """
    found = lint_source(textwrap.dedent(src))
    assert [int(dict(f.where)["line"]) for f in found] == [5, 6]


def test_syntax_error_reported_not_raised():
    found = lint_source("def broken(:\n", filename="bad.py")
    assert [f.code for f in found] == ["LINT_SYNTAX"]


def test_port_tree_is_clean():
    """The port's solver + kernels trees lint clean: every library
    reduction carries its blessing pragma (CG's inner products, the
    integer counts of ``kernels/spmv.py``)."""
    found = lint_paths()
    assert found == [], "\n".join(f.message for f in found)
    roots = default_lint_roots()
    assert [Path(r).relative_to(REPO / "src").as_posix() for r in roots] == [
        "repro_torch/solver", "repro_torch/kernels"]
    # the blessings really are load-bearing: without them the tree is dirty
    spmv = (REPO / "src" / "repro_torch" / "kernels" / "spmv.py").read_text()
    bare = spmv.replace("repro: blessed-reduction", "an unblessed comment")
    assert len(lint_source(bare)) == 2


def test_cli_exit_codes(tmp_path):
    from repro_torch.analysis.lint import main

    clean = tmp_path / "clean.py"
    clean.write_text("X = 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import torch\ndef f(v):\n    return torch.sum(v)\n")
    assert main([str(clean)]) == 0
    assert main([str(dirty)]) == 1
    assert main([]) == 0  # the default roots
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(dirty)],
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 1 and "LINT_NONDET_REDUCTION" in out.stdout
