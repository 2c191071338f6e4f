"""CG's guarantee as the configuration states it: every call of the window
stops with its relative residual ‖r‖₂ / ‖b‖₂ at or below ``cg.tol``, as
``cg_solve`` reports it; a call that stops at ``maxiter`` above it, or that
was stopped early, fails (the cell's limit is ``cg.tol``). It judges the
program's own report; ``true_relres`` judges its answer."""


def compare(run) -> dict:
    return dict(enumerate(run.counters.get("relres", [])))
