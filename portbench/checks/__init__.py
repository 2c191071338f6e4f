"""The comparisons that decide ``correct``, one module a number, found by
the names under the cell's ``checks`` (each with its limit). Each has
``compare(run)``: the number of each compared call as ``{call index:
value}``, held against the limit (larger is worse, NaN reads as infinity).
``run`` holds ``matrix``, ``config``, ``device``, ``kept`` (the sampled
calls as ``(index, rhs, answer)``) and ``counters`` (what the program
reported of every call of the window). A check that judges the answers may
have ``control(matrix, rhs, config, device)``: the plain reference put in
the program's place one precision below the configuration's; the cell's
first check that has one gives the cell's control. They use only
``portbench.reference``."""
import torch

# the step below each stated precision that a later change might take
PRECISION_BELOW = {"float32": torch.bfloat16}


def columns(ts) -> torch.Tensor:
    """The right-hand sides or answers of the kept calls side by side:
    f[n, columns], each call's columns in turn."""
    return torch.cat([t.reshape(t.shape[0], -1) for t in ts], dim=1)


def per_call(run, per_col: torch.Tensor) -> dict:
    """``{call index: its worst column}`` from one value a column."""
    per_col = torch.nan_to_num(per_col.cpu(), nan=float("inf"))
    m = per_col.numel() // max(len(run.kept), 1)  # columns of one call
    worst = per_col.reshape(len(run.kept), m).amax(dim=1).tolist()
    return {i: v for (i, _, _), v in zip(run.kept, worst)}
