"""Core library: the paper's scheduling contribution, as far as the port
has come.

  * ``grow_local`` — the GrowLocal scheduler (§3, Alg. 3.1)
  * ``apply_reordering`` — §5 locality reordering
  * ``Schedule`` / ``check_validity`` / ``bsp_cost`` / ``serial_schedule``
    — Def. 2.1 + cost model
  * ``compile_plan`` — schedule -> padded ExecPlan for the executors
  * ``elastic_transform`` — the bounded-slack certificate of
    ``mode="elastic"`` (``ElasticPlan``, ``DEFAULT_SLACK``)

Copies of the JAX package's ``repro.core`` modules of the same names. The
front door for solving is ``repro_torch.pipeline.TriangularSolver``.
"""
from repro_torch.core.elastic import (
    DEFAULT_SLACK,
    ElasticPlan,
    elastic_transform,
    step_dependencies,
)
from repro_torch.core.growlocal import grow_local
from repro_torch.core.plan import ExecPlan, compile_plan, plans_bitwise_equal
from repro_torch.core.reorder import Reordering, apply_reordering, schedule_order
from repro_torch.core.schedule import (
    DEFAULT_L,
    Schedule,
    bsp_cost,
    check_validity,
    serial_schedule,
)

__all__ = [
    "grow_local",
    "serial_schedule",
    "Schedule",
    "check_validity",
    "bsp_cost",
    "DEFAULT_L",
    "apply_reordering",
    "schedule_order",
    "Reordering",
    "ExecPlan",
    "compile_plan",
    "plans_bitwise_equal",
    "DEFAULT_SLACK",
    "ElasticPlan",
    "elastic_transform",
    "step_dependencies",
]
