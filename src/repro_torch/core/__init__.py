"""Core library: the paper's scheduling contribution.

  * ``grow_local`` — the GrowLocal scheduler (§3, Alg. 3.1)
  * ``funnel_grow_local`` / ``funnel_partition`` / ``coarsen_dag`` /
    ``pull_back_schedule`` — §4 (``core/funnel.py`` / ``core/coarsen.py``)
  * ``apply_reordering`` — §5 locality reordering
  * ``block_parallel_schedule`` — §3.1
  * baselines: ``wavefront_schedule``, ``hdagg_schedule``, ``spmp_like_schedule``
  * ``Schedule`` / ``check_validity`` / ``bsp_cost`` — Def. 2.1 + cost model,
    and the step-granular ``step_cost`` / ``elastic_cost`` the autotuner's
    elastic rule reads
  * ``compile_plan`` — schedule -> padded ExecPlan for the executors
  * ``elastic_transform`` — the bounded-slack certificate of
    ``mode="elastic"`` (``ElasticPlan``, ``DEFAULT_SLACK``)
  * ``partition_plan`` — the host-side row-shard partition with its halo
    exchange tables (``RowShardPlan``, ``HaloRound``)
  * ``grow_local_pipeline`` — GrowLocal as a pipeline-parallel schedule
    (``PipelineProblem``, ``pipeline_dag``, ``pipeline_stats``)

Copies of the JAX package's ``repro.core`` modules of the same names. The
front door for solving is ``repro_torch.pipeline.TriangularSolver``.
"""
from repro_torch.core.blocks import block_parallel_schedule, block_sub_dag, split_ranges
from repro_torch.core.coarsen import (
    Coarsening,
    coarsen_dag,
    funnel_partition,
    is_cascade,
    pull_back_schedule,
    transitive_sparsify,
)
from repro_torch.core.elastic import (
    DEFAULT_SLACK,
    ElasticPlan,
    elastic_transform,
    step_dependencies,
)
from repro_torch.core.funnel import funnel_grow_local
from repro_torch.core.growlocal import grow_local
from repro_torch.core.hdagg import hdagg_schedule
from repro_torch.core.pipeline_schedule import (
    PipelineProblem,
    grow_local_pipeline,
    pipeline_dag,
    pipeline_stats,
)
from repro_torch.core.plan import ExecPlan, compile_plan, plans_bitwise_equal
from repro_torch.core.reorder import Reordering, apply_reordering, schedule_order
from repro_torch.core.rowshard import HaloRound, RowShardPlan, partition_plan
from repro_torch.core.schedule import (
    DEFAULT_L,
    DEFAULT_L_STEP,
    Schedule,
    bsp_cost,
    check_validity,
    elastic_cost,
    schedule_stats,
    schedule_step_count,
    serial_schedule,
    step_cost,
)
from repro_torch.core.spmp_like import L_P2P_EFFECTIVE, spmp_like_schedule
from repro_torch.core.wavefront import wavefront_schedule

__all__ = [
    "grow_local",
    "funnel_grow_local",
    "hdagg_schedule",
    "spmp_like_schedule",
    "wavefront_schedule",
    "serial_schedule",
    "Schedule",
    "check_validity",
    "bsp_cost",
    "schedule_stats",
    "DEFAULT_L",
    "L_P2P_EFFECTIVE",
    "funnel_partition",
    "coarsen_dag",
    "pull_back_schedule",
    "is_cascade",
    "transitive_sparsify",
    "Coarsening",
    "apply_reordering",
    "schedule_order",
    "Reordering",
    "block_parallel_schedule",
    "block_sub_dag",
    "split_ranges",
    "ExecPlan",
    "compile_plan",
    "plans_bitwise_equal",
    "DEFAULT_SLACK",
    "ElasticPlan",
    "elastic_transform",
    "step_dependencies",
    "DEFAULT_L_STEP",
    "schedule_step_count",
    "step_cost",
    "elastic_cost",
    "partition_plan",
    "RowShardPlan",
    "HaloRound",
    "PipelineProblem",
    "pipeline_dag",
    "grow_local_pipeline",
    "pipeline_stats",
]
