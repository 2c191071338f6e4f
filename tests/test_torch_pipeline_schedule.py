"""The port's ``core/pipeline_schedule.py`` against the JAX package's:
the pipeline DAG and GrowLocal's pipeline schedule array-equal, value and
dtype, and ``pipeline_stats`` dict-equal, on the same problems; then the
JAX file's three property tests run against the port."""
import numpy as np
import pytest

from repro.core import pipeline_schedule as jps
from repro.core.schedule import DEFAULT_L as JAX_DEFAULT_L
from repro_torch.core import (
    DEFAULT_L,
    PipelineProblem,
    check_validity,
    grow_local_pipeline,
    pipeline_dag,
    pipeline_stats,
)
from repro_torch.sparse.dag import topological_levels

SIZES = [(2, 4), (4, 8), (4, 16), (3, 7)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("stages,micro", SIZES)
def test_pipeline_dag_equals_jax(stages, micro):
    dag, stage = pipeline_dag(PipelineProblem(n_stages=stages, n_microbatches=micro))
    jdag, jstage = jps.pipeline_dag(jps.PipelineProblem(n_stages=stages,
                                                        n_microbatches=micro))
    _same(stage, jstage)
    assert dag.n == jdag.n
    for name in ("parent_ptr", "parent_idx", "child_ptr", "child_idx", "weights"):
        _same(getattr(dag, name), getattr(jdag, name))


@pytest.mark.parametrize("L", [0.1, 1.0, 100.0, "default"])
@pytest.mark.parametrize("stages,micro", SIZES)
def test_grow_local_pipeline_equals_jax(stages, micro, L):
    assert DEFAULT_L == JAX_DEFAULT_L
    L = DEFAULT_L if L == "default" else L
    p = PipelineProblem(n_stages=stages, n_microbatches=micro)
    jp = jps.PipelineProblem(n_stages=stages, n_microbatches=micro)
    s, js = grow_local_pipeline(p, L=L), jps.grow_local_pipeline(jp, L=L)
    for name in ("pi", "sigma", "rank"):
        _same(getattr(s, name), getattr(js, name))
    assert (s.n, s.k, s.n_supersteps) == (js.n, js.k, js.n_supersteps)
    assert pipeline_stats(p, s) == jps.pipeline_stats(jp, js)


# the JAX package's tests/test_pipeline_schedule.py, on the port
@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 8), (4, 16)])
def test_pipeline_schedule_valid(stages, micro):
    p = PipelineProblem(n_stages=stages, n_microbatches=micro)
    dag, stage = pipeline_dag(p)
    topological_levels(dag)  # acyclic
    sched = grow_local_pipeline(p)
    check_validity(dag, sched)
    np.testing.assert_array_equal(sched.pi, stage.astype(np.int32))


def test_pipeline_bubble_improves_with_microbatches():
    fracs = []
    for micro in (2, 8, 32):
        p = PipelineProblem(n_stages=4, n_microbatches=micro)
        sched = grow_local_pipeline(p, L=1.0)
        fracs.append(pipeline_stats(p, sched)["bubble_fraction"])
    assert fracs[-1] < fracs[0]
    assert fracs[-1] < 0.3


def test_pipeline_supersteps_scale_with_L():
    p = PipelineProblem(n_stages=4, n_microbatches=16)
    cheap = grow_local_pipeline(p, L=0.1)
    pricey = grow_local_pipeline(p, L=100.0)
    assert pricey.n_supersteps <= cheap.n_supersteps
