"""The dry run's counting (``launch/op_analysis.py``) against the JAX
package's (``launch/hlo_analysis.analyze_hlo`` on the jitted program) on
every family's reduced config: prefill and one decode step, dot FLOPs
equal but for the dots XLA rewrote, each named (``tests/_dryrun_flops.py``).
"""
import pytest

from _dryrun_flops import FAMILIES, assert_equal_but_named, counts


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_dot_flops_equal_analyze_hlo(arch, kind):
    jf, counter, cfg = counts(arch, kind)
    gaps = assert_equal_but_named(jf, counter, cfg, kind)
    assert jf > 0 and counter.flops > 0
    # which cells carry a named gap, and that nothing else does
    expected = {("seamless_m4t_large_v2", "prefill"): {"xla_cse"}}.get((arch, kind), set())
    assert {k for k, v in gaps.items() if v} == expected, gaps
