"""``portbench.spantrace``: the reducer on Chrome events made by hand (idle
split exactly at span boundaries and charged to the innermost program
span, the parts adding up to the idle; device time tied to spans by the
launch's correlation id), the benchmark's own traced segment holding no
program span, and the second segment of each cell on the CPU at a small
size."""
import json
import time

import pytest
import torch

from portbench import devtrace, harness, spantrace

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
CPU = torch.device("cpu")
SEED = 2**31 + 4242


def x(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def hand_made():
    """Two calls, [0, 100] and [110, 200] (µs). Device busy over [0, 8],
    [20, 30], [46, 58], [125, 150], [190, 200]: idle [8, 20], [30, 46],
    [58, 125], [150, 190], 135 µs in all."""
    call = devtrace.CALL
    return [
        x(call, "user_annotation", 0, 100), x(call, "user_annotation", 110, 90),
        x("executor.solve", "user_annotation", 5, 55),
        x("executor.permute", "user_annotation", 6, 4),
        x("kernel.solve", "user_annotation", 12, 38),
        x("aten::cat", "cpu_op", 15, 10),  # a host op, not a span: kernel.solve's
        x("kernel.launch", "user_annotation", 40, 5),
        x("cg.solve", "user_annotation", 115, 80),
        x("cg.converged", "user_annotation", 120, 10),
        x("cg.matvec", "user_annotation", 130, 10),
        x("cudaLaunchKernel", "cuda_runtime", 1, 1, correlation=3),
        x("cudaLaunchKernel", "cuda_runtime", 41, 1, correlation=7),
        x("cudaLaunchKernel", "cuda_runtime", 131, 1, correlation=9),
        x("k0", "kernel", 0, 8, correlation=3), x("k1", "kernel", 20, 10, correlation=7),
        x("fill", "gpu_memset", 46, 12), x("k2", "kernel", 125, 25, correlation=9),
        x("k3", "kernel", 190, 10),
        x("cudaDeviceSynchronize", "cuda_runtime", 60, 40),
    ]


def test_each_idle_piece_goes_to_the_innermost_span():
    got = spantrace.reduce(hand_made())
    us = 1e-6
    assert got["calls"] == 2 and got["device_events"] == 5
    assert got["window_s"] == pytest.approx(200 * us) and got["idle_s"] == pytest.approx(135 * us)
    idle = {n: v["idle_s"] / us for n, v in got["spans"].items()}
    # [8, 20] straddles permute (8-10), executor.solve (10-12) and kernel.solve
    # (12-20, under aten::cat from 15); [30, 46] kernel.solve, kernel.launch,
    # kernel.solve; [58, 125] executor.solve, outside (60-115, between the
    # calls too), cg.solve, cg.converged; [150, 190] cg.solve
    want = {"executor.permute": 2, "executor.solve": 4, "kernel.solve": 19,
            "kernel.launch": 5, "cg.solve": 45, "cg.converged": 5, "cg.matvec": 0}
    assert idle == pytest.approx(want)
    layers = {k: v / us for k, v in got["idle_by_layer"].items()}
    assert layers == pytest.approx({"front door": 6, "kernel": 24, "consumer": 50,
                                    spantrace.OUTSIDE: 55})
    assert sum(got["idle_by_layer"].values()) == pytest.approx(got["idle_s"], rel=1e-12)
    assert got["parts_over_idle"] == pytest.approx(1.0)
    spans = got["spans"]
    assert spans["executor.solve"]["self_s"] == pytest.approx(13 * us)  # 5-6, 10-12, 50-60
    assert spans["kernel.solve"]["self_s"] == pytest.approx(33 * us)
    assert all(v["count"] == 1 for v in spans.values())
    # k1 launched inside kernel.launch counts under it and the spans around
    # it; k0's launch lies outside every span; the memset has no launch
    dev = {n: v["device_s"] / us for n, v in spans.items()}
    assert dev == pytest.approx({"executor.solve": 10, "executor.permute": 0, "kernel.solve": 10,
                                 "kernel.launch": 10, "cg.solve": 25, "cg.converged": 0,
                                 "cg.matvec": 25})
    # the idle the benchmark's own segment names portbench.call (no torch op
    # open at a stretch's middle): [8, 20] and [30, 46] (aten::cat opens at
    # 15, after the middle of the first) and [150, 190]; [58, 125] is
    # cudaDeviceSynchronize's
    unnamed = {k: v / us for k, v in got["unnamed_s"].items()}
    assert unnamed == pytest.approx({"executor.permute": 2, "executor.solve": 2,
                                     "kernel.solve": 19, "kernel.launch": 5, "cg.solve": 40})
    assert spantrace.idle_us(got, 2, "solve") == pytest.approx(
        {"frontdoor_idle_us.solve": 3, "launch_idle_us.solve": 12})
    assert spantrace.idle_us(got, 5, "pcg") == pytest.approx(
        {"frontdoor_idle_us.pcg": 1.2, "launch_idle_us.pcg": 4.8, "cg_idle_us.pcg": 10})


def test_without_program_spans_all_idle_is_outside():
    plain = [e for e in hand_made()
             if e["cat"] != "user_annotation" or e["name"] == devtrace.CALL]
    got = spantrace.reduce(plain)
    assert got["spans"] == {} and got["idle_by_layer"] == {spantrace.OUTSIDE: got["idle_s"]}
    assert got["unnamed_s"] == pytest.approx({spantrace.OUTSIDE: 68e-6})
    assert spantrace.idle_us(got, 2, "solve") == {}  # nothing to read: no metric
    with pytest.raises(RuntimeError):
        spantrace.reduce([e for e in plain if e["name"] != devtrace.CALL])


def tiny_spec(cell):
    spec = harness.load_spec(cell)
    spec.config.update(spec.config["test_sizes"]["tiny"])
    spec.cell["trace_calls"] = min(spec.cell["trace_calls"], 3)
    return spec


@pytest.mark.parametrize("cell", CELLS)
def test_the_benchmarks_segment_holds_no_program_span(cell, monkeypatch):
    seen = []
    real = devtrace.reduce

    def keep(events):
        seen.append(events)
        return real(events)

    monkeypatch.setattr(devtrace, "reduce", keep)
    harness.run(tiny_spec(cell), seed=SEED, seconds=0.1, trace=True, device=CPU,
                t0=time.perf_counter(), log=lambda line: None)
    (events,) = seen
    notes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert notes == {devtrace.CALL}


@pytest.mark.parametrize("cell", CELLS)
def test_the_second_segment_charges_the_idle_to_the_programs_spans(cell):
    spec = tiny_spec(cell)
    got = spantrace.measure(spec, SEED, 0.0, CPU)
    n, seg = spec.cell["trace_calls"], got["second"]
    counts = {name: v["count"] for name, v in seg["spans"].items()}
    pcg = "cg" in spec.config
    if pcg:
        iters = got["units"]["second"]
        assert got["units"]["per"] == "iteration" and iters > 1
        assert counts["cg.solve"] == counts["cg.bind"] == n
        assert counts["cg.matvec"] == iters and counts["cg.precond"] == iters + n
        assert counts["executor.solve"] == counts["kernel.solve"] == 2 * (iters + n)
    else:
        assert got["units"] == {"per": "call", "first": n, "second": n}
        assert counts == {"executor.solve": n, "executor.permute": n,
                          "executor.unpermute": n, "kernel.solve": n}
    # the CPU runs no device operation: the whole segment is idle, and
    # every part of it is charged once
    assert seg["device_events"] == 0 and seg["idle_s"] == pytest.approx(seg["window_s"])
    assert seg["parts_over_idle"] == pytest.approx(1.0)
    want = {"frontdoor_idle_us", "launch_idle_us"} | ({"cg_idle_us"} if pcg else set())
    kind = "pcg" if pcg else "solve"
    assert set(got["metrics"]) == {f"{m}.{kind}" for m in want}
    assert all(v > 0 for v in got["metrics"].values())
    json.dumps(got, allow_nan=False)
