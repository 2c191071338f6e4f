"""The port's dry run: every (arch × shape) cell counted on ``meta``, and
the paper's own workload (the SpTRSV cells) run on the card.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell on a
16x16 (or 2x16x16) TPU mesh of 512 forced host devices and reads FLOPs,
HBM bytes and collective bytes out of the optimized HLO. One H100 has no
XLA, no HLO and no 512-device world, so this is a dry run for PyTorch on
the H100, not a translation:

  * An LM cell runs the port's own program — ``make_train_step`` (train),
    ``prefill`` or one ``decode_step`` — on ``meta`` tensors (bfloat16
    parameters, float32 moments and recurrent states, as the JAX dry run's
    abstract state), under ``launch.op_analysis.OpCounter``, which counts
    each op's dot FLOPs and bytes as it dispatches. Nothing is allocated.
    The totals are for the whole program; the per-chip numbers divide them
    by the mesh's chips, which assumes even sharding. The times are those
    totals against one H100's published peaks (``launch.roofline``).
    Collective bytes are ``None``: one process runs no sharded program.
  * An SpTRSV cell plans the JAX cell's matrix (``n = 100,000``) with
    GrowLocal, ``k = 16``, on the distributed backend over the 16x16
    production mesh with every position on ``cuda:0``, solves 16
    right-hand sides through the ported kernels, and reports the exchange
    rounds and bytes, the range launches a solve makes, the time of a
    solve (CUDA events, 3 warm-ups, median of 10) and its roofline terms.
    The answer is held bitwise against the kernel backend's on the same
    plan and right-hand sides.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sptrsv --shape solve_nb100k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
Each cell writes experiments/dryrun_torch/<cell>[.mp].json. The SpTRSV
cells run on the card and raise without CUDA unless ``--device cpu``.
The environment knobs of the JAX dry run are read where it reads them:
``REPRO_WKV_CHUNK`` (rwkv6's WKV chunk), ``REPRO_NO_REMAT`` (remat off)
and ``REPRO_SEQ_SHARD`` (the sequence-sharded residual rule, installed
through ``sharding_ctx`` and shown in each LM record's
``activation_rules``; a one-process count does not change with it).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.device import resolve_device
from repro_torch.distributed.meshes import resolve_spec, shard_count, tree_shard_bytes
from repro_torch.distributed.sharding_ctx import activation_rules, activation_sharding
from repro_torch.launch.inputs import (
    batch_logical,
    cache_logical,
    decode_state_shapes,
    resolve_kv_logical,
    train_batch_shapes,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.launch.roofline import (
    FP32_FLOPS,
    HBM_BW,
    NO_COLLECTIVES,
    RooflineTerms,
    essential_bytes,
    model_flops,
)
from repro_torch.models import abstract_params, logical_specs, param_specs
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.decode import decode_step, prefill
from repro_torch.models.lm import ModelConfig
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.train_loop import TrainState

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

EVEN_SHARDING = ("per chip = the counted totals of the one-process program divided by "
                 "the mesh's chips: assumes even sharding")

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    """The parameters as ``meta`` tensors (shapes and dtypes, no memory)."""
    return abstract_params(param_specs(cfg), dtype=dtype)


def _abstract_state(cfg: ModelConfig) -> TrainState:
    """bfloat16 parameters and float32 moments, as the JAX dry run's."""
    p = _abstract_params(cfg)
    f32 = lambda a: _meta(a.shape, torch.float32)  # noqa: E731
    return TrainState(params=p, opt_state={
        "mu": tree_map(f32, p), "nu": tree_map(f32, p),
        "step": _meta((), torch.int32),
    })


def _batch_meta(cfg: ModelConfig, shape) -> dict:
    """The train batch of ``train_batch_shapes`` as ``meta`` tensors; token
    ids as int64, the index dtype of the port's gathers (JAX's are
    int32)."""
    out = {}
    for name, (shp, dt) in train_batch_shapes(cfg, shape).items():
        out[name] = _meta(shp, torch.int64 if dt == np.int32 else torch.float32)
    return out


def _microbatches_for(cfg: ModelConfig, shape) -> int:
    """Gradient-accumulation depth per cell: keep per-microbatch activation
    memory bounded. Scales with parameter width."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 12000:
        return 16
    if cfg.d_model >= 5000:
        return 8
    if cfg.d_model >= 4000:
        return 4
    return 2


def cell_config(arch: str) -> ModelConfig:
    """The arch's config with the JAX dry run's environment knobs applied."""
    cfg = get_config(arch)
    wkv_chunk = int(os.environ.get("REPRO_WKV_CHUNK", "0"))
    if wkv_chunk and cfg.family == "rwkv6":
        cfg = dataclasses.replace(cfg, wkv_chunk=wkv_chunk)
    if os.environ.get("REPRO_NO_REMAT"):
        cfg = dataclasses.replace(cfg, remat=False)
    return cfg


def _fit(mesh, rule, shape) -> tuple:
    """A role rule (``sharding_ctx``) as the spec of a tensor of ``shape``:
    cut or padded to its rank, as JAX's ``constrain`` does, and an entry
    dropped where its axes do not divide the dimension."""
    entries = list(rule)[:len(shape)]
    entries += [None] * (len(shape) - len(entries))
    out = [e if e is not None and dim % shard_count(mesh, (e,)) == 0 else None
           for dim, e in zip(shape, entries)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def cell_program(cfg: ModelConfig, shape, mesh):
    """``(fn, args, arg_specs, out_specs)`` of one LM cell on ``meta``:
    ``fn(*args)`` is the program, ``arg_specs`` a spec per argument leaf
    (a tree matching ``args``), and ``out_specs(out)`` the specs of what it
    returns."""
    param_log = logical_specs(param_specs(cfg))

    def specs_of(logical, tensors, resolve=resolve_spec):
        if isinstance(tensors, dict):
            return {k: specs_of(logical[k], tensors[k], resolve) for k in tensors}
        return resolve(mesh, logical, tuple(tensors.shape))

    def batch_specs(batch):
        log = batch_logical(cfg, shape.kind)
        return {k: resolve_spec(mesh, log[k], tuple(v.shape)) for k, v in batch.items()}

    rules = activation_rules(mesh)

    def logits_spec(t):
        return _fit(mesh, rules["logits"], tuple(t.shape))

    if shape.kind == "train":
        state = _abstract_state(cfg)
        batch = _batch_meta(cfg, shape)
        step = make_train_step(cfg, AdamWConfig(), microbatches=_microbatches_for(cfg, shape))
        pspec = specs_of(param_log, state.params)
        state_specs = {"params": pspec, "mu": pspec, "nu": pspec, "step": ()}
        args_tree = {"params": state.params, "mu": state.opt_state["mu"],
                     "nu": state.opt_state["nu"], "step": state.opt_state["step"],
                     "batch": batch}
        arg_specs = {**state_specs, "batch": batch_specs(batch)}

        def out_specs(out):
            new_state, metrics = out
            tree = {"params": new_state.params, "mu": new_state.opt_state["mu"],
                    "nu": new_state.opt_state["nu"], "step": new_state.opt_state["step"],
                    "metrics": metrics}
            return tree, {**state_specs, "metrics": {k: () for k in metrics}}

        return (lambda: step(state, batch)), args_tree, arg_specs, out_specs

    params = _abstract_params(cfg)
    pspec = specs_of(param_log, params)
    if shape.kind == "prefill":
        batch = _batch_meta(cfg, shape)
        args_tree = {"params": params, "batch": batch}
        arg_specs = {"params": pspec, "batch": batch_specs(batch)}

        def out_specs(out):
            logits, cache, pos = out
            tree = {"logits": logits, "cache": cache}
            return tree, {"logits": logits_spec(logits),
                          "cache": specs_of(cache_logical(cfg), cache, resolve_kv_logical)}

        return (lambda: prefill(cfg, params, batch, max_len=shape.seq_len)), args_tree, \
            arg_specs, out_specs

    cache, (tok_shape, _) = decode_state_shapes(cfg, shape)
    tok = _meta(tok_shape, torch.int64)
    pos = _meta((), torch.int64)
    cspec = specs_of(cache_logical(cfg), cache, resolve_kv_logical)
    args_tree = {"params": params, "cache": cache, "pos": pos, "tok": tok}
    arg_specs = {"params": pspec, "cache": cspec, "pos": (),
                 "tok": resolve_spec(mesh, ("batch",), tok_shape)}

    def out_specs(out):
        logits, new_cache = out
        return {"logits": logits, "cache": new_cache}, {"logits": logits_spec(logits),
                                                         "cache": cspec}

    return (lambda: decode_step(cfg, params, cache, pos, tok)), args_tree, arg_specs, out_specs


def count_cell(arch: str, shape_name: str, *, multi_pod: bool = False, log: bool = False):
    """``(OpCounter, meta)`` of one LM cell counted on ``meta``, or
    ``(None, {"skipped": reason})``."""
    cfg = cell_config(arch)
    shape = SHAPES[shape_name]
    skip = shape_applicable(cfg, shape)
    if skip:
        return None, {"skipped": skip}
    mesh = make_production_mesh(multi_pod=multi_pod, devices="meta")
    chips = int(np.prod(list(mesh.shape.values())))
    seq_sharded = bool(int(os.environ.get("REPRO_SEQ_SHARD", "0"))) and shape.kind != "decode"
    fn, args_tree, arg_specs, out_specs = cell_program(cfg, shape, mesh)
    with activation_sharding(mesh, seq_sharded=seq_sharded):
        with OpCounter(log=log) as counter:
            out = fn()
    out_tree, out_spec_tree = out_specs(out)
    memory = {
        "argument_size_in_bytes": tree_shard_bytes(mesh, arg_specs, args_tree),
        "output_size_in_bytes": tree_shard_bytes(mesh, out_spec_tree, out_tree),
        "temp_size_in_bytes": counter.peak_live_bytes / chips,
        "temp_basis": "the peak of the live bytes of the tensors the program made "
                      "(launch.op_analysis), divided by the chips",
        "peak_live_bytes_one_process": counter.peak_live_bytes,
        "args_and_outputs_basis": "each leaf's bytes over the product of the mesh axes "
                                  "its resolved spec shards",
    }
    rules = {"seq_sharded": seq_sharded,
             "installed": activation_rules(mesh, seq_sharded=seq_sharded),
             "note": "installed for the count and read by nothing in it: one process "
                     "holds each tensor whole (sharding_ctx.constrain returns its input), "
                     "so REPRO_SEQ_SHARD changes no number of the record"}
    return counter, {"chips": chips, "mesh": dict(mesh.shape), "cfg": cfg, "shape": shape,
                     "memory": memory, "activation_rules": rules}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             save: bool = True) -> dict:
    t0 = time.time()
    tag = f"{arch}.{shape_name}" + (".mp" if multi_pod else "")
    try:
        counter, meta = count_cell(arch, shape_name, multi_pod=multi_pod)
    except Exception as e:  # noqa: BLE001
        result = {"cell": tag, "status": "ERROR", "error": f"{type(e).__name__}: {e}",
                  "where": _where(e), "trace": traceback.format_exc()[-2000:]}
        _save(result, tag, save)
        return result
    if counter is None:
        result = {"cell": tag, "status": "SKIP", "reason": meta["skipped"]}
        _save(result, tag, save)
        return result

    cfg, shape, chips = meta["cfg"], meta["shape"], meta["chips"]
    per_chip = RooflineTerms(flops=counter.flops / chips,
                             bytes_accessed=counter.bytes / chips,
                             collective_bytes=None, chips=1)
    terms = per_chip.as_dict()
    n_params, n_active = _param_counts(cfg)
    mf = model_flops(cfg, shape, n_params, n_active)
    ess = essential_bytes(cfg, shape, n_params, chips,
                          microbatches=_microbatches_for(cfg, shape),
                          tp=meta["mesh"].get("model", 1))
    terms.update({
        "collective_note": NO_COLLECTIVES,
        "per_chip": EVEN_SHARDING,
        "flops_total": counter.flops,
        "bytes_total": counter.bytes,
        "bytes_basis": "operand + output bytes of every eager op (launch.op_analysis)",
        "essential_bytes": ess,
        "t_memory_lb_s": ess / HBM_BW,
        "top_ops": counter.breakdown(top=8),
    })
    result = {
        "cell": tag,
        "status": "OK",
        "mesh": meta["mesh"],
        "chips": chips,
        "count_s": round(time.time() - t0, 1),
        "roofline": terms,
        "memory_analysis": meta["memory"],
        "model_flops": mf,
        "n_params": n_params,
        "n_active_params": n_active,
        "useful_flops_ratio": (mf / counter.flops) if counter.flops else None,
        "remat": cfg.remat,
        "microbatches": _microbatches_for(cfg, shape),
        "activation_rules": meta["activation_rules"],
    }
    _save(result, tag, save)
    return result


def _where(e: BaseException) -> str:
    """file:line of the innermost frame of ``e``'s traceback in this repo."""
    tb = traceback.extract_tb(e.__traceback__)
    root = str(Path(__file__).resolve().parents[3])
    ours = [f for f in tb if f.filename.startswith(root)]
    f = (ours or tb)[-1]
    name = os.path.relpath(f.filename, root) if f.filename.startswith(root) else f.filename
    return f"{name}:{f.lineno}"


def _param_counts(cfg: ModelConfig):
    """(total, active) parameter counts from the abstract tree."""
    specs = param_specs(cfg)
    total = sum(int(np.prod(a.shape)) for a in tree_leaves(abstract_params(specs)))
    active = total
    if cfg.moe is not None:
        # routed experts contribute top_k/n_experts of their params per token
        moe_leaves = 0
        for name in ("w_gate", "w_up", "w_down"):
            leaf = specs["layers"]["moe"][name]
            moe_leaves += int(np.prod(leaf.shape))
        active = total - moe_leaves + int(
            moe_leaves * cfg.moe.top_k / cfg.moe.n_experts
        )
    return total, active


def _fmt(x) -> str:
    return "-" if x is None else f"{x:.3e}s"


def _save(result: dict, tag: str, save: bool):
    line = (
        f"[{result['status']}] {tag}"
        + (f" count={result.get('count_s')}s" if "count_s" in result else "")
    )
    print(line, flush=True)
    if result["status"] == "OK":
        r = result["roofline"]
        print(
            f"    t_comp={_fmt(r['t_compute_s'])} t_mem={_fmt(r['t_memory_s'])} "
            f"t_coll={_fmt(r['t_collective_s'])} dominant={r['dominant']}",
            flush=True,
        )
        mem = result.get("memory_analysis")  # the LM cells'
        if mem:
            mem = {k: v for k, v in mem.items() if k.endswith("_in_bytes")}
            print(f"    memory/device: {mem}", flush=True)
    elif result["status"] == "ERROR":
        print("    " + result["error"] + f" ({result.get('where')})", flush=True)
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / f"{tag}.json").write_text(json.dumps(result, indent=1))


# ---------------------------------------------------------------------------
# the paper's own workload as dry-run cells
# ---------------------------------------------------------------------------
SPTRSV_SHAPES = {
    # (n, kind, params, batch): batch = #RHS sharded over 'data';
    # shard = mesh decomposition ("model" all_gather | "rows" halo ring)
    "solve_er100k": dict(n=100_000, kind="er", p=5e-5, batch=16),
    "solve_nb100k": dict(n=100_000, kind="nb", p=0.14, band=10.0, batch=16),
    "solve_nb100k_rows": dict(
        n=100_000, kind="nb", p=0.14, band=10.0, batch=16, shard="rows"
    ),
}

TIMING = dict(warmup=3, reps=10)


def dominant_values(L, data=None) -> np.ndarray:
    """``data`` (default ``L``'s values), in ``L``'s pattern, with each
    diagonal entry set to +-(1 + the sum of its row's |off-diagonals|): a
    solve whose |x| stays bounded by max|b| however deep the DAG (the NB
    values of the paper overflow float32 at n = 100,000)."""
    data = L.data if data is None else data
    rows = L.row_of_entry()
    on_diag = L.indices == rows
    off = np.bincount(rows, weights=np.where(on_diag, 0.0, np.abs(data)),
                      minlength=L.n_rows)
    out = np.array(data, dtype=np.float64)
    out[on_diag] = np.where(data[on_diag] < 0, -1.0, 1.0) * (1.0 + off[rows[on_diag]])
    return out


def sptrsv_work(plan, esize: int, cols: int = 0) -> dict:
    """What this run's data needs of a solve of ``cols`` right-hand sides,
    padding left out: the plan's real entries (index and value) and real
    lane steps (row, diagonal, accum flag) read once, b read and x written
    once (``bytes``); two operations an entry and a finishing row a column
    (``ops``); and the plan's padding share."""
    real = plan.row_ids < plan.n
    entries = int((plan.val_src >= 0).sum())
    lane_steps = int(real.sum())
    finishes = int((real & ~plan.accum).sum())
    return {"entries": entries, "finishes": finishes,
            "bytes": entries * (4 + esize) + lane_steps * (4 + esize + 1)
            + 2 * plan.n * cols * esize,
            "ops": 2 * (entries + finishes) * cols,
            "padding_share": 1.0 - entries / plan.col_idx.size}


def nvidia_smi_line():
    """The card's name and power limit as nvidia-smi gives them, or None."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip() if out.returncode == 0 else None


def _solve_ms(fn, dev: torch.device, warmup: int, reps: int) -> list:
    """``reps`` times of ``fn`` in ms after ``warmup`` calls: CUDA events on
    the card, the host clock (after the call returned) on the CPU."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def run_sptrsv_cell(shape_name: str, *, multi_pod: bool = False, save: bool = True,
                    device=None, mesh_shape=None, seed: int = 0, probe=None,
                    **overrides) -> dict:
    """One SpTRSV cell (see the module docstring). ``device`` is the card
    unless ``"cpu"``; ``mesh_shape`` (data, model) and ``overrides`` of the
    cell's ``n``/``p``/``batch`` make a smaller cell of the same body.
    ``probe(solve)``, where given, is called after the timing with the
    timed solve (no arguments) and its dict is kept under ``"probe"``: a
    caller's profile of the same solves."""
    from repro_torch.backends import get_backend
    from repro_torch.kernels import sptrsv
    from repro_torch.mesh import make_mesh
    from repro_torch.pipeline import TriangularSolver
    from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower

    t0 = time.time()
    tag = f"sptrsv.{shape_name}" + (".mp" if multi_pod else "")
    spec = {**SPTRSV_SHAPES[shape_name], **overrides}
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    # the JAX solve shards the batch over 'data' and replicates it over
    # 'pod': every pod computes the same thing, so the bind is on one pod
    if mesh_shape is None:
        mesh = make_production_mesh(devices=dev)
    else:
        mesh = make_mesh(mesh_shape, ("data", "model"), devices=dev)
    reported = ({"pod": 2, **dict(mesh.shape)} if multi_pod else dict(mesh.shape))
    chips = int(np.prod(list(reported.values())))
    k = mesh.shape["model"]
    batch = spec["batch"]

    if spec["kind"] == "er":
        L = erdos_renyi_lower(spec["n"], spec["p"], seed=1)
    else:
        L = narrow_band_lower(spec["n"], spec["p"], spec["band"], seed=1)
    shard = spec.get("shard", "model")
    t_plan = time.perf_counter()
    solver = TriangularSolver.plan(L, strategy="growlocal", k=k, backend="distributed",
                                   mesh=mesh, shard=shard, device=dev)
    plan_s = time.perf_counter() - t_plan
    info = solver.info()
    binding = info["binding"]
    ex = binding.get("exchange") or {}

    # the solve: NB's own values overflow float32, so it is timed and
    # checked on the same pattern with a dominant diagonal
    plan = solver.exec_plan
    values = "the cell's own"
    if spec["kind"] == "nb":
        plan = dataclasses.replace(plan, vals=plan.vals.copy(), diag=plan.diag.copy())
        plan.numeric_update(dominant_values(L))
        values = "the cell's pattern with a dominant diagonal (its own overflow float32)"
    be = get_backend("distributed")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_bind = time.perf_counter()
    bound = be.bind(plan, mesh=mesh, shard=shard, device=dev)
    sync()
    bind_s = time.perf_counter() - t_bind
    rng = np.random.default_rng(seed)
    rhs = torch.as_tensor(rng.standard_normal((plan.n, batch)), dtype=torch.float32).to(dev)
    d = bound.describe()
    want = d["launches_per_solve"]["mrhs" if batch > 1 else "single"]
    kind = "range_mrhs" if batch > 1 else "range_single"
    before = dict(sptrsv.launches)
    x = bound.solve(rhs)
    sync()
    counted = sptrsv.launches[kind] - before[kind] if dev.type == "cuda" else None
    if counted is not None and counted != want:
        raise RuntimeError(f"{tag}: {counted} range launches, describe() says {want}")
    t_ref = time.perf_counter()
    ref = get_backend("kernel").bind(plan, device=dev).solve(rhs)
    bitwise = bool(torch.equal(x.cpu().view(torch.int32), ref.cpu().view(torch.int32)))
    if not bitwise:
        raise RuntimeError(f"{tag}: the mesh solve != the kernel backend's answer")
    finite = bool(torch.isfinite(x).all())
    ref_s = time.perf_counter() - t_ref
    t_time = time.perf_counter()
    times = _solve_ms(lambda: bound.solve(rhs), dev, **TIMING)
    timing_s = time.perf_counter() - t_time
    ms = statistics.median(times)

    work = sptrsv_work(plan, 4, batch)  # float32
    coll = None if not ex else ex["comm_bytes_per_solve"] * batch
    terms = RooflineTerms(flops=work["ops"], bytes_accessed=work["bytes"],
                          collective_bytes=coll, chips=1, peak_flops=FP32_FLOPS)
    # the bound of the run measured here: every position is on this card,
    # so each exchanged byte is read and written once in its HBM
    card_bytes = work["bytes"] + 2 * (coll or 0)
    t_card = {"operations": terms.t_compute, "bytes": card_bytes / HBM_BW}
    roofline = {
        **terms.as_dict(),
        "basis": ("operations at fp32's 67 TFLOP/s (no tensor cores); the plan's real "
                  "entries and lane steps, b and x at 3.35 TB/s; t_collective_s and "
                  "dominant project the exchange bytes of the right-hand sides onto "
                  "NVLink's 450 GB/s each way, as if the positions were cards"),
        "card_bytes": card_bytes,
        "card_basis": ("bound_ms: the one card that ran it, the exchange bytes read and "
                       "written once in its HBM with the plan's bytes, against the "
                       "operations"),
        "bound_by": max(t_card, key=t_card.get),
        "bound_ms": max(t_card.values()) * 1e3,
    }
    result = {
        "cell": tag, "status": "OK", "mesh": reported, "chips": chips,
        "device": str(dev),
        "positions_on": f"{mesh.devices.size} positions on {dev}",
        "compile_s": round(time.time() - t0, 1),
        "plan_s": plan_s, "bind_s": bind_s, "reference_s": ref_s, "timing_s": timing_s,
        "roofline": roofline,
        "supersteps": solver.n_supersteps,
        "shard": binding.get("shard", "model"),
        "comm": {
            "mode": ex.get("mode"),
            "exchange_rounds": ex.get("rounds"),
            "comm_values_per_solve": ex.get("comm_values_per_solve"),
            "comm_bytes_per_solve": ex.get("comm_bytes_per_solve"),
            "halo_bytes_per_solve": ex.get("halo_bytes_per_solve"),
            "allgather_bytes": ex.get("allgather_bytes"),
            "halo_ratio": ex.get("halo_ratio"),
        },
        "plan": info["plan"],
        "binding": binding,
        "nnz": L.nnz,
        # useful flops: 2 per off-diagonal nnz + 1 divide per row
        "model_flops": float(2 * (L.nnz - L.n_rows) + L.n_rows) * batch,
        "rhs": batch,
        "solve_values": values,
        "launches_per_solve": want,
        "launches_counted": counted,
        "ms": ms, "ms_all": times,
        "ms_clock": "CUDA events" if dev.type == "cuda" else "host clock",
        "bound_share": roofline["bound_ms"] / ms if ms else None,
        "bitwise_vs_kernel_backend": bitwise, "x_finite": finite,
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
    }
    if probe is not None:
        t_probe = time.perf_counter()
        result["probe"] = probe(lambda: bound.solve(rhs))
        result["probe_s"] = time.perf_counter() - t_probe
    if multi_pod:
        result["multi_pod_note"] = ("bound on one 16x16 pod: the JAX solve shards the "
                                    "right-hand sides over 'data' and replicates them over "
                                    "'pod', so the two pods compute the same thing")
    if ex:
        print(f"    comm[{result['shard']}]: mode={ex.get('mode')} rounds={ex.get('rounds')} "
              f"bytes/solve={ex.get('comm_bytes_per_solve')} launches/solve={want} "
              f"ms={ms:.3f}", flush=True)
    _save(result, tag, save)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the SpTRSV cells run (default: the CUDA device; "
                         "'cpu' to run them on the CPU)")
    ap.add_argument(
        "--trace", metavar="PATH", default=None,
        help="trace the dry run with repro_torch.obs and write a Chrome "
             "trace_event JSON to PATH (the SpTRSV cells span the inspector "
             "and backend layers; the LM cells' counting is untraced)",
    )
    args = ap.parse_args(argv)

    trace_buf = None
    if args.trace:
        from repro_torch import obs

        trace_buf = obs.enable()
    try:
        _dispatch(args)
    finally:
        if trace_buf is not None:
            from repro_torch import obs

            obs.disable()
            obs.export_chrome_trace(args.trace, trace_buf)
            print(f"[trace: {len(trace_buf)} spans -> {args.trace}]", flush=True)


def _dispatch(args):
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                run_cell(arch, shape, multi_pod=args.multi_pod)
        for shape in SPTRSV_SHAPES:
            run_sptrsv_cell(shape, multi_pod=args.multi_pod, device=args.device)
        return
    assert args.arch and args.shape, "--arch and --shape (or --all)"
    if args.arch == "sptrsv":
        run_sptrsv_cell(args.shape, multi_pod=args.multi_pod, device=args.device)
    else:
        run_cell(args.arch, args.shape, multi_pod=args.multi_pod)


if __name__ == "__main__":
    main()
