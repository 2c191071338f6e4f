#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure ends the run with a non-zero exit:

  env        card name and power limit (nvidia-smi), torch, nvcc version
  build      compile every csrc/*.cu with nvcc for sm_90a, from the sources,
             one nvcc per source, all at once
  kernels    on ER and NB matrices of n=2,000, each kernel against its plain
             version run on the CPU, bitwise: the bulk SpTRSV kernels, both
             level walks of the bulk order (k in {8, 32}, width in {None,
             2}, single RHS and m in {5, 64, 300}, the latter a block per
             column; the largest ulp gap to the plain version run on the
             card is reported; and range launches over the bulk order cut
             at each superstep, one and m RHS, bitwise one full launch), the elastic kernels (the level walk over
             runs of slack supersteps; k in {8, 32}, slack in {1, 8},
             single RHS and m in {5, 64}; also bitwise-equal to the bulk
             plain version) and the SpMV kernel (ER, NB and a matrix with
             dense rows, width in {None, 2}, float32 and float64; also
             bitwise-equal to the padded-ELL product with the split rows
             summed in order, the definition it keeps)
  main_path  the paper's synthetic sets at n=100,000 (§6.2.4 ER p=1e-4,
             §6.2.5 NB p=0.14 B=10, seed 0; NB with a dominant diagonal, as
             its own values overflow float32): TriangularSolver.plan(L) with
             every default (cuda, growlocal, k=8, kernel backend), solve b
             f[n] and B f[n, 32], numeric_update, solve again, then
             factor_pair on IC(0) of a 128x128 Poisson grid; every answer
             bitwise-equal to the plain version on the CPU
  main_path_elastic   TriangularSolver.plan(L, mode="elastic") on the same
             matrices, the same b, B and numeric_update: every answer
             bitwise-equal to the bulk answers above; the barrier counts
             (supersteps, the elastic level order's levels, and the
             certificate's readiness waves the TPU kernel walks)
  validate   the static verifier on the card path (repro_torch.analysis):
             TriangularSolver.plan(L, validate="full") on the same
             matrices, bulk and mode="elastic", each on a fresh PlanCache;
             the same b, B, numeric_update, b, B: every answer bitwise the
             unvalidated main path's, one launch a solve; the host seconds
             of compile_plan, full and (REPRO_VALIDATE=fast, no argument)
             fast verification, level_order and the level check of the
             bound order, fast over compile; no finding; then a bind whose
             level order carries a levels mutation (levels_shift_run) is
             refused with VerificationError before any launch
  main_path_spmv      spmv(L, x) on the same matrices, against scipy in f64
             and bitwise the CPU plain version; one launch a call
  strategies the seven scheduling strategies on the same matrices:
             TriangularSolver.plan(L, strategy=s) with every other default,
             solve b and B f[n, 32], each answer bitwise the same plan bound
             on the CPU scan backend (the plan's steps; on the serial plans
             the CPU kernel backend, the level walk's plain version, bitwise
             the step walk) and within 1e-5 of scipy in f64
             (relative, in norm); the plan's host seconds, supersteps, T, W,
             bsp_cost (from the plan's rows), levels (= block barriers) and
             the widest level, kernel ms single and m = 32 (CUDA events, 3
             warm-ups, median of 20); the CPU plain versions of this phase
             and the next run in two spawned worker processes while the
             card's plans are made
  main_path_auto      TriangularSolver.plan(L, strategy="auto") on the same
             matrices: the Selection (regime, pick, slack, candidates' costs,
             equal to the strategies phase's bsp_cost) equal to the CPU scan
             plan's, answers bitwise that plan's (the elastic kernels launch
             on NB); a second auto plan on the same PlanCache selects
             nothing; then, on NB only (host time), tune=True on the card
             (the trials' ms, the slack sweep, the clock's pick beside the
             model's, the tuned answer bitwise a CPU scan plan of the tuned
             pick)
  pcg        pcg_ichol(A, b, k=8, strategy="growlocal", tol=1e-6,
             maxiter=2000) on the 512x512
             Poisson grid (n=262,144; IC(0) factor of 785,408 entries),
             float32, kernel backend, b from --seed: recurrence relres
             < 1e-6, true residual (float64, host) < 1e-4, fewer iterations
             than plain CG on the card, launch counts exact (2(iters+1)
             single-RHS solves, iters SpMVs: one launch a matvec), a second
             request through the
             same PlanCache plans nothing; bwd(fwd(r)) and the matvec
             bitwise their CPU plain versions; at 64x64 the card's PCG
             against the CPU plain PCG (float64 iterations equal, float32
             within one, x within 1e-3). Reports the host seconds of IC(0)
             and of each plan, wall seconds, ms per iteration (CUDA events)
             beside its byte bound, fwd, bwd and matvec ms per launch (fwd
             and bwd also with L2 emptied before each launch), and
             a torch.profiler window of 20 iterations (device time by
             kernel, the device's idle share)
  serve      the batching solve service (repro_torch.serve.SolveService,
             kernel backend) at n=100,000, each mode a closed loop of 8
             clients x 25 requests (the CLI's defaults), prewarmed, every
             b drawn before the window, so the clients only submit:
             microbatch on ER and NB registered through main_path_auto's
             PlanCache (no plan built; NB's elastic pick on the elastic
             m-RHS kernel) with a numeric_update of ER mid-stream;
             width-class batching on shifted_coupling_lower(n, j, stride=8,
             seed=j), j = 0..5, wavefront (one width class, a bank of 8
             lanes); continuous mode, 32 slots, on the same family. Each
             mode: requests served, throughput, p50/p99 latency
             (ServeMetrics), dispatch widths, bank rebuilds, launches by
             kind (banked traffic only on the bank kernel), every result
             bitwise its direct_reference / GroupReplay on the card and a
             sample of 64 bitwise the CPU plain version (solved together);
             the device's idle share in a second, profiled loop of the same
             requests; the host seconds of update_values on the card. Then
             the bank kernel on 8 distinct-valued clones of ER's plan at
             m = 32, every lane used: bitwise its CPU plain version, timed
             beside the cols kernel on one of those plans and the library
             (torch.triangular_solve on the clones' block diagonal as
             sparse CSR, B [8n, 4]: the same x)
  distributed  the distributed backend on meshes of card positions, every
             position on cuda:0 (repro_torch.mesh.make_mesh): the main
             path's ER and NB plans (growlocal, k=8, n=100,000, after its
             numeric_update) bound straight through
             get_backend("distributed").bind: shard="rows" on mesh (1, 8)
             at slack 0 and 8 with b f[n], and on (2, 4) with B f[n, 32];
             shard="model" on (1, 8) with b and with B. Each answer bitwise
             the kernel backend's on the same plan and the same binding on
             a CPU mesh (the plain version); describe()["exchange"] equal
             to the CPU binding's; solve_timed one step per round, bitwise
             solve; update_values bitwise a fresh bind (slack 0, b, one per
             shard mode). Reports the range launches per solve (equal to
             describe()["launches_per_solve"]: rounds x positions with
             work), ms per solve (CUDA events, 3 warm-ups, median of 10)
             beside the kernel backend's, the per-round µs, halo_ratio and
             halo bytes, bind seconds. Then one front-door
             TriangularSolver.plan(ER, backend="distributed", mesh (2, 4),
             shard="rows", validate="fast") (answers bitwise the main
             path's initial ones) and SolveService on its PlanCache with
             the same mesh: 4 clients x 10 requests, batch_align 2, every
             result bitwise its direct_reference
             Each main-path phase sets the launch counters to 0 just before
             it and reads them just after; its kernels must have launched.
  lm_serve   the LM stack's serving path (repro_torch.launch.serve.serve) at
             full width: granite-3-2b, 40 layers, d_model 2,048, vocab 49,155
             padded to 51,200, float32 weights from --seed, batch 4, prompt
             64, 32 new tokens (one prefill, 31 greedy decode steps) on the
             card: every logit finite, every token in [0, 49155); the
             decode step at position 64 against a fresh prefill over the
             prompt and that token (max |gap| <= 1e-3 max |logit|); the
             first 2 layers at full width (each leaf's std as in the 40-layer
             stack), made on the CPU and carried to the card with
             lm_params_from_numpy, prefill and 4 teacher-forced decode steps
             on both (the same bound; greedy tokens equal where the CPU's
             top-2 margin exceeds it; TF32 off). Reports prefill ms (first
             call and warm, median of 5) and decode ms per token (median of
             31 steps) beside their bounds (prefill: operations at fp32's
             67 TFLOP/s; decode: every weight but the embedding and the KV
             read once at 3.35 TB/s), peak memory, parameter and cache
             bytes, and a torch.profiler window of 8 decode steps (the
             device's idle share by the union of its events, kernel launch
             calls and device events per step, the top 5 device operations)
  lm_families  the MoE, RWKV-6 and RG-LRU hybrid families the same way, one
             model at a time, each at full width and depth through serve():
             deepseek-moe-16b (28 layers, 64 routed experts top-6 and 2
             shared; 16.88B parameters, 67.5 GB), rwkv6-7b (32 layers,
             chunked WKV; 30.1 GB), recurrentgemma-2b (8 superblocks and 2
             tail layers, local window 2,048; 14.2 GB). Before each, the
             card is freed (gc, empty_cache) and must have room for the
             parameters (mem_get_info); nothing cuts a depth. Decode at
             position 64 against a fresh prefill (rwkv6, recurrentgemma;
             max |gap| <= 1e-3 max |logit|); for deepseek, which routes a
             prefill a group a sequence (capacity 7) and a decode step as
             one group of the batch (capacity 4), so that the two are
             different functions, each layer's dropped assignments and
             distinct experts reached in prefill and in one decode step.
             The card against the CPU on the cut (2 layers; the hybrid's
             first superblock and 2 tail layers), for deepseek the routing
             first: a sequence's logits are held while its top-6 experts
             agree on every layer, and tokens whose 6th and 7th router
             probabilities lie within 1e-5 are listed. Prefill and decode
             ms beside their bounds (deepseek's decode: the all-expert
             einsums' read and the experts one step's routing reaches),
             peak memory, a profiled window of 8 decode steps
  lm_frontends  the encoder-decoder family and the frontend stubs the same
             way, one model at a time at full width and depth through
             serve(): seamless-m4t-large-v2 (24 encoder layers over the
             16 projected audio frames of a 64-token prompt, 24 decoder
             layers with cross-attention, vocab 256,206 padded to 258,048;
             2.04B parameters, 8.16 GB) and llava-next-mistral-7b (32
             layers, 32 projected patches ahead of 32 tokens; 7.26B, 29.06
             GB). Decode at position 64 against a fresh prefill over the
             same frames or patches and the tokens with that token appended;
             the card against the CPU on the cut (2 layers; seamless's 2
             encoder and 2 decoder layers). Bounds count what each step
             reads: a decode step neither the encoder, nor frontend_proj,
             nor the cross-attention's wk / wv (it reads their cached k / v).
             Then llava at the published anyres size, batch 1 and 5,760
             positions (2,880 patches, 2,880 tokens): a first prefill, 3
             warm (median), 4 greedy decode steps, the first against a
             fresh prefill of 5,761 positions; its attention chunk is the
             largest divisor of the positions up to attn_kv_chunk (960 and
             823: the chunked attention takes whole chunks, in JAX as
             well). Prefill ms beside its bound, peak memory
  lm_train   the training path (repro_torch.train, float32, TF32 off; no
             kernel of its own): (a) every reduced config, one
             make_train_step (2 microbatches, batch 4, 64 positions) on the
             card and on the CPU from the same parameters and batch: the
             loss, grad_norm and every gradient leaf within rtol 1e-4, atol
             1e-4 x max|leaf| plus twice the CPU's own spread (two draws
             of one-ulp nudged parameters; the hybrid also with a float32
             exp in the RG-LRU's decay), the largest gap per arch; (b) granite-3-2b at
             full width and depth through SyntheticLMData and
             make_train_step, batch 4, sequence 512, 2 microbatches, AdamW
             lr 1e-3, warmup 1, 4 steps: each step's loss and grad_norm
             (finite, the parameters moved), ms a step (CUDA events, median
             of steps 2-4, the first apart) beside its operation bound (the
             layers' matmuls and attention four times: forward, recompute,
             backward x2; the unembedding three times), peak memory, and
             the AdamW update alone (median of 3) beside its byte bound (p,
             g, m, v read, p, m, v written); (c) the reduced granite: one
             step twice from the same state (does the card repeat its
             bits?), 3 steps, an AsyncCheckpointer save, restore, step 4,
             against an uninterrupted step 4 (bitwise where the card
             repeats itself); (d) python -m repro_torch.launch.train
             --arch granite_3_2b --steps 20, reduced, on the card, then
             with --compress-grads
  dryrun     the port's dry run (repro_torch.launch.dryrun): the three
             SpTRSV cells (ER p=5e-5, NB p=0.14 B=10 with shard "model"
             and "rows"; n=100,000, seed 1, growlocal k=16) on a 16x16
             mesh of cuda:0 positions, 16 right-hand sides: each answer
             bitwise the kernel backend's, the range launches of a solve
             equal to describe()'s, ms a solve (CUDA events, 3 warm-ups,
             median of 10), the exchange rounds and bytes, the roofline
             terms, plan and bind seconds, a torch.profiler window of one
             solve on the ER and NB "model" cells (NB solved on its
             pattern with a dominant diagonal, as its own values overflow
             float32); granite-3-2b's
             train_4k, prefill_32k and decode_32k counted on meta; the
             counter on the card's tensors (lm_serve's prefill, batch 4,
             prompt 64, float32) equal op by op to its meta count, beside
             lm_work's operations
  timing     CUDA events on the main-path plans: kernel (3 warm-ups, median
             of 20; the range kernels: the launches over the bulk order cut
             at each superstep, the same function as one full launch), plain version on the card (SpTRSV once, SpMV median of
             5), the library yardstick (torch.triangular_solve on a
             sparse-CSR L for SpTRSV, the sparse-CSR matvec for SpMV; never
             called by the port), and the byte/operation bound of the H100
             data sheet for the real entries (padding left out; the padded
             plan's byte bound and padding share are printed beside it).
             SpMV, on ER, NB and PCG's A: the whole product spmv() returns
             (EllOperator(A)(x)) eager, as the replay of a CUDA graph of one
             call and of 100 calls (per call), its device operations (the
             nodes of a CUDA graph that captures one call, read through the
             driver API), which must be one launch of the kernel, and its
             device time from torch.profiler over 200 eager calls (after
             200 traced and dropped), which must record no other operation;
             the same for L_csr @ x; the bound share and the layout's
             lane-idle share. The single-RHS
             line also reports the level order: its host seconds, levels,
             block barriers (one a chunk of a level) and the walk's stage
             layout (`staging`), widest level, the supersteps and the DAG's
             longest path beside them; the m-RHS line adds its column
             blocks and the time of the column-major copy of b that its
             call makes; the elastic lines report the levels
             of the order over runs of slack supersteps and its slack

then the ``kernels`` summary line (the path launches include those of the
validate, strategies, main_path_auto, pcg, serve, distributed and dryrun
phases), the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. It exits non-zero,
printing no result, without CUDA or outside a checkout of the repository.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, outside the tensor cores
# kernel name -> (TPU kernel it replaces, CUDA source of its entry point,
# launch counter, the kernel's body: file and function)
_LEVEL_1, _LEVEL_M = "level.cuh::sptrsv_level_kernel", "level.cuh::sptrsv_level_cols_kernel"
# a solve through the front door (TriangularSolver.solve) on the card is one
# launch of the ordered solve (the walk of _LEVEL_1 / _LEVEL_M between b's
# gather and x's scatter, one entry for the bulk and the elastic order),
# counted under these kinds
_ORDERED = "level.cuh::sptrsv_level_ordered_kernel"
KERNELS = {
    "sptrsv_single": ("src/repro/kernels/sptrsv.py:52", "sptrsv.cu", "ordered_single", _ORDERED),
    "sptrsv_mrhs": ("src/repro/kernels/sptrsv.py:98", "sptrsv.cu", "ordered_mrhs", _ORDERED),
    "sptrsv_elastic_single": (
        "src/repro/kernels/sptrsv.py:146", "sptrsv.cu", "elastic_ordered_single", _ORDERED),
    "sptrsv_elastic_mrhs": (
        "src/repro/kernels/sptrsv.py:232", "sptrsv.cu", "elastic_ordered_mrhs", _ORDERED),
    "spmv": ("src/repro/kernels/spmv.py:32", "spmv.cu", "spmv", "spmv.cu::spmv_sliced_kernel"),
    # the m-RHS kernel's banked launch: the serve layer's width-class grouping
    "sptrsv_bank": ("src/repro/kernels/sptrsv.py:98", "sptrsv.cu", "bank",
                    "level.cuh::sptrsv_level_bank_kernel"),
    # the bulk entries launched over a range of levels: the distributed
    # backend's exchange rounds, one launch per position and round
    "sptrsv_range_single": ("src/repro/kernels/sptrsv.py:52", "sptrsv.cu", "range_single",
                            _LEVEL_1),
    "sptrsv_range_mrhs": ("src/repro/kernels/sptrsv.py:98", "sptrsv.cu", "range_mrhs",
                          _LEVEL_M),
}
KERNEL_REPLACES = {name: k[0] for name, k in KERNELS.items()}
FRONT_DOOR = tuple(KERNELS[k][2] for k in (
    "sptrsv_single", "sptrsv_mrhs", "sptrsv_elastic_single", "sptrsv_elastic_mrhs"))
MAIN_M = 32
# a float32 solve against scipy's in float64: ||x - x64|| / ||x64||
RELERR_VS_SCIPY = 1e-5
LIBRARY_GAP = 1e-4  # a yardstick's answer against the kernel's: the same system solved
STRATEGIES = ("growlocal", "serial", "wavefront", "spmp", "hdagg", "funnel-gl", "block")
TWIN_WORKERS = 2  # processes that solve the strategies' plans on the CPU
# the pcg phase: poisson2d_matrix(512), (n, nnz(A), nnz(IC(0) factor))
PCG_GRID = 512
PCG_SIZES = (262_144, 1_308_672, 785_408)
PCG_TOL = 1e-6
PCG_MAXITER = 2000
# the serve phase: the CLI's closed loop, the width family, the slots
SERVE_CLIENTS = 8
SERVE_REQUESTS = 25
SERVE_SAMPLE = 64  # served results per mode held against the CPU plain version
SERVE_FAMILY = 6  # shifted_coupling_lower shifts: one width class, a bank of 8 lanes
SERVE_SLOTS = 32
# the distributed phase: (shard, mesh shape, slack, m) on cuda:0 positions
DIST_CONFIGS = (
    ("rows", (1, 8), 0, None),
    ("rows", (1, 8), 8, None),
    ("rows", (2, 4), 0, MAIN_M),
    ("model", (1, 8), 0, None),
    ("model", (1, 8), 0, MAIN_M),
)
DIST_CLIENTS, DIST_REQUESTS = 4, 10
# the lm_serve phase: granite-3-2b at full width through launch.serve.serve
LM_ARCH = "granite_3_2b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 64, 32
LM_REL = 1e-3  # logits: max |gap| <= LM_REL * max |logit|
LM_CHECK_LAYERS, LM_CHECK_STEPS = 2, 4  # the card against the CPU
LM_PROFILE_STEPS = 8
# the lm_families phase: one model of each other family at full width, in turn
LM_FAMILIES = ("deepseek_moe_16b", "rwkv6_7b", "recurrentgemma_2b")
# the lm_frontends phase: the encoder-decoder family and the vision frontend,
# then llava at the published anyres size (batch 1; 2,880 patches, 2,880 tokens)
LM_FRONTENDS = ("seamless_m4t_large_v2", "llava_next_mistral_7b")
ANYRES_ARCH, ANYRES_BATCH, ANYRES_STEPS = "llava_next_mistral_7b", 1, 4
# the lm_train phase: every reduced config card against CPU (batch 4, 64
# positions, 2 microbatches), granite-3-2b at full width (batch 4, sequence
# 512, 2 microbatches, AdamW lr 1e-3, warmup 1, 4 steps), a resume of the
# reduced granite after 3 steps, the train CLI
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 4, 64
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = "granite_3_2b", 4, 512, 2, 4
TRAIN_LR = 1e-3
TRAIN_UPDATE_REPS = 3
TRAIN_RESUME_AT = 3
TRAIN_CLI_STEPS = 20
MOE_NEAR_TIE = 1e-5  # a token's K-th and (K+1)-th router probabilities this close
# the runtime calls that launch a kernel, as torch.profiler names them
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx"}
T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj["elapsed_s"] = round(time.perf_counter() - T_START, 1)
    print(json.dumps(obj), flush=True)


def require(cond, msg) -> None:
    if not cond:
        raise RuntimeError(msg)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


def device_events(prof) -> list:
    """The device events of a ``torch.profiler`` run, summed by name,
    longest first: ``{"name", "count", "ms"}``."""
    events = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        events.append({"name": evt.key[:80], "count": evt.count, "ms": us / 1e3})
    return sorted(events, key=lambda e: -e["ms"])


def busy_union_ms(prof) -> float:
    """The device's busy time in a ``torch.profiler`` run: the union of its
    events' intervals, so that work on streams that overlap counts once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and not e.name.startswith("ProfilerStep"))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def profile_iterations(run, n_iter=20) -> dict:
    """``run(n_iter)`` (that many CG iterations) under ``torch.profiler``:
    the device time of each kernel, summed by name, and the device's busy
    time (``busy_union_ms``: the union of its events' intervals) against
    the elapsed time of CUDA events around the run, whence the device's
    idle share. The profiler slows the host, so the profiled iteration is
    slower than an unprofiled one; a profiler that records no device time
    gives ``device_busy_ms`` 0 (then read only ``ms_per_iter``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(2)  # warm-up outside the window
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0.record()
        run(n_iter)
        e1.record()
        e1.synchronize()
    elapsed = e0.elapsed_time(e1)
    kernels = device_events(prof)
    busy = busy_union_ms(prof)
    return {"iters": n_iter, "elapsed_ms": elapsed, "ms_per_iter": elapsed / n_iter,
            "device_busy_ms": busy, "kernel_ms_sum": sum(k["ms"] for k in kernels),
            "idle_share": 1.0 - busy / elapsed,
            "kernels": len(kernels), "launches": sum(k["count"] for k in kernels),
            "top": kernels[:10]}


def pcg_phase(args, dev, cuda_times, bitwise_equal, max_abs, main_err, card) -> dict:
    """IC(0)-preconditioned CG at full width on the card (see the module
    docstring); returns the phase's record, which it has emitted."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import obs
    from repro_torch.kernels import spmv, sptrsv
    from repro_torch.kernels.ops import level_plan_arrays
    from repro_torch.solver import cg_solve, pcg_ichol
    from repro_torch.solver.cg import _csr_matvec_fn
    from repro_torch.solver.executor import pad_rhs
    from repro_torch.sparse import ichol0, poisson2d_matrix

    def sync():
        torch.cuda.synchronize()

    A = poisson2d_matrix(PCG_GRID)
    n = A.n_rows
    t0 = time.perf_counter()
    lf = ichol0(A)
    ichol_s = time.perf_counter() - t0
    require((n, A.nnz, lf.nnz) == PCG_SIZES, f"pcg system: {(n, A.nnz, lf.nnz)}")
    rng = np.random.default_rng(args.seed)
    b1, b2, r = (rng.standard_normal(n) for _ in range(3))
    # float32, kernel backend, the card; GrowLocal, as in PRs 17-18 (pcg_ichol
    # defaults to "auto", which would schedule three candidates per factor)
    kw = dict(k=8, tol=PCG_TOL, maxiter=PCG_MAXITER, strategy="growlocal")
    cache = repro_torch.PlanCache()

    def request(b):
        """One pcg_ichol request, traced, its launch counters set to 0 just
        before it and read just after; checks the counts are exact."""
        buf = obs.TraceBuffer("pcg")
        sptrsv.reset_launches()
        spmv.reset_launches()
        t0 = time.perf_counter()
        with obs.tracing(buf):
            x, iters, relres, info = pcg_ichol(A, b, cache=cache, **kw)
        sync()
        wall = time.perf_counter() - t0
        launches = {**sptrsv.launches, **spmv.launches}
        # z0 = M(b), then one M(r) per iteration: two solves each, each one
        # launch of the ordered walk; one matvec per iteration
        want = {**{k: 0 for k in sptrsv.launches}, "ordered_single": 2 * (iters + 1),
                "spmv": iters}
        require(launches == want, f"pcg launches {launches}, want {want}")
        require(x.device.type == dev.type and x.dtype == torch.float32 and x.shape == (n,)
                and bool(torch.isfinite(x).all()), "pcg output")
        require(relres < PCG_TOL, f"pcg relres {relres} after {iters} iterations")
        true = float(np.linalg.norm(b - A.to_scipy() @ x.double().cpu().numpy())
                     / np.linalg.norm(b))
        require(true < 1e-4, f"pcg true residual {true} (float64, host)")
        return x, iters, relres, info, buf, wall, launches, true

    x1, iters1, relres1, info1, buf1, wall1, launches, true1 = request(b1)
    require(info1["cache"]["misses"] == 2 and info1["cache"]["hits"] == 0, f"{info1['cache']}")
    plan_s = [(sp.t1_ns - sp.t0_ns) / 1e9 for sp in buf1.spans() if sp.name == "cache.build"]
    require(len(plan_s) == 2, "the first request plans fwd and bwd")
    # a second request with a new b: the cache hits twice and plans nothing
    _, iters2, relres2, info2, buf2, wall2, _, true2 = request(b2)
    require(info2["cache"]["misses"] == 2 and info2["cache"]["hits"] == 2, f"{info2['cache']}")
    require(not [sp.name for sp in buf2.spans()
                 if sp.name == "cache.build" or sp.name.startswith("inspector.")],
            "the second request planned")

    # plain CG on the card takes more iterations
    t0 = time.perf_counter()
    _, cg_iters, cg_relres = cg_solve(A, b1, tol=PCG_TOL, maxiter=5000)
    sync()
    cg_wall = time.perf_counter() - t0
    require(iters1 < cg_iters, f"pcg {iters1} iterations, plain cg {cg_iters}")

    # one preconditioner application, bitwise the CPU plain version's
    fwd, bwd = repro_torch.factor_pair(lf, k=8, cache=cache)  # the requests' pair
    t0 = time.perf_counter()
    fwd_c, bwd_c = repro_torch.factor_pair(lf, k=8, backend="scan", device="cpu")
    cpu_plan_s = time.perf_counter() - t0
    z = bwd(fwd(r))
    sync()
    z_c = bwd_c(fwd_c(r))
    require(bitwise_equal(z, z_c), "bwd(fwd(r)) != CPU plain version")
    main_err["sptrsv_single"] = max(main_err["sptrsv_single"], max_abs(z, z_c))
    # CG's matvec at this shape, against its plain version on the CPU
    op = _csr_matvec_fn(A, torch.float32, dev)
    xs = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    y = op(xs.to(dev))
    sync()
    y_c = _csr_matvec_fn(A, torch.float32, "cpu")(xs)
    require(bitwise_equal(y, y_c), "matvec != CPU plain version")
    main_err["spmv"] = max(main_err["spmv"], max_abs(y, y_c))

    # CG alone, CUDA events around it: ms per iteration
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    _, iters3, _ = cg_solve(A, b1, precond=lambda res: bwd(fwd(res)), tol=PCG_TOL,
                            maxiter=PCG_MAXITER)
    e1.record()
    e1.synchronize()
    cg_pass_wall = time.perf_counter() - t0
    ms_per_iter = e0.elapsed_time(e1) / iters3
    profiled = profile_iterations(lambda n_iter: cg_solve(
        A, b1, precond=lambda res: bwd(fwd(res)), tol=0.0, maxiter=n_iter))
    # the pieces of an iteration, timed alone at these shapes
    la_f = level_plan_arrays(fwd.exec_plan, device=dev)
    la_b = level_plan_arrays(bwd.exec_plan, device=dev)
    r_pad = pad_rhs(torch.as_tensor(r, dtype=torch.float32)).to(dev)
    xs = xs.to(dev)
    rt = torch.as_tensor(r, dtype=torch.float32, device=dev)

    def med(fn):
        return statistics.median(cuda_times(fn, 3, 20))

    fwd_ms = med(lambda: sptrsv.sptrsv_level_cuda(*la_f[:7], r_pad, chunks=la_f.chunks))
    bwd_ms = med(lambda: sptrsv.sptrsv_level_cuda(*la_b[:7], r_pad, chunks=la_b.chunks))
    # the same launches with L2 emptied before each (a write of twice its
    # 50 MB), as a solve inside CG may find it after the other factor,
    # A and the vectors have passed through
    flush = torch.empty(100 * 2**20 // 4, dtype=torch.float32, device=dev)

    def cold(fn, reps=20):
        out = []
        for _ in range(reps):
            flush.fill_(1.0)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out)

    fwd_cold_ms = cold(lambda: sptrsv.sptrsv_level_cuda(*la_f[:7], r_pad, chunks=la_f.chunks))
    bwd_cold_ms = cold(lambda: sptrsv.sptrsv_level_cuda(*la_b[:7], r_pad, chunks=la_b.chunks))
    del flush
    spmv_ms = med(lambda: op(xs))  # the matvec: one launch of the SpMV kernel
    precond_ms = med(lambda: bwd(fwd(rt)))  # the front door: gathers included
    # per-iteration bound: L read twice (fwd, bwd), A once (value, column,
    # row pointers, 4 bytes each), and the CG vectors of a fused
    # iteration: p read, Ap written (matvec); x, p, r, Ap read, x, r
    # written (updates); r read, y written, y read, z written (the
    # solves); z, p read, p written: 15 vectors of n floats
    l_bytes = lf.nnz * 8 + (n + 1) * 4
    a_bytes = A.nnz * 8 + (n + 1) * 4
    vec_bytes = 15 * n * 4
    bound_us = (2 * l_bytes + a_bytes + vec_bytes) / HBM_BYTES_PER_S * 1e6

    # a small grid: the card's PCG against the CPU plain PCG
    small = []
    A_s = poisson2d_matrix(64)
    b_s = rng.standard_normal(A_s.n_rows)
    for dtype in (torch.float64, torch.float32):
        xg, ig, rg, _ = pcg_ichol(A_s, b_s, dtype=dtype, **kw)
        # the CPU plain PCG: the kernels' plain versions (bitwise the scan's)
        xc, ic, rc, _ = pcg_ichol(A_s, b_s, dtype=dtype, device="cpu", **kw)
        xg, xc = xg.cpu().double().numpy(), xc.double().numpy()
        # the dots reduce in another order on the card: float64 counts
        # equal, float32 within one
        same_iters = abs(ig - ic) <= (0 if dtype == torch.float64 else 1)
        close = bool(np.allclose(xg, xc, rtol=1e-3, atol=1e-3 * np.abs(xc).max()))
        small.append({"dtype": str(dtype).replace("torch.", ""), "iters": ig, "iters_cpu": ic,
                      "relres": rg, "relres_cpu": rc,
                      "max_rel_gap": float(np.abs(xg - xc).max() / np.abs(xc).max())})
        require(same_iters and close, f"pcg card vs CPU plain at 64x64: {small[-1]}")

    rec = {"phase": "pcg", "grid": PCG_GRID, "n": n, "nnz_A": A.nnz, "nnz_L": lf.nnz,
           "seed": args.seed, "dtype": "float32", "backend": "kernel", "k": 8,
           "tol": PCG_TOL, "ichol_s": ichol_s, "plan_s": {"fwd": plan_s[0], "bwd": plan_s[1]},
           "inspector_s": {"fwd": fwd.inspector_seconds, "bwd": bwd.inspector_seconds},
           "cpu_plain_pair_plan_s": cpu_plan_s,
           "iters": iters1, "relres": relres1, "true_relres_f64": true1,
           "pcg_wall_s": wall1, "second_request": {
               "iters": iters2, "relres": relres2, "true_relres_f64": true2,
               "pcg_wall_s": wall2, "cache": info2["cache"]},
           "cg_iters": cg_iters, "cg_relres": cg_relres, "cg_wall_s": cg_wall,
           "cg_pass": {"iters": iters3, "wall_s": cg_pass_wall},
           "ms_per_iter": ms_per_iter, "profile": profiled,
           "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "spmv_ms": spmv_ms,
           "l2_flushed": {"fwd_ms": fwd_cold_ms, "bwd_ms": bwd_cold_ms},
           "precond_ms": precond_ms, "spmv_lane_idle_share": op.lane_idle_share,
           "rest_ms": ms_per_iter - fwd_ms - bwd_ms - spmv_ms,
           "levels": {"fwd": fwd.bound.describe()["n_levels"],
                      "bwd": bwd.bound.describe()["n_levels"]},
           "supersteps": {"fwd": fwd.n_supersteps, "bwd": bwd.n_supersteps},
           "bound_us_per_iter": bound_us, "bound_by": "bytes",
           "bound_bytes": {"L_twice": 2 * l_bytes, "A": a_bytes, "vectors": vec_bytes},
           "launches": launches, "bitwise_precond_vs_cpu_plain": True,
           "bitwise_matvec_vs_cpu_plain": True, "small_grid_vs_cpu_plain": small, **card}
    emit(rec)
    return rec


def kernel_ms(solver, m, cuda_times) -> float:
    """Median ms of the solver's kernel alone on a right-hand side of m
    columns (None: one), CUDA events, 3 warm-ups, median of 20: the level
    arrays the bound solve reads, the bulk or the elastic wrapper."""
    import torch

    from repro_torch.kernels import sptrsv

    la = solver.bound._la
    fn = sptrsv.sptrsv_elastic_cuda if solver.info()["mode"] == "elastic" else \
        sptrsv.sptrsv_level_cuda
    n = solver.n
    b_pad = torch.randn((n + 1,) if m is None else (n + 1, m),
                        generator=torch.Generator().manual_seed(7)).to(solver.device)
    return statistics.median(cuda_times(lambda: fn(*la[:7], b_pad, chunks=la.chunks), 3, 20))


def level_shape(solver) -> dict:
    """The level order a kernel solve walks: its levels (one block barrier
    each) and its widest level."""
    ptr = solver.bound._la.level_ptr.cpu()
    return {"levels": int(ptr.numel() - 1), "level_width_max": int((ptr[1:] - ptr[:-1]).max())}


def plan_bsp_cost(solver, L, barrier=500.0) -> float:
    """The §2.2 BSP cost of the schedule behind ``solver``'s plan, read off
    the plan: each row finishes once (its last piece), at its superstep and
    lane, with its row's nnz as weight; the plan's row r is the caller's row
    ``perm[r]``. Equal to ``bsp_cost`` of the schedule (integer weights sum
    exactly), without scheduling again."""
    import numpy as np

    plan = solver.exec_plan
    t, lane = np.nonzero((plan.row_ids < plan.n) & ~plan.accum)
    step = np.searchsorted(plan.step_bounds, t, side="right") - 1
    w = np.diff(L.indptr)[solver._perm.cpu().numpy()[plan.row_ids[t, lane]]]
    loads = np.zeros((plan.n_supersteps, plan.k))
    np.add.at(loads, (step, lane), w)
    return float(loads.max(axis=1).sum() + barrier * plan.n_supersteps)


def twin_args(solver, backend="scan") -> dict:
    """What binds ``solver``'s own plan anew on the CPU (see ``cpu_twin``):
    plain data, which a worker process can take."""
    return dict(exec_plan=solver.exec_plan, total_perm=solver._perm.cpu().numpy(),
                backend=backend, dtype=solver.dtype, fingerprint=solver.fingerprint,
                strategy=solver.strategy, lower=solver.lower)


def cpu_twin(solver, backend="scan"):
    """``solver``'s own plan bound on the CPU, the plain version of every
    kernel: the same rows, order and values, with no second schedule. On
    the ``scan`` backend it runs the plan's steps; on the ``kernel`` backend
    the level walk's plain version (``sptrsv_level_ref``, bitwise the
    steps), one pass per level instead of per step."""
    import torch

    import repro_torch

    return repro_torch.TriangularSolver(**twin_args(solver, backend),
                                        device=torch.device("cpu"), inspector_seconds=0.0)


def twin_worker_init(src: str) -> None:
    sys.path.insert(0, src)


def twin_pool():
    """Worker processes for the CPU plain versions of the card's plans
    (spawned: the parent holds a CUDA context)."""
    return ProcessPoolExecutor(TWIN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=twin_worker_init, initargs=(str(ROOT / "src"),))


def scan_plan_solves(L, rhs_list, **plan_kw) -> tuple:
    """In a worker process: ``TriangularSolver.plan(L, device="cpu",
    backend="scan", **plan_kw)``, its Selection (a dict, or None), its
    answers (numpy) to ``rhs_list`` and the seconds of the plan."""
    import torch

    import repro_torch

    t0 = time.perf_counter()
    cpu = repro_torch.TriangularSolver.plan(L, device=torch.device("cpu"), backend="scan",
                                            **plan_kw)
    plan_s = time.perf_counter() - t0
    sel = None if cpu.selection is None else cpu.selection.as_dict()
    return sel, [cpu.solve(rhs).numpy() for rhs in rhs_list], plan_s


def twin_solves(args: dict, rhs_list) -> tuple:
    """In a worker process: the answers (numpy) of the solver that
    ``twin_args`` describes, bound on the CPU, to ``rhs_list``, and the
    seconds of those solves."""
    import torch

    import repro_torch

    twin = repro_torch.TriangularSolver(**args, device=torch.device("cpu"),
                                        inspector_seconds=0.0)
    t0 = time.perf_counter()
    out = [twin.solve(rhs).numpy() for rhs in rhs_list]
    return out, time.perf_counter() - t0


def scipy_refs(mats, inputs) -> dict:
    """scipy's float64 solves of b and B, per matrix."""
    import scipy.sparse.linalg as spla

    out = {}
    for name, L in mats.items():
        b, B, _ = inputs[name]
        A = L.to_scipy().tocsr()
        out[name] = (spla.spsolve_triangular(A, b, lower=True),
                     spla.spsolve_triangular(A, B, lower=True))
    return out


def relerr(x, x64) -> float:
    import numpy as np

    xx = x.double().cpu().numpy()
    return float(np.linalg.norm(xx - x64) / np.linalg.norm(x64))


def strategies_phase(mats, inputs, refs, cuda_times, bitwise_equal, max_abs, main_err,
                     card, pool) -> dict:
    """Every registered strategy through the front door on the card (see
    the module docstring), the CPU plain versions in ``pool``'s workers;
    returns the phase's record, which it has emitted, with the launches of
    its solves."""
    import torch

    import repro_torch
    from repro_torch.kernels import sptrsv
    from repro_torch.pipeline import available_strategies

    require(sorted(STRATEGIES) == list(available_strategies()),
            f"strategies {available_strategies()}")
    rows, solvers, pending = [], [], []
    sptrsv.reset_launches()  # the phase's launches start here
    # the kernel's plain version on the same plan, on the CPU, in worker
    # processes while the next plans are made: the plan's steps; on the
    # serial plans (~100,000 steps, over 10 s each in the step loop) the
    # level walk (sptrsv_level_ref), bitwise the step walk
    for name, L in mats.items():
        b, B, _ = inputs[name]
        for strategy in STRATEGIES:
            t0 = time.perf_counter()
            gpu = repro_torch.TriangularSolver.plan(L, strategy=strategy)  # cuda, k=8
            plan_s = time.perf_counter() - t0
            require(gpu.strategy == strategy and gpu.info()["mode"] == "bsp"
                    and gpu.device.type == "cuda" and gpu.backend == "kernel",
                    f"{name} {strategy}: defaults")
            backend = "kernel" if strategy == "serial" else "scan"
            twin = pool.submit(twin_solves, twin_args(gpu, backend), [b, B])
            row = {"matrix": name, "strategy": strategy, "plan_s": plan_s,
                   **{key: gpu.info()["plan"][key]
                      for key in ("n_steps", "n_supersteps", "W", "k")},
                   **level_shape(gpu), "bsp_cost": plan_bsp_cost(gpu, L),
                   "cpu_plain": backend}
            xs = [gpu.solve(rhs) for rhs in (b, B)]
            torch.cuda.synchronize()
            pending.append((name, strategy, row, gpu, xs, twin))
    for name, strategy, row, gpu, xs, twin in pending:
        x_cpus, row["cpu_plain_s"] = twin.result()
        x64, X64 = refs[name]
        for kname, ref, x, x_cpu in zip(("sptrsv_single", "sptrsv_mrhs"), (x64, X64), xs,
                                        x_cpus):
            x_cpu = torch.from_numpy(x_cpu)
            require(bool(torch.isfinite(x).all()), f"{name} {strategy}: non-finite x")
            require(bitwise_equal(x, x_cpu),
                    f"{name} {strategy} {kname}: kernel != CPU plain version")
            main_err[kname] = max(main_err[kname], max_abs(x, x_cpu))
            err = relerr(x, ref)
            require(err < RELERR_VS_SCIPY, f"{name} {strategy} {kname}: relerr {err}")
            row["relerr_vs_scipy_f64" + ("" if kname == "sptrsv_single" else "_m32")] = err
        rows.append(row)
        solvers.append((row, gpu))
    launches = dict(sptrsv.launches)
    want = len(rows)
    require(launches["ordered_single"] == want and launches["ordered_mrhs"] == want
            and launches["elastic_ordered_single"] == launches["elastic_ordered_mrhs"] == 0,
            f"strategies launches {launches}, want {want} bulk solves of each shape")
    # the kernels alone, after the counters are read
    for row, gpu in solvers:
        row["ms"] = kernel_ms(gpu, None, cuda_times)
        row["ms_m32"] = kernel_ms(gpu, MAIN_M, cuda_times)
    rec = {"phase": "strategies", "m": MAIN_M, "rows": rows, "launches": launches,
           "bitwise_vs_cpu_plain": True, "relerr_limit": RELERR_VS_SCIPY, **card}
    emit(rec)
    return rec


def auto_phase(mats, inputs, refs, cuda_times, bitwise_equal, max_abs, main_err, card,
               strategy_rows, pool):
    """``strategy="auto"`` on the card, model-based and tuned (see the
    module docstring), the CPU scan plans in ``pool``'s workers; returns
    the phase's record, which it has emitted, with the launches of its
    solves and trials, and the PlanCache that holds the model-based
    plans."""
    import torch

    import repro_torch
    from repro_torch.kernels import sptrsv

    def pick(sel):
        return {"strategy": sel.strategy, "slack": sel.options.slack}

    rows = []
    # one PlanCache for both matrices: the serve phase registers them
    # through it and builds no second plan
    cache = repro_torch.PlanCache()
    # the CPU scan plans, made in worker processes while the card's are
    cpu_jobs = {name: pool.submit(scan_plan_solves, L, inputs[name][:2], strategy="auto")
                for name, L in mats.items()}
    sptrsv.reset_launches()  # the model-based path's launches start here
    for name, L in mats.items():
        b, B, _ = inputs[name]
        x64, X64 = refs[name]
        before = cache.stats.as_dict()
        t0 = time.perf_counter()
        gpu = repro_torch.TriangularSolver.plan(L, strategy="auto", cache=cache)
        plan_s = time.perf_counter() - t0
        cpu_sel, x_cpus, cpu_plan_s = cpu_jobs[name].result()
        sel = gpu.selection
        require(sel is not None and not sel.tuned and sel.as_dict() == cpu_sel,
                f"{name}: the card's Selection differs from the CPU scan plan's")
        require(gpu.strategy == sel.strategy and gpu.info()["slack"] == sel.options.slack,
                f"{name}: the plan is not the Selection's")
        # the shortlisted strategies at default options score what the
        # strategies phase measured
        for c in sel.candidates:
            r = [r for r in strategy_rows if r["matrix"] == name and r["strategy"] == c.strategy]
            if r and c.options.replace(slack=0) == repro_torch.ScheduleOptions():
                require(r[0]["bsp_cost"] == c.cost, f"{name} {c.strategy}: cost {c.cost}")
        row = {"matrix": name, "plan_s": plan_s, "cpu_plan_s": cpu_plan_s,
               "selection": sel.as_dict(), "mode": gpu.info()["mode"],
               "slack_unit": gpu.info()["slack_unit"], **level_shape(gpu),
               "n_supersteps": gpu.n_supersteps}
        for kname, rhs, ref, x_cpu in zip(("single", "m32"), (b, B), (x64, X64), x_cpus):
            x = gpu.solve(rhs)
            torch.cuda.synchronize()
            x_cpu = torch.from_numpy(x_cpu)
            require(bitwise_equal(x, x_cpu), f"{name} auto {kname}: != CPU scan plan")
            key = ("sptrsv_elastic_" if gpu.info()["mode"] == "elastic" else "sptrsv_") + (
                "single" if kname == "single" else "mrhs")
            main_err[key] = max(main_err.get(key, 0.0), max_abs(x, x_cpu))
            err = relerr(x, ref)
            require(err < RELERR_VS_SCIPY, f"{name} auto {kname}: relerr {err}")
            row["relerr_vs_scipy_f64_" + kname] = err
        # a second plan on the same PlanCache: no selection work, no plan
        t0 = time.perf_counter()
        again = repro_torch.TriangularSolver.plan(L, strategy="auto", cache=cache)
        row["second_plan_s"] = time.perf_counter() - t0
        st = {k: v - before[k] for k, v in cache.stats.as_dict().items()}  # this matrix's
        require(again is gpu and st["selections"] == 1 and st["selection_hits"] == 1
                and st["misses"] == 1 and st["hits"] == 1, f"{name}: second auto plan: {st}")
        row["cache"] = st
        rows.append((row, gpu))
    model_launches = dict(sptrsv.launches)
    nb_mode = [r for r, _ in rows if r["matrix"] == "nb"][0]["mode"]
    require(nb_mode == "elastic" and model_launches["elastic_ordered_single"] > 0
            and model_launches["elastic_ordered_mrhs"] > 0,
            f"auto on NB: mode {nb_mode}, launches {model_launches}")

    sptrsv.reset_launches()  # the measured trials' launches start here
    tuned_solvers = []
    # measured trials on NB only: on ER they add half a minute of host time
    # (PERF.md §6, PR 19)
    tuned_rows = [r for r in rows if r[0]["matrix"] == "nb"]
    for row, gpu in tuned_rows:
        name = row["matrix"]
        L = mats[name]
        b, B, _ = inputs[name]
        cache_t = repro_torch.PlanCache()
        t0 = time.perf_counter()
        tuned = repro_torch.TriangularSolver.plan(L, strategy="auto", tune=True, cache=cache_t)
        tune_s = time.perf_counter() - t0
        ts = tuned.selection
        require(ts.tuned and ts.timings and ts.slack_timings, f"{name}: tune=True {ts}")
        require(tuned.device.type == "cuda" and tuned.backend == "kernel", f"{name}: tuned")
        # the tuned answer, bitwise a CPU scan plan of the tuned pick (made
        # in a worker process while the second plan is)
        ref = pool.submit(scan_plan_solves, L, [b, B], strategy=ts.strategy,
                          options=ts.options)
        t0 = time.perf_counter()
        again = repro_torch.TriangularSolver.plan(L, strategy="auto", tune=True, cache=cache_t)
        second_s = time.perf_counter() - t0
        for rhs, x_cpu in zip((b, B), ref.result()[1]):
            x = tuned.solve(rhs)
            torch.cuda.synchronize()
            require(bitwise_equal(x, torch.from_numpy(x_cpu)), f"{name}: tuned != CPU scan plan")
        require(again is tuned and cache_t.stats.selections == 1
                and cache_t.stats.selection_hits == 1, f"{name}: second tuned plan")
        model = pick(gpu.selection)
        clock = pick(ts)
        row["tuned"] = {
            "tune_s": tune_s, "second_plan_s": second_s,
            "timings_ms": [(s, sec * 1e3) for s, sec in ts.timings],
            "slack_timings_ms": [(s, sec * 1e3) for s, sec in ts.slack_timings],
            "model_pick": model, "clock_pick": clock, "clock_differs": model != clock,
            "strategy_differs": model["strategy"] != clock["strategy"],
            "bitwise_vs_cpu_scan": True}
        tuned_solvers.append(tuned)
    tuned_launches = dict(sptrsv.launches)
    require(sum(tuned_launches.values()) > 0, "the trials launched no kernel")
    # the kernels alone, after the counters are read
    for row, gpu in rows:
        row["ms"] = kernel_ms(gpu, None, cuda_times)
        row["ms_m32"] = kernel_ms(gpu, MAIN_M, cuda_times)
    for (row, _), tuned in zip(tuned_rows, tuned_solvers):
        row["tuned"]["ms"] = kernel_ms(tuned, None, cuda_times)
        row["tuned"]["ms_m32"] = kernel_ms(tuned, MAIN_M, cuda_times)
    rec = {"phase": "main_path_auto", "matrices": [r for r, _ in rows],
           "plan_cache": cache.stats.as_dict(),
           "tune_matrices": [r["matrix"] for r, _ in tuned_rows],
           "launches": {"model": model_launches, "tune_and_checks": tuned_launches},
           "bitwise_vs_cpu_scan": True, "relerr_limit": RELERR_VS_SCIPY, **card}
    emit(rec)
    return rec, cache


def validate_phase(mats, inputs, answers, bitwise_equal, card) -> dict:
    """The ``validate`` phase (see the module docstring): plans ER and NB
    with ``validate="full"``, bulk and elastic, each on a fresh
    ``PlanCache``, solves the main path's b, B, ``numeric_update`` and b,
    B again, every answer bitwise the unvalidated main path's with one
    launch a solve; the verifier's host seconds from the obs spans; then
    ``REPRO_VALIDATE=fast`` with no argument, and a bind whose level order
    carries a ``levels`` mutation, which must raise before any launch.
    Returns the phase's record, which it has emitted."""
    import os

    import numpy as np
    import torch

    import repro_torch
    from repro_torch import analysis, obs
    from repro_torch.analysis import mutate
    from repro_torch.kernels import ops, sptrsv
    from repro_torch.kernels.levels import level_order
    from repro_torch.pipeline import PlanCache

    def spans_s(buf, name):
        return [(sp.t1_ns - sp.t0_ns) / 1e9 for sp in buf.spans() if sp.name == name]

    def traced_plan(L, **kw):
        """Plan on a fresh cache under a trace: (solver, seconds, buffer)."""
        buf = obs.TraceBuffer("validate")
        t0 = time.perf_counter()
        with obs.tracing(buf):
            s = repro_torch.TriangularSolver.plan(L, cache=PlanCache(), **kw)
        return s, time.perf_counter() - t0, buf

    sptrsv.reset_launches()  # the validated paths' launches start here
    rows, findings = [], 0
    for name, L in mats.items():
        b, B, new_data = inputs[name]
        row = {"matrix": name, "n": L.n_rows}
        for mode in ("bsp", "elastic"):
            s, plan_s, buf = traced_plan(L, validate="full", mode=mode)
            counters = buf.counters()
            require(counters.get("analysis.verifications") == 2,
                    f"{name} {mode}: validate='full' did not verify build and bind")
            findings += counters.get("analysis.findings", 0)
            for stage in ("initial", "numeric_update"):
                if stage == "numeric_update":
                    s.numeric_update(new_data)
                for kname, rhs in (("sptrsv_single", b), ("sptrsv_mrhs", B)):
                    x = s.solve(rhs)
                    torch.cuda.synchronize()
                    require(bitwise_equal(x, answers[(name, stage, kname)]),
                            f"{name} {mode} {stage} {kname}: validated != unvalidated")
            tag = "" if mode == "bsp" else "elastic_"
            row[f"{tag}plan_s"] = round(plan_s, 3)
            row[f"{tag}level_check_full_s"] = spans_s(buf, "analysis.verify.levels")[0]
            if mode == "bsp":
                row["compile_plan_s"] = spans_s(buf, "inspector.compile_plan")[0]
                row["verify_full_s"] = spans_s(buf, "analysis.verify")[0]
                t0 = time.perf_counter()
                order = level_order(s.exec_plan)
                row["level_order_s"] = time.perf_counter() - t0
                held = s.bound._la.order
                require(all(np.array_equal(getattr(order, f), getattr(held, f))
                            for f in ("perm", "vert_ptr", "level_ptr", "level_run")),
                        f"{name}: the bound level order is not level_order(plan)")
                row["levels"] = order.n_levels
        # REPRO_VALIDATE=fast with no argument verifies, build and bind
        before = os.environ.get("REPRO_VALIDATE")
        os.environ["REPRO_VALIDATE"] = "fast"
        try:
            _, _, buf = traced_plan(L)
        finally:
            if before is None:
                del os.environ["REPRO_VALIDATE"]
            else:
                os.environ["REPRO_VALIDATE"] = before
        require(buf.counters().get("analysis.verifications") == 2,
                f"{name}: REPRO_VALIDATE=fast did not verify")
        findings += buf.counters().get("analysis.findings", 0)
        row["verify_fast_s"] = spans_s(buf, "analysis.verify")[0]
        row["level_check_fast_s"] = spans_s(buf, "analysis.verify.levels")[0]
        row["fast_over_compile"] = row["verify_fast_s"] / row["compile_plan_s"]
        rows.append(row)
    launches = dict(sptrsv.launches)
    per_kind = 2 * len(mats)  # before and after numeric_update, as unvalidated
    for kind in FRONT_DOOR:
        require(launches[kind] == per_kind,
                f"validated {kind} launches {launches[kind]}: one a solve")
    require(findings == 0, f"{findings} findings on pristine plans")

    # the gate on the card path: a bind whose level order carries a
    # structural mutation is refused before any launch
    real = ops.level_order

    def shifted(plan, slack=1):
        order = real(plan, slack)
        art = analysis.Artifacts(L=None, sched=None, plan=plan, levels=order)
        return mutate.levels_shift_run(art, np.random.default_rng(0)).levels

    ops.level_order = shifted
    try:
        raised = None
        try:
            repro_torch.TriangularSolver.plan(mats["nb"], validate="fast", cache=PlanCache())
        except analysis.VerificationError as e:
            raised = e.report.codes()
    finally:
        ops.level_order = real
    require(raised is not None, "a mutated level order was not refused")
    require(dict(sptrsv.launches) == launches, "the refused bind launched a kernel")
    rec = {"phase": "validate", "matrices": rows, "launches": launches, "findings": findings,
           "bitwise_vs_unvalidated": True, "mutated_order_refused": list(raised),
           "mutation": "levels_shift_run", **card}
    emit(rec)
    return rec


def superstep_ranges(order):
    """The level ranges of the bulk order cut at each superstep: the range
    launches of one position of a mesh whose rounds are the supersteps."""
    import numpy as np

    from repro_torch.kernels.levels import round_ranges

    return [int(v) for v in round_ranges(order, np.arange(int(order.level_run.max()) + 2))]


def distributed_phase(solvers, mats, inputs, cuda_times, bitwise_equal, max_abs, main_err,
                      card, dev) -> dict:
    """The distributed backend on meshes of cuda:0 positions (see the
    module docstring); returns the phase's record, which it has emitted,
    with the launches of its path: those of the checked solves (one per
    configuration, the front door's two and the served requests), not of
    the timing, profiling and update checks' solves."""
    import threading

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.backends import get_backend
    from repro_torch.kernels import sptrsv
    from repro_torch.mesh import make_mesh
    from repro_torch.pipeline import PlanCache
    from repro_torch.serve import SolveService, direct_reference

    t_phase = time.perf_counter()
    be = get_backend("distributed")
    sptrsv.reset_launches()  # the distributed path's launches start here
    path = {"range_single": 0, "range_mrhs": 0}

    def tally(before):
        for k in path:
            path[k] += sptrsv.launches[k] - before[k]

    rows = []
    for name, solver in solvers.items():
        plan = solver.exec_plan  # after the main path's numeric_update
        b, B, _ = inputs[name]
        # plan row order on the card: what a bound solve takes
        rhs = {m: torch.as_tensor(v, dtype=torch.float32, device=dev)[solver._perm]
               for m, v in ((None, b), (MAIN_M, B))}
        ref = {m: solver.bound.solve(r) for m, r in rhs.items()}  # the kernel backend
        kernel_ms = {m: statistics.median(cuda_times(lambda r=r: solver.bound.solve(r), 3, 10))
                     for m, r in rhs.items()}
        data2 = solver.source_values * 0.75  # the same pattern, new values
        for shard, shape, slack, m in DIST_CONFIGS:
            cfg = f"{name} shard={shard} mesh={shape} slack={slack} m={m}"
            t0 = time.perf_counter()
            gpu = be.bind(plan, mesh=make_mesh(shape, devices=dev), shard=shard, slack=slack)
            torch.cuda.synchronize()
            bind_s = time.perf_counter() - t0
            cpu = be.bind(plan, device="cpu", mesh=make_mesh(shape, devices="cpu"),
                          shard=shard, slack=slack)
            kind = "range_single" if m is None else "range_mrhs"
            d = gpu.describe()
            ex = d["exchange"]
            want = d["launches_per_solve"]["single" if m is None else "mrhs"]
            before = dict(sptrsv.launches)
            x = gpu.solve(rhs[m])
            torch.cuda.synchronize()
            made = {k: sptrsv.launches[k] - before[k] for k in before}
            tally(before)
            require(made[kind] == want and sum(made.values()) == want,
                    f"{cfg}: launches {made}, expected {want} {kind}")
            require(x.device == rhs[m].device and x.shape == rhs[m].shape
                    and bool(torch.isfinite(x).all()), f"{cfg}: x")
            require(bitwise_equal(x, ref[m]), f"{cfg}: != the kernel backend's answer")
            t0 = time.perf_counter()
            x_cpu = cpu.solve(rhs[m].cpu())
            cpu_s = time.perf_counter() - t0
            require(bitwise_equal(x, x_cpu), f"{cfg}: != the CPU mesh (plain version)")
            require(ex == cpu.describe()["exchange"], f"{cfg}: exchange != the CPU binding's")
            xt, steps = gpu.solve_timed(rhs[m])
            torch.cuda.synchronize()
            require(len(steps) == ex["rounds"] and bitwise_equal(xt, x),
                    f"{cfg}: solve_timed, {len(steps)} steps for {ex['rounds']} rounds")
            ms = statistics.median(cuda_times(lambda: gpu.solve(rhs[m]), 3, 10))
            rec = {"matrix": name, "shard": shard, "mesh": list(shape), "slack": slack,
                   "m": 1 if m is None else m, "rounds": ex["rounds"],
                   "n_supersteps": ex["n_supersteps"], "kernel": kind,
                   "launches_per_solve": made[kind],
                   "rounds_x_positions_with_work": want,
                   "n_levels": d["n_levels"], "ms": ms, "kernel_backend_ms": kernel_ms[m],
                   "ms_over_kernel_backend": ms / kernel_ms[m],
                   "round_us": [st["us"] for st in steps],
                   "round_launches": [st["launches"] for st in steps],
                   "comm_values_per_solve": ex["comm_values_per_solve"],
                   "comm_bytes_per_solve": ex["comm_bytes_per_solve"] * (
                       1 if m is None else m),
                   "bind_s": bind_s, "cpu_mesh_solve_s": cpu_s,
                   "bitwise_vs_kernel_backend": True, "bitwise_vs_cpu_mesh": True}
            if shard == "rows":
                rec.update(halo_ratio=ex["halo_ratio"],
                           halo_bytes_per_solve=ex["halo_bytes_per_solve"] * (
                               1 if m is None else m),
                           halo_values_max_round=ex["halo_values_max_round"],
                           n_loc=d["n_loc"], n_halo=d["n_halo"])
            if slack:
                rec.update(predicted_rounds=ex["predicted_rounds"],
                           executed_fusion=ex["executed_fusion"])
            if shape == (1, 8) and slack == 0 and m is None:
                # where a solve's time goes: the device's busy time, the
                # union over the positions' streams, against the elapsed
                prof = profile_iterations(lambda k: [gpu.solve(rhs[m]) for _ in range(k)], 10)
                rec["profile_10_solves"] = {key: prof[key] for key in (
                    "elapsed_ms", "ms_per_iter", "device_busy_ms", "kernel_ms_sum",
                    "idle_share", "kernels", "launches", "top")}
            if slack == 0 and m is None:
                fresh_plan = dataclasses.replace(plan, vals=plan.vals.copy(),
                                                 diag=plan.diag.copy())
                fresh_plan.numeric_update(data2)
                fresh = be.bind(fresh_plan, mesh=make_mesh(shape, devices=dev), shard=shard)
                t0 = time.perf_counter()
                upd = gpu.update_values(data2)
                torch.cuda.synchronize()
                rec["update_values_s"] = time.perf_counter() - t0
                require(bitwise_equal(upd.solve(rhs[m]), fresh.solve(rhs[m])),
                        f"{cfg}: update_values != a fresh bind")
                rec["update_values_bitwise_fresh_bind"] = True
            main_err[f"sptrsv_{kind}"] = max(main_err.get(f"sptrsv_{kind}", 0.0),
                                             max_abs(x, x_cpu))
            rows.append(rec)
            emit({"phase": "distributed", "row": rec})

    # the front door once, and the service on its PlanCache: ER, (2, 4), rows
    b, B, _ = inputs["er"]
    mesh = make_mesh((2, 4), devices=dev)
    cache = PlanCache()
    t0 = time.perf_counter()
    fd = repro_torch.TriangularSolver.plan(mats["er"], backend="distributed", mesh=mesh,
                                           shard="rows", validate="fast", cache=cache)
    fd_s = time.perf_counter() - t0
    require(fd.info()["shard"] == "rows" and fd.device.type == dev.type, "front door binding")
    before = dict(sptrsv.launches)
    x, X = fd.solve(b), fd.solve(B)
    torch.cuda.synchronize()
    tally(before)
    initial = solvers["er"].clone_with_values(mats["er"])  # the kernel backend
    require(bitwise_equal(x, initial.solve(b)) and bitwise_equal(X, initial.solve(B)),
            "front door: != the kernel backend's answers")
    svc = SolveService(max_batch=8, max_wait_us=2000, strategy="growlocal", cache=cache,
                       backend="distributed", mesh=mesh, shard="rows")
    try:
        fp = svc.register(mats["er"])
        require(cache.stats.hits >= 1, "the service planned again")
        require(svc.stats()["serving"]["batch_align"] == 2, "batch_align")
        rng = np.random.default_rng(31)
        reqs = [[rng.standard_normal(mats["er"].n_rows).astype(np.float32)
                 for _ in range(DIST_REQUESTS)] for _ in range(DIST_CLIENTS)]
        served, errors = [], []

        def client(bs):
            try:
                for bb in bs:
                    t = svc.submit(fp, bb)
                    served.append((t, bb, t.result(300)))
            except Exception as e:  # reported below, after the join
                errors.append(repr(e))

        before = dict(sptrsv.launches)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(bs,)) for bs in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        tally(before)
        require(not errors and not any(t.is_alive() for t in threads), f"serve: {errors}")
        require(len(served) == DIST_CLIENTS * DIST_REQUESTS, "serve: requests lost")
        for t, bb, xx in served:
            require(t.batch_width % 2 == 0, f"serve: width {t.batch_width}")
            ref = direct_reference(t.served_by, bb, t.batch_width, t.batch_position)
            require(np.array_equal(xx.view(np.uint32), ref.view(np.uint32)),
                    "serve: a result != its direct_reference")
        snap = svc.stats()
    finally:
        report = svc.close(timeout=120)
    require(report["workers_alive"] == [], "serve: workers alive after close")
    # the range launches of the path's checked solves (the kernel
    # backend's reference and timing solves launch the bulk kernels)
    launches = dict(path)
    for k in launches:
        require(launches[k] > 0, f"{k} was not launched on the distributed path")
    rec = {"phase": "distributed", "rows": rows, "launches": launches,
           "front_door": {"plan_s": fd_s, "mesh": [2, 4], "shard": "rows",
                          "validate": "fast", "bitwise_vs_kernel_backend": True},
           "serve": {"clients": DIST_CLIENTS, "requests": len(served), "wall_s": wall,
                     "req_per_s": len(served) / wall, "batch_align": 2,
                     "batch_sizes": dict(snap.get("batch_size_hist", {})),
                     "latency_us": snap.get("latency_us"),
                     "bitwise_vs_direct_reference": True},
           "phase_s": time.perf_counter() - t_phase, **card}
    emit(rec)
    return rec


def bound(nbytes, ops) -> dict:
    """The least time of the card for ``nbytes`` moved and ``ops``
    operations (data sheet rates): the larger of the two."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS * 1e3
    return {"bound_us": max(bytes_ms, ops_ms) * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def serve_phase(mats, inputs, er_solver, auto_cache, cuda_times, bitwise_equal, max_abs,
                main_err, card):
    """The batching solve service on the card (see the module docstring);
    returns the phase's record, which it has emitted, with each mode's
    launches and the bank kernel's timing record."""
    import collections
    import itertools
    import threading

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.kernels import sptrsv
    from repro_torch.kernels.ops import stack_level_bank
    from repro_torch.kernels.ref import sptrsv_level_bank_ref
    from repro_torch.launch.dryrun import sptrsv_work
    from repro_torch.pipeline import GroupBank
    from repro_torch.serve import (
        GroupReplay,
        SolveService,
        direct_reference,
        make_sampler,
        run_closed_loop,
        width_class_patterns,
    )

    def check_served(name, kept, grouped):
        """Every served result bitwise its replay on the card (its
        ``direct_reference`` at the recorded width and position, through
        ``GroupReplay`` for banked tickets); a sample of SERVE_SAMPLE of
        them bitwise the CPU plain version, solved together: a column's
        bits depend neither on its width nor on its position."""
        for t, b, x in kept:
            require(bitwise_equal(torch.from_numpy(x), torch.from_numpy(
                direct_reference(t.served_by, b, t.batch_width, t.batch_position))),
                f"serve {name}: a result differs from its replay on the card")
        step = max(1, len(kept) // SERVE_SAMPLE)
        sample = kept[::step][:SERVE_SAMPLE]
        require(len(sample) >= min(32, len(kept)), f"serve {name}: sample {len(sample)}")
        B = np.stack([b for _, b, _ in sample], axis=1)
        twins = {}
        for t, _, _ in sample:
            s = t.served_by.solver if isinstance(t.served_by, GroupReplay) else t.served_by
            twins.setdefault(id(s), cpu_twin(s))
        if grouped:
            bank = GroupBank()
            for key, twin in twins.items():
                bank.add(key, twin)
            keys = [id(t.served_by.solver if isinstance(t.served_by, GroupReplay)
                       else t.served_by) for t, _, _ in sample]
            X = bank.solve(keys, B)
        else:
            X = torch.empty(B.shape, dtype=torch.float32)
            for key, twin in twins.items():
                cols = [j for j, (t, _, _) in enumerate(sample) if id(t.served_by) == key]
                X[:, cols] = twin.solve(B[:, cols])
        err = 0.0
        for j, (_, _, x) in enumerate(sample):
            require(bitwise_equal(torch.from_numpy(x), X[:, j]),
                    f"serve {name}: a result differs from the CPU plain version")
            err = max(err, max_abs(torch.from_numpy(x), X[:, j]))
        if grouped:
            main_err["sptrsv_bank"] = max(main_err.get("sptrsv_bank", 0.0), err)
        return {"replayed_on_card": len(kept), "cpu_plain_sample": len(sample),
                "cpu_plain_twins": len(twins), "max_abs_vs_cpu_plain": err}

    def drive(name, svc, patterns, seed, update=None):
        """The closed loop of the CLI's defaults on ``svc`` over
        ``patterns`` (prewarmed, telemetry and counters zeroed first).
        Every request is drawn before the window (``draw_s``), so the
        clients only submit and wait; ``update()`` runs once, mid-stream,
        from another thread. Launches are read before any replay. Returns
        the row, the served ``(ticket, b, x)`` and the metrics, and the
        drawn requests (``device_window`` replays them)."""
        total = SERVE_CLIENTS * SERVE_REQUESTS
        sampler = make_sampler(patterns, "uniform", seed=seed)
        t0 = time.perf_counter()
        pool = [sampler() for _ in range(total)]
        draw_s = time.perf_counter() - t0
        svc.prewarm()
        svc.metrics.reset()
        torch.cuda.synchronize()
        kept, half = [], threading.Event()
        drawn = itertools.count()

        def counted():
            i = next(drawn)
            if i == total // 2:
                half.set()
            return pool[i]

        result = {}
        updater = None
        if update is not None:
            def run_update():
                if half.wait(600):
                    result["update"] = update()

            updater = threading.Thread(target=run_update, daemon=True)
            updater.start()
        sptrsv.reset_launches()  # this mode's launches start here
        report = run_closed_loop(svc, counted, n_clients=SERVE_CLIENTS,
                                 requests_per_client=SERVE_REQUESTS, timeout=600, keep=kept)
        launches = dict(sptrsv.launches)
        if updater is not None:
            updater.join(600)
            require("update" in result, f"serve {name}: the mid-stream update did not run")
        snap = report["metrics"]
        require(report["errors"] == 0 and report["rejected"] == 0 and len(kept) == total
                and snap["completed"] == total, f"serve {name}: served {len(kept)} of {total}")
        row = {"mode": name, "requests": total, "completed": snap["completed"],
               "elapsed_s": report["elapsed_seconds"],
               "throughput_req_s": report["solves_per_sec"],
               "latency_us": snap["latency_us"], "queue_wait_us": snap["queue_wait_us"],
               "batch_solve_us": snap["batch_solve_us"],
               "dispatch_width_hist": dict(sorted(collections.Counter(
                   t.batch_width for t, _, _ in kept).items())),
               "batch_size_hist": snap["batch_size_hist"], "batches": snap["batches"],
               "grouped_batches": snap["grouped_batches"], "slots": snap["slots"],
               "draw_s": draw_s, "launches": launches, **result}
        return row, kept, snap, pool

    def device_window(svc, pool):
        """The same requests again, in a second closed loop under
        ``torch.profiler``: the device's busy time (``busy_union_ms`` of
        its kernels and copies) against the loop's elapsed time, whence its
        idle share
        while serving. The profiler slows the host, so this loop is
        slower than the measured one; its launches are not counted."""
        drawn = itertools.count()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            report = run_closed_loop(svc, lambda: pool[next(drawn)], n_clients=SERVE_CLIENTS,
                                     requests_per_client=SERVE_REQUESTS, timeout=600)
        require(report["errors"] == 0 and report["metrics"]["completed"] > 0,
                "serve: the profiled loop failed")
        events = device_events(prof)
        busy = busy_union_ms(prof)
        elapsed_ms = report["elapsed_seconds"] * 1e3
        return {"elapsed_ms": elapsed_ms, "req_s": report["solves_per_sec"],
                "device_busy_ms": busy,
                "idle_share": 1.0 - busy / elapsed_ms if busy else "not measured",
                "top": events[:6]}

    rows = []
    # ---- microbatch: ER and NB through the main_path_auto PlanCache
    misses = auto_cache.stats.misses
    er_new = inputs["er"][2]
    with SolveService(cache=auto_cache, strategy="auto") as svc:
        fps = {name: svc.register(L) for name, L in mats.items()}
        require(auto_cache.stats.misses == misses, "serve: registration built a second plan")
        modes = {name: svc.pattern(fp).current_solver().info()["mode"]
                 for name, fp in fps.items()}

        def update_er():
            t0 = time.perf_counter()
            v = svc.numeric_update(fps["er"], er_new)
            return {"version": v, "numeric_update_s": time.perf_counter() - t0}

        patterns = [(fps[n], mats[n].n_rows) for n in mats]
        row, kept, snap, pool = drive("microbatch", svc, patterns, 11, update_er)
        checks = check_served("microbatch", kept, grouped=False)
        row["device_window"] = device_window(svc, pool)
        # update_values alone on the card: the device gather, synchronized
        er_bound = svc.pattern(fps["er"]).current_solver().bound
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            er_bound.update_values(er_new)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        versions = sorted({(t.fingerprint == fps["er"], t.version) for t, _, _ in kept})
    launches = row["launches"]
    # ER's bulk plan on the m-RHS kernel, NB's elastic pick on the elastic
    # m-RHS kernel: a microbatch is one plan, so no bank
    require(launches["ordered_mrhs"] > 0 and launches["bank"] == 0
            and (launches["elastic_ordered_mrhs"] > 0) == (modes["nb"] == "elastic"),
            f"serve microbatch launches {launches}, modes {modes}")
    require((True, 1) in versions and (True, 0) in versions,
            f"serve microbatch: ER versions served {versions}")
    row.update(checks, modes=modes, update_values_s=statistics.median(secs),
               update_values_s_all=secs, plans_built=auto_cache.stats.misses - misses)
    rows.append(row)

    # ---- width-class batching and continuous serving: one width class
    cache = repro_torch.PlanCache()
    t0 = time.perf_counter()
    with SolveService(cache=cache, strategy="wavefront", width_class_batching=True) as svc:
        pats = width_class_patterns(svc, SERVE_FAMILY, n=mats["er"].n_rows, stride=8, seed=0)
        plan_s = time.perf_counter() - t0
        row, kept, snap, pool = drive("width_class", svc, pats, 12)
        wc = next(iter(svc._banks.values()))
        lanes = int(wc._bank.level_off.shape[0])
        row.update(check_served("width_class", kept, grouped=True), plan_s=plan_s,
                   patterns=len(pats), bank=wc.describe(), bank_lanes=lanes,
                   width_classes=len(snap["width_classes"]),
                   device_window=device_window(svc, pool))
    launches = row["launches"]
    plain_batches = snap["batches"] - snap["grouped_batches"]
    require(launches["bank"] == snap["grouped_batches"] > 0
            and launches["ordered_mrhs"] == plain_batches
            and launches["elastic_ordered_mrhs"] == 0,
            f"serve width_class launches {launches}, batches {snap['batches']}, "
            f"grouped {snap['grouped_batches']}")
    require(lanes == 8, f"serve width_class: a bank of {lanes} lanes, want 8")
    rows.append(row)

    with SolveService(cache=cache, strategy="wavefront", mode="continuous",
                      n_slots=SERVE_SLOTS) as svc:
        misses = cache.stats.misses
        pats = width_class_patterns(svc, SERVE_FAMILY, n=mats["er"].n_rows, stride=8, seed=0)
        require(cache.stats.misses == misses, "serve continuous: registration built a plan")
        row, kept, snap, pool = drive("continuous", svc, pats, 13)
        eng = next(iter(svc._engines.values()))
        row.update(check_served("continuous", kept, grouped=True), engine=eng.describe(),
                   n_slots=eng.n_slots, device_window=device_window(svc, pool))
    launches = row["launches"]
    require(launches["bank"] == snap["slots"]["passes"] > 0 and launches["ordered_mrhs"] == 0
            and launches["elastic_ordered_mrhs"] == 0,
            f"serve continuous launches {launches}, passes {snap['slots']['passes']}")
    rows.append(row)

    # ---- the bank kernel: 8 distinct-valued clones of ER's plan, m = 32
    L = mats["er"]
    rng = np.random.default_rng(14)
    values = [L.data * rng.uniform(0.5, 1.5, L.nnz) for _ in range(8)]
    clones = [er_solver.clone_with_values(v) for v in values]
    require(len({c.width_class for c in clones}) == 1, "ER clones: one width class")
    bank = stack_level_bank([c.bound._la for c in clones], [c._perm for c in clones],
                            [c._inv for c in clones])
    n, m = L.n_rows, MAIN_M
    lane_idx = torch.arange(m, dtype=torch.int32) % 8  # every lane, four columns each
    b_col = torch.randn((m, n + 1), generator=torch.Generator().manual_seed(15)).to(
        er_solver.device)
    b_col[:, n] = 0
    sptrsv.reset_launches()
    x = sptrsv.sptrsv_level_bank_cuda(*bank[:9], lane_idx, b_col, chunks=bank.chunks)
    torch.cuda.synchronize()
    require(sptrsv.launches["bank"] == 1, "the bank check is one launch")
    t0 = time.perf_counter()
    x_cpu = sptrsv_level_bank_ref(*(t.cpu() for t in bank[:9]), lane_idx, b_col.cpu())
    ref_cpu_s = time.perf_counter() - t0
    require(bitwise_equal(x, x_cpu), "the bank kernel != its CPU plain version")
    main_err["sptrsv_bank"] = max(main_err.get("sptrsv_bank", 0.0), max_abs(x, x_cpu))
    ms = statistics.median(cuda_times(
        lambda: sptrsv.sptrsv_level_bank_cuda(*bank[:9], lane_idx, b_col, chunks=bank.chunks),
        3, 20))
    # the cols kernel on one of those plans, on the same column-major
    # buffer: the m-RHS entry's launch as its wrapper makes it (x zeroed,
    # one launch), without the wrapper's copy of b into that layout
    la = clones[0].bound._la
    cols_ms = statistics.median(cuda_times(
        lambda: sptrsv._launch_level("single", "mrhs", la[:7], b_col.T, la.chunks), 3, 20))
    plain = cuda_times(lambda: sptrsv_level_bank_ref(*bank[:9], lane_idx, b_col), 0, 1)
    # the library: one cuSPARSE solve of the 8 clones' block diagonal
    # (sparse CSR, the rows of lane l at l * n) with B [8n, 4], lane l's
    # four columns (l, l + 8, l + 16, l + 24) in its rows, in caller order
    inv = clones[0]._inv  # the clones share ER's plan

    def stacked(cols):  # f[32, n + 1] in plan order -> f[8n, 4] in caller order
        return cols[:, :n][:, inv].reshape(m // 8, 8, n).permute(1, 2, 0).reshape(8 * n, -1)

    nnz = L.nnz
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        L_bd = torch.sparse_csr_tensor(
            torch.cat([torch.as_tensor(L.indptr[:-1], dtype=torch.int64) + lane * nnz
                       for lane in range(8)] + [torch.tensor([8 * nnz])]),
            torch.cat([torch.as_tensor(L.indices, dtype=torch.int64) + lane * n
                       for lane in range(8)]),
            torch.as_tensor(np.concatenate(values), dtype=torch.float32),
            size=(8 * n, 8 * n)).to(er_solver.device)
        B_bd = stacked(b_col).contiguous()
        lib = cuda_times(lambda: torch.triangular_solve(B_bd, L_bd, upper=False), 3, 20)
        x_lib = torch.triangular_solve(B_bd, L_bd, upper=False)[0]
    x_ref = stacked(x).double()
    lib_gap = float((x_lib.double() - x_ref).norm() / x_ref.norm())
    require(lib_gap < LIBRARY_GAP, f"bank: the library's block-diagonal solve differs "
            f"from the bank kernel by {lib_gap}")
    esize = b_col.element_size()
    work = sptrsv_work(er_solver.exec_plan, esize)  # each lane: the same pattern
    lanes_used = 8
    timing = {"matrix": "er", "kernel": "sptrsv_bank", "m": m, "lanes": lanes_used,
              "bank_lanes": int(bank.level_off.shape[0]), "ms": ms, "cols_ms": cols_ms,
              "bank_over_cols": ms / cols_ms, "launches_per_solve": 1,
              **bound(lanes_used * work["bytes"] + 2 * n * m * esize,
                      2 * (work["entries"] + work["finishes"]) * m),
              "levels_per_lane": [int(v) for v in bank.n_levels.tolist()],
              "plain_ms": statistics.median(plain), "plain_reps": len(plain),
              "plain_cpu_s": ref_cpu_s, "library_ms": statistics.median(lib),
              "library": "torch.triangular_solve, block-diagonal sparse CSR of the 8 "
                         "clones, B [8n, 4]", "library_relgap": lib_gap,
              "bitwise_vs_cpu_plain": True, **card}
    emit({"phase": "timing", **timing})
    rec = {"phase": "serve", "modes": rows, "clients": SERVE_CLIENTS,
           "requests_per_client": SERVE_REQUESTS, "bank_check": {
               "clones": 8, "m": m, "bitwise_vs_cpu_plain": True, "ms": ms,
               "cols_ms": cols_ms, "library_ms": timing["library_ms"]}, **card}
    emit(rec)
    return rec, timing


def first_layers_specs(cfg, cut):
    """``param_specs(cut)``, ``cut`` being ``cfg`` with fewer layers, each
    stacked leaf keeping the std ``init_params`` gives it in ``cfg``'s whole
    stack (its ``fan_in`` is the stack's depth: ``n_layers``, the hybrid's
    superblock and tail counts, or the encoder's and the decoder's)."""
    from repro_torch.models import param_specs
    from repro_torch.models.common import ParamSpec, tree_map
    from repro_torch.models.lm import stack_depth

    full, specs = param_specs(cfg), param_specs(cut)
    out = dict(specs)
    for key in ("layers", "superblocks", "tail", "enc_layers", "dec_layers"):
        if key in specs:
            keep = (stack_depth(specs[key]) / stack_depth(full[key])) ** 0.5
            out[key] = tree_map(lambda s, keep=keep: ParamSpec(
                s.shape, s.logical, s.init, s.scale * keep), specs[key])
    return out


def check_cut(cfg):
    """The card-against-CPU cut of ``cfg``: its first 2 layers, the
    hybrid's first superblock and its 2 tail layers, the encoder-decoder's
    first 2 encoder and 2 decoder layers."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS, n_dec_layers=LM_CHECK_LAYERS)
    return dataclasses.replace(cfg, n_layers=5 if cfg.family == "hybrid" else LM_CHECK_LAYERS)


# the leaves that multiply the activations (every other one is elementwise)
MATMUL_LEAVES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router", "shared_gate",
                 "shared_up", "shared_down", "wr", "wg", "decay_a", "decay_b", "w_in_gate",
                 "w_in_rnn", "gate_a", "gate_x", "w_out", "frontend_proj"}


def frame_side(path) -> bool:
    """A leaf that works on the frontend's frames or patches alone: the
    encoder, ``frontend_proj``, the cross-attention's k / v projections of
    the encoder output. Prefill reads them; a decode step does not (the
    cross caches hold what it needs)."""
    return (path[0] in ("enc_layers", "enc_norm", "frontend_proj")
            or (path[1:2] == ("cross_attn",) and path[-1] in ("wk", "wv")))


def lm_work(cfg, batch, prompt, pos, experts=None) -> dict:
    """What this run's data needs of a prefill (``pos`` None) over
    ``make_train_batch(seq_len=prompt)`` or of a decode step at ``pos``,
    float32. Bytes: every weight the step uses read once (not the
    embedding; of an MoE layer's routed experts, the ``experts[l]``
    distinct ones its routing reaches, all of them where ``experts`` is
    None; a decode step reads no ``frame_side`` leaf), the embedding rows
    of the tokens and the frontend's embeddings, the state the step reads
    (the KV it attends to, the cross caches, the recurrent states) and
    writes, the logits. Operations: two a multiply-add of the matmuls (an
    MoE token through its top K experts and the shared ones; the frames
    through the frame-side leaves), of the attention (the pairs the causal
    window keeps; the encoder's every pair of frames; the cross-attention's
    every pair of decoder position and frame), of the WKV state (three per
    state element a token) and of the last position's unembedding;
    elementwise work left out."""
    from repro_torch.launch.inputs import token_split
    from repro_torch.models import param_specs
    from repro_torch.models.common import tree_paths

    D, V, B = cfg.d_model, cfg.padded_vocab, batch
    frames = token_split(cfg, prompt)[0]
    # the positions through the (decoder) layers: an encoder-decoder's
    # prompt is its tokens, a frontend's positions come ahead of a decoder-only
    # model's tokens
    tokens = B * prompt if pos is None else B
    weight_bytes = per_token = per_frame = 0
    for path, s in tree_paths(param_specs(cfg)).items():
        n = math.prod(s.shape)
        if path[0] in ("embed", "unembed"):
            weight_bytes += 0 if path[0] == "embed" else n * 4
            continue
        if frame_side(path):
            if pos is None:
                weight_bytes += n * 4
                per_frame += n if path[-1] in MATMUL_LEAVES else 0
            continue
        if path[1:2] == ("moe",) and path[-1] in ("w_gate", "w_up", "w_down"):
            E = cfg.moe.n_experts
            reached = cfg.n_layers * E if experts is None else sum(experts)
            weight_bytes += reached * (n // (cfg.n_layers * E)) * 4
            per_token += cfg.moe.top_k * n // E
            continue
        weight_bytes += n * 4
        if path[-1] in MATMUL_LEAVES:
            per_token += n
    n_super, n_tail = divmod(cfg.n_layers, 3)
    n_dec = cfg.n_dec_layers or cfg.n_layers
    attn_layers = {"dense": cfg.n_layers, "moe": cfg.n_layers, "hybrid": n_super,
                   "encdec": n_dec}.get(cfg.family, 0)
    window = cfg.local_window if cfg.family == "hybrid" else cfg.window
    span = (lambda t: t + 1) if window is None else (lambda t: min(t + 1, window))
    pairs = B * (sum(span(t) for t in range(prompt)) if pos is None else span(pos))
    kv_row = cfg.n_kv_heads * cfg.hd * 2 * 4  # one position's k and v of one layer
    state = attn_layers * (tokens * kv_row + (0 if pos is None else pairs * kv_row))
    ops = 2 * tokens * per_token + 2 * 2 * attn_layers * cfg.n_heads * cfg.hd * pairs
    embeds = tokens * D * 4  # the tokens' rows (and a decoder-only model's frontend's)
    if pos is None and cfg.frontend:  # the frames through the frame-side leaves
        ops += 2 * B * frames * per_frame
        if cfg.family == "encdec":
            embeds += B * frames * D * 4
    if cfg.family == "encdec":
        # the encoder's pairs (prefill) and the decoder positions against every
        # frame; the cross caches written by prefill, read by a decode step
        enc_pairs = cfg.n_layers * B * frames * frames if pos is None else 0
        ops += 2 * 2 * cfg.n_heads * cfg.hd * (enc_pairs + n_dec * tokens * frames)
        state += n_dec * B * frames * kv_row
    elif cfg.family == "rwkv6":
        Dh = D // cfg.n_heads
        layer = B * (cfg.n_heads * Dh * Dh + 2 * D) * 4
        state += cfg.n_layers * layer * (1 if pos is None else 2)
        ops += 2 * 3 * tokens * cfg.n_layers * D * Dh
    elif cfg.family == "hybrid":
        R = cfg.d_rnn or D
        state += (2 * n_super + n_tail) * B * 4 * R * 4 * (1 if pos is None else 2)
    nbytes = weight_bytes + embeds + state + B * V * 4
    return bound(nbytes, ops + 2 * B * D * V)


def profile_decode(cfg, params, cache, pos, tok, steps) -> dict:
    """``steps`` decode steps from ``pos`` under ``torch.profiler``, CUDA
    events around them: ms a step, the device's busy time (the union of
    its events) and idle share, kernel launch calls and device events a
    step, the top 5 device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step

    V = cfg.vocab_size
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0.record()
        for i in range(steps):
            logits, cache = decode_step(cfg, params, cache, pos + i, tok)
            tok = logits[:, :V].argmax(-1)
        e1.record()
        e1.synchronize()
    elapsed = e0.elapsed_time(e1)
    busy = busy_union_ms(prof)
    kernels = device_events(prof)
    return {"steps": steps, "elapsed_ms": elapsed, "ms_per_step": elapsed / steps,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / elapsed if elapsed else None,
            "launch_calls_per_step": sum(1 for e in prof.events()
                                         if e.name in LAUNCH_CALLS) / steps,
            "device_events_per_step": sum(k["count"] for k in kernels) / steps,
            "top": kernels[:5]}


class RoutingLog:
    """Wraps ``repro_torch.models.moe.route`` while open and keeps each
    call's ``Routing`` (one a MoE layer a forward call), in order."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self._route = moe.route

        def route(*a, **kw):
            r = self._route(*a, **kw)
            self.calls.append(r)
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route
        return False


def routing_stats(calls) -> list:
    """A row a MoE layer: its groups and capacity, its assignments, the
    dropped ones and the distinct experts it reaches."""
    rows = []
    for layer, r in enumerate(calls):
        G, S, E, C = r.dispatch.shape
        kept = r.in_cap.sum(dim=(0, 1, 2))  # [E]
        rows.append({"layer": layer, "groups": G, "group_size": S, "capacity": C,
                     "assignments": int(r.onehot.sum()),
                     "dropped": int(r.onehot.sum() - r.in_cap.sum()),
                     "experts_reached": int((kept > 0).sum())})
    return rows


def kth_gaps(r, K):
    """Per token, the gap between its K-th and (K+1)-th expert probability."""
    import torch

    top = torch.sort(r.probs, dim=-1, descending=True, stable=True).values
    return top[..., K - 1] - top[..., K]


def lm_cut_run(cut, params, batch, tokens=None):
    """Prefill over ``batch`` and ``LM_CHECK_STEPS`` decode steps, greedy
    or teacher forced with ``tokens``: each step's logits (on the CPU), its
    MoE routing calls, and the tokens fed."""
    from repro_torch.models import decode_step, prefill

    V = cut.vocab_size
    with RoutingLog() as log:
        logits, cache, pos = prefill(cut, params, batch, max_len=LM_PROMPT + LM_CHECK_STEPS)
    out = {"logits": [logits.cpu()], "routing": [list(log.calls)], "tokens": []}
    for i in range(LM_CHECK_STEPS):
        tok = logits[:, :V].argmax(-1) if tokens is None else tokens[i].to(logits.device)
        out["tokens"].append(tok.cpu())
        log.calls.clear()
        with log:
            logits, cache = decode_step(cut, params, cache, pos + i, tok)
        out["logits"].append(logits.cpu())
        out["routing"].append(list(log.calls))
    return out


def lm_card_vs_cpu(cfg, seed, dev) -> dict:
    """``check_cut(cfg)`` made on the CPU (each leaf at the full stack's
    std), carried to the card with ``lm_params_from_numpy``: prefill and
    ``LM_CHECK_STEPS`` decode steps, the card teacher forced with the CPU's
    tokens; logits within ``LM_REL`` x max |logit|, greedy tokens equal
    where the CPU's top-2 margin exceeds the bound. For the MoE family the
    routing comes first: a sequence is held only while its top-K experts
    agree on every layer, and each token whose K-th and (K+1)-th
    probabilities are within ``MOE_NEAR_TIE`` is listed."""
    import torch

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.inputs import make_train_batch
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_map

    cut = check_cut(cfg)
    V, B, P = cfg.vocab_size, LM_BATCH, LM_PROMPT
    moe = cfg.family == "moe"
    cpu_params = init_params(first_layers_specs(cfg, cut), torch.Generator().manual_seed(seed),
                             device="cpu")
    gpu_params = lm_params_from_numpy(cut, tree_map(lambda x: x.numpy(), cpu_params),
                                      device=dev)
    cpu_batch = make_train_batch(cut, batch=B, seq_len=P, seed=seed, device="cpu")
    ref = lm_cut_run(cut, cpu_params, cpu_batch)
    got = lm_cut_run(cut, gpu_params, make_train_batch(cut, batch=B, seq_len=P, seed=seed,
                                                       device=dev), ref["tokens"])
    del gpu_params
    agreed = torch.ones(B, dtype=torch.bool)
    rows, near_ties, flips = [], [], []
    for i, (c_logits, g) in enumerate(zip(ref["logits"], got["logits"])):
        for layer, (cr, gr) in enumerate(zip(ref["routing"][i], got["routing"][i])):
            # prefill routes [B, S] (a group a sequence), decode [1, B]
            same = (cr.top_e == gr.top_e.cpu()).all(dim=-1)  # per token
            agreed &= same.all(dim=1) if i == 0 else same[0]
            gaps = kth_gaps(cr, cfg.moe.top_k)
            for idx in torch.nonzero(gaps < MOE_NEAR_TIE).tolist():
                near_ties.append({"step": i, "layer": layer, "token": idx,
                                  "gap": float(gaps[tuple(idx)])})
            for idx in torch.nonzero(~same).tolist():
                flips.append({"step": i, "layer": layer, "token": idx,
                              "gap": float(gaps[tuple(idx)])})
        held = agreed if moe else torch.ones(B, dtype=torch.bool)
        require(held.any(), f"lm card against CPU, {cfg.name} step {i}: no sequence's "
                            f"routing agreed ({flips[:4]})")
        gap = float((g[held] - c_logits[held]).abs().max())
        scale = float(c_logits[held].abs().max())
        top2 = c_logits[:, :V].topk(2).values
        clear = ((top2[:, 0] - top2[:, 1]) > LM_REL * scale) & held
        rows.append({"step": i, "sequences_held": int(held.sum()), "max_abs_gap": gap,
                     "max_abs_logit": scale, "rel_gap": gap / scale,
                     "clear_margins": int(clear.sum()),
                     "tokens_equal_where_clear": bool(torch.equal(
                         g[:, :V].argmax(-1)[clear], c_logits[:, :V].argmax(-1)[clear]))})
        require(gap <= LM_REL * scale and rows[-1]["tokens_equal_where_clear"],
                f"lm card against CPU, {cfg.name} step {i}: {rows[-1]}")
    out = {"n_layers": cut.n_layers, "bound": LM_REL, "steps": rows}
    if moe:
        out.update(near_tie_bound=MOE_NEAR_TIE, near_ties=near_ties, routing_flips=flips,
                   sequences_agreed=int(agreed.sum()))
    return out


def lm_serve_phase(args, dev, cuda_times, card) -> dict:
    """The LM stack's serving path at full width on the card (see the
    module docstring); returns the phase's record, which it has emitted."""
    return lm_model_phase("lm_serve", LM_ARCH, args, dev, cuda_times, card)


def lm_families_phase(args, dev, cuda_times, card) -> list:
    """The MoE, RWKV-6 and hybrid families at full width, one model at a
    time (see the module docstring); returns their records."""
    return [lm_model_phase("lm_families", arch, args, dev, cuda_times, card)
            for arch in LM_FAMILIES]


def lm_frontends_phase(args, dev, cuda_times, card) -> list:
    """The encoder-decoder family and the frontend stubs at full width, one
    model at a time, then llava's anyres prefill (see the module
    docstring); returns their records."""
    recs = [lm_model_phase("lm_frontends", arch, args, dev, cuda_times, card)
            for arch in LM_FRONTENDS]
    return recs + [lm_anyres_run(args, dev, cuda_times, card)]


def whole_chunks(cfg, positions):
    """``cfg`` with the attention chunk the largest divisor of
    ``positions`` up to its ``attn_kv_chunk``: the chunked attention takes
    a key length that is a multiple of its chunk."""
    chunk = max(c for c in range(1, min(cfg.attn_kv_chunk, positions) + 1)
                if positions % c == 0)
    return dataclasses.replace(cfg, attn_kv_chunk=chunk)


def lm_anyres_run(args, dev, cuda_times, card) -> dict:
    """llava-next at the published anyres size: batch 1, 2,880 patches
    ahead of 2,880 tokens. A first prefill, 3 warm (median), 4 greedy
    decode steps, the first against a fresh prefill over the same patches
    and the tokens with its token appended; every logit finite; prefill
    and decode ms beside their bounds, peak memory. Emits the record and
    returns it."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.configs.llava_next_mistral_7b import N_PATCHES as n_patches
    from repro_torch.launch.inputs import make_train_batch, token_split
    from repro_torch.models import decode_step, init_params, param_specs, prefill

    t_phase = time.perf_counter()
    cfg = configs.get_config(ANYRES_ARCH)
    S, B, V = 2 * n_patches, ANYRES_BATCH, cfg.vocab_size
    patches, text = token_split(cfg, S)
    require(patches == text == n_patches, f"anyres: token_split gives {(patches, text)}")
    run_cfg, fresh_cfg = whole_chunks(cfg, S), whole_chunks(cfg, S + 1)
    n_params = cfg.param_count(param_specs(cfg))
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    require(free > 4 * n_params, f"anyres: {cfg.name} needs {4 * n_params} bytes, {free} free")
    params = init_params(param_specs(cfg), torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    batch = make_train_batch(cfg, batch=B, seq_len=S, seed=args.seed, device=dev)
    max_len = S + ANYRES_STEPS
    torch.cuda.reset_peak_memory_stats()
    out = {}

    def run_prefill():
        out["prefill"] = prefill(run_cfg, params, batch, max_len=max_len)

    first_ms = cuda_times(run_prefill, 0, 1)[0]
    warm = cuda_times(run_prefill, 0, 3)
    logits, cache, pos = out.pop("prefill")
    require(pos == S, f"anyres: prefill's position {pos} != {S}")
    finite = bool(torch.isfinite(logits).all())
    tok = logits[:, :V].argmax(-1)
    first_tok, step_ms, steps = tok, [], []
    for i in range(ANYRES_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        logits, cache = decode_step(run_cfg, params, cache, pos + i, tok)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        finite &= bool(torch.isfinite(logits).all())
        if i == 0:
            dec = logits.clone()
        tok = logits[:, :V].argmax(-1)
        steps.append(tok)
    del cache
    full = dict(batch, tokens=torch.cat([batch["tokens"], first_tok[:, None]], dim=1))
    ref, ref_cache, ref_pos = prefill(fresh_cfg, params, full, max_len=S + 1)
    del ref_cache
    peak = torch.cuda.max_memory_allocated()
    gap, scale = float((dec - ref).abs().max()), float(ref.abs().max())
    require(finite and bool(torch.isfinite(ref).all()),
            f"anyres: a logit of {cfg.name} is not finite")
    require(ref_pos == S + 1 and gap <= LM_REL * scale,
            f"anyres: decode at position {S} against a fresh prefill: max |gap| {gap} > "
            f"{LM_REL} * {scale}")
    del params, batch, full, ref, dec, logits
    gc.collect()
    torch.cuda.empty_cache()
    prefill_ms, decode_ms = statistics.median(warm), statistics.median(step_ms)
    pb, db = lm_work(cfg, B, S, None), lm_work(cfg, B, S, S + ANYRES_STEPS // 2)
    rec = {"phase": "lm_frontends", "run": "anyres", "arch": cfg.name, "batch": B,
           "seq_len": S, "patches": patches, "text_tokens": text, "dtype": "float32",
           "seed": args.seed, "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "attn_kv_chunk": run_cfg.attn_kv_chunk,
           "fresh_prefill_attn_kv_chunk": fresh_cfg.attn_kv_chunk,
           "prefill_ms_first": first_ms, "prefill_ms": prefill_ms, "prefill_ms_runs": warm,
           "prefill_bound_ms": pb["bound_us"] / 1e3, "prefill_bound_by": pb["bound_by"],
           "prefill_bound_share": pb["bound_us"] / 1e3 / prefill_ms,
           "prefill_ops": pb["ops"], "prefill_bytes": pb["bytes"],
           "decode_ms": step_ms, "decode_ms_per_token": decode_ms,
           "decode_bound_ms": db["bound_us"] / 1e3, "decode_bound_by": db["bound_by"],
           "decode_bytes": db["bytes"],
           "decode_vs_prefill": {"pos": S, "max_abs_gap": gap, "max_abs_logit": scale,
                                 "rel_gap": gap / scale, "bound": LM_REL},
           "logits_finite": finite, "tokens": [t.tolist() for t in steps],
           "max_memory_allocated": peak, "card_free_bytes_before": free,
           "phase_s": time.perf_counter() - t_phase, **card}
    emit(rec)
    return rec


def lm_model_phase(phase, arch, args, dev, cuda_times, card) -> dict:
    """One model at full width and depth on the card: ``serve()``, then
    decode against a fresh prefill (or, for the MoE family, each layer's
    routing in prefill and in decode), prefill warm and a profiled window
    of decode steps, and the card against the CPU on its cut. Emits the
    record and returns it."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.launch.inputs import make_train_batch, token_split
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_params, param_specs, prefill

    t_phase = time.perf_counter()
    cfg = configs.get_config(arch)
    V, B, P, N = cfg.vocab_size, LM_BATCH, LM_PROMPT, LM_NEW
    n_params = cfg.param_count(param_specs(cfg))
    moe = cfg.family == "moe"

    def room():
        """Free what the card holds; the parameters must fit."""
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        require(free > 4 * n_params, f"{phase}: {cfg.name} needs {4 * n_params} bytes of "
                                     f"parameters, the card has {free} of {total} free")
        return free

    # 1. the entry point at full width
    free_before = room()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve(cfg, batch=B, prompt_len=P, new_tokens=N, device=dev, seed=args.seed)
    serve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    require(res["logits_finite"], f"{phase}: a logit of {cfg.name}'s served run is not finite")
    require(tuple(toks.shape) == (B, N) and int(toks.min()) >= 0 and int(toks.max()) < V,
            f"{phase}: {cfg.name}'s served tokens {tuple(toks.shape)} outside [0, {V})")
    require(res["param_bytes"] == 4 * n_params, f"{phase}: {cfg.name}'s parameter bytes")

    # 2. decode against a fresh prefill, full depth; MoE: the routing
    room()
    params = init_params(param_specs(cfg), torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    batch = make_train_batch(cfg, batch=B, seq_len=P, seed=args.seed, device=dev)
    with RoutingLog() as log:
        logits0, cache, pos = prefill(cfg, params, batch, max_len=P + N)
    prefill_routing = routing_stats(log.calls)
    t = logits0[:, :V].argmax(-1)
    log.calls.clear()
    with log:
        dec, cache = decode_step(cfg, params, cache, pos, t)
    decode_routing = routing_stats(log.calls)
    log.calls.clear()
    first_equal = bool(torch.equal(t.cpu(), toks[:, 0]))
    if moe:
        # prefill routes a group a sequence (capacity C at S = P), decode one
        # group of B tokens: two functions, in JAX as well
        check = {"left_out": "MoE prefill routes each sequence as a group of "
                             f"{P} tokens (capacity {prefill_routing[0]['capacity']}) and "
                             f"drops assignments; decode routes the {B} tokens as one group "
                             f"(capacity {decode_routing[0]['capacity']}), so a decode "
                             "step and a fresh prefill compute different functions",
                 "prefill_routing": prefill_routing, "decode_routing": decode_routing,
                 "prefill_dropped": sum(r["dropped"] for r in prefill_routing),
                 "decode_dropped": sum(r["dropped"] for r in decode_routing)}
    else:
        # the same frames or patches, the prompt's tokens and the new one
        full = dict(batch, tokens=torch.cat([batch["tokens"], t[:, None]], dim=1))
        ref, _, _ = prefill(cfg, params, full, max_len=P + 1)
        gap, scale = float((dec - ref).abs().max()), float(ref.abs().max())
        check = {"pos": pos, "max_abs_gap": gap, "max_abs_logit": scale,
                 "rel_gap": gap / scale, "bound": LM_REL,
                 "greedy_equal": bool(torch.equal(dec[:, :V].argmax(-1),
                                                  ref[:, :V].argmax(-1)))}
        del ref
        require(torch.isfinite(dec).all() and gap <= LM_REL * scale,
                f"{phase}: {cfg.name}'s decode at position {pos} against a fresh prefill: "
                f"max |gap| {gap} > {LM_REL} * {scale}")
    check["serve_first_tokens_equal"] = first_equal

    # 3. where the time goes: prefill warm, decode under the profiler
    del cache, logits0, dec
    prefill_warm = cuda_times(lambda: prefill(cfg, params, batch, max_len=P + N), 1, 5)
    logits, cache, pos = prefill(cfg, params, batch, max_len=P + N)
    tok = logits[:, :V].argmax(-1)
    for i in range(2):  # warm-up outside the window
        logits, cache = decode_step(cfg, params, cache, pos + i, tok)
        tok = logits[:, :V].argmax(-1)
    profile_rec = profile_decode(cfg, params, cache, pos + 2, tok, LM_PROFILE_STEPS)
    del params, cache, logits, batch
    room()
    prefill_ms = statistics.median(prefill_warm)
    decode_ms = res["decode_ms_per_token"]
    prefill_bound = lm_work(cfg, B, P, None)
    decode_bound = lm_work(cfg, B, P, P + N // 2)
    bounds = {"prefill_bound_ms": prefill_bound["bound_us"] / 1e3,
              "prefill_bound_by": prefill_bound["bound_by"],
              "prefill_bound_share": prefill_bound["bound_us"] / 1e3 / prefill_ms,
              "prefill_ops": prefill_bound["ops"], "prefill_bytes": prefill_bound["bytes"],
              "decode_bound_ms": decode_bound["bound_us"] / 1e3,
              "decode_bound_by": decode_bound["bound_by"],
              "decode_bound_share": decode_bound["bound_us"] / 1e3 / decode_ms,
              "decode_bytes": decode_bound["bytes"], "decode_ops": decode_bound["ops"]}
    if moe:
        # the weights the step's routing reaches, beside the all-expert read
        reached = lm_work(cfg, B, P, P, [r["experts_reached"] for r in decode_routing])
        bounds.update(decode_bound_reached_ms=reached["bound_us"] / 1e3,
                      decode_bytes_reached=reached["bytes"],
                      decode_bound_all_experts_ms=lm_work(cfg, B, P, P)["bound_us"] / 1e3,
                      prefill_bound_reached_ms=lm_work(
                          cfg, B, P, None, [r["experts_reached"] for r in prefill_routing]
                      )["bound_us"] / 1e3)

    # 4. the card against the CPU on the cut
    card_vs_cpu = lm_card_vs_cpu(cfg, args.seed, dev)
    room()

    frames, text = token_split(cfg, P)
    rec = {"phase": phase, "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
           "n_dec_layers": cfg.n_dec_layers, "frontend": cfg.frontend,
           "frontend_positions": frames, "text_positions": text,
           "d_model": cfg.d_model, "padded_vocab": cfg.padded_vocab, "batch": B,
           "prompt": P, "new_tokens": N, "dtype": "float32", "seed": args.seed,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "params": n_params, "param_bytes": res["param_bytes"],
           "card_free_bytes_before": free_before,
           "cache_bytes": res["cache_bytes"], "max_memory_allocated": peak,
           "serve_s": serve_s, "prefill_ms_first": res["prefill_ms"],
           "prefill_ms": prefill_ms, "prefill_ms_runs": prefill_warm,
           "decode_ms_per_token": decode_ms, "decode_ms": res["decode_ms"], **bounds,
           "first_tokens": toks[0, :12].tolist(),
           ("moe_routing" if moe else "decode_vs_prefill"): check,
           "card_vs_cpu": card_vs_cpu, "profile_decode": profile_rec,
           "phase_s": time.perf_counter() - t_phase, **card}
    emit(rec)
    return rec


def nudged_params(params, seed=0):
    """Every parameter moved up by one ulp with probability 1/2."""
    import torch

    from repro_torch.models.common import tree_map

    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: torch.where(torch.rand(t.shape, generator=gen) < 0.5,
                                          torch.nextafter(t, torch.tensor(float("inf"))), t),
                    params)


def train_run(cfg, params, batch, microbatches):
    """One make_train_step on a copy of ``params`` and the gradients it
    applies: (loss, grad_norm, {path: gradient on the CPU})."""
    import torch

    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_loop import init_train_state, microbatch_grads

    grads, _ = microbatch_grads(cfg, params, batch, microbatches)
    grads = {k: v.cpu() for k, v in tree_paths(grads).items()}
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1),
                           microbatches=microbatches)
    _, m = step(init_train_state(cfg, tree_map(torch.clone, params)), batch)
    return float(m["loss"]), float(m["grad_norm"]), grads


def train_card_vs_cpu(arch, seed, dev) -> dict:
    """The reduced ``arch``: one train step and its gradients on the card
    and on the CPU from the same parameters and batch, held within rtol
    1e-4, atol 1e-4 x max|leaf| plus twice the CPU's own spread (two draws
    of one-ulp nudged parameters; for the hybrid also a float32 exp in the
    RG-LRU's decay, whose last bit the card and the host round apart)."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.inputs import make_train_batch
    from repro_torch.models import init_params, param_specs, rglru
    from repro_torch.models.common import tree_map

    cfg = get_reduced(arch)
    cpu_params = init_params(param_specs(cfg), torch.Generator().manual_seed(seed),
                             device="cpu")
    gpu_params = lm_params_from_numpy(cfg, tree_map(lambda t: t.numpy(), cpu_params),
                                      device=dev)
    kw = dict(batch=TRAIN_CHECK_BATCH, seq_len=TRAIN_CHECK_SEQ, seed=seed)
    cpu_batch = make_train_batch(cfg, device="cpu", **kw)
    ref = train_run(cfg, cpu_params, cpu_batch, TRAIN_MICRO)
    got = train_run(cfg, gpu_params, make_train_batch(cfg, device=dev, **kw), TRAIN_MICRO)
    others = [train_run(cfg, nudged_params(cpu_params, draw), cpu_batch, TRAIN_MICRO)
              for draw in (0, 1)]
    if cfg.family == "hybrid":
        decay = rglru._decay
        rglru._decay = lambda log_a: torch.exp(log_a.float())
        try:
            others.append(train_run(cfg, cpu_params, cpu_batch, TRAIN_MICRO))
        finally:
            rglru._decay = decay
    worst, worst_leaf, rel_gap = 0.0, None, 0.0
    for k, r in ref[2].items():
        spread = max(float((o[2][k] - r).abs().max()) for o in others)
        scale = float(r.abs().max())
        gap = (got[2][k] - r).abs()
        allowed = 1e-4 * r.abs() + 1e-4 * scale + 2 * spread
        ratio = float((gap / allowed.clamp(min=1e-30)).max())
        rel_gap = max(rel_gap, float(gap.max()) / scale if scale else 0.0)
        if ratio > worst:
            worst, worst_leaf = ratio, "/".join(k)
    rec = {"arch": cfg.name, "family": cfg.family, "loss_cpu": ref[0], "loss_card": got[0],
           "grad_norm_cpu": ref[1], "grad_norm_card": got[1], "leaves": len(ref[2]),
           "max_rel_gap": rel_gap, "worst_gap_over_allowed": worst, "worst_leaf": worst_leaf}
    for i, key in ((0, "loss"), (1, "grad_norm")):
        spread = max(abs(o[i] - ref[i]) for o in others)
        rec[f"{key}_gap"] = abs(got[i] - ref[i])
        require(rec[f"{key}_gap"] <= 1e-4 + 1e-4 * abs(ref[i]) + 2 * spread,
                f"lm_train card against CPU, {cfg.name}: {key} {got[i]} vs {ref[i]}")
    require(worst <= 1.0, f"lm_train card against CPU, {cfg.name}: gradient {worst_leaf} "
                          f"{worst:.3g} x its tolerance")
    return rec


def train_work(cfg, batch, seq) -> dict:
    """The least work of one train step of ``batch`` x ``seq`` tokens,
    float32: ``lm_work``'s matmuls and attention of a prefill four times
    (the forward, its recompute under remat, the backward's two products),
    the unembedding of every position three times (not recomputed)."""
    D, V = cfg.d_model, cfg.padded_vocab
    fwd = lm_work(cfg, batch, seq, None)
    layers = fwd["ops"] - 2 * batch * D * V  # lm_work unembeds the last position only
    return bound(0, 4 * layers + 3 * 2 * batch * seq * D * V)


def train_resume(cfg, seed, dev) -> dict:
    """The reduced ``cfg`` on the card: one step twice from one state,
    then ``TRAIN_RESUME_AT`` steps, an AsyncCheckpointer save, a restore
    and the next step against the same step taken without the break."""
    import tempfile

    import torch

    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_loop import clone_state, init_train_state

    def leaves(state):
        return {("params",) + k: v for k, v in tree_paths(state.params).items()} | {
            ("opt_state",) + k: v for k, v in tree_paths(state.opt_state).items()}

    def gaps(a, b):
        la, lb = leaves(a), leaves(b)
        return {"/".join(k): float((la[k].double() - lb[k].double()).abs().max())
                for k in la if not torch.equal(la[k], lb[k])}

    params = init_params(param_specs(cfg), torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    state = init_train_state(cfg, params)
    data = SyntheticLMData(vocab=cfg.vocab_size, batch=TRAIN_CHECK_BATCH,
                           seq=TRAIN_CHECK_SEQ, seed=seed, device=str(dev))
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10),
                           microbatches=TRAIN_MICRO)
    twin = clone_state(state)
    state, m1 = step(state, data.batch_at(0))
    twin, _ = step(twin, data.batch_at(0))
    repeat = gaps(state, twin)
    for s in range(1, TRAIN_RESUME_AT):
        state, _ = step(state, data.batch_at(s))
    with tempfile.TemporaryDirectory() as tmp:
        ck = AsyncCheckpointer(tmp)
        ck.save(state, step=TRAIN_RESUME_AT)
        ck.wait()
        restored, meta = restore_checkpoint(ck.latest(), template=state, device=dev)
    straight, ms = step(clone_state(state), data.batch_at(TRAIN_RESUME_AT))
    resumed, mr = step(restored, data.batch_at(meta["step"]))
    resume = gaps(straight, resumed)
    # where the card does not repeat itself, the resume is held to that spread
    bitwise = not repeat
    require(meta["step"] == TRAIN_RESUME_AT, f"lm_train resume: meta {meta}")
    require(not resume if bitwise else all(
        v <= 2 * max(repeat.values()) for v in resume.values()),
        f"lm_train resume: step {TRAIN_RESUME_AT + 1} after a restore differs: {resume}")
    require(all(torch.isfinite(t).all() for t in tree_leaves(resumed.params)),
            "lm_train resume: a parameter is not finite")
    return {"arch": cfg.name, "steps_before_save": TRAIN_RESUME_AT,
            "repeats_its_bits": bitwise, "repeat_leaves_differing": repeat,
            "resume_bitwise": not resume, "resume_leaves_differing": resume,
            "loss_step1": float(m1["loss"]), "loss_resumed": float(mr["loss"]),
            "loss_straight": float(ms["loss"])}


def lm_train_phase(args, dev, card) -> dict:
    """The training path on the card (see the module docstring); emits one
    record a part and returns them."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import AdamWConfig, adamw_update_, make_train_step
    from repro_torch.train.train_loop import init_train_state, microbatch_grads

    t_phase = time.perf_counter()
    recs = {}

    # (a) every reduced config, the card against the CPU
    rows = [train_card_vs_cpu(arch, args.seed, dev) for arch in ARCH_IDS]
    recs["card_vs_cpu"] = {"phase": "lm_train", "part": "card_vs_cpu", "seed": args.seed,
                           "batch": TRAIN_CHECK_BATCH, "seq": TRAIN_CHECK_SEQ,
                           "microbatches": TRAIN_MICRO, "rtol": 1e-4, "atol_of_max": 1e-4,
                           "allow_tf32": torch.backends.cuda.matmul.allow_tf32, "archs": rows,
                           "phase_s": time.perf_counter() - t_phase, **card}
    emit(recs["card_vs_cpu"])

    # (b) granite-3-2b at full width and depth
    t0 = time.perf_counter()
    cfg = configs.get_config(TRAIN_ARCH)
    n_params = cfg.param_count(param_specs(cfg))
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    require(free > 16 * n_params, f"lm_train: {cfg.name} needs {16 * n_params} bytes of "
                                  f"parameters, gradients and moments, {free} free")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(param_specs(cfg), torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    state = init_train_state(cfg, params)
    data = SyntheticLMData(vocab=cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           seed=args.seed, device=str(dev))
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, opt, microbatches=TRAIN_MICRO)
    # a sample of every leaf, to see the parameters move
    sample = [t.reshape(-1)[:4096].clone() for t in tree_leaves(state.params)]
    losses, norms, step_ms = [], [], []
    for s in range(TRAIN_STEPS):
        batch = data.batch_at(s)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, batch)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    moved = sum(int(not torch.equal(a, t.reshape(-1)[:4096]))
                for a, t in zip(sample, tree_leaves(state.params)))
    require(all(math.isfinite(v) for v in losses + norms),
            f"lm_train: {cfg.name}'s loss {losses} or grad_norm {norms} is not finite")
    require(moved == len(sample), f"lm_train: {moved} of {len(sample)} parameter leaves moved")
    # the AdamW update alone, on the gradients of one more batch
    grads, _ = microbatch_grads(cfg, state.params, data.batch_at(TRAIN_STEPS), TRAIN_MICRO)
    update_ms = []
    for _ in range(TRAIN_UPDATE_REPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        adamw_update_(opt, state.params, grads, state.opt_state)
        e1.record()
        e1.synchronize()
        update_ms.append(e0.elapsed_time(e1))
    del state, params, grads, sample, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    work = train_work(cfg, TRAIN_BATCH, TRAIN_SEQ)
    ms = statistics.median(step_ms[1:])
    upd = statistics.median(update_ms)
    upd_bytes = 7 * 4 * n_params
    upd_bound_ms = upd_bytes / HBM_BYTES_PER_S * 1e3
    recs["full"] = {
        "phase": "lm_train", "part": "full_width", "arch": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "tokens": TRAIN_BATCH * TRAIN_SEQ, "microbatches": TRAIN_MICRO, "remat": cfg.remat,
        "dtype": "float32", "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "seed": args.seed, "lr": TRAIN_LR, "losses": losses, "grad_norms": norms,
        "leaves_moved": moved, "step_ms": step_ms, "step_ms_first": step_ms[0],
        "step_ms_median_2_on": ms, "step_bound_ms": work["bound_us"] / 1e3,
        "step_bound_by": work["bound_by"], "step_ops": work["ops"],
        "step_bound_share": work["bound_us"] / 1e3 / ms,
        "step_tflops": work["ops"] / ms / 1e9,
        "update_ms": update_ms, "update_ms_median": upd, "update_bound_ms": upd_bound_ms,
        "update_bound_by": "bytes", "update_bytes": upd_bytes,
        "update_bound_share": upd_bound_ms / upd,
        "max_memory_allocated": peak, "card_free_bytes_before": free,
        "part_s": time.perf_counter() - t0, **card}
    emit(recs["full"])

    # (c) resume on the card, reduced granite
    t0 = time.perf_counter()
    recs["resume"] = {"phase": "lm_train", "part": "resume",
                      **train_resume(get_reduced(TRAIN_ARCH), args.seed, dev),
                      "part_s": time.perf_counter() - t0, **card}
    emit(recs["resume"])

    # (d) the CLI, reduced, on the card
    cli = []
    for extra in ([], ["--compress-grads"]):
        t0 = time.perf_counter()
        out = train_cli.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_CLI_STEPS), *extra])
        require(out["device"].startswith("cuda") and all(math.isfinite(v)
                                                         for v in out["losses"]),
                f"lm_train CLI {extra}: {out['device']} {out['losses']}")
        cli.append({"args": ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_CLI_STEPS), *extra],
                    "device": out["device"], "losses_first_last": [out["losses"][0],
                                                                    out["losses"][-1]],
                    "loss_mean_first5": statistics.mean(out["losses"][:5]),
                    "loss_mean_last5": statistics.mean(out["losses"][-5:]),
                    "train_s": out["seconds"], "wall_s": time.perf_counter() - t0})
        del out
    recs["cli"] = {"phase": "lm_train", "part": "cli", "runs": cli,
                   "phase_s": time.perf_counter() - t_phase, **card}
    emit(recs["cli"])
    return recs


DRYRUN_LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_UNPROFILED = ("solve_nb100k_rows",)


def dryrun_phase(dev, card) -> dict:
    """The port's dry run (``repro_torch.launch.dryrun``; see the module
    docstring): the SpTRSV cells on 16x16 meshes of cuda:0 positions, the
    LM cells of granite-3-2b counted on meta, and the counting mode on
    CUDA tensors against meta on lm_serve's prefill. Emits a line a cell
    and the phase's record, and returns the record with the launches of
    its path (the cells' checked solves)."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.kernels import sptrsv
    from repro_torch.launch import dryrun
    from repro_torch.launch.inputs import make_train_batch
    from repro_torch.launch.op_analysis import count_ops
    from repro_torch.models import abstract_params, init_params, param_specs, prefill

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sptrsv.reset_launches()  # the dry run's launches start here
    cells = []
    for name in dryrun.SPTRSV_SHAPES:
        t0 = time.perf_counter()
        # the profile of one solve, on one cell a matrix (it took 17-35 s on
        # the third cell, whose launches are the second's)
        probe = (None if name in DRYRUN_UNPROFILED else
                 lambda solve: profile_iterations(lambda k: [solve() for _ in range(k)], 1))
        rec = dryrun.run_sptrsv_cell(name, save=False, device=dev, probe=probe)
        torch.cuda.synchronize()
        require(rec["status"] == "OK" and rec["bitwise_vs_kernel_backend"] and rec["x_finite"],
                f"dryrun {name}: {rec.get('error')}")
        require(rec["launches_counted"] == rec["launches_per_solve"]
                == rec["binding"]["launches_per_solve"]["mrhs"],
                f"dryrun {name}: launches {rec['launches_counted']} != describe()'s")
        cell = {key: rec[key] for key in (
            "cell", "mesh", "chips", "positions_on", "supersteps", "shard", "comm", "nnz",
            "model_flops", "rhs", "solve_values", "launches_per_solve", "launches_counted",
            "ms", "ms_all", "ms_clock", "bound_share", "roofline", "plan_s", "bind_s",
            "reference_s", "timing_s", "compile_s",
            "bitwise_vs_kernel_backend", "nvidia_smi")}
        cell["n_levels"] = rec["binding"]["n_levels"]
        cell["probe_s"] = rec.get("probe_s")
        cell["profile_1_solve"] = None if probe is None else {key: rec["probe"][key] for key in (
            "elapsed_ms", "ms_per_iter", "device_busy_ms", "kernel_ms_sum", "idle_share",
            "kernels", "launches", "top")}
        cell["cell_s"] = time.perf_counter() - t0
        cells.append(cell)
        emit({"phase": "dryrun", "sptrsv": cell, **card})
    sptrsv_launches = dict(sptrsv.launches)
    launches = {"range_mrhs": sum(c["launches_counted"] for c in cells)}
    require(launches["range_mrhs"] > 0, "the dry run launched no range kernel")

    lm = []
    for shape in DRYRUN_LM_SHAPES:
        rec = dryrun.run_cell(LM_ARCH, shape, save=False)
        require(rec["status"] == "OK", f"dryrun {LM_ARCH} {shape}: {rec.get('error')}")
        r = rec["roofline"]
        lm.append({"cell": rec["cell"], "count_s": rec["count_s"], "chips": rec["chips"],
                   "flops_total": r["flops_total"], "bytes_total": r["bytes_total"],
                   "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
                   "t_memory_lb_s": r["t_memory_lb_s"], "dominant": r["dominant"],
                   "model_flops": rec["model_flops"],
                   "useful_flops_ratio": rec["useful_flops_ratio"],
                   "memory_analysis": {k: v for k, v in rec["memory_analysis"].items()
                                       if k.endswith("_in_bytes")}})
        emit({"phase": "dryrun", "lm": lm[-1]})

    # the counting mode on the card's tensors against meta: lm_serve's prefill
    cfg = configs.get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(param_specs(cfg), gen, dtype=torch.float32, device=dev)
    batch = make_train_batch(cfg, batch=LM_BATCH, seq_len=LM_PROMPT, seed=0, device=dev)
    max_len = LM_PROMPT + LM_NEW
    t0 = time.perf_counter()
    with torch.no_grad():
        (logits, _, _), c_cuda = count_ops(
            lambda: prefill(cfg, params, batch, max_len=max_len), log=True)
        torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    require(bool(torch.isfinite(logits).all()), "dryrun: the counted prefill's logits")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta_params = abstract_params(param_specs(cfg), dtype=torch.float32)
    meta_batch = {k: v.to("meta") for k, v in batch.items()}
    c_meta = count_ops(lambda: prefill(cfg, meta_params, meta_batch, max_len=max_len),
                       log=True)[1]
    meta_s = time.perf_counter() - t0
    a, b = c_cuda.costed(), c_meta.costed()
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    require(a == b and c_cuda.dots == c_meta.dots,
            f"dryrun: the CUDA count != the meta count op by op ({len(a)} / {len(b)} ops; "
            f"first difference at {first}: {a[first] if first is not None else None} / "
            f"{b[first] if first is not None else None})")
    work = lm_work(cfg, LM_BATCH, LM_PROMPT, None)
    counted = {"ops": len(a), "dots": len(c_cuda.dots), "flops": c_cuda.flops,
               "bytes": c_cuda.bytes, "lm_work_ops": work["ops"],
               "flops_over_lm_work": c_cuda.flops / work["ops"],
               "top": c_cuda.breakdown(top=5), "cuda_s": cuda_s, "meta_s": meta_s,
               "equal_op_by_op": True}
    emit({"phase": "dryrun", "count_cuda_vs_meta": counted})
    rec = {"phase": "dryrun", "sptrsv_cells": [c["cell"] for c in cells],
           "lm_cells": [c["cell"] for c in lm], "launches": launches,
           "launches_all": sptrsv_launches, "phase_s": time.perf_counter() - t_phase, **card}
    emit(rec)
    return rec


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA GPU.")
    ap.add_argument("--seed", type=int, default=0, help="seed of the pcg phase's right-hand sides")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch
    from repro_torch.core import elastic_transform
    from repro_torch.kernels import build, spmv, sptrsv
    from repro_torch.kernels.levels import level_order
    from repro_torch.kernels.ops import elastic_kernel_arrays, level_plan_arrays, ordered_walk
    from repro_torch.kernels.ref import (
        spmv_ell_rows_ref,
        spmv_sliced_ref,
        sptrsv_level_ref,
        sptrsv_ordered_ref,
        sptrsv_ref,
    )
    from repro_torch.launch.dryrun import dominant_values, nvidia_smi_line, sptrsv_work
    from repro_torch.solver.executor import pad_rhs, plan_arrays
    from repro_torch.sparse import (
        csr_from_coo,
        dag_from_lower_csr,
        erdos_renyi_lower,
        ichol0,
        narrow_band_lower,
        poisson2d_matrix,
    )
    from repro_torch.sparse.dag import longest_path_length

    dev = torch.device("cuda")

    # ------------------------------------------------------------ env
    smi = nvidia_smi_line()
    require(smi, "nvidia-smi gave no name and power limit")
    nvcc_line = [ln for ln in run([build.nvcc_path(), "--version"]).splitlines()
                 if "release" in ln][0].strip()
    card = {"nvidia_smi": smi}
    emit({"phase": "env", **card, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc_line})

    # ---------------------------------------------------------- build
    sources = sorted(build.CSRC.glob("*.cu"))
    require({s.name for s in sources} >= {k[1] for k in KERNELS.values()},
            f"missing kernel sources in {build.CSRC}")
    for src in sources:
        build.library_path(src).unlink(missing_ok=True)  # build from the sources

    def timed_build(src):
        t0 = time.perf_counter()
        _, log = build.build(src)
        return time.perf_counter() - t0, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        built = list(pool.map(timed_build, sources))
    build_s = time.perf_counter() - t0
    for src in sources:
        build.load(src.stem)
    emit({"phase": "build", "flags": " ".join(build.NVCC_FLAGS),
          "seconds": round(build_s, 3),
          "sources": [{"source": str(src.relative_to(ROOT)), "seconds": round(sec, 3),
                       "ptxas": [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                                 if "registers" in ln]}
                      for src, (sec, log) in zip(sources, built)]})

    def bits(t):
        t = t.detach().cpu().contiguous()
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64).long()

    def bitwise_equal(a, b) -> bool:
        return a.shape == b.shape and torch.equal(bits(a), bits(b))

    def ulp_gap(a, b) -> int:
        ia, ib = bits(a), bits(b)
        sign = 1 << (31 if a.dtype == torch.float32 else 63)
        mono = lambda i: torch.where(i < 0, -(i & (sign - 1)), i)  # noqa: E731
        return int((mono(ia) - mono(ib)).abs().max()) if ia.numel() else 0

    def max_abs(a, b) -> float:
        d = (a.detach().cpu().double() - b.detach().cpu().double()).abs()
        return float(d.max()) if d.numel() else 0.0

    def cuda_times(fn, warmup, reps):
        for _ in range(warmup):
            fn()
        out = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return out

    # -------------------------------------------------------- kernels
    small = {"er": erdos_renyi_lower(2000, 5e-3, seed=0),
             "nb": narrow_band_lower(2000, 0.14, 10, seed=0)}
    sptrsv.reset_launches()
    cells = []
    for gen_name, L in small.items():
        for k in (8, 32):
            for width in (None, 2):
                plan = repro_torch.TriangularSolver.plan(
                    L, k=k, width=width, device="cpu").exec_plan
                pa_cpu = plan_arrays(plan, device="cpu")
                la_gpu = level_plan_arrays(plan, device=dev)
                rng = np.random.default_rng(k)
                for m in (None, 5, 64, 300):
                    b = torch.as_tensor(rng.standard_normal(
                        2000 if m is None else (2000, m)), dtype=torch.float32)
                    b_pad = pad_rhs(b)
                    x_cpu = sptrsv_ref(*pa_cpu[:5], b_pad)
                    # one block for b f[n+1], a block per column for f[n+1, m]
                    x_gpu = sptrsv.sptrsv_level_cuda(*la_gpu[:7], b_pad.to(dev),
                                                     chunks=la_gpu.chunks)
                    x_plain_gpu = sptrsv_level_ref(*la_gpu[:7], b_pad.to(dev))
                    torch.cuda.synchronize()
                    same = bitwise_equal(x_gpu, x_cpu)
                    cells.append({"matrix": gen_name, "k": k, "W": plan.W,
                                  "T": plan.n_steps, "m": m, "bitwise": same,
                                  "levels": int(la_gpu.level_ptr.numel() - 1),
                                  "ulp_vs_plain_on_card": ulp_gap(x_gpu, x_plain_gpu)})
                    require(same, f"kernel != CPU plain version at {cells[-1]}")
                    if m in (None, 5):  # range launches, one a superstep
                        b_r = (b_pad if m is None else b_pad.T.contiguous()).to(dev)
                        x_r = torch.zeros_like(b_r)
                        cuts = superstep_ranges(la_gpu.order)
                        # no levels packed across a range's bounds
                        cut = level_plan_arrays(plan, device=dev, order=la_gpu.order,
                                                cuts=cuts).chunks
                        for lo, hi in zip(cuts[:-1], cuts[1:]):
                            sptrsv.sptrsv_level_range_cuda(*la_gpu[:7], lo, hi, b_r, x_r,
                                                           chunks=cut)
                        torch.cuda.synchronize()
                        cells[-1]["range_launches_bitwise_full"] = bitwise_equal(
                            x_r if m is None else x_r.T, x_gpu)
                        require(cells[-1]["range_launches_bitwise_full"],
                                f"range launches != one full launch at {cells[-1]}")
    emit({"phase": "kernels", "names": ["sptrsv_single", "sptrsv_mrhs", "sptrsv_range_single",
                                        "sptrsv_range_mrhs"],
          "launches": dict(sptrsv.launches), "cells": len(cells),
          "all_bitwise_vs_cpu_plain": all(c["bitwise"] for c in cells),
          "max_ulp_vs_plain_on_card": max(c["ulp_vs_plain_on_card"] for c in cells),
          "detail": cells})

    sptrsv.reset_launches()
    cells = []
    for gen_name, L in small.items():
        for k in (8, 32):
            plan = repro_torch.TriangularSolver.plan(L, k=k, device="cpu").exec_plan
            pa_cpu = plan_arrays(plan, device="cpu")
            for slack in (1, 8):
                plan_e = dataclasses.replace(plan, elastic=elastic_transform(plan, slack))
                la_cpu = elastic_kernel_arrays(plan_e, device="cpu")
                la_gpu = elastic_kernel_arrays(plan_e, device=dev)
                rng = np.random.default_rng(k + slack)
                for m in (None, 5, 64):
                    b_pad = pad_rhs(torch.as_tensor(rng.standard_normal(
                        2000 if m is None else (2000, m)), dtype=torch.float32))
                    x_cpu = sptrsv_level_ref(*la_cpu[:7], b_pad)
                    x_bulk = sptrsv_ref(*pa_cpu[:5], b_pad)
                    x_gpu = sptrsv.sptrsv_elastic_cuda(*la_gpu[:7], b_pad.to(dev),
                                                       chunks=la_gpu.chunks)
                    torch.cuda.synchronize()
                    same = bitwise_equal(x_gpu, x_cpu)
                    cells.append({"matrix": gen_name, "k": k, "slack": slack, "W": plan.W,
                                  "T": plan.n_steps, "supersteps": plan.n_supersteps,
                                  "levels": int(la_gpu.level_ptr.numel() - 1),
                                  "waves": int(plan_e.elastic.n_waves.sum()),
                                  "m": m, "bitwise": same,
                                  "bitwise_vs_bulk": bitwise_equal(x_gpu, x_bulk)})
                    require(same and cells[-1]["bitwise_vs_bulk"],
                            f"elastic kernel != CPU plain versions at {cells[-1]}")
    emit({"phase": "kernels", "names": ["sptrsv_elastic_single", "sptrsv_elastic_mrhs"],
          "launches": {key: sptrsv.launches[key] for key in ("elastic_single", "elastic_mrhs")},
          "cells": len(cells), "all_bitwise_vs_cpu_plain": True,
          "all_bitwise_vs_bulk_plain": True, "detail": cells})

    spmv.reset_launches()
    cells = []
    er = small["er"]  # with three dense rows, which split into many pieces
    dense = [np.full(i, i) for i in (500, 1000, 1999)]
    arrow = csr_from_coo(
        2000, 2000, np.concatenate([er.row_of_entry(), *dense]),
        np.concatenate([er.indices, *[np.arange(i) for i in (500, 1000, 1999)]]),
        np.random.default_rng(8).uniform(-1, 1, er.nnz + 3499))
    for gen_name, L in {**small, "arrow": arrow}.items():
        for width in (None, 2):
            for dtype in (torch.float32, torch.float64):
                np_dtype = np.float32 if dtype == torch.float32 else np.float64
                lay = spmv.sliced_from_csr(L, width=width, dtype=np_dtype)
                host = [torch.from_numpy(a) for a in lay[:4]]
                x = torch.as_tensor(np.random.default_rng(3).standard_normal(L.n_cols),
                                    dtype=dtype)
                y_gpu = spmv.spmv_sliced_cuda(*(t.to(dev) for t in host), lay.width, x.to(dev))
                torch.cuda.synchronize()
                y_cpu = spmv_sliced_ref(*host, lay.width, x)
                col_idx, vals, row_map = spmv.ell_from_csr(L, width=width, dtype=np_dtype)
                y_def = spmv_ell_rows_ref(torch.from_numpy(col_idx), torch.from_numpy(vals),
                                          torch.from_numpy(row_map), x)
                cells.append({"matrix": gen_name, "dtype": str(dtype).replace("torch.", ""),
                              "W": lay.width, "pieces": int(col_idx.shape[0]),
                              "split_rows": int((lay.row_len > lay.width).sum()),
                              "lane_idle_share": lay.lane_idle_share(),
                              "bitwise": bitwise_equal(y_gpu, y_cpu),
                              "bitwise_vs_ell_definition": bitwise_equal(y_gpu, y_def)})
                require(cells[-1]["bitwise"] and cells[-1]["bitwise_vs_ell_definition"],
                        f"spmv kernel != CPU plain version at {cells[-1]}")
    require(spmv.launches["spmv"] == len(cells), f"spmv launches {spmv.launches}")
    emit({"phase": "kernels", "names": ["spmv"], "launches": dict(spmv.launches),
          "cells": len(cells), "all_bitwise_vs_cpu_plain": True,
          "all_bitwise_vs_ell_definition": True, "detail": cells})

    # ------------------------------------------------------ main_path
    import scipy.sparse.linalg as spla

    mats = {}
    t0 = time.perf_counter()
    mats["er"] = erdos_renyi_lower(100_000, 1e-4, seed=0)
    nb = narrow_band_lower(100_000, 0.14, 10, seed=0)
    # the paper's NB values make |x| grow past float32 along the 10^4-step
    # deep chains (inf, then NaN); keep its pattern, make it dominant
    mats["nb"] = dataclasses.replace(nb, data=dominant_values(nb))
    lf = ichol0(poisson2d_matrix(128))
    gen_s = time.perf_counter() - t0
    rng = np.random.default_rng(2025)
    main_err = {"sptrsv_single": 0.0, "sptrsv_mrhs": 0.0}
    solvers, rows, inputs, answers = {}, [], {}, {}
    sptrsv.reset_launches()  # the main path's launches start here
    spmv.reset_launches()
    for name, L in mats.items():
        n = L.n_rows
        t0 = time.perf_counter()
        gpu = repro_torch.TriangularSolver.plan(L)  # every default
        plan_s = time.perf_counter() - t0
        require(gpu.device.type == "cuda" and gpu.backend == "kernel", "defaults")
        cpu = repro_torch.TriangularSolver.plan(L, device="cpu", backend="scan")
        b = rng.standard_normal(n)
        B = rng.standard_normal((n, MAIN_M))
        new_data = dominant_values(L, L.data * rng.uniform(0.5, 1.5, L.nnz))
        inputs[name] = (b, B, new_data)
        row = {"matrix": name, "n": n, "nnz": L.nnz, "plan_s": round(plan_s, 3),
               **{key: gpu.info()["plan"][key] for key in ("n_steps", "n_supersteps", "W", "k")},
               "n_levels": gpu.bound.describe()["n_levels"]}
        for stage in ("initial", "numeric_update"):
            if stage == "numeric_update":
                gpu.numeric_update(new_data)
                cpu.numeric_update(new_data)
            for kname, rhs in (("sptrsv_single", b), ("sptrsv_mrhs", B)):
                x = gpu.solve(rhs)
                torch.cuda.synchronize()
                x_ref = cpu.solve(rhs)
                require(x.device.type == "cuda" and x.shape == x_ref.shape, "shape")
                require(bool(torch.isfinite(x).all()), f"{name} {stage}: non-finite x")
                require(bitwise_equal(x, x_ref),
                        f"{name} {stage} {kname}: kernel != CPU plain version")
                main_err[kname] = max(main_err[kname], max_abs(x, x_ref))
                answers[(name, stage, kname)] = x
            if stage == "initial":
                A = L.to_scipy().tocsr()
                x64 = spla.spsolve_triangular(A, b, lower=True)
                x = gpu.solve(b).double().cpu().numpy()
                row["relerr_vs_scipy_f64"] = float(
                    np.linalg.norm(x - x64) / np.linalg.norm(x64))
        rows.append(row)
        solvers[name] = gpu
    fwd, bwd = repro_torch.factor_pair(lf)
    fwd_c, bwd_c = repro_torch.factor_pair(lf, device="cpu", backend="scan")
    r = rng.standard_normal(lf.n_rows)
    z = bwd.solve(fwd.solve(r))
    torch.cuda.synchronize()
    require(bitwise_equal(z, bwd_c.solve(fwd_c.solve(r))), "factor_pair != CPU plain")
    A = lf.to_scipy().tocsr()
    zz = z.double().cpu().numpy()
    pcg_relres = float(np.linalg.norm(A @ (A.T @ zz) - r) / np.linalg.norm(r))
    main_launches = dict(sptrsv.launches)
    for kname in ("sptrsv_single", "sptrsv_mrhs"):
        require(main_launches[KERNELS[kname][2]] > 0,
                f"{kname} was not launched on the main path")
    # why NB carries a dominant diagonal: its own values, same plan
    x_paper = solvers["nb"].clone_with_values(nb.data).solve(rng.standard_normal(nb.n_rows))
    nb_paper_finite = bool(torch.isfinite(x_paper).all())
    emit({"phase": "main_path", "matrices": rows, "generate_s": round(gen_s, 3),
          "factor_pair": {"n": lf.n_rows, "nnz": lf.nnz,
                          "steps": [fwd.exec_plan.n_steps, bwd.exec_plan.n_steps],
                          "bitwise_vs_cpu_plain": True,
                          "relres_LLt_f64": pcg_relres},
          "launches": main_launches, "bitwise_vs_cpu_plain": True,
          "nb_with_paper_values_finite": nb_paper_finite,
          "max_abs_err": main_err, **card})

    # --------------------------------------------- main_path_elastic
    sptrsv.reset_launches()  # the elastic path's launches start here
    elastic_solvers, rows = {}, []
    for name, L in mats.items():
        b, B, new_data = inputs[name]
        t0 = time.perf_counter()
        el = repro_torch.TriangularSolver.plan(L, mode="elastic")
        plan_s = time.perf_counter() - t0
        require(el.device.type == "cuda" and el.bound.backend == "kernel"
                and el.info()["mode"] == "elastic", "elastic defaults")
        for stage in ("initial", "numeric_update"):
            if stage == "numeric_update":
                el.numeric_update(new_data)
            for kname, rhs in (("sptrsv_elastic_single", b), ("sptrsv_elastic_mrhs", B)):
                x = el.solve(rhs)
                torch.cuda.synchronize()
                # the bulk answer, itself bitwise-equal to the CPU plain version
                x_bulk = answers[(name, stage, kname.replace("elastic_", ""))]
                require(bitwise_equal(x, x_bulk),
                        f"{name} {stage} {kname}: elastic kernel != bulk answer")
                main_err[kname] = max(main_err.get(kname, 0.0), max_abs(x, x_bulk))
        ep = el.exec_plan.elastic
        # one block barrier per level of the order over runs of slack
        # supersteps; the certificate's waves are what the TPU kernel walks
        rows.append({"matrix": name, "plan_s": round(plan_s, 3), "slack": ep.slack,
                     "n_steps": ep.n_steps, "n_supersteps": ep.n_supersteps,
                     # both bulk kernels walk the bulk level order
                     "barriers_bulk": solvers[name].bound.describe()["n_levels"],
                     "barriers_elastic": el.bound.describe()["n_levels"],
                     "waves_certificate": int(ep.n_waves.sum()),
                     "mean_waves_per_tile": float(ep.n_waves.mean())})
        elastic_solvers[name] = el
    elastic_launches = dict(sptrsv.launches)
    for kname in ("sptrsv_elastic_single", "sptrsv_elastic_mrhs"):
        require(elastic_launches[KERNELS[kname][2]] > 0,
                f"{kname} was not launched on the elastic path")
    require(elastic_launches["ordered_single"] == elastic_launches["ordered_mrhs"] == 0,
            "the elastic path launched a bulk kernel")
    emit({"phase": "main_path_elastic", "matrices": rows, "launches": elastic_launches,
          "bitwise_vs_bulk": True, "max_abs_err": {
              k: main_err[k] for k in ("sptrsv_elastic_single", "sptrsv_elastic_mrhs")},
          **card})

    # ------------------------------------------------------- validate
    validated = validate_phase(mats, inputs, answers, bitwise_equal, card)

    # ------------------------------------------------ main_path_spmv
    spmv.reset_launches()  # the SpMV path's launches start here
    rows = []
    spmv_x = {}
    for name, L in mats.items():
        x = rng.standard_normal(L.n_cols)
        spmv_x[name] = x
        y = spmv.spmv(L, x)  # float32 on the card
        torch.cuda.synchronize()
        y_cpu = spmv.spmv(L, x, device="cpu")
        y64 = L.to_scipy() @ x
        yy = y.double().cpu().numpy()
        rel = float(np.linalg.norm(yy - y64) / np.linalg.norm(y64))
        require(y.device.type == "cuda" and y.shape == (L.n_rows,)
                and bool(torch.isfinite(y).all()), f"{name}: spmv output")
        require(bitwise_equal(y, y_cpu), f"{name}: spmv != CPU plain version")
        require(rel <= 1e-5, f"{name}: spmv relative error {rel} vs scipy f64")
        main_err["spmv"] = max(main_err.get("spmv", 0.0), max_abs(y, y_cpu))
        rows.append({"matrix": name, "n": L.n_rows, "nnz": L.nnz,
                     "relerr_vs_scipy_f64": rel,
                     "max_abs_vs_scipy_f64": float(np.abs(yy - y64).max())})
    spmv_launches = dict(spmv.launches)
    require(spmv_launches["spmv"] == len(mats), f"spmv launches {spmv_launches}: one a call")
    emit({"phase": "main_path_spmv", "matrices": rows, "launches": spmv_launches,
          "bitwise_vs_cpu_plain": True, "max_abs_err": main_err["spmv"], **card})
    path_launches = {**main_launches, **{k: elastic_launches[k] for k in (
        "elastic_ordered_single", "elastic_ordered_mrhs")}, **spmv_launches}
    for key, v in validated["launches"].items():  # the validated paths'
        path_launches[key] = path_launches.get(key, 0) + v

    # --------------------------------------------- strategies, auto
    with twin_pool() as pool:  # the CPU plain versions of both phases' plans
        refs = scipy_refs(mats, inputs)
        strat = strategies_phase(mats, inputs, refs, cuda_times, bitwise_equal, max_abs,
                                 main_err, card, pool)
        auto, auto_cache = auto_phase(mats, inputs, refs, cuda_times, bitwise_equal, max_abs,
                                      main_err, card, strat["rows"], pool)
    # the kernels' path launches add these paths' (the tuned plans' trials
    # and solves too, but not the launches that time a kernel alone)
    for counts in (strat["launches"], *auto["launches"].values()):
        for key, v in counts.items():
            path_launches[key] += v

    # ------------------------------------------------------------ pcg
    pcg = pcg_phase(args, dev, cuda_times, bitwise_equal, max_abs, main_err, card)
    # the kernels' path launches add this path's
    path_launches["ordered_single"] += pcg["launches"]["ordered_single"]
    path_launches["spmv"] += pcg["launches"]["spmv"]

    # ---------------------------------------------------------- serve
    serve, bank_timing = serve_phase(mats, inputs, solvers["er"], auto_cache, cuda_times,
                                     bitwise_equal, max_abs, main_err, card)
    for row in serve["modes"]:  # the serving loops' launches, not the replays'
        for key, v in row["launches"].items():
            path_launches[key] += v

    # ---------------------------------------------------- distributed
    dist = distributed_phase(solvers, mats, inputs, cuda_times, bitwise_equal, max_abs,
                             main_err, card, dev)
    for key, v in dist["launches"].items():
        path_launches[key] = path_launches.get(key, 0) + v

    # ------------------------------------------------------- lm_serve
    lm_serve_phase(args, dev, cuda_times, card)

    # --------------------------------------------------- lm_families
    lm_families_phase(args, dev, cuda_times, card)

    # -------------------------------------------------- lm_frontends
    lm_frontends_phase(args, dev, cuda_times, card)

    # ------------------------------------------------------- lm_train
    lm_train_phase(args, dev, card)

    # --------------------------------------------------------- dryrun
    dry = dryrun_phase(dev, card)
    for key, v in dry["launches"].items():
        path_launches[key] = path_launches.get(key, 0) + v

    # --------------------------------------------------------- timing
    def graph_ms(fn, reps):
        """Median ms of replaying a CUDA graph that holds ``fn``'s launches:
        the device's time without the host's launch path (wrapper checks,
        ctypes), which an eager call of a short kernel is bound by;
        (None, error text) where capture is refused."""
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return statistics.median(cuda_times(g.replay, 3, reps)), None
        except RuntimeError as e:
            return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"

    def library_ms(L, values, rhs, x_port):
        """Median ms of torch.triangular_solve on L's pattern with
        ``values`` as sparse CSR, and the relative gap of its answer to the
        port's ``solve(rhs)`` on the same values (it must solve the same
        system); (None, None, error text) where it is refused."""
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                Lc = torch.sparse_csr_tensor(
                    torch.as_tensor(L.indptr), torch.as_tensor(L.indices),
                    torch.as_tensor(values, dtype=torch.float32),
                    size=(L.n_rows, L.n_cols),
                ).to(dev)
                Bd = rhs.reshape(L.n_rows, -1).contiguous()
                ts = cuda_times(lambda: torch.triangular_solve(Bd, Lc, upper=False), 1, 5)
                x_lib = torch.triangular_solve(Bd, Lc, upper=False)[0]
            ref = x_port.reshape(x_lib.shape).double()
            gap = float((x_lib.double() - ref).norm() / ref.norm())
            return statistics.median(ts), gap, None
        except (RuntimeError, NotImplementedError, TypeError) as e:
            return None, None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"

    def rhs_pad(n, m):
        shape = (n + 1,) if m is None else (n + 1, m)
        return torch.randn(shape, generator=torch.Generator().manual_seed(7)).to(dev)

    def ordered_timing(solver, la, rhs, elastic, what):
        """The main path's kernel at this shape: the ordered solve (b and x
        in the caller's row order, one launch) on ``rhs`` over ``la`` and
        the solver's row order, its ms, and its plain version's once, both
        answers bitwise the front door's."""
        walk = ordered_walk(la, solver._perm, elastic=elastic)
        ms = statistics.median(cuda_times(lambda: sptrsv.sptrsv_ordered_cuda(walk, rhs), 3, 20))
        x = sptrsv.sptrsv_ordered_cuda(walk, rhs)
        x_plain = []
        plain = cuda_times(lambda: x_plain.append(
            sptrsv_ordered_ref(*la[:7], solver._perm, rhs)), 0, 1)
        require(bitwise_equal(x, x_plain[0]), f"{what}: timed ordered solve != plain")
        require(bitwise_equal(x, solver.solve(rhs)), f"{what}: ordered solve != front door")
        return {"ordered_ms": ms, "ordered_plain_ms": statistics.median(plain),
                "ordered_grid": min(max(rhs.shape[1] if rhs.dim() == 2 else 1,
                                        sptrsv.ORDERED_SPREAD), sptrsv.ordered_columns(walk))}

    timing = {}
    for name, gpu in solvers.items():
        plan = gpu.exec_plan
        t0 = time.perf_counter()
        order = level_order(plan)
        level_s = time.perf_counter() - t0
        la = level_plan_arrays(plan, device=dev, order=order)
        esize = la.vals.element_size()
        work = sptrsv_work(plan, esize)  # the plan's share; the right-hand sides below
        stats = order.stats()
        for kname, m in (("sptrsv_single", None), ("sptrsv_mrhs", MAIN_M)):
            b_pad = rhs_pad(gpu.n, m)
            # both walk the bulk level order: one block for b f[n+1], a
            # block per column of a column-major copy (timed with it) for
            # f[n+1, m]
            ms = statistics.median(cuda_times(
                lambda: sptrsv.sptrsv_level_cuda(*la[:7], b_pad, chunks=la.chunks), 3, 20))
            x = sptrsv.sptrsv_level_cuda(*la[:7], b_pad, chunks=la.chunks)
            # the plain version once: it launches tens of operations per level
            x_plain = []
            plain = cuda_times(lambda: x_plain.append(sptrsv_level_ref(*la[:7], b_pad)), 0, 1)
            require(bitwise_equal(x, x_plain[0]), f"{name} {kname}: timed kernel != plain")
            # the library solves L itself (caller row order), so it is
            # checked against the front door's answer, not the plan's
            rhs = b_pad[:-1].contiguous()
            lib, lib_gap, lib_err = library_ms(
                mats[name], gpu.source_values, rhs, gpu.solve(rhs))
            cols = 1 if m is None else m
            # the bound is the solve's data alone, the same for every layout:
            # the plan's real work, b read and x written
            rhs_bytes = 2 * gpu.n * cols * esize
            # the kernel's arrays as it reads them, padding slots included
            plan_total = (sum(t.numel() * t.element_size() for t in la[:7])
                          + 2 * b_pad.numel() * b_pad.element_size())
            rec = {"matrix": name, "kernel": kname, "m": cols, "ms": ms,
                   "launches_per_solve": 1,
                   **bound(work["bytes"] + rhs_bytes,
                           2 * (work["entries"] + work["finishes"]) * cols),
                   "entries": work["entries"], "padding_share": work["padding_share"],
                   "bound_padded_plan_us": plan_total / HBM_BYTES_PER_S * 1e6,
                   "padded_plan_bytes": plan_total,
                   # one block barrier per level (per column block for m
                   # RHS), the plan's operands staged ahead of it a chunk at
                   # a time
                   "barriers": order.n_levels, "levels": order.n_levels,
                   "staging": la.chunks.stats(),
                   "level_width_max": stats["level_width_max"],
                   "supersteps": plan.n_supersteps, "level_order_s": level_s,
                   "plain_ms": statistics.median(plain),
                   "plain_reps": len(plain), "library_ms": lib,
                   "library": "torch.triangular_solve(B, L_csr, upper=False)",
                   "library_rel_gap_to_port": lib_gap,
                   "library_error": lib_err, **card}
            if m is None:
                rec.update(stats, dag_longest_path=longest_path_length(
                    dag_from_lower_csr(mats[name])))
            else:  # the wrapper's column-major copy of b, part of ms
                copy_in = cuda_times(lambda: b_pad.T.contiguous(), 3, 20)
                rec.update(blocks=cols, copy_in_ms=statistics.median(copy_in))
            # the same bound: the ordered solve reads b and writes x once too
            rec.update(ordered_timing(gpu, la, rhs, False, f"{name} {kname}"))
            timing[(name, kname)] = rec
            emit({"phase": "timing", **rec})
        # the range kernels: the bulk order cut at each superstep, walked by
        # one range launch a superstep into one x — the same function as
        # one full launch, so the bulk line's bound and library apply
        from repro_torch.kernels.ref import sptrsv_level_range_ref

        cuts = superstep_ranges(order)
        # no levels packed across a range's bounds
        cut = level_plan_arrays(plan, device=dev, order=order, cuts=cuts).chunks
        for kname, m in (("sptrsv_range_single", None), ("sptrsv_range_mrhs", MAIN_M)):
            b_pad = rhs_pad(gpu.n, m)
            b_r = b_pad if m is None else b_pad.T.contiguous()  # column-major for m

            def ranged(walk, x, **kw):
                for lo, hi in zip(cuts[:-1], cuts[1:]):
                    walk(*la[:7], lo, hi, b_r, x, **kw)
                return x

            ms = statistics.median(cuda_times(lambda: ranged(
                sptrsv.sptrsv_level_range_cuda, torch.zeros_like(b_r), chunks=cut), 3, 20))
            x = ranged(sptrsv.sptrsv_level_range_cuda, torch.zeros_like(b_r), chunks=cut)
            full = sptrsv.sptrsv_level_cuda(*la[:7], b_pad, chunks=la.chunks)
            require(bitwise_equal(x if m is None else x.T, full),
                    f"{name} {kname}: range launches != one full launch")
            x_plain = []
            plain = cuda_times(lambda: x_plain.append(
                ranged(sptrsv_level_range_ref, torch.zeros_like(b_r))), 0, 1)
            require(bitwise_equal(x, x_plain[0]), f"{name} {kname}: timed kernel != plain")
            bulk = timing[(name, kname.replace("range_", ""))]
            rec = {"matrix": name, "kernel": kname, "m": 1 if m is None else m, "ms": ms,
                   "launches_per_solve": sum(1 for lo, hi in zip(cuts[:-1], cuts[1:])
                                             if hi > lo),
                   "ranges": "the bulk order cut at each superstep",
                   "bound_us": bulk["bound_us"], "bound_by": bulk["bound_by"],
                   "levels": order.n_levels, "supersteps": plan.n_supersteps,
                   "full_launch_ms": bulk["ms"], "ms_over_full_launch": ms / bulk["ms"],
                   "plain_ms": statistics.median(plain), "plain_reps": len(plain),
                   "library_ms": bulk["library_ms"], "library": bulk["library"],
                   "library_error": bulk["library_error"], **card}
            timing[(name, kname)] = rec
            emit({"phase": "timing", **rec})

    for name, el in elastic_solvers.items():
        plan = el.exec_plan
        ep = plan.elastic
        t0 = time.perf_counter()
        order = level_order(plan, slack=ep.slack)
        level_s = time.perf_counter() - t0
        la = level_plan_arrays(plan, device=dev, order=order)
        esize = la.vals.element_size()
        work = sptrsv_work(plan, esize)  # the plan's share; the right-hand sides below
        for kname, m in (("sptrsv_elastic_single", None), ("sptrsv_elastic_mrhs", MAIN_M)):
            b_pad = rhs_pad(el.n, m)  # the bulk timing's right-hand side
            ms = statistics.median(cuda_times(
                lambda: sptrsv.sptrsv_elastic_cuda(*la[:7], b_pad, chunks=la.chunks), 3, 20))
            x = sptrsv.sptrsv_elastic_cuda(*la[:7], b_pad, chunks=la.chunks)
            ordered = ordered_timing(el, la, b_pad[:-1].contiguous(), True, f"{name} {kname}")
            # the plain version once: it launches tens of operations per level
            x_plain = []
            plain = cuda_times(lambda: x_plain.append(sptrsv_level_ref(*la[:7], b_pad)), 0, 1)
            require(bitwise_equal(x, x_plain[0]), f"{name} {kname}: timed kernel != plain")
            cols = 1 if m is None else m
            bulk = timing[(name, kname.replace("elastic_", ""))]
            stats = order.stats()
            rec = {"matrix": name, "kernel": kname, "m": cols, "ms": ms,
                   "launches_per_solve": 1,
                   # the solve's data alone, as for the bulk lines
                   **bound(work["bytes"] + 2 * el.n * cols * esize,
                           2 * (work["entries"] + work["finishes"]) * cols),
                   "entries": work["entries"], "slack": ep.slack,
                   # one block barrier per level (per column block for m
                   # RHS), the plan's operands staged ahead of it a chunk at
                   # a time
                   "levels": order.n_levels, "barriers": order.n_levels,
                   "staging": la.chunks.stats(),
                   "level_width_max": stats["level_width_max"],
                   "levels_per_run": stats["levels_per_run"], "level_order_s": level_s,
                   "supersteps": ep.n_supersteps, "waves_certificate": int(ep.n_waves.sum()),
                   "barriers_bulk": bulk["barriers"],
                   "bulk_ms": bulk["ms"], "ms_over_bulk": ms / bulk["ms"],
                   "plain_ms": statistics.median(plain), "plain_reps": len(plain),
                   # the same system and right-hand side as the bulk record
                   "library_ms": bulk["library_ms"], "library": bulk["library"],
                   "library_error": bulk["library_error"], **ordered, **card}
            timing[(name, kname)] = rec
            emit({"phase": "timing", **rec})

    def graph_nodes(fn):
        """The device operations of one call of ``fn``, exactly: the nodes
        of a CUDA graph that captures the call, as (node type, kernel name)
        read through the driver API (a kernel's name is mangled)."""
        import ctypes

        cu = ctypes.CDLL("libcuda.so.1")

        def check(rc, what):
            require(rc == 0, f"{what} returned CUDA driver error {rc}")

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            fn()
        handle = ctypes.c_void_p(g.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * count.value)()
        check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
        # CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset, 3 host, ...
        kinds = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host"}
        out = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            name = None
            if kind.value == 0:
                # CUDA_KERNEL_NODE_PARAMS_v2 starts with the CUfunction
                params = (ctypes.c_byte * 256)()
                check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params),
                      "cuGraphKernelNodeGetParams_v2")
                func = ctypes.c_void_p.from_buffer(params, 0)
                cname = ctypes.c_char_p()
                check(cu.cuFuncGetName(ctypes.byref(cname), func), "cuFuncGetName")
                name = cname.value.decode()
            out.append((kinds.get(kind.value, str(kind.value)), name))
        del g
        return out

    def profiled_calls(fn, reps=200):
        """``reps`` eager calls of ``fn`` under torch.profiler: the device
        operations it records, by name, with their count and mean time, and
        the device time of a call (the means summed); ``device_ms`` None
        where it records no device time. The profiler may drop device
        events (on the H100 it has recorded 197 and 198 of 200 launches
        of one kernel), so a count here is a lower bound and only the means
        are read; ``graph_nodes`` counts a call's operations exactly."""
        from torch.profiler import ProfilerActivity, profile, schedule

        # a warm-up step, traced and dropped, then the window
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ops = {}
        for evt in prof.key_averages():
            # the step's own range ("ProfilerStep#1") is an annotation the
            # profiler mirrors on the device timeline, not an operation
            if str(evt.device_type).endswith("CUDA") and not evt.key.startswith("ProfilerStep"):
                us = getattr(evt, "self_device_time_total", None)
                if us is None:
                    us = getattr(evt, "self_cuda_time_total", 0.0)
                ops[evt.key[:80]] = {"count": evt.count, "ms": us / 1e3,
                                     "mean_ms": us / 1e3 / evt.count}
        return {"reps": reps, "ops": ops,
                "events_recorded": sum(o["count"] for o in ops.values()),
                "device_ms": sum(o["mean_ms"] for o in ops.values()) if ops else None}

    def graph_calls_ms(fn, calls=100):
        """Per call: a CUDA graph of ``calls`` calls replayed, the device's
        time for back-to-back calls without the host's launch path."""
        ms, err = graph_ms(lambda: [fn() for _ in range(calls)], 20)
        return (ms / calls if ms is not None else None), err

    spmv_mats = {**mats, "pcg_A": poisson2d_matrix(PCG_GRID)}
    for name, L in spmv_mats.items():
        op = spmv.EllOperator(L)  # float32 on the card: what spmv() binds
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(L.n_cols),
                            dtype=torch.float32, device=dev)
        ms = statistics.median(cuda_times(lambda: op(x), 3, 20))
        op_graph_ms, op_graph_err = graph_ms(lambda: op(x), 20)
        op_graph100_ms, _ = graph_calls_ms(lambda: op(x))
        # the whole product is one device operation a call: the kernel
        nodes = graph_nodes(lambda: op(x))
        require(len(nodes) == 1 and nodes[0][0] == "kernel"
                and "spmv_sliced_kernel" in nodes[0][1],
                f"{name}: a spmv call is not one launch of the kernel: {nodes}")
        prof = profiled_calls(lambda: op(x))
        # the profiler may miss events but never invents them: every device
        # operation it saw is the kernel, at most one a call
        require(not prof["ops"] or (prof["events_recorded"] <= prof["reps"] and all(
            "spmv_sliced_kernel" in k for k in prof["ops"])),
            f"{name}: the spmv calls ran other device operations: {prof['ops']}")
        plain = cuda_times(lambda: spmv_sliced_ref(*op.layout[:5], x), 1, 5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            Lc = torch.sparse_csr_tensor(
                torch.as_tensor(L.indptr), torch.as_tensor(L.indices),
                torch.as_tensor(L.data, dtype=torch.float32), size=(L.n_rows, L.n_cols),
            ).to(dev)
            lib = cuda_times(lambda: Lc @ x, 1, 5)
            lib_graph_ms, lib_graph_err = graph_ms(lambda: Lc @ x, 20)
            lib_graph100_ms, _ = graph_calls_ms(lambda: Lc @ x)
            lib_prof = profiled_calls(lambda: Lc @ x)
            try:
                lib_ops = len(graph_nodes(lambda: Lc @ x))
            except RuntimeError:  # capture refused, as graph_ms records
                lib_ops = None
            y_lib = (Lc @ x).double().cpu().numpy()
        y64 = L.to_scipy() @ x.double().cpu().numpy()
        lay = op.layout
        # the function's data: each real entry's column and value, row_len
        # and slice_ptr read once, x read once, y written once (the stored
        # padding is never read)
        esize = 4
        nbytes = (L.nnz * (4 + esize) + lay.row_len.numel() * 4 + lay.slice_ptr.numel() * 8
                  + (L.n_cols + L.n_rows) * esize)
        work = bound(nbytes, 2 * L.nnz)
        device_ms = prof["device_ms"] if prof["device_ms"] is not None else op_graph100_ms
        rec = {"matrix": name, "kernel": "spmv", "n": L.n_rows, "nnz": L.nnz, "W": lay.width,
               "slots": int(lay.col.numel()), "lane_idle_share": op.lane_idle_share,
               "split_rows": int((lay.row_len > lay.width).sum()),
               "ms": ms, "graph_ms": op_graph_ms, "graph_error": op_graph_err,
               "graph100_ms_per_call": op_graph100_ms, "device_ms": device_ms,
               "device_ms_from": "profiler" if prof["device_ms"] is not None else "graph100",
               "profile": prof, "launches_per_call": len(nodes), **work,
               "bound_share": work["bound_us"] / 1e3 / device_ms if device_ms else None,
               "plain_ms": statistics.median(plain), "plain_reps": len(plain),
               "library_ms": statistics.median(lib), "library": "L_csr @ x",
               "library_graph_ms": lib_graph_ms, "library_graph_error": lib_graph_err,
               "library_graph100_ms_per_call": lib_graph100_ms,
               "library_device_ms": lib_prof["device_ms"],
               "library_ops_per_call": lib_ops,
               "library_relerr_vs_scipy_f64": float(
                   np.linalg.norm(y_lib - y64) / np.linalg.norm(y64)), **card}
        timing[(name, "spmv")] = rec
        emit({"phase": "timing", **rec})

    timing[("er", "sptrsv_bank")] = bank_timing
    summary = []
    for kname, (replaces, source, counter, body) in KERNELS.items():
        rec = timing[("er", kname)]
        row = {
            "name": kname, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "body": f"src/repro_torch/csrc/{body}",
            "replaces": replaces, "launches": path_launches[counter],
            "max_abs_err": main_err[kname], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_us"] / 1e3, "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        }
        if counter in FRONT_DOOR:  # the main path's kernel, and the walk alone
            row.update(ms=rec["ordered_ms"], plain_ms=rec["ordered_plain_ms"],
                       walk_ms=rec["ms"], walk_plain_ms=rec["plain_ms"])
        summary.append(row)
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
