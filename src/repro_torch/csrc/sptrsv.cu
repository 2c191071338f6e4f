// Scheduled sparse triangular solve (bulk-synchronous) for NVIDIA Hopper.
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/sptrsv.py::_sptrsv_kernel       (one right-hand side)
//   src/repro/kernels/sptrsv.py::_sptrsv_mrhs_kernel  (m right-hand sides)
// and computes the function the JAX scan executor defines bit for bit
// (src/repro/solver/executor.py::_step_single / _step_mrhs): for every plan
// step t and lane l,
//     acc = fma(vals[t,l,w], x[col_idx[t,l,w]], acc)   for w = 0..W-1, in order
//     if !accum[t,l]:  x[row_ids[t,l]] = (b[row] - acc) / diag[t,l];  acc = 0
// with one fused multiply-add per entry and a correctly rounded subtract and
// divide (the _rn intrinsics; this file must never be built with
// --use_fast_math). The Pallas bodies tree-sum over W instead; these kernels
// follow the executor, so they match the plain PyTorch versions
// (kernels/ref.py) bit for bit.
//
// Bound on this card. A solve reads each real plan entry and lane-step once,
// reads b and writes x (n+1 entries per right-hand side). Those bytes over
// the H100's 3.35 TB/s are the least time the card could take. The real
// limit is latency: a row reads x rows that earlier rows wrote, so the solve
// is a chain of dependent gathers (index load, then x load, then the FMA
// chain, then the store) as long as the dependency structure the kernel
// keeps.
//
// Both entries run the level walk of csrc/level.cuh over the plan in the
// bulk level order (kernels/levels.py, a run per superstep), one
// __syncthreads() per level: 80 on the paper's ER set at n = 100,000 and
// 2,020 on its NB set, against T = 13,561 and 16,635 plan steps.
// mode="elastic" launches the same code over runs of supersteps
// (csrc/sptrsv_elastic.cu).
//
// Single right-hand side: one block of 1,024 threads.
//
// A bank of plans (the serve layer's width-class grouping, for which the JAX
// package vmaps its scan over the lanes): sptrsv_bank_f32/_f64 launch the
// same column grid, block c walking column c on its own plan of the bank
// (level.cuh, sptrsv_level_bank_kernel), with the bits of the m-RHS entry on
// that plan alone. Its bound is the bytes of the lanes it reads, b and x.
//
// m right-hand sides (replaces src/repro/kernels/sptrsv.py:98,
// _sptrsv_mrhs_kernel, which carries a [k, m] accumulator tile through the
// plan's steps in VMEM): the column grid, block c walks the level order for
// column c of a column-major copy of b (rows 1 apart, columns n + 1
// apart). Columns never interact, so blocks never wait
// for each other. Bound: the single-RHS bytes with b and x m columns wide,
// 9.1 us at m = 32 on ER and 8.3 us on NB. The previous design (a thread per
// column and lane walking the lane's chain of each superstep, one barrier
// per superstep) was held back by that chain: T / S dependent plan steps per
// thread, each a gather of rows the previous step may have written, about
// 1.45 us each, on one block, so 17-20 ms at m = 32, over 2,000x the bound.
// The level walk cuts the chain to one dependent load chain per level. What
// still holds it back is what holds the single-RHS walk back: a dependent
// load chain and a block barrier per level, and on ER's wide levels (up to
// 7,548 vertices) rounds of 1,024 vertices per block. Column groups (a
// thread solving one vertex for C columns of x packed f[G, n + 1, C], one
// 16-byte load for C entries of a row) did not beat this grid by more than
// 5% at m = 32 on the sum of both plans, and in float32 every C > 1 lost:
// G = m / C blocks run on G of the card's 132 SMs and one block takes its C
// columns in 1.1-1.4x the time of one column, so fewer, wider blocks lose.
// kernels/level_sweep.py builds and times them (csrc/sweep/groups.cu);
// PERF.md holds the numbers.
//
// Left for later: skipping padding slots (with an acc + 0 where padding
// stood), staging the plan in shared memory, more than one block for a
// level wider than one block, column groups past the SM count (m > 132).
#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"

// Plain C entry points, bound with ctypes by kernels/sptrsv.py. Each launches
// on the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success). They leave the current device alone:
// the caller makes the stream's device current around the call.
extern "C" {

int sptrsv_single_f32(const void* row_ids, const void* col_idx, const void* vals,
                      const void* diag, const void* accum, const void* vert_ptr,
                      const void* level_ptr, int n_levels, int W, const void* b,
                      void* x, void* stream) {
  return level::launch<float>(row_ids, col_idx, vals, diag, accum, vert_ptr,
                              level_ptr, n_levels, W, b, x, stream);
}

int sptrsv_single_f64(const void* row_ids, const void* col_idx, const void* vals,
                      const void* diag, const void* accum, const void* vert_ptr,
                      const void* level_ptr, int n_levels, int W, const void* b,
                      void* x, void* stream) {
  return level::launch<double>(row_ids, col_idx, vals, diag, accum, vert_ptr,
                               level_ptr, n_levels, W, b, x, stream);
}

int sptrsv_mrhs_f32(const void* row_ids, const void* col_idx, const void* vals,
                    const void* diag, const void* accum, const void* vert_ptr,
                    const void* level_ptr, int n_levels, int W, int m,
                    int64_t rows, const void* b, void* x, void* stream) {
  return level::launch_cols<float>(row_ids, col_idx, vals, diag, accum, vert_ptr,
                                   level_ptr, n_levels, W, m, rows, b, x, stream);
}

int sptrsv_mrhs_f64(const void* row_ids, const void* col_idx, const void* vals,
                    const void* diag, const void* accum, const void* vert_ptr,
                    const void* level_ptr, int n_levels, int W, int m,
                    int64_t rows, const void* b, void* x, void* stream) {
  return level::launch_cols<double>(row_ids, col_idx, vals, diag, accum, vert_ptr,
                                    level_ptr, n_levels, W, m, rows, b, x, stream);
}

// A bank of plans of one width class, m right-hand sides column-major:
// column c walks its own lane lane_idx[c] (level.cuh,
// sptrsv_level_bank_kernel). The serve layer's grouped, banked and
// resident-slot solves.
int sptrsv_bank_f32(const void* row_ids, const void* col_idx, const void* vals,
                    const void* diag, const void* accum, const void* vert_ptr,
                    const void* level_ptr, const void* level_off, const void* n_levels,
                    const void* lane_idx, int W, int m, int64_t rows, const void* b,
                    void* x, void* stream) {
  return level::launch_bank<float>(row_ids, col_idx, vals, diag, accum, vert_ptr,
                                   level_ptr, level_off, n_levels, lane_idx, W, m, rows, b,
                                   x, stream);
}

int sptrsv_bank_f64(const void* row_ids, const void* col_idx, const void* vals,
                    const void* diag, const void* accum, const void* vert_ptr,
                    const void* level_ptr, const void* level_off, const void* n_levels,
                    const void* lane_idx, int W, int m, int64_t rows, const void* b,
                    void* x, void* stream) {
  return level::launch_bank<double>(row_ids, col_idx, vals, diag, accum, vert_ptr,
                                    level_ptr, level_off, n_levels, lane_idx, W, m, rows, b,
                                    x, stream);
}

}  // extern "C"
