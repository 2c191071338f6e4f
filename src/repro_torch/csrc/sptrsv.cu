// Scheduled sparse triangular solve for NVIDIA Hopper, bulk-synchronous and
// under a staleness bound (mode="elastic"): one library for both level orders.
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/sptrsv.py::_sptrsv_kernel               (one right-hand side)
//   src/repro/kernels/sptrsv.py::_sptrsv_mrhs_kernel          (m right-hand sides)
//   src/repro/kernels/sptrsv.py::_sptrsv_elastic_kernel       (elastic, one)
//   src/repro/kernels/sptrsv.py::_sptrsv_elastic_mrhs_kernel  (elastic, m)
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
// is a chain of dependent gathers (the x loads, then the FMA chain, then
// the store; the index and value loads are staged off it, level.cuh) as
// long as the dependency structure the kernel keeps.
//
// Both entries run the level walk of csrc/level.cuh over the plan in the
// bulk level order (kernels/levels.py, a run per superstep), one barrier
// per level, chunks of at most 992 vertices between them: 80 levels on the
// paper's ER set at n = 100,000 and 2,020 on its NB set, against T = 13,561
// and 16,635 plan steps. Each chunk's plan operands are staged in shared
// memory ahead of it (level.cuh), so a level waits only on its x gathers.
//
// mode="elastic" launches the same entries over another level order: the
// supersteps grouped into runs of `slack`, one level numbering spanning a
// run (kernels/levels.py). A vertex reads only rows of an earlier run or of
// a lower level of its own run, both complete behind an earlier barrier, so
// the bits are the bulk order's with fewer barriers (38 levels on ER and
// 1,460 on NB at slack 8). The TPU kernels walk a VMEM tile of `slack` plan
// steps in readiness waves; on this card a wave is about one plan step
// (GrowLocal keeps dependency chains on one lane), so a wave kernel would
// pay a block barrier and a dependent gather per plan step.
//
// Single right-hand side: one block of 1,024 threads (31 consumer warps and
// the producer warp).
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
// still holds it back is what holds the single-RHS walk back: a level's x
// gathers and a block barrier, and on ER's wide levels (up to 7,548
// vertices) chunks of up to 992 vertices per block. Column groups (a
// thread solving one vertex for C columns of x packed f[G, n + 1, C], one
// 16-byte load for C entries of a row) did not beat this grid by more than
// 5% at m = 32 on the sum of both plans, and in float32 every C > 1 lost:
// G = m / C blocks run on G of the card's 132 SMs and one block takes its C
// columns in 1.1-1.4x the time of one column, so fewer, wider blocks lose.
// kernels/level_sweep.py builds and times them (csrc/sweep/groups.cu);
// PERF.md holds the numbers.
//
// The ordered entries (sptrsv_ordered_*) take b and x in the caller's row
// order: one cooperative launch moves b into plan row order, walks, and
// moves x back, on many SMs (level.cuh), so the front door's solve is one
// launch, with no gather, padding or fill around it.
//
// Done: staging the plan's operands in shared memory ahead of each barrier
// (level.cuh). Left for later: skipping padding slots (with an acc + 0
// where padding stood), more than one block for a level wider than one
// block, column groups past the SM count (m > 132; with up to 227 KB of
// stages a block, one block fits an SM).
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
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, const void* b, void* x, void* stream) {
  return level::launch<float>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                            level_chunk, n_levels, W, stage_bytes, n_stages, b, x, stream);
}

int sptrsv_single_f64(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, const void* b, void* x, void* stream) {
  return level::launch<double>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                            level_chunk, n_levels, W, stage_bytes, n_stages, b, x, stream);
}

int sptrsv_mrhs_f32(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, int m, int64_t rows, const void* b, void* x,
                void* stream) {
  return level::launch_cols<float>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                                 level_chunk, n_levels, W, stage_bytes, n_stages, m, rows, b,
                                 x, stream);
}

int sptrsv_mrhs_f64(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, int m, int64_t rows, const void* b, void* x,
                void* stream) {
  return level::launch_cols<double>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                                 level_chunk, n_levels, W, stage_bytes, n_stages, m, rows, b,
                                 x, stream);
}

// The ordered solve (level.cuh, sptrsv_level_ordered_kernel): b and x in the
// caller's row order, f[n] (m = 1) or row-major f[n, m], perm int32[n] the
// caller's row of each plan row, scratch 2 * m * (n + 1) elements,
// uninitialised; one cooperative launch of `grid` blocks, m <= grid <= what
// sptrsv_ordered_blocks_* reports. The front door's solve.
int sptrsv_ordered_f32(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, int m, int grid, int64_t n, const void* perm,
                const void* b, void* out, void* scratch, void* stream) {
  return level::launch_ordered<float>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                                    level_chunk, n_levels, W, stage_bytes, n_stages, m, grid, n,
                                    perm, b, out, scratch, stream);
}

int sptrsv_ordered_blocks_f32(int stage_bytes, int n_stages, int* blocks) {
  return level::ordered_blocks<float>(stage_bytes, n_stages, blocks);
}

int sptrsv_ordered_f64(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, int m, int grid, int64_t n, const void* perm,
                const void* b, void* out, void* scratch, void* stream) {
  return level::launch_ordered<double>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                                    level_chunk, n_levels, W, stage_bytes, n_stages, m, grid, n,
                                    perm, b, out, scratch, stream);
}

int sptrsv_ordered_blocks_f64(int stage_bytes, int n_stages, int* blocks) {
  return level::ordered_blocks<double>(stage_bytes, n_stages, blocks);
}

// A bank of plans of one width class, m right-hand sides column-major:
// column c walks its own lane lane_idx[c] (level.cuh,
// sptrsv_level_bank_kernel). The serve layer's grouped, banked and
// resident-slot solves.
int sptrsv_bank_f32(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, const void* level_off,
                const void* n_levels, const void* lane_idx, int W, int stage_bytes,
                int n_stages, int m, int64_t rows, const void* b, void* x, void* stream) {
  return level::launch_bank<float>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                                 level_chunk, level_off, n_levels, lane_idx, W, stage_bytes,
                                 n_stages, m, rows, b, x, stream);
}

int sptrsv_bank_f64(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, const void* level_off,
                const void* n_levels, const void* lane_idx, int W, int stage_bytes,
                int n_stages, int m, int64_t rows, const void* b, void* x, void* stream) {
  return level::launch_bank<double>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                                 level_chunk, level_off, n_levels, lane_idx, W, stage_bytes,
                                 n_stages, m, rows, b, x, stream);
}

}  // extern "C"
