// Scheduled sparse triangular solve under a staleness bound (mode="elastic")
// for NVIDIA Hopper.
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/sptrsv.py::_sptrsv_elastic_kernel       (one right-hand side)
//   src/repro/kernels/sptrsv.py::_sptrsv_elastic_mrhs_kernel  (m right-hand sides)
// and computes the bulk kernels' function (csrc/sptrsv.cu) bit for bit, in
// another order. The elastic contract is the same bits with fewer barriers,
// under a staleness bound of `slack`. The TPU kernels fill a VMEM tile of
// `slack` plan steps and walk it in readiness waves; on this card a wave is
// about one plan step (GrowLocal keeps dependency chains on one lane), so a
// wave kernel pays a block barrier and a dependent gather per plan step.
// These kernels take the level layout instead (kernels/levels.py): the
// supersteps are grouped into runs of `slack`, one level numbering spans a
// run, and the level walk of csrc/level.cuh ends each level in one block
// barrier (its chunks of at most 992 vertices between), each chunk's plan
// operands staged in shared memory ahead of it. A vertex reads only rows of
// an earlier run or of a lower level of its own run, both complete behind
// an earlier barrier; the barrier
// orders every lane, so a run needs no cut at cross-core reads. Each row
// keeps the plan's exact FMA chain and correctly rounded finish (rn.cuh;
// never --use_fast_math), so the bits are the bulk kernels'.
//
// Bound on this card: the bulk kernels' bytes (each real plan entry and
// lane-step read once, b read, x written) over 3.35 TB/s. The real limit is
// latency: a level's x gathers, its FMA chain and a block barrier (the plan
// operands are staged ahead of it), and one block takes a wide level in
// chunks of up to 992 vertices. Runs of slack = 8 supersteps take 38
// levels on the paper's ER set at n = 100,000 (80 per
// superstep, 12,761 waves) and 1,460 on its NB set (2,020; 14,378 waves).
//
//   Single right-hand side: one block of 1,024 threads (992 consumers)
//   over each level's vertices: the bulk kernel's code over the elastic
//   order.
//   m right-hand sides: the grid runs over columns, block c walks the level
//   order for column c. Columns never interact and a level's barrier is
//   needed only within one column, so blocks never wait for each other.
//   b and x are a column-major copy (rows 1 apart, columns n + 1 apart), so
//   a block's gathers and stores stay in its own column: at m = 32 that
//   took 24% less time than row-major x on the paper's ER set and 3% less
//   on NB, the copies included (kernels/level_sweep.py, H100 80GB HBM3 at
//   700 W), where row-major x spreads every row over 32 blocks' cache
//   lines.
//
// Left for later: skipping padding slots (with an acc + 0 where padding
// stood), more than one block for a level wider than one block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"

// Plain C entry points, bound with ctypes by kernels/sptrsv.py. Each launches
// on the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success). The caller makes the stream's device
// current around the call.
extern "C" {

int sptrsv_elastic_single_f32(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, const void* b, void* x, void* stream) {
  return level::launch<float>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                            level_chunk, n_levels, W, stage_bytes, n_stages, b, x, stream);
}

int sptrsv_elastic_single_f64(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, const void* b, void* x, void* stream) {
  return level::launch<double>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                            level_chunk, n_levels, W, stage_bytes, n_stages, b, x, stream);
}

int sptrsv_elastic_mrhs_f32(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, int m, int64_t rows, const void* b, void* x,
                void* stream) {
  return level::launch_cols<float>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                                 level_chunk, n_levels, W, stage_bytes, n_stages, m, rows, b,
                                 x, stream);
}

int sptrsv_elastic_mrhs_f64(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, int m, int64_t rows, const void* b, void* x,
                void* stream) {
  return level::launch_cols<double>(row_ids, col_idx, vals, diag, accum, vert_ptr, chunk_ptr,
                                 level_chunk, n_levels, W, stage_bytes, n_stages, m, rows, b,
                                 x, stream);
}

}  // extern "C"
