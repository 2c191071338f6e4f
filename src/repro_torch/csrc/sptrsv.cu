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
// Bound on this card. A solve reads each real plan entry and lane-step once
// and the index arrays that order them, reads b and writes x (n+1 entries
// per right-hand side). Those bytes over the H100's 3.35 TB/s are the least
// time the card could take. The real limit is latency: a row reads x rows
// that earlier rows wrote, so the solve is a chain of dependent gathers
// (index load, then x load, then the FMA chain, then the store) as long as
// the dependency structure the kernel keeps.
//
// Within one superstep a lane depends only on its own earlier steps (the BSP
// validity of the schedule: a cross-core edge always crosses a superstep
// boundary, see core/plan.py). x stays in device memory and L2: at the
// paper's sizes it is larger than a block's shared memory, and it is written
// inside the kernel, so it is read through a plain pointer (no __ldg, no
// const __restrict__); the plan arrays are read through __ldg.
//
// Single right-hand side: the level walk of csrc/level.cuh over the plan in
// the bulk level order (kernels/levels.py, a run per superstep): one block of
// 1,024 threads, one __syncthreads() per level (80 on the paper's ER set at
// n = 100,000, against T = 13,561 plan steps). mode="elastic" launches the
// same code over runs of supersteps (csrc/sptrsv_elastic.cu).
//
// Multi right-hand side: columns never interact, so the grid runs over
// chunks of 32 columns; thread (c, l) owns column c of lane l, walks the
// lane's chain of each superstep, and the block synchronises once per
// superstep. The 32 threads of a warp read neighbouring columns of one row
// of x f[n+1, m] (row-major, right-hand side minor), so their loads
// coalesce. Padding lanes target the scratch slot n and write the 0 that the
// plain version writes there; accum lanes write nothing.
//
// Left for later: skipping padding slots (with an acc + 0 where padding
// stood), staging the plan in shared memory, more than one block for a
// level wider than one block, the level walk for the m right-hand sides
// (csrc/level.cuh's column grid, as mode="elastic" runs it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "level.cuh"
#include "rn.cuh"

namespace {

template <typename T>
__global__ void sptrsv_mrhs_kernel(
    const int32_t* __restrict__ row_ids,
    const int32_t* __restrict__ col_idx,
    const T* __restrict__ vals,
    const T* __restrict__ diag,
    const uint8_t* __restrict__ accum,
    const int32_t* __restrict__ step_bounds,
    int n_supersteps, int k, int W, int m,
    const T* __restrict__ b,                  // [n + 1, m]
    T* x) {                                   // [n + 1, m], zeroed by the caller
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < m;  // idle threads still reach every barrier
  for (int s = 0; s < n_supersteps; ++s) {
    const int t0 = step_bounds[s];
    const int t1 = step_bounds[s + 1];
    if (live) {
      for (int l = threadIdx.y; l < k; l += blockDim.y) {
        T acc = T(0);
        for (int t = t0; t < t1; ++t) {
          const int64_t tl = static_cast<int64_t>(t) * k + l;
          const int32_t* ci = col_idx + tl * W;
          const T* v = vals + tl * W;
          for (int w = 0; w < W; ++w) {
            acc = rn::fma(v[w], x[static_cast<int64_t>(ci[w]) * m + c], acc);
          }
          if (!accum[tl]) {
            const int64_t rc = static_cast<int64_t>(row_ids[tl]) * m + c;
            x[rc] = rn::finish(b[rc], acc, diag[tl]);
            acc = T(0);
          }
        }
      }
    }
    __syncthreads();
  }
}

constexpr int kMaxThreads = 1024;
constexpr int kColsPerBlock = 32;

template <typename T>
int launch_mrhs(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* step_bounds,
                int n_supersteps, int k, int W, int m, const void* b, void* x,
                void* stream) {
  int lanes = k;  // thread rows; more lanes than that are looped over
  if (lanes > kMaxThreads / kColsPerBlock) lanes = kMaxThreads / kColsPerBlock;
  if (lanes < 1) lanes = 1;
  const dim3 block(kColsPerBlock, lanes);
  const dim3 grid((m + kColsPerBlock - 1) / kColsPerBlock);
  sptrsv_mrhs_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ids), static_cast<const int32_t*>(col_idx),
      static_cast<const T*>(vals), static_cast<const T*>(diag),
      static_cast<const uint8_t*>(accum), static_cast<const int32_t*>(step_bounds),
      n_supersteps, k, W, m, static_cast<const T*>(b), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
                    const void* diag, const void* accum, const void* step_bounds,
                    int n_supersteps, int k, int W, int m, const void* b, void* x,
                    void* stream) {
  return launch_mrhs<float>(row_ids, col_idx, vals, diag, accum, step_bounds,
                            n_supersteps, k, W, m, b, x, stream);
}

int sptrsv_mrhs_f64(const void* row_ids, const void* col_idx, const void* vals,
                    const void* diag, const void* accum, const void* step_bounds,
                    int n_supersteps, int k, int W, int m, const void* b, void* x,
                    void* stream) {
  return launch_mrhs<double>(row_ids, col_idx, vals, diag, accum, step_bounds,
                             n_supersteps, k, W, m, b, x, stream);
}

}  // extern "C"
