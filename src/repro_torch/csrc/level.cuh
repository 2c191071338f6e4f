// The level walk: scheduled sparse triangular solve over a plan in level
// order (src/repro_torch/kernels/levels.py), shared by csrc/sptrsv.cu (the
// bulk order, a run per superstep) and csrc/sptrsv_elastic.cu (runs of
// `slack` supersteps, mode="elastic"). Each launches one block for one
// right-hand side and a block per column for m.
//
// A vertex is a lane's run of accum steps plus the step that finishes it;
// the host orders the plan's real lane-steps by (run, level, lane, step)
// and passes the vertex and level bounds. A block's threads stride over one
// level's vertices, each walking its vertex's steps in order with the
// accumulator in a register:
//     acc = fma(vals[p,w], x[col_idx[p,w]], acc)   for w = 0..W-1, in order
//     if !accum[p]:  x[row_ids[p]] = (b[row] - acc) / diag[p]
// with one fused multiply-add per entry and a correctly rounded subtract and
// divide (rn.cuh; never --use_fast_math), the scan executor's step body
// (src/repro_torch/solver/executor.py::_step_single). One __syncthreads()
// ends the level and makes its x rows visible to the next; a vertex reads
// only rows finished in an earlier run or at a lower level of its own run,
// both complete behind an earlier barrier (the proof is in levels.py).
// Every row gets the plan's exact FMA chain, padding slots included: each
// computes fma(+0, x[n] = +0, acc), which maps an acc of -0 to +0, so
// skipping them would change bits.
//
// x stays in device memory and L2: at the paper's sizes it is larger than a
// block's shared memory, and it is written inside the kernel, so it is read
// through a plain pointer (no __ldg, no const __restrict__); the plan arrays
// are read through __ldg.
//
// Bound on this card. A solve reads each real plan entry and lane-step once,
// reads b and writes x: those bytes over the H100's 3.35 TB/s are the least
// time the card could take. The real limit is latency: each level is a chain
// of dependent loads (vertex bounds, indices and values, the x gather, the
// FMA chain, the store) and a block barrier, and one block takes a wide
// level in rounds of blockDim vertices.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rn.cuh"

namespace level {

constexpr int kThreads = 1024;

// The level walk of one right-hand side: b and x hold its entries at
// b[r * stride] and x[r * stride] for row r.
template <typename T>
__device__ __forceinline__ void walk(
    const int32_t* __restrict__ row_ids,    // [P]
    const int32_t* __restrict__ col_idx,    // [P, W]
    const T* __restrict__ vals,             // [P, W]
    const T* __restrict__ diag,             // [P]
    const uint8_t* __restrict__ accum,      // [P] (bool)
    const int32_t* __restrict__ vert_ptr,   // [V + 1]
    const int32_t* __restrict__ level_ptr,  // [n_levels + 1]
    int n_levels, int W, const T* __restrict__ b, T* x, int64_t stride) {
  int v0 = __ldg(level_ptr);
  for (int lv = 0; lv < n_levels; ++lv) {
    const int v1 = __ldg(level_ptr + lv + 1);
    for (int v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
      const int p1 = __ldg(vert_ptr + v + 1);
      T acc = T(0);
      for (int p = __ldg(vert_ptr + v); p < p1; ++p) {
        const int32_t* c = col_idx + static_cast<int64_t>(p) * W;
        const T* a = vals + static_cast<int64_t>(p) * W;
#pragma unroll 4
        for (int w = 0; w < W; ++w) acc = rn::fma(__ldg(a + w), x[__ldg(c + w) * stride], acc);
        if (!__ldg(accum + p)) {
          const int64_t r = __ldg(row_ids + p) * stride;
          x[r] = rn::finish(__ldg(b + r), acc, __ldg(diag + p));
        }
      }
    }
    __syncthreads();
    v0 = v1;
  }
}

// One right-hand side, b and x f[n + 1]: one block.
template <typename T>
__global__ void sptrsv_level_kernel(
    const int32_t* __restrict__ row_ids, const int32_t* __restrict__ col_idx,
    const T* __restrict__ vals, const T* __restrict__ diag,
    const uint8_t* __restrict__ accum, const int32_t* __restrict__ vert_ptr,
    const int32_t* __restrict__ level_ptr, int n_levels, int W,
    const T* __restrict__ b,  // [n + 1]
    T* x) {                   // [n + 1], zeroed by the caller
  walk(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, n_levels, W, b, x,
       int64_t{1});
}

// m right-hand sides, column-major f[m, rows = n + 1]: block c walks the
// level order for column c, the single-RHS walk on b + c * rows and
// x + c * rows. Columns never interact, so blocks need no barrier between
// them.
template <typename T>
__global__ void sptrsv_level_cols_kernel(
    const int32_t* __restrict__ row_ids, const int32_t* __restrict__ col_idx,
    const T* __restrict__ vals, const T* __restrict__ diag,
    const uint8_t* __restrict__ accum, const int32_t* __restrict__ vert_ptr,
    const int32_t* __restrict__ level_ptr, int n_levels, int W, int64_t rows,
    const T* __restrict__ b,  // [m, rows]
    T* x) {                   // the same layout, zeroed by the caller
  const int64_t c = static_cast<int64_t>(blockIdx.x) * rows;
  walk(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, n_levels, W, b + c,
       x + c, int64_t{1});
}

template <typename T>
int launch(const void* row_ids, const void* col_idx, const void* vals, const void* diag,
           const void* accum, const void* vert_ptr, const void* level_ptr, int n_levels,
           int W, const void* b, void* x, void* stream) {
  sptrsv_level_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ids), static_cast<const int32_t*>(col_idx),
      static_cast<const T*>(vals), static_cast<const T*>(diag),
      static_cast<const uint8_t*>(accum), static_cast<const int32_t*>(vert_ptr),
      static_cast<const int32_t*>(level_ptr), n_levels, W, static_cast<const T*>(b),
      static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cols(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* level_ptr, int n_levels, int W, int m, int64_t rows,
                const void* b, void* x, void* stream) {
  sptrsv_level_cols_kernel<T><<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ids), static_cast<const int32_t*>(col_idx),
      static_cast<const T*>(vals), static_cast<const T*>(diag),
      static_cast<const uint8_t*>(accum), static_cast<const int32_t*>(vert_ptr),
      static_cast<const int32_t*>(level_ptr), n_levels, W, rows, static_cast<const T*>(b),
      static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace level
