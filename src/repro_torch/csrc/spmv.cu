// Sparse matrix-vector product y = A x for NVIDIA Hopper, one launch for the
// whole product, on the sliced layout of kernels/spmv.py (SlicedEll).
//
// Replaces the TPU kernel of the JAX package
//   src/repro/kernels/spmv.py::_spmv_kernel
// and the segment sum that src/repro/kernels/spmv.py::spmv runs after it.
// The TPU kernel computes one value per padded-ELL row of W slots (a tree sum
// over W); rows wider than W are split into several ELL rows and summed by
// the caller. Here row i is one left-to-right fused multiply-add chain over
// its real entries from +0, restarted every W entries (the ELL pieces), each
// finished chain added to the row's sum from +0, so
//     y[i] = ((+0 + c0) + c1) + ...
// with rn::fma and rn::add (rn.cuh; never --use_fast_math). That is bit for
// bit the padded-ELL product chained over every slot, padding included, with
// the pieces summed in order (kernels/ref.py::spmv_ell_rows_ref): a padding
// slot adds fma(+0, +0, acc), which is acc unless acc is -0, and the sum's
// +0 start turns a chain's -0 into +0 as that slot would. The plain version
// is kernels/ref.py::spmv_sliced_ref. SpMV is outside the solver's bitwise
// contract (the reference marks it a blessed reduction), so the JAX package
// is held to it within a tolerance.
//
// Layout. Rows go in slices of 32 consecutive rows, one slice per warp; slot
// k of row i lies at slice_ptr[i / 32] + 32 k + i % 32, so for each slot a
// warp reads 128 bytes of columns and 128 (f32) or 256 (f64) of values,
// contiguous. Slots past a row's length up to its slice's longest row are
// stored and never read: each lane stops at row_len[i].
//
// Bound on this card. Each real entry's column and value, row_len and
// slice_ptr read once, x read once and y written once, over 3.35 TB/s: the
// work is a gather with 2 operations per entry, so bytes bound it. What the
// design does about it: one thread per row and coalesced slot loads; the
// matrix streamed past the caches (__ldcs, evict first) so that L1 and L2
// keep x, which the gathers read again and again; padding never loaded.
// A thread takes kUnroll slots a step: their columns and values first, then
// their x gathers, then the FMAs in slot order, so the chain's order, and so
// its bits, do not depend on kUnroll (it ships at 1; see below). With one
// thread per row, a matrix of few rows (ER, NB: 100,000) fills about a
// third of the card's threads, and its longest chains set the time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rn.cuh"

namespace {

constexpr int kSlice = 32;  // rows of a slice: one warp

template <typename T, int kUnroll, int kThreads>
__global__ void __launch_bounds__(kThreads)
    spmv_sliced_kernel(const int32_t* __restrict__ col,        // [S]
                       const T* __restrict__ val,              // [S]
                       const int64_t* __restrict__ slice_ptr,  // [ceil(n / 32) + 1]
                       const int32_t* __restrict__ row_len,    // [n]
                       int n, int W,
                       const T* __restrict__ x,                // [n_cols]
                       T* __restrict__ y) {                    // [n]
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int len = row_len[i];
  const int64_t base = slice_ptr[i / kSlice] + i % kSlice;
  const int32_t* c = col + base;
  const T* v = val + base;
  T sum = T(0);
  T acc = T(0);
  int left = W;  // entries before the chain folds into the row's sum
  for (int k = 0; k < len; k += kUnroll) {
    int32_t cs[kUnroll];
    T vs[kUnroll];
    T xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cs[u] = 0;
      vs[u] = T(0);
      if (k + u < len) {
        cs[u] = __ldcs(c + static_cast<int64_t>(k + u) * kSlice);
        vs[u] = __ldcs(v + static_cast<int64_t>(k + u) * kSlice);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xs[u] = k + u < len ? __ldg(x + cs[u]) : T(0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u < len) {
        acc = rn::fma(vs[u], xs[u], acc);
        if (--left == 0) {
          sum = rn::add(sum, acc);
          acc = T(0);
          left = W;
        }
      }
    }
  }
  if (left != W) sum = rn::add(sum, acc);  // the last, shorter chain
  y[i] = sum;
}

template <typename T, int kUnroll, int kThreads>
int launch(const void* col, const void* val, const void* slice_ptr, const void* row_len, int n,
           int W, const void* x, void* y, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  spmv_sliced_kernel<T, kUnroll, kThreads>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(col), static_cast<const T*>(val),
          static_cast<const int64_t*>(slice_ptr), static_cast<const int32_t*>(row_len), n, W,
          static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

// The shipped choice of slots a step and threads a block. Of the eight
// choices that kernels/spmv_sweep.py times (U in 1, 2, 4, 8; 128 or 256
// threads), none beat it by more than 5% on the sum of graph-replay times
// over ER, NB and PCG's A (U = 1 at 128 threads led it by at most 3.2%).
// On PCG's A, near its byte bound, U = 4 and 8 ran 11-13% and 29-30% slower
// than U = 1; on ER and NB the choices tied within the run-to-run spread.
constexpr int kUnroll = 1;
constexpr int kThreads = 256;

}  // namespace

// Plain C entry points, bound with ctypes by kernels/spmv.py. Each launches on
// the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success). The caller makes the stream's device
// current around the call.
extern "C" {

int spmv_sliced_f32(const void* col, const void* val, const void* slice_ptr, const void* row_len,
                    int n, int W, const void* x, void* y, void* stream) {
  return launch<float, kUnroll, kThreads>(col, val, slice_ptr, row_len, n, W, x, y, stream);
}

int spmv_sliced_f64(const void* col, const void* val, const void* slice_ptr, const void* row_len,
                    int n, int W, const void* x, void* y, void* stream) {
  return launch<double, kUnroll, kThreads>(col, val, slice_ptr, row_len, n, W, x, y, stream);
}

}  // extern "C"
