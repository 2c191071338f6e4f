// Padded-ELL sparse matrix-vector product for NVIDIA Hopper.
//
// Replaces the TPU kernel of the JAX package
//   src/repro/kernels/spmv.py::_spmv_kernel
// which computes, for every ELL row r of an [R, W] padded-ELL matrix (columns
// padded with the scratch slot n, whose x entry is 0, values with 0),
//     y[r] = sum_w vals[r, w] * x[col_idx[r, w]]
// This kernel chains one fused multiply-add per slot, left to right from 0
// (rn.cuh; never --use_fast_math), so it matches the plain PyTorch version
// (kernels/ref.py::spmv_ell_ref, a torch.addcmul chain) bit for bit. The
// Pallas body tree-sums over W instead: SpMV is outside the solver's bitwise
// contract (the reference marks it a blessed reduction), so the JAX package
// is held to it within a tolerance.
//
// Bound on this card. Each real entry is read once (a 4-byte column and a
// value), x once and y written once: those bytes over 3.35 TB/s. Rows are
// independent and the work is a gather, so the kernel is bound by memory
// traffic, not by its 2 operations per entry.
//
// Design. One thread per ELL row, grid-stride, the accumulator in a
// register; x is read-only here, so it is read through the read-only cache.
// A thread reads its row's W contiguous slots, so neighbouring threads read
// addresses W entries apart. Left for later: a warp per row band with
// coalesced slot loads, and skipping padding slots.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rn.cuh"

namespace {

template <typename T>
__global__ void spmv_ell_kernel(const int32_t* __restrict__ col_idx,  // [R, W]
                                const T* __restrict__ vals,           // [R, W]
                                int R, int W,
                                const T* __restrict__ x,              // [n + 1]
                                T* __restrict__ y) {                  // [R]
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; r < R;
       r += stride) {
    const int32_t* c = col_idx + r * W;
    const T* v = vals + r * W;
    T acc = T(0);
    for (int w = 0; w < W; ++w) acc = rn::fma(v[w], __ldg(x + c[w]), acc);
    y[r] = acc;
  }
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs

template <typename T>
int launch(const void* col_idx, const void* vals, int R, int W, const void* x, void* y,
           void* stream) {
  int blocks = (R + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  spmv_ell_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(col_idx), static_cast<const T*>(vals), R, W,
      static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes by kernels/spmv.py. Each launches on
// the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success). The caller makes the stream's device
// current around the call.
extern "C" {

int spmv_ell_f32(const void* col_idx, const void* vals, int R, int W, const void* x,
                 void* y, void* stream) {
  return launch<float>(col_idx, vals, R, W, x, y, stream);
}

int spmv_ell_f64(const void* col_idx, const void* vals, int R, int W, const void* x,
                 void* y, void* stream) {
  return launch<double>(col_idx, vals, R, W, x, y, stream);
}

}  // extern "C"
