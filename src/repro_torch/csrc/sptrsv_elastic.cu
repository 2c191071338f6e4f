// Scheduled sparse triangular solve in readiness waves (mode="elastic") for
// NVIDIA Hopper.
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/sptrsv.py::_sptrsv_elastic_kernel       (one right-hand side)
//   src/repro/kernels/sptrsv.py::_sptrsv_elastic_mrhs_kernel  (m right-hand sides)
// and computes the bulk kernels' function (csrc/sptrsv.cu) bit for bit, in
// another order. The T plan steps are padded to M tiles of S = slack steps;
// the elastic certificate (src/repro_torch/core/elastic.py) splits each tile
// into n_waves[i] runs of consecutive steps (wave_id) whose gathers were all
// written before the run starts and whose accumulator chains do not cross
// inside the run. So the (step, lane) pairs of one wave are independent:
//     acc = accum[t-1,l] ? tot[t-1,l] : 0          (selected, never re-summed)
//     acc = fma(vals[t,l,w], x[col_idx[t,l,w]], acc)   for w = 0..W-1, in order
//     accum[t,l] ? tot[t,l] = acc : x[row_ids[t,l]] = (b[row] - acc) / diag[t,l]
// with the same fused multiply-add chain and correctly rounded subtract and
// divide as the bulk kernels (rn.cuh; never --use_fast_math). The entering
// accumulator is the one the bulk walk holds at step t, so each x row gets
// the bulk kernel's bits. The Pallas body tree-sums over W instead, and
// recomputes all S*k*W gathers of its tile in every wave; this kernel runs
// only the wave's own pairs.
//
// Bound on this card. The bytes are the bulk kernels' (each plan entry and
// lane step read once, b read, x written) plus the wave ids: the least time
// is those bytes over 3.35 TB/s. The real limit is latency: every wave ends
// in a block barrier, and a wave is about one plan step (GrowLocal keeps
// dependency chains on one lane, so waves seldom merge steps), so the kernel
// pays about one barrier and one dependent gather per plan step, where the
// bulk kernel pays one barrier per superstep.
//
// Design. One block walks the tiles in order (the wave ids are per tile).
// For each wave every thread finds the wave's step range [s0, s1) by reading
// the tile's wave ids (the same few words for all threads, from L1), takes
// (step, lane) pairs strided over the block, and the block synchronises once
// after the wave, which makes its x rows and totals visible to the next.
// tot is a device scratch tensor indexed by the absolute step, [T, k(, m)],
// allocated by the wrapper: the accumulator carried into a tile's first step
// is then tot[t-1] like any other, and no shared-memory limit caps S*k. It is
// read only behind accum[t-1, l], whose write sits in an earlier wave, so it
// needs no initialisation. x stays in device memory behind a plain pointer
// (it is written inside the kernel).
//   Single right-hand side: one block of up to S*k threads.
//   Multi right-hand side: the grid runs over chunks of 32 columns; thread
//   (c, p) owns column c of pair p, so a warp's loads of a row of x f[n+1, m]
//   (right-hand side minor) coalesce.
// Left for later: staging tot and x in shared memory, and merging waves
// into fewer barriers where lanes do not interact.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rn.cuh"

namespace {

// End of the wave that starts at step s0 of the tile [.., end): the wave ids
// of a valid certificate rise by one from 0 across the tile.
__device__ __forceinline__ int wave_end(const int32_t* wave_id, int s0, int end,
                                        int r) {
  int s1 = s0 + 1;
  while (s1 < end && wave_id[s1] == r) ++s1;
  return s1;
}

template <typename T>
__global__ void sptrsv_elastic_single_kernel(
    const int32_t* __restrict__ wave_id,  // [M * S]
    const int32_t* __restrict__ n_waves,  // [M]
    const int32_t* __restrict__ row_ids,  // [M * S, k]
    const int32_t* __restrict__ col_idx,  // [M * S, k, W]
    const T* __restrict__ vals,           // [M * S, k, W]
    const T* __restrict__ diag,           // [M * S, k]
    const uint8_t* __restrict__ accum,    // [M * S, k] (bool)
    int M, int S, int k, int W,
    const T* __restrict__ b,              // [n + 1]
    T* x,                                 // [n + 1], zeroed by the caller
    T* tot) {                             // [M * S, k] scratch
  for (int i = 0; i < M; ++i) {
    const int end = (i + 1) * S;
    const int nw = n_waves[i];
    int s0 = i * S;
    for (int r = 0; r < nw && s0 < end; ++r) {
      const int s1 = wave_end(wave_id, s0, end, r);
      const int pairs = (s1 - s0) * k;
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int64_t tl = static_cast<int64_t>(s0) * k + p;  // (t, l) flat
        T acc = (tl >= k && accum[tl - k]) ? tot[tl - k] : T(0);
        const int32_t* c = col_idx + tl * W;
        const T* v = vals + tl * W;
        for (int w = 0; w < W; ++w) acc = rn::fma(v[w], x[c[w]], acc);
        if (accum[tl]) {
          tot[tl] = acc;
        } else {
          const int32_t row = row_ids[tl];
          x[row] = rn::finish(b[row], acc, diag[tl]);
        }
      }
      __syncthreads();
      s0 = s1;
    }
  }
}

template <typename T>
__global__ void sptrsv_elastic_mrhs_kernel(
    const int32_t* __restrict__ wave_id,
    const int32_t* __restrict__ n_waves,
    const int32_t* __restrict__ row_ids,
    const int32_t* __restrict__ col_idx,
    const T* __restrict__ vals,
    const T* __restrict__ diag,
    const uint8_t* __restrict__ accum,
    int M, int S, int k, int W, int m,
    const T* __restrict__ b,              // [n + 1, m]
    T* x,                                 // [n + 1, m], zeroed by the caller
    T* tot) {                             // [M * S, k, m] scratch
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < m;  // idle threads still reach every barrier
  for (int i = 0; i < M; ++i) {
    const int end = (i + 1) * S;
    const int nw = n_waves[i];
    int s0 = i * S;
    for (int r = 0; r < nw && s0 < end; ++r) {
      const int s1 = wave_end(wave_id, s0, end, r);
      const int pairs = (s1 - s0) * k;
      if (live) {
        for (int p = threadIdx.y; p < pairs; p += blockDim.y) {
          const int64_t tl = static_cast<int64_t>(s0) * k + p;
          T acc = (tl >= k && accum[tl - k]) ? tot[(tl - k) * m + c] : T(0);
          const int32_t* ci = col_idx + tl * W;
          const T* v = vals + tl * W;
          for (int w = 0; w < W; ++w) {
            acc = rn::fma(v[w], x[static_cast<int64_t>(ci[w]) * m + c], acc);
          }
          if (accum[tl]) {
            tot[tl * m + c] = acc;
          } else {
            const int64_t rc = static_cast<int64_t>(row_ids[tl]) * m + c;
            x[rc] = rn::finish(b[rc], acc, diag[tl]);
          }
        }
      }
      __syncthreads();
      s0 = s1;
    }
  }
}

constexpr int kMaxThreads = 1024;
constexpr int kColsPerBlock = 32;

template <typename T>
int launch_single(const void* wave_id, const void* n_waves, const void* row_ids,
                  const void* col_idx, const void* vals, const void* diag,
                  const void* accum, int M, int S, int k, int W, const void* b,
                  void* x, void* tot, void* stream) {
  int threads = ((S * k + 31) / 32) * 32;  // whole warps, a thread per pair
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  sptrsv_elastic_single_kernel<T><<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wave_id), static_cast<const int32_t*>(n_waves),
      static_cast<const int32_t*>(row_ids), static_cast<const int32_t*>(col_idx),
      static_cast<const T*>(vals), static_cast<const T*>(diag),
      static_cast<const uint8_t*>(accum), M, S, k, W, static_cast<const T*>(b),
      static_cast<T*>(x), static_cast<T*>(tot));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mrhs(const void* wave_id, const void* n_waves, const void* row_ids,
                const void* col_idx, const void* vals, const void* diag,
                const void* accum, int M, int S, int k, int W, int m, const void* b,
                void* x, void* tot, void* stream) {
  int rows = S * k;  // thread rows, a pair each; more pairs are looped over
  if (rows > kMaxThreads / kColsPerBlock) rows = kMaxThreads / kColsPerBlock;
  if (rows < 1) rows = 1;
  const dim3 block(kColsPerBlock, rows);
  const dim3 grid((m + kColsPerBlock - 1) / kColsPerBlock);
  sptrsv_elastic_mrhs_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wave_id), static_cast<const int32_t*>(n_waves),
      static_cast<const int32_t*>(row_ids), static_cast<const int32_t*>(col_idx),
      static_cast<const T*>(vals), static_cast<const T*>(diag),
      static_cast<const uint8_t*>(accum), M, S, k, W, m, static_cast<const T*>(b),
      static_cast<T*>(x), static_cast<T*>(tot));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes by kernels/sptrsv.py. Each launches
// on the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success). The caller makes the stream's device
// current around the call.
extern "C" {

int sptrsv_elastic_single_f32(const void* wave_id, const void* n_waves,
                              const void* row_ids, const void* col_idx,
                              const void* vals, const void* diag, const void* accum,
                              int M, int S, int k, int W, const void* b, void* x,
                              void* tot, void* stream) {
  return launch_single<float>(wave_id, n_waves, row_ids, col_idx, vals, diag, accum,
                              M, S, k, W, b, x, tot, stream);
}

int sptrsv_elastic_single_f64(const void* wave_id, const void* n_waves,
                              const void* row_ids, const void* col_idx,
                              const void* vals, const void* diag, const void* accum,
                              int M, int S, int k, int W, const void* b, void* x,
                              void* tot, void* stream) {
  return launch_single<double>(wave_id, n_waves, row_ids, col_idx, vals, diag, accum,
                               M, S, k, W, b, x, tot, stream);
}

int sptrsv_elastic_mrhs_f32(const void* wave_id, const void* n_waves,
                            const void* row_ids, const void* col_idx,
                            const void* vals, const void* diag, const void* accum,
                            int M, int S, int k, int W, int m, const void* b, void* x,
                            void* tot, void* stream) {
  return launch_mrhs<float>(wave_id, n_waves, row_ids, col_idx, vals, diag, accum,
                            M, S, k, W, m, b, x, tot, stream);
}

int sptrsv_elastic_mrhs_f64(const void* wave_id, const void* n_waves,
                            const void* row_ids, const void* col_idx,
                            const void* vals, const void* diag, const void* accum,
                            int M, int S, int k, int W, int m, const void* b, void* x,
                            void* tot, void* stream) {
  return launch_mrhs<double>(wave_id, n_waves, row_ids, col_idx, vals, diag, accum,
                             M, S, k, W, m, b, x, tot, stream);
}

}  // extern "C"
