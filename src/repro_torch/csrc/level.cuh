// The level walk: scheduled sparse triangular solve over a plan in level
// order (src/repro_torch/kernels/levels.py), shared by csrc/sptrsv.cu (the
// bulk order, a run per superstep) and csrc/sptrsv_elastic.cu (runs of
// `slack` supersteps, mode="elastic"). Each launches one block for one
// right-hand side and a block per column for m; csrc/sptrsv.cu also
// launches a block per column over a bank of plans, each column on its
// own plan (sptrsv_level_bank_kernel).
//
// A vertex is a lane's run of accum steps plus the step that finishes it
// (its last); the host orders the plan's real lane-steps by (run, level,
// lane, step) and cuts each level into chunks of at most 992 vertices, the
// block's consumer threads (kernels/levels.py, level_chunks). The consumers
// walk the chunks in order, a thread a vertex, walking its vertex's steps
// with the accumulator in a register:
//     acc = fma(vals[p,w], x[col_idx[p,w]], acc)   for w = 0..W-1, in order
//     if !accum[p]:  x[row_ids[p]] = (b[row] - acc) / diag[p]
// with one fused multiply-add per entry and a correctly rounded subtract and
// divide (rn.cuh; never --use_fast_math), the scan executor's step body
// (src/repro_torch/solver/executor.py::_step_single). One barrier of the
// consumers ends each level and makes its x rows visible to the next;
// inside a level the warps run from chunk to chunk without one. A vertex
// reads only rows finished in an earlier run or at a lower level of its own
// run, both complete behind an earlier barrier (the proof is in
// levels.py). Every row gets the
// plan's exact FMA chain, padding slots included: each computes fma(+0,
// x[n] = +0, acc), which maps an acc of -0 to +0, so skipping them would
// change bits.
//
// Staging. None of a chunk's plan operands depends on x, so none has to
// wait for the barrier before it: a ring of n_stages (2-4) stages in
// dynamic shared memory holds the chunks ahead. The block's last warp is
// the producer: one thread of it copies chunk q into stage q % n_stages,
// one cp.async.bulk (TMA) per level tensor, global to shared, counted on
// the stage's full mbarrier, as soon as every consumer warp has released
// the stage's previous chunk on its empty mbarrier. It takes no part in
// the consumers' barriers, so its work is never on their path. Before it
// moves on a consumer waits on the next chunk's stage, reads its vertex's
// finishing row there and starts the gather of b[row] into a register, so
// after a level's barrier its only memory wait is its x gathers; the
// operands come from shared memory. Shared memory:
//
//     [0, 256)        the stages' full and empty mbarriers (8 B each) and
//                     heads (Head)
//     256 + s * stage_bytes, s < n_stages: stage s, a chunk's slices of
//                     vert_ptr[v0 .. v0 + nv], col_idx, vals, row_ids, diag,
//                     accum in that order, each copied from its 16-byte
//                     aligned start to its 16-byte aligned end
//
// The host sizes the stages from the plan (W, the element size, its widest
// chunk) within half the card's 227 KB a block, leaving the rest to L1,
// and cuts a chunk that would not fit one stage. A chunk of one vertex
// that alone does not fit (slice_need above stage_bytes, decided here as
// the host decides it) is read from global memory as before staging; its
// stage then only passes a phase.
//
// x stays in device memory and L2: at the paper's sizes it is larger than a
// block's shared memory, and it is written inside the kernel, so it is read
// through a plain pointer (no __ldg, no const __restrict__).
//
// Bound on this card. A solve reads each real plan entry and lane-step once,
// reads b and writes x: those bytes over the H100's 3.35 TB/s are the least
// time the card could take. The real limit is latency: a level costs its
// x gathers, its FMA chain and store, and the consumers' barrier, whether
// the plan operands hit L2 or not; one block takes a wide level in chunks
// of up to 992 vertices, its warps each at their own pace.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "rn.cuh"

namespace level {

constexpr int kThreads = 1024;
// kernels/levels.py holds the same three numbers (SMEM_BYTES,
// STAGE_HEAD_BYTES, MAX_STAGES): the host sizes the stages by them
constexpr int kSmemBytes = 232448;  // dynamic shared memory a block may use
constexpr int kHeadBytes = 256;     // the mbarriers and heads ahead of the stages
constexpr int kMaxStages = 4;
constexpr int kSlices = 6;  // vert_ptr, col_idx, vals, row_ids, diag, accum

// What the producer leaves in shared memory for the chunk in a stage.
struct Head {
  int v0, nv;        // first vertex, vertices
  int p0, np;        // first lane-step, lane-steps
  int off[kSlices];  // each slice's first element: its byte offset in the stage
  int staged;        // 0: the chunk is read from global memory
  int last;          // the chunk ends its level
};
static_assert(kMaxStages * (2 * sizeof(uint64_t) + sizeof(Head)) <= kHeadBytes, "head region");

// The level tensors of one plan.
template <typename T>
struct Plan {
  const int32_t* __restrict__ row_ids;   // [P]
  const int32_t* __restrict__ col_idx;   // [P, W]
  const T* __restrict__ vals;            // [P, W]
  const T* __restrict__ diag;            // [P]
  const uint8_t* __restrict__ accum;     // [P] (bool)
  const int32_t* __restrict__ vert_ptr;  // [V + 1]
};

// The bytes a stage needs for a chunk of nv vertices and np lane-steps:
// each slice rounded out to 16-byte bounds wherever it starts
// (kernels/levels.py, stage_need, is the same sum).
__device__ __forceinline__ int64_t slice_need(int64_t bytes) {
  return (bytes + 30) & ~int64_t{15};
}

template <typename T>
__device__ __forceinline__ void slices(const Plan<T>& pl, int W, const Head& h,
                                       const char* (&src)[kSlices], int64_t (&len)[kSlices]) {
  const int64_t pw = static_cast<int64_t>(h.p0) * W, nw = static_cast<int64_t>(h.np) * W;
  src[0] = reinterpret_cast<const char*>(pl.vert_ptr + h.v0);
  src[1] = reinterpret_cast<const char*>(pl.col_idx + pw);
  src[2] = reinterpret_cast<const char*>(pl.vals + pw);
  src[3] = reinterpret_cast<const char*>(pl.row_ids + h.p0);
  src[4] = reinterpret_cast<const char*>(pl.diag + h.p0);
  src[5] = reinterpret_cast<const char*>(pl.accum + h.p0);
  len[0] = 4 * (static_cast<int64_t>(h.nv) + 1);
  len[1] = 4 * nw;
  len[2] = static_cast<int64_t>(sizeof(T)) * nw;
  len[3] = 4 * static_cast<int64_t>(h.np);
  len[4] = static_cast<int64_t>(sizeof(T)) * h.np;
  len[5] = h.np;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits for the phase of the given parity to complete. A phase that never
// completes is a fault of the walk, not a wait: after 2^30 tries (each
// suspends the thread for a while; tens of seconds in all, far beyond the
// longest chunk) it traps, and the launch fails instead of holding the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 30)) __trap();
  }
}

// global -> shared, completion counted on bar; 16-byte aligned, a multiple of 16
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The producer: chunk [lo, hi) (vertex, lane-step bounds) into a stage.
// The head is a plain store, released to the consumers by the arrive.
template <typename T>
__device__ __forceinline__ void issue(const Plan<T>& pl, int W, int2 lo, int2 hi, int last,
                                      unsigned char* stage, int stage_bytes, Head* head,
                                      uint64_t* bar) {
  Head h;
  h.v0 = lo.x;
  h.nv = hi.x - lo.x;
  h.p0 = lo.y;
  h.np = hi.y - lo.y;
  h.last = last;
  const char* src[kSlices];
  int64_t len[kSlices];
  slices(pl, W, h, src, len);
  int64_t need = 0;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) need += slice_need(len[k]);
  h.staged = need <= stage_bytes;
  uint32_t at[kSlices], size[kSlices], total = 0;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src[k]);
    const uintptr_t a0 = a & ~uintptr_t{15};
    size[k] = static_cast<uint32_t>(((a + len[k] + 15) & ~uintptr_t{15}) - a0);
    at[k] = total;
    h.off[k] = static_cast<int>(total + (a - a0));
    src[k] = reinterpret_cast<const char*>(a0);
    total += size[k];
  }
  *head = h;
  if (h.staged) {
    mbar_expect_tx(bar, total);
#pragma unroll
    for (int k = 0; k < kSlices; ++k) bulk_copy(stage + at[k], src[k], size[k], bar);
  } else {
    mbar_arrive(bar);
  }
}

// The gather of b at the row of this thread's vertex's finishing step.
template <typename T>
__device__ __forceinline__ T preload(const Plan<T>& pl, const Head& h,
                                     const unsigned char* stage, const T* __restrict__ b,
                                     int64_t stride) {
  const int i = threadIdx.x;
  if (i >= h.nv) return T(0);
  int row;
  if (h.staged) {
    const int* vp = reinterpret_cast<const int*>(stage + h.off[0]);
    row = reinterpret_cast<const int*>(stage + h.off[3])[vp[i + 1] - 1 - h.p0];
  } else {
    row = __ldg(pl.row_ids + __ldg(pl.vert_ptr + h.v0 + i + 1) - 1);
  }
  return __ldg(b + row * stride);
}

// Vertex i of a chunk: its steps in order, the operands read through the
// given slices (of a stage, or of the level tensors at the chunk's start).
template <typename T>
__device__ __forceinline__ void solve_vertex(const int* __restrict__ vp,
                                             const int32_t* __restrict__ col,
                                             const T* __restrict__ val,
                                             const int32_t* __restrict__ row,
                                             const T* __restrict__ dg,
                                             const uint8_t* __restrict__ acc_flag, int i,
                                             int p0, int W, T bv, T* x, int64_t stride) {
  const int p1 = vp[i + 1] - p0;
  T acc = T(0);
  for (int p = vp[i] - p0; p < p1; ++p) {
    const int32_t* c = col + static_cast<int64_t>(p) * W;
    const T* a = val + static_cast<int64_t>(p) * W;
#pragma unroll 4
    for (int w = 0; w < W; ++w) acc = rn::fma(a[w], x[c[w] * stride], acc);
    if (!acc_flag[p]) x[row[p] * stride] = rn::finish(bv, acc, dg[p]);
  }
}

// The producer warp's one thread: issues every chunk of [c0, c1) in turn,
// chunk q into stage (q - c0) % n_stages once the consumer warps have
// released that stage's previous chunk (its empty mbarrier), and marks the
// chunk that ends each level (level_chunk).
template <typename T>
__device__ __forceinline__ void produce(const Plan<T>& pl, const int2* __restrict__ chunk_ptr,
                                        const int32_t* __restrict__ level_chunk, int n_levels,
                                        int c0, int c1, int W, int stage_bytes, int n_stages,
                                        unsigned char* stages, Head* head, uint64_t* full,
                                        uint64_t* empty) {
  int2 lo = __ldg(chunk_ptr + c0), hi = __ldg(chunk_ptr + c0 + 1);
  int lv = 0, lv_end = __ldg(level_chunk + 1);  // the level of chunk q, and its end
  int s = 0;
  uint32_t use = 0;  // the stage's use: the chunk's index among those of stage s
  for (int q = c0; q < c1; ++q) {
    if (use > 0) {
      mbar_wait(empty + s, (use - 1) & 1u);
      // the consumers' generic reads of the stage come before these writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    const int last = q + 1 == lv_end;
    issue(pl, W, lo, hi, last, stages + s * stage_bytes, stage_bytes, head + s, full + s);
    if (last && ++lv < n_levels) lv_end = __ldg(level_chunk + lv + 1);
    lo = hi;
    if (q + 2 <= c1) hi = __ldg(chunk_ptr + q + 2);
    if (++s == n_stages) {
      s = 0;
      ++use;
    }
  }
}

// The level walk of one right-hand side over chunks
// [level_chunk[0], level_chunk[n_levels]) of chunk_ptr (int2: first vertex,
// first lane-step; the next entry bounds a chunk): b and x hold its entries
// at b[r * stride] and x[r * stride] for row r. The block's last warp
// produces (one thread of it); the others consume, a vertex a thread, and
// end each level in a barrier of their own (named barrier 1), so the
// producer's work is never on their path.
template <typename T>
__device__ __forceinline__ void walk(const Plan<T>& pl, const int2* __restrict__ chunk_ptr,
                                     const int32_t* __restrict__ level_chunk, int n_levels,
                                     int W, int stage_bytes, int n_stages,
                                     const T* __restrict__ b, T* x, int64_t stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  Head* head = reinterpret_cast<Head*>(smem + 2 * kMaxStages * sizeof(uint64_t));
  unsigned char* stages = smem + kHeadBytes;
  const int c0 = __ldg(level_chunk), c1 = __ldg(level_chunk + n_levels);
  if (c0 >= c1) return;
  const int tid = threadIdx.x;
  const int consumers = blockDim.x - 32;
  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= consumers) {
    if (tid == consumers)
      produce(pl, chunk_ptr, level_chunk, n_levels, c0, c1, W, stage_bytes, n_stages, stages,
              head, full, empty);
    return;
  }
  int s = 0;
  uint32_t parity = 0;
  mbar_wait(full, 0);
  T bv = preload(pl, head[0], stages, b, stride);
  for (int c = c0; c < c1; ++c) {
    const Head h = head[s];
    if (tid < h.nv) {
      if (h.staged) {
        const unsigned char* st = stages + s * stage_bytes;
        solve_vertex(reinterpret_cast<const int*>(st + h.off[0]),
                     reinterpret_cast<const int32_t*>(st + h.off[1]),
                     reinterpret_cast<const T*>(st + h.off[2]),
                     reinterpret_cast<const int32_t*>(st + h.off[3]),
                     reinterpret_cast<const T*>(st + h.off[4]),
                     reinterpret_cast<const uint8_t*>(st + h.off[5]), tid, h.p0, W, bv, x,
                     stride);
      } else {
        const int64_t pw = static_cast<int64_t>(h.p0) * W;
        solve_vertex(pl.vert_ptr + h.v0, pl.col_idx + pw, pl.vals + pw, pl.row_ids + h.p0,
                     pl.diag + h.p0, pl.accum + h.p0, tid, h.p0, W, bv, x, stride);
      }
    }
    // the warp is done with the stage: once every consumer warp is, the
    // producer refills it
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + s);
    const int s1 = s + 1 == n_stages ? 0 : s + 1;
    const uint32_t parity1 = s1 == 0 ? parity ^ 1u : parity;
    if (c + 1 < c1) {
      mbar_wait(full + s1, parity1);
      bv = preload(pl, head[s1], stages + s1 * stage_bytes, b, stride);
    }
    // a level's last chunk ends the level among the consumers: its x rows
    // are visible to the next; inside a level the warps run on
    if (h.last) asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
    s = s1;
    parity = parity1;
  }
}

// One right-hand side, b and x f[n + 1]: one block.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) sptrsv_level_kernel(
    Plan<T> pl, const int2* __restrict__ chunk_ptr, const int32_t* __restrict__ level_chunk,
    int n_levels, int W, int stage_bytes, int n_stages,
    const T* __restrict__ b,  // [n + 1]
    T* x) {                   // [n + 1], zeroed by the caller
  walk(pl, chunk_ptr, level_chunk, n_levels, W, stage_bytes, n_stages, b, x, int64_t{1});
}

// m right-hand sides, column-major f[m, rows = n + 1]: block c walks the
// level order for column c, the single-RHS walk on b + c * rows and
// x + c * rows, with stages of its own. Columns never interact, so blocks
// need no barrier between them.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) sptrsv_level_cols_kernel(
    Plan<T> pl, const int2* __restrict__ chunk_ptr, const int32_t* __restrict__ level_chunk,
    int n_levels, int W, int stage_bytes, int n_stages, int64_t rows,
    const T* __restrict__ b,  // [m, rows]
    T* x) {                   // the same layout, zeroed by the caller
  const int64_t c = static_cast<int64_t>(blockIdx.x) * rows;
  walk(pl, chunk_ptr, level_chunk, n_levels, W, stage_bytes, n_stages, b + c, x + c,
       int64_t{1});
}

// A bank of plans of one width class (the serve layer's grouped and
// resident-slot solves), m right-hand sides in the column-major layout of
// sptrsv_level_cols_kernel: block c walks column c on ITS OWN lane
// lane_idx[c]. The bank concatenates its lanes' level tensors and chunk
// tables (kernels/ops.py, _concat_levels), each lane's vert_ptr shifted by
// its lane-step offset, its chunk bounds by its vertex and lane-step
// offsets and its level_chunk by its chunk offset, so lane l's levels are
// level_chunk[level_off[l] .. level_off[l] + n_levels[l]] and the walk runs
// unchanged: a column's bits are those of sptrsv_level_cols_kernel on its
// lane's plan alone. Lanes share n, T, k, W and the stage layout, not their
// level counts, so nothing is padded.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) sptrsv_level_bank_kernel(
    Plan<T> pl, const int2* __restrict__ chunk_ptr, const int32_t* __restrict__ level_chunk,
    const int32_t* __restrict__ level_off,  // [lanes]
    const int32_t* __restrict__ n_levels,   // [lanes]
    const int32_t* __restrict__ lane_idx,   // [m]
    int W, int stage_bytes, int n_stages, int64_t rows,
    const T* __restrict__ b,  // [m, rows]
    T* x) {                   // the same layout, zeroed by the caller
  const int lane = __ldg(lane_idx + blockIdx.x);
  const int64_t c = static_cast<int64_t>(blockIdx.x) * rows;
  walk(pl, chunk_ptr, level_chunk + __ldg(level_off + lane), __ldg(n_levels + lane), W,
       stage_bytes, n_stages, b + c, x + c, int64_t{1});
}

// The host side, with internal linkage: each library that includes this
// header (csrc/sptrsv.cu, csrc/sptrsv_elastic.cu) keeps its own flags of
// allow_smem. A static local of an inline function with external linkage
// is one object across every library loaded in the process, so one
// library's flag would stand for another's kernels, which it never set.
namespace {

template <typename T>
Plan<T> plan_of(const void* row_ids, const void* col_idx, const void* vals, const void* diag,
                const void* accum, const void* vert_ptr) {
  return Plan<T>{static_cast<const int32_t*>(row_ids), static_cast<const int32_t*>(col_idx),
                 static_cast<const T*>(vals),          static_cast<const T*>(diag),
                 static_cast<const uint8_t*>(accum),   static_cast<const int32_t*>(vert_ptr)};
}

// The stage layout's shared memory, or 0 where the layout is not one the
// walk takes (16-byte stages, 2 to kMaxStages of them, within kSmemBytes).
inline int smem_bytes(int stage_bytes, int n_stages) {
  if (n_stages < 2 || n_stages > kMaxStages || stage_bytes < 16 || stage_bytes % 16 ||
      stage_bytes > (kSmemBytes - kHeadBytes) / n_stages)
    return 0;
  return kHeadBytes + n_stages * stage_bytes;
}

// Lets `kernel` take kSmemBytes of dynamic shared memory on the current
// device, once per device for each kernel (`done` is the kernel's own).
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T>
int launch(const void* row_ids, const void* col_idx, const void* vals, const void* diag,
           const void* accum, const void* vert_ptr, const void* chunk_ptr,
           const void* level_chunk, int n_levels, int W, int stage_bytes, int n_stages,
           const void* b, void* x, void* stream) {
  static std::atomic<uint64_t> done{0};
  const int smem = smem_bytes(stage_bytes, n_stages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = allow_smem(sptrsv_level_kernel<T>, done)) return static_cast<int>(err);
  sptrsv_level_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      plan_of<T>(row_ids, col_idx, vals, diag, accum, vert_ptr),
      static_cast<const int2*>(chunk_ptr), static_cast<const int32_t*>(level_chunk), n_levels,
      W, stage_bytes, n_stages, static_cast<const T*>(b), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cols(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                int stage_bytes, int n_stages, int m, int64_t rows, const void* b, void* x,
                void* stream) {
  static std::atomic<uint64_t> done{0};
  const int smem = smem_bytes(stage_bytes, n_stages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = allow_smem(sptrsv_level_cols_kernel<T>, done))
    return static_cast<int>(err);
  sptrsv_level_cols_kernel<T><<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      plan_of<T>(row_ids, col_idx, vals, diag, accum, vert_ptr),
      static_cast<const int2*>(chunk_ptr), static_cast<const int32_t*>(level_chunk), n_levels,
      W, stage_bytes, n_stages, rows, static_cast<const T*>(b), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bank(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* chunk_ptr, const void* level_chunk, const void* level_off,
                const void* n_levels, const void* lane_idx, int W, int stage_bytes,
                int n_stages, int m, int64_t rows, const void* b, void* x, void* stream) {
  static std::atomic<uint64_t> done{0};
  const int smem = smem_bytes(stage_bytes, n_stages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = allow_smem(sptrsv_level_bank_kernel<T>, done))
    return static_cast<int>(err);
  sptrsv_level_bank_kernel<T><<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      plan_of<T>(row_ids, col_idx, vals, diag, accum, vert_ptr),
      static_cast<const int2*>(chunk_ptr), static_cast<const int32_t*>(level_chunk),
      static_cast<const int32_t*>(level_off), static_cast<const int32_t*>(n_levels),
      static_cast<const int32_t*>(lane_idx), W, stage_bytes, n_stages, rows,
      static_cast<const T*>(b), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace level
