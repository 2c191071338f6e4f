// The level walk: scheduled sparse triangular solve over a plan in level
// order (src/repro_torch/kernels/levels.py), launched by csrc/sptrsv.cu over
// the bulk order (a run per superstep) or the elastic one (runs of `slack`
// supersteps, mode="elastic"): one block for one right-hand side, a block
// per column for m, and a block per column over a bank of plans, each
// column on its own plan (sptrsv_level_bank_kernel).
//
// A vertex is a lane's run of accum steps plus the step that finishes it
// (its last); the host orders the plan's real lane-steps by (run, level,
// lane, step) and cuts each level into chunks of at most 992 vertices, the
// block's consumer threads, then packs consecutive levels that are each one
// such chunk into one chunk, as many as fit a stage (kernels/levels.py,
// level_chunks). The consumers walk the chunks in order and the levels of a
// chunk in turn, thread t vertex t of a level, walking its vertex's steps
// with the accumulator in a register:
//     acc = fma(vals[p,w], x[col_idx[p,w]], acc)   for w = 0..W-1, in order
//     if !accum[p]:  x[row_ids[p]] = (b[row] - acc) / diag[p]
// with one fused multiply-add per entry and a correctly rounded subtract and
// divide (rn.cuh; never --use_fast_math), the scan executor's step body
// (src/repro_torch/solver/executor.py::_step_single). One barrier of the
// consumers ends each level and makes its x rows visible to the next,
// inside a chunk of packed levels as at a chunk's end; inside a level the
// warps run from chunk to chunk without one. A vertex
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
// finishing row there and starts the gather of b[row] into a register (in
// a chunk of packed levels, the next level's before the level's barrier),
// so after a level's barrier its only memory wait is its x gathers; the
// operands, the level bounds among them, come from shared memory. A deep
// DAG's narrow levels (tens of vertices) pack many to a chunk, so the ring
// holds many levels ahead, not n_stages: a stage load's round trip
// (release, refill, land) is paid once a chunk, not once a level. A chunk
// of one level (or a piece of one) takes the loop body it took before
// packing; only a chunk of several levels loops over them, its level
// bounds staged with it. On an H100, the walk alone on the paper's NB set
// (f64, 1,176 levels in 155 chunks, not 1,251) ran 13% faster than one
// level a chunk at most, a Poisson factor 3% faster, ER (wide levels)
// within 1.5% (PERF.md). Shared memory:
//
//     [0, 256)        the stages' full and empty mbarriers (8 B each) and
//                     heads (Head)
//     256 + s * stage_bytes, s < n_stages: stage s, a chunk's slices of
//                     vert_ptr[v0 .. v0 + nv], col_idx, vals, row_ids, diag,
//                     accum and, for more than one level, level_ptr[lv ..
//                     lv + nl] in that order, each copied from its 16-byte
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
// The ordered solve (sptrsv_level_ordered_kernel; the front door's, through
// kernels/sptrsv.py, sptrsv_ordered_cuda) takes b and returns x in the
// caller's row order in one launch: a cooperative grid of at least m
// blocks (128 where the card holds them: kernels/sptrsv.py,
// ORDERED_SPREAD), all resident at once, gathers b into plan row order in a
// column-major scratch (b_col[c][r] = b[perm[r]][c], perm the solver's row
// permutation), meets at a grid barrier, walks column c in block c with the
// walk above, unchanged, meets again, and scatters x back (out[perm[r]][c]
// = x_col[c][r]); for m columns the moves go through 32 x 32 tiles in
// shared memory, so both sides of each are whole lines. The walk's block
// touches 4 bytes of each 128-byte row of the caller's row-major b and x, so
// done by the walk itself they cost a scattered access per row and column,
// all on one SM: measured there, 9-31% of the walk on the paper's ER set, a
// Poisson factor and 32 columns (stored in the level loop, the caller's
// rows cost most), against 1-9% spread over the grid (PERF.md). The walk
// reads the gathered b with plain loads: the launch wrote it, so the
// read-only path may not serve it. The scatter writes every row; the
// gather sets the scratch slot x[n] = +0 and the walk writes every other row
// of x before it reads it (levels.py), so the caller allocates both without
// a fill. The blocks that do not walk wait at the second grid barrier, so
// the grid holds its SMs until the walk ends: the scatter then runs spread
// over them. Letting them leave would leave the scatter to the walking
// blocks, the 9-31% above, or to a second launch. Work on other streams
// gets the SMs the grid leaves free, and a second ordered solve on another
// stream starts when its whole grid fits (a cooperative launch's blocks
// are all resident), so solves on two streams run one after the other.
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

#include <cooperative_groups.h>

#include <atomic>

#include "rn.cuh"

namespace level {

constexpr int kThreads = 1024;
// kernels/levels.py holds the same three numbers (SMEM_BYTES,
// STAGE_HEAD_BYTES, MAX_STAGES): the host sizes the stages by them
constexpr int kSmemBytes = 232448;  // dynamic shared memory a block may use
constexpr int kHeadBytes = 256;     // the mbarriers and heads ahead of the stages
constexpr int kMaxStages = 4;
// vert_ptr, col_idx, vals, row_ids, diag, accum, level_ptr (the last only
// for a chunk of more than one level)
constexpr int kSlices = 7;

// What the producer leaves in shared memory for the chunk in a stage.
struct Head {
  int v0, nv;        // first vertex, vertices
  int p0;            // first lane-step
  int e0;            // the end of its first level, a vertex of the chunk (nv for one level)
  int off[kSlices];  // each slice's first element: its byte offset in the stage
  int flags;         // kStaged | kLast | levels << kLevelShift
};
constexpr int kStaged = 1;  // else the chunk is read from global memory
constexpr int kLast = 2;    // the chunk ends its last level
constexpr int kLevelShift = 2;
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

// The bytes a stage needs for a chunk of nv vertices, np lane-steps and nl
// levels: each slice rounded out to 16-byte bounds wherever it starts, the
// level bounds only where nl > 1 (kernels/levels.py, stage_need, is the
// same sum).
__device__ __forceinline__ int64_t slice_need(int64_t bytes) {
  return bytes == 0 ? 0 : (bytes + 30) & ~int64_t{15};
}

// The slices of chunk [v0, v0 + nv) x [p0, p0 + np) holding nl levels from
// level lv on.
template <typename T>
__device__ __forceinline__ void slices(const Plan<T>& pl, const int32_t* level_ptr, int W, int v0,
                                       int nv, int p0, int np, int lv, int nl,
                                       const char* (&src)[kSlices], int64_t (&len)[kSlices]) {
  const int64_t pw = static_cast<int64_t>(p0) * W, nw = static_cast<int64_t>(np) * W;
  src[0] = reinterpret_cast<const char*>(pl.vert_ptr + v0);
  src[1] = reinterpret_cast<const char*>(pl.col_idx + pw);
  src[2] = reinterpret_cast<const char*>(pl.vals + pw);
  src[3] = reinterpret_cast<const char*>(pl.row_ids + p0);
  src[4] = reinterpret_cast<const char*>(pl.diag + p0);
  src[5] = reinterpret_cast<const char*>(pl.accum + p0);
  src[6] = reinterpret_cast<const char*>(level_ptr + lv);
  len[0] = 4 * (static_cast<int64_t>(nv) + 1);
  len[1] = 4 * nw;
  len[2] = static_cast<int64_t>(sizeof(T)) * nw;
  len[3] = 4 * static_cast<int64_t>(np);
  len[4] = static_cast<int64_t>(sizeof(T)) * np;
  len[5] = np;
  len[6] = nl > 1 ? 4 * (static_cast<int64_t>(nl) + 1) : 0;
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

// The producer: chunk [lo, hi) (vertex, lane-step bounds), which holds nl
// levels from level lv on, into a stage; `last`: it ends its last level.
// The head is a plain store, released to the consumers by the arrive. A
// chunk of several levels that does not fit its stage is a fault of the
// chunk table (kernels/levels.py packs only levels that fit): it traps.
template <typename T>
__device__ __forceinline__ void issue(const Plan<T>& pl, const int32_t* level_ptr, int W,
                                      int2 lo, int2 hi, int lv, int nl, int last,
                                      unsigned char* stage, int stage_bytes, Head* head,
                                      uint64_t* bar) {
  Head h;
  h.v0 = lo.x;
  h.nv = hi.x - lo.x;
  h.p0 = lo.y;
  h.e0 = nl > 1 ? __ldg(level_ptr + lv + 1) - lo.x : h.nv;
  const char* src[kSlices];
  int64_t len[kSlices];
  slices(pl, level_ptr, W, h.v0, h.nv, h.p0, hi.y - lo.y, lv, nl, src, len);
  int64_t need = 0;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) need += slice_need(len[k]);
  const bool staged = need <= stage_bytes;
  if (!staged && nl > 1) __trap();
  h.flags = (staged ? kStaged : 0) | (last ? kLast : 0) | (nl << kLevelShift);
  uint32_t at[kSlices], size[kSlices], total = 0;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src[k]);
    const uintptr_t a0 = a & ~uintptr_t{15};
    size[k] = len[k] == 0 ? 0u : static_cast<uint32_t>(((a + len[k] + 15) & ~uintptr_t{15}) - a0);
    at[k] = total;
    h.off[k] = static_cast<int>(total + (a - a0));
    src[k] = reinterpret_cast<const char*>(a0);
    total += size[k];
  }
  *head = h;
  if (staged) {
    mbar_expect_tx(bar, total);
    constexpr int kBounds = kSlices - 1;  // the level bounds, copied for nl > 1 only
#pragma unroll
    for (int k = 0; k < kBounds; ++k) bulk_copy(stage + at[k], src[k], size[k], bar);
    if (nl > 1) bulk_copy(stage + at[kBounds], src[kBounds], size[kBounds], bar);
  } else {
    mbar_arrive(bar);
  }
}

// The gather of b at the row of the finishing step of the chunk's vertex
// i, if i < end; through the read-only path, or, where the launch itself
// wrote b (kWrittenB: the ordered solve's scratch, behind a grid barrier),
// a plain load, which L1 may cache as the read-only path does.
template <typename T, bool kWrittenB>
__device__ __forceinline__ T preload(const Plan<T>& pl, const Head& h,
                                     const unsigned char* stage, int i, int end, const T* b,
                                     int64_t stride) {
  if (i >= end) return T(0);
  int row;
  if (h.flags & kStaged) {
    const int* vp = reinterpret_cast<const int*>(stage + h.off[0]);
    row = reinterpret_cast<const int*>(stage + h.off[3])[vp[i + 1] - 1 - h.p0];
  } else {
    row = __ldg(pl.row_ids + __ldg(pl.vert_ptr + h.v0 + i + 1) - 1);
  }
  if constexpr (kWrittenB) {
    return b[row * stride];
  } else {
    return __ldg(b + row * stride);
  }
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

// Vertex i of the chunk in a stage, its operands read there.
template <typename T>
__device__ __forceinline__ void staged_vertex(const Head& h, const unsigned char* st, int i, int W,
                                              T bv, T* x, int64_t stride) {
  solve_vertex(reinterpret_cast<const int*>(st + h.off[0]),
               reinterpret_cast<const int32_t*>(st + h.off[1]),
               reinterpret_cast<const T*>(st + h.off[2]),
               reinterpret_cast<const int32_t*>(st + h.off[3]),
               reinterpret_cast<const T*>(st + h.off[4]),
               reinterpret_cast<const uint8_t*>(st + h.off[5]), i, h.p0, W, bv, x, stride);
}

// The producer warp's one thread: issues every chunk of [c0, c1) in turn,
// chunk q into stage (q - c0) % n_stages once the consumer warps have
// released that stage's previous chunk (its empty mbarrier), with the
// levels it holds and whether it ends the last of them. level_chunk[l] is
// the chunk of level l's first vertex, so chunk q holds levels [lv, le):
// lv, which its first vertex is of, and those that begin in it; it ends
// level le - 1 where level le begins chunk q + 1 (level_chunk[n_levels] =
// c1).
template <typename T>
__device__ __forceinline__ void produce(const Plan<T>& pl, const int32_t* __restrict__ level_ptr,
                                        const int2* __restrict__ chunk_ptr,
                                        const int32_t* __restrict__ level_chunk, int n_levels,
                                        int c0, int c1, int W, int stage_bytes, int n_stages,
                                        unsigned char* stages, Head* head, uint64_t* full,
                                        uint64_t* empty) {
  int2 lo = __ldg(chunk_ptr + c0), hi = __ldg(chunk_ptr + c0 + 1);
  int lv = 0, next = __ldg(level_chunk + 1);  // the level of chunk q; level_chunk[lv + 1]
  int s = 0;
  uint32_t use = 0;  // the stage's use: the chunk's index among those of stage s
  for (int q = c0; q < c1; ++q) {
    if (use > 0) {
      mbar_wait(empty + s, (use - 1) & 1u);
      // the consumers' generic reads of the stage come before these writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    int le = lv + 1;
    while (next == q) next = __ldg(level_chunk + ++le);
    const int last = next == q + 1;
    issue(pl, level_ptr, W, lo, hi, lv, le - lv, last, stages + s * stage_bytes, stage_bytes,
          head + s, full + s);
    if (last) {
      lv = le;
      if (lv < n_levels) next = __ldg(level_chunk + lv + 1);
    }
    lo = hi;
    if (q + 2 <= c1) hi = __ldg(chunk_ptr + q + 2);
    if (++s == n_stages) {
      s = 0;
      ++use;
    }
  }
}

// The level walk of one right-hand side over levels [0, n_levels) of
// level_ptr, chunks [level_chunk[0], level_chunk[n_levels]) of chunk_ptr
// (int2: first vertex, first lane-step; the next entry bounds a chunk): b
// and x hold its entries at b[r * stride] and x[r * stride] for row r. The
// block's last warp produces (one thread of it); the others consume, a
// vertex a thread, and end each level in a barrier of their own (named
// barrier 1), so the producer's work is never on their path. kWrittenB: b
// was written in this launch (preload).
template <typename T, bool kWrittenB = false>
__device__ __forceinline__ void walk(const Plan<T>& pl, const int32_t* __restrict__ level_ptr,
                                     const int2* __restrict__ chunk_ptr,
                                     const int32_t* __restrict__ level_chunk, int n_levels,
                                     int W, int stage_bytes, int n_stages, const T* b, T* x,
                                     int64_t stride) {
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
      produce(pl, level_ptr, chunk_ptr, level_chunk, n_levels, c0, c1, W, stage_bytes, n_stages,
              stages, head, full, empty);
    return;
  }
  int s = 0;
  uint32_t parity = 0;
  mbar_wait(full, 0);
  T bv = preload<T, kWrittenB>(pl, head[0], stages, tid, head[0].e0, b, stride);
  for (int c = c0; c < c1; ++c) {
    const Head h = head[s];
    const unsigned char* st = stages + s * stage_bytes;
    const int nl = h.flags >> kLevelShift;
    if (nl == 1) {  // one level, or a piece of one: a vertex a thread
      if (tid < h.nv) {
        if (h.flags & kStaged) {
          staged_vertex(h, st, tid, W, bv, x, stride);
        } else {
          const int64_t pw = static_cast<int64_t>(h.p0) * W;
          solve_vertex(pl.vert_ptr + h.v0, pl.col_idx + pw, pl.vals + pw, pl.row_ids + h.p0,
                       pl.diag + h.p0, pl.accum + h.p0, tid, h.p0, W, bv, x, stride);
        }
      }
    } else {  // whole levels, staged: level k is the chunk's vertices [a, e)
      const int* lb = reinterpret_cast<const int*>(st + h.off[6]);  // level_ptr[lv ..]
      for (int k = 1, a = 0, e = h.e0;; ++k) {
        if (tid < e - a) staged_vertex(h, st, a + tid, W, bv, x, stride);
        if (k == nl) break;
        // the next level's b gather in flight across the barrier that
        // makes this level's x rows visible to it
        const int e1 = k + 1 == nl ? h.nv : lb[k + 1] - h.v0;
        bv = preload<T, kWrittenB>(pl, h, st, e + tid, e1, b, stride);
        asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
        a = e;
        e = e1;
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
      bv = preload<T, kWrittenB>(pl, head[s1], stages + s1 * stage_bytes, tid, head[s1].e0, b,
                                 stride);
    }
    // a chunk that ends a level ends it among the consumers: its x rows
    // are visible to the next; inside a level the warps run on
    if (h.flags & kLast) asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
    s = s1;
    parity = parity1;
  }
}

// One right-hand side, b and x f[n + 1]: one block.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) sptrsv_level_kernel(
    Plan<T> pl, const int32_t* __restrict__ level_ptr, const int2* __restrict__ chunk_ptr,
    const int32_t* __restrict__ level_chunk, int n_levels, int W, int stage_bytes, int n_stages,
    const T* __restrict__ b,  // [n + 1]
    T* x) {                   // [n + 1], zeroed by the caller
  walk(pl, level_ptr, chunk_ptr, level_chunk, n_levels, W, stage_bytes, n_stages, b, x,
       int64_t{1});
}

// m right-hand sides, column-major f[m, rows = n + 1]: block c walks the
// level order for column c, the single-RHS walk on b + c * rows and
// x + c * rows, with stages of its own. Columns never interact, so blocks
// need no barrier between them.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) sptrsv_level_cols_kernel(
    Plan<T> pl, const int32_t* __restrict__ level_ptr, const int2* __restrict__ chunk_ptr,
    const int32_t* __restrict__ level_chunk, int n_levels, int W, int stage_bytes, int n_stages,
    int64_t rows,
    const T* __restrict__ b,  // [m, rows]
    T* x) {                   // the same layout, zeroed by the caller
  const int64_t c = static_cast<int64_t>(blockIdx.x) * rows;
  walk(pl, level_ptr, chunk_ptr, level_chunk, n_levels, W, stage_bytes, n_stages, b + c, x + c,
       int64_t{1});
}

// A bank of plans of one width class (the serve layer's grouped and
// resident-slot solves), m right-hand sides in the column-major layout of
// sptrsv_level_cols_kernel: block c walks column c on ITS OWN lane
// lane_idx[c]. The bank concatenates its lanes' level tensors and chunk
// tables (kernels/ops.py, _concat_levels), each lane's vert_ptr shifted by
// its lane-step offset, its level_ptr by its vertex offset, its chunk
// bounds by its vertex and lane-step offsets and its level_chunk by its
// chunk offset, so lane l's levels are level_ptr and level_chunk[level_off[l]
// .. level_off[l] + n_levels[l]] and the walk runs
// unchanged: a column's bits are those of sptrsv_level_cols_kernel on its
// lane's plan alone. Lanes share n, T, k, W and the stage layout, not their
// level counts, so nothing is padded.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) sptrsv_level_bank_kernel(
    Plan<T> pl, const int32_t* __restrict__ level_ptr, const int2* __restrict__ chunk_ptr,
    const int32_t* __restrict__ level_chunk,
    const int32_t* __restrict__ level_off,  // [lanes]
    const int32_t* __restrict__ n_levels,   // [lanes]
    const int32_t* __restrict__ lane_idx,   // [m]
    int W, int stage_bytes, int n_stages, int64_t rows,
    const T* __restrict__ b,  // [m, rows]
    T* x) {                   // the same layout, zeroed by the caller
  const int lane = __ldg(lane_idx + blockIdx.x);
  const int64_t c = static_cast<int64_t>(blockIdx.x) * rows;
  const int l0 = __ldg(level_off + lane);
  walk(pl, level_ptr + l0, chunk_ptr, level_chunk + l0, __ldg(n_levels + lane), W, stage_bytes,
       n_stages, b + c, x + c, int64_t{1});
}

// The ordered solve's moves of b and x between the caller's row-major
// f[n, m] (f[n] for one column) and the column-major scratch f[m, n + 1] in
// plan row order, by every thread of the grid: plan row r is the caller's
// row perm[r]. For m > 1 (kCols) 32 x 32 tiles of (plan row, column) go
// through shared memory (`tile`, kTiles of 32 x 33 elements), so a warp
// reads or writes 32 columns of one caller row and 32 plan rows of one
// column; a block moves kTiles tiles down the rows at once, their loads in
// flight together.
//
// The caller's b is read-only for the launch (__ldg); the scratch, written
// in it by other blocks, is read through L2 (__ldcg), never the read-only
// path.
constexpr int kTile = 32;
constexpr int kTiles = 8;
template <typename T, bool kCols, bool kToPlan>
__device__ __forceinline__ void move_rows(const T* from, T* to, const int32_t* __restrict__ perm,
                                          int64_t n, int m, T* tile) {
  const int64_t rows = n + 1;
  if constexpr (!kCols) {
    const int64_t nt = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
         r += nt) {
      const int64_t i = __ldg(perm + r);
      if constexpr (kToPlan) {
        to[r] = __ldg(from + i);
      } else {
        to[i] = __ldcg(from + r);
      }
    }
    return;
  }
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int col_tiles = (m + kTile - 1) / kTile;
  const int64_t span = int64_t{kTile} * kTiles;  // the rows of a pass
  const int64_t passes = (n + span - 1) / span * col_tiles;
  for (int64_t t = blockIdx.x; t < passes; t += gridDim.x) {
    const int64_t r0 = t / col_tiles * span;
    const int c0 = static_cast<int>(t % col_tiles) * kTile;
    // thread (ty, tx) of tile u moves caller row r0 + 32u + ty, column
    // c0 + tx, held in tile u at [ty][tx], and plan row r0 + 32u + tx,
    // column c0 + ty of the scratch, held at [tx][ty]
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      const int64_t r = r0 + u * kTile;
      T* tl = tile + u * kTile * (kTile + 1);
      if constexpr (kToPlan) {
        if (r + ty < n && c0 + tx < m)
          tl[ty * (kTile + 1) + tx] =
              __ldg(from + static_cast<int64_t>(__ldg(perm + r + ty)) * m + c0 + tx);
      } else {
        if (c0 + ty < m && r + tx < n)
          tl[tx * (kTile + 1) + ty] = __ldcg(from + static_cast<int64_t>(c0 + ty) * rows + r + tx);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      const int64_t r = r0 + u * kTile;
      const T* tl = tile + u * kTile * (kTile + 1);
      if constexpr (kToPlan) {
        if (c0 + ty < m && r + tx < n)
          to[static_cast<int64_t>(c0 + ty) * rows + r + tx] = tl[tx * (kTile + 1) + ty];
      } else {
        if (r + ty < n && c0 + tx < m)
          to[static_cast<int64_t>(__ldg(perm + r + ty)) * m + c0 + tx] = tl[ty * (kTile + 1) + tx];
      }
    }
    __syncthreads();
  }
}

// The ordered solve, a cooperative launch of at least m blocks: b and out
// the caller's f[n] (one column) or row-major f[n, m] (kCols), b_col and
// x_col two column-major f[m, n + 1] scratches (b, then x, in plan row
// order), uninitialised. Block c < m walks column c. One column has its own
// instantiation, as the unordered walk has (sptrsv_level_kernel): its walk
// reads both scratches straight from the launch's parameters and holds the
// registers it holds in a kernel of its own (54 float32, 56 float64, against
// 54 / 55 there; on an H100 the same time). Sharing the m-column kernel's
// per-block offset, it held 64, the cap at 1,024 threads, and the float64
// walk ran 5-8% slower.
template <typename T, bool kCols>
__global__ void __launch_bounds__(kThreads, 1) sptrsv_level_ordered_kernel(
    Plan<T> pl, const int32_t* __restrict__ level_ptr, const int2* __restrict__ chunk_ptr,
    const int32_t* __restrict__ level_chunk, int n_levels, int W, int stage_bytes, int n_stages,
    int m, int64_t n, const int32_t* __restrict__ perm, const T* __restrict__ b, T* out,
    T* b_col, T* x_col) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the tiles lie past the walk's mbarriers, in its stages' room
  T* tile = reinterpret_cast<T*>(smem + kHeadBytes);
  const int64_t rows = n + 1;
  // the scratch slot the padding slots read, x[n] = +0 in each column
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < m) x_col[threadIdx.x * rows + n] = T(0);
  move_rows<T, kCols, true>(b, b_col, perm, n, m, tile);
  cooperative_groups::this_grid().sync();
  if constexpr (kCols) {
    if (static_cast<int>(blockIdx.x) < m) {
      const int64_t c = static_cast<int64_t>(blockIdx.x) * rows;
      walk<T, true>(pl, level_ptr, chunk_ptr, level_chunk, n_levels, W, stage_bytes, n_stages,
                    b_col + c, x_col + c, int64_t{1});
    }
  } else {
    if (blockIdx.x == 0)
      walk<T, true>(pl, level_ptr, chunk_ptr, level_chunk, n_levels, W, stage_bytes, n_stages,
                    b_col, x_col, int64_t{1});
  }
  cooperative_groups::this_grid().sync();
  move_rows<T, kCols, false>(x_col, out, perm, n, m, tile);
}

// The host side, with internal linkage: each library that includes this
// header (csrc/sptrsv.cu, and the sweeps' sources) keeps its own flags of
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
           const void* accum, const void* vert_ptr, const void* level_ptr, const void* chunk_ptr,
           const void* level_chunk, int n_levels, int W, int stage_bytes, int n_stages,
           const void* b, void* x, void* stream) {
  static std::atomic<uint64_t> done{0};
  const int smem = smem_bytes(stage_bytes, n_stages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = allow_smem(sptrsv_level_kernel<T>, done)) return static_cast<int>(err);
  sptrsv_level_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      plan_of<T>(row_ids, col_idx, vals, diag, accum, vert_ptr),
      static_cast<const int32_t*>(level_ptr), static_cast<const int2*>(chunk_ptr),
      static_cast<const int32_t*>(level_chunk), n_levels,
      W, stage_bytes, n_stages, static_cast<const T*>(b), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cols(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* level_ptr, const void* chunk_ptr, const void* level_chunk,
                int n_levels, int W,
                int stage_bytes, int n_stages, int m, int64_t rows, const void* b, void* x,
                void* stream) {
  static std::atomic<uint64_t> done{0};
  const int smem = smem_bytes(stage_bytes, n_stages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = allow_smem(sptrsv_level_cols_kernel<T>, done))
    return static_cast<int>(err);
  sptrsv_level_cols_kernel<T><<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      plan_of<T>(row_ids, col_idx, vals, diag, accum, vert_ptr),
      static_cast<const int32_t*>(level_ptr), static_cast<const int2*>(chunk_ptr),
      static_cast<const int32_t*>(level_chunk), n_levels,
      W, stage_bytes, n_stages, rows, static_cast<const T*>(b), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bank(const void* row_ids, const void* col_idx, const void* vals,
                const void* diag, const void* accum, const void* vert_ptr,
                const void* level_ptr, const void* chunk_ptr, const void* level_chunk,
                const void* level_off,
                const void* n_levels, const void* lane_idx, int W, int stage_bytes,
                int n_stages, int m, int64_t rows, const void* b, void* x, void* stream) {
  static std::atomic<uint64_t> done{0};
  const int smem = smem_bytes(stage_bytes, n_stages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = allow_smem(sptrsv_level_bank_kernel<T>, done))
    return static_cast<int>(err);
  sptrsv_level_bank_kernel<T><<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      plan_of<T>(row_ids, col_idx, vals, diag, accum, vert_ptr),
      static_cast<const int32_t*>(level_ptr), static_cast<const int2*>(chunk_ptr),
      static_cast<const int32_t*>(level_chunk),
      static_cast<const int32_t*>(level_off), static_cast<const int32_t*>(n_levels),
      static_cast<const int32_t*>(lane_idx), W, stage_bytes, n_stages, rows,
      static_cast<const T*>(b), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

// The ordered solve's dynamic shared memory: the walk's, and for m columns
// room past the head for the tiles.
template <typename T, bool kCols>
int ordered_smem(int stage_bytes, int n_stages) {
  const int smem = smem_bytes(stage_bytes, n_stages);
  const int tile = kHeadBytes + kTiles * kTile * (kTile + 1) * static_cast<int>(sizeof(T));
  return smem == 0 || !kCols ? smem : (smem > tile ? smem : tile);
}

template <typename T, bool kCols>
std::atomic<uint64_t>& ordered_done() {
  static std::atomic<uint64_t> done{0};
  return done;
}

template <typename T, bool kCols>
cudaError_t ordered_per_sm(int stage_bytes, int n_stages, int* per_sm) {
  const int smem = ordered_smem<T, kCols>(stage_bytes, n_stages);
  if (smem == 0) return cudaErrorInvalidValue;
  if (cudaError_t err = allow_smem(sptrsv_level_ordered_kernel<T, kCols>, ordered_done<T, kCols>()))
    return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, sptrsv_level_ordered_kernel<T, kCols>, kThreads, smem);
}

// The most blocks of the ordered solve, of one column or of m, resident at
// once on the current device (its SMs times the blocks an SM holds), for
// the stage layout: what a cooperative launch may take.
template <typename T>
int ordered_blocks(int stage_bytes, int n_stages, int* blocks) {
  int dev = 0, sms = 0, one = 0, cols = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = ordered_per_sm<T, false>(stage_bytes, n_stages, &one);
  if (err == cudaSuccess) err = ordered_per_sm<T, true>(stage_bytes, n_stages, &cols);
  *blocks = (one < cols ? one : cols) * sms;
  return static_cast<int>(err);
}

template <typename T, bool kCols>
int launch_ordered_as(Plan<T> pl, const int32_t* lp, const int2* cp, const int32_t* lc,
                      int n_levels, int W, int stage_bytes, int n_stages, int m, int grid,
                      int64_t n, const int32_t* pp, const T* bp, T* op, T* sp,
                      cudaStream_t stream) {
  const int smem = ordered_smem<T, kCols>(stage_bytes, n_stages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = allow_smem(sptrsv_level_ordered_kernel<T, kCols>, ordered_done<T, kCols>()))
    return static_cast<int>(err);
  T* xp = sp + static_cast<int64_t>(m) * (n + 1);
  void* args[] = {&pl, &lp, &cp, &lc, &n_levels, &W, &stage_bytes, &n_stages, &m, &n,
                  &pp, &bp, &op, &sp, &xp};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sptrsv_level_ordered_kernel<T, kCols>), dim3(grid),
      dim3(kThreads), args, static_cast<size_t>(smem), stream));
}

// The ordered solve on `grid` blocks, m <= grid <= ordered_blocks: b and
// out the caller's f[n] or row-major f[n, m], perm int32[n], scratch
// 2 * m * (n + 1) elements. One column takes its own instantiation.
template <typename T>
int launch_ordered(const void* row_ids, const void* col_idx, const void* vals, const void* diag,
                   const void* accum, const void* vert_ptr, const void* level_ptr,
                   const void* chunk_ptr, const void* level_chunk, int n_levels, int W,
                   int stage_bytes, int n_stages, int m, int grid, int64_t n, const void* perm,
                   const void* b, void* out, void* scratch, void* stream) {
  if (m < 1 || n < 1 || grid < m) return static_cast<int>(cudaErrorInvalidValue);
  const Plan<T> pl = plan_of<T>(row_ids, col_idx, vals, diag, accum, vert_ptr);
  const auto* lp = static_cast<const int32_t*>(level_ptr);
  const auto* cp = static_cast<const int2*>(chunk_ptr);
  const auto* lc = static_cast<const int32_t*>(level_chunk);
  const auto* pp = static_cast<const int32_t*>(perm);
  const auto* bp = static_cast<const T*>(b);
  auto* st = static_cast<cudaStream_t>(stream);
  if (m == 1)
    return launch_ordered_as<T, false>(pl, lp, cp, lc, n_levels, W, stage_bytes, n_stages, m,
                                       grid, n, pp, bp, static_cast<T*>(out),
                                       static_cast<T*>(scratch), st);
  return launch_ordered_as<T, true>(pl, lp, cp, lc, n_levels, W, stage_bytes, n_stages, m, grid,
                                    n, pp, bp, static_cast<T*>(out), static_cast<T*>(scratch), st);
}

}  // namespace

}  // namespace level
