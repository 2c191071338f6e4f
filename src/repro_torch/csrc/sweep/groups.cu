// The level walk over column groups: m right-hand sides of the bulk or
// elastic level order, a thread solving one vertex for a group of C columns.
// Built and timed by kernels/level_sweep.py only, beside the column grid
// that ships (csrc/level.cuh, one column a block); no wrapper of the
// package launches it.
//
// b and x are f[G, n + 1, C]: group g holds columns g*C .. g*C + C - 1, and
// the C entries of one row are contiguous, so a row is C * sizeof(T) bytes,
// aligned to that or to 16 bytes (the caller checks the base pointers).
// Block g walks the level order for group g; groups never interact, so
// blocks never wait for each other. Per slot a thread loads the index and
// the value once (through __ldg) and the C entries of that x row in 16-byte
// pieces (one 4- or 8-byte load where the row is narrower), and keeps C
// independent FMA chains in registers, one rn::fma per column in slot
// order. Each column's chain is the single-RHS walk's, padding slots
// included, so each column keeps its bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../level.cuh"

namespace {

// The load of a row of kBytes: the whole row, at most 16 bytes of it.
template <int kBytes>
struct Piece;
template <>
struct Piece<4> {
  using type = unsigned int;
};
template <>
struct Piece<8> {
  using type = uint2;
};
template <>
struct Piece<16> {
  using type = uint4;
};

// The C entries of one row of a group, moved in pieces.
template <typename T, int C>
struct Row {
  static constexpr int kBytes = C * static_cast<int>(sizeof(T));
  static constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  static constexpr int kPieces = kBytes / kPiece;
  using P = typename Piece<kPiece>::type;
  union {
    P piece[kPieces];
    T v[C];
  };
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) piece[i] = reinterpret_cast<const P*>(p)[i];
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) reinterpret_cast<P*>(p)[i] = piece[i];
  }
};

// Block g walks group g of b and x f[G, rows = n + 1, C].
template <typename T, int C>
__global__ void sptrsv_level_groups_kernel(
    const int32_t* __restrict__ row_ids, const int32_t* __restrict__ col_idx,
    const T* __restrict__ vals, const T* __restrict__ diag,
    const uint8_t* __restrict__ accum, const int32_t* __restrict__ vert_ptr,
    const int32_t* __restrict__ level_ptr, int n_levels, int W, int64_t rows,
    const T* __restrict__ b,  // [G, rows, C]
    T* x) {                   // the same layout, zeroed by the caller
  const int64_t g = static_cast<int64_t>(blockIdx.x) * rows * C;
  b += g;
  x += g;
  int v0 = __ldg(level_ptr);
  for (int lv = 0; lv < n_levels; ++lv) {
    const int v1 = __ldg(level_ptr + lv + 1);
    for (int v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
      const int p1 = __ldg(vert_ptr + v + 1);
      T acc[C];
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] = T(0);
      for (int p = __ldg(vert_ptr + v); p < p1; ++p) {
        const int32_t* c = col_idx + static_cast<int64_t>(p) * W;
        const T* a = vals + static_cast<int64_t>(p) * W;
#pragma unroll 4
        for (int w = 0; w < W; ++w) {
          const T aw = __ldg(a + w);
          Row<T, C> xr;
          xr.load(x + static_cast<int64_t>(__ldg(c + w)) * C);
#pragma unroll
          for (int j = 0; j < C; ++j) acc[j] = rn::fma(aw, xr.v[j], acc[j]);
        }
        if (!__ldg(accum + p)) {
          const int64_t r = static_cast<int64_t>(__ldg(row_ids + p)) * C;
          const T d = __ldg(diag + p);
          Row<T, C> br, xr;
          br.load(b + r);
#pragma unroll
          for (int j = 0; j < C; ++j) xr.v[j] = rn::finish(br.v[j], acc[j], d);
          xr.store(x + r);
        }
      }
    }
    __syncthreads();
    v0 = v1;
  }
}

template <typename T, int C>
int launch(const void* row_ids, const void* col_idx, const void* vals, const void* diag,
           const void* accum, const void* vert_ptr, const void* level_ptr, int n_levels,
           int W, int groups, int64_t rows, const void* b, void* x, void* stream) {
  sptrsv_level_groups_kernel<T, C>
      <<<groups, level::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(row_ids), static_cast<const int32_t*>(col_idx),
          static_cast<const T*>(vals), static_cast<const T*>(diag),
          static_cast<const uint8_t*>(accum), static_cast<const int32_t*>(vert_ptr),
          static_cast<const int32_t*>(level_ptr), n_levels, W, rows,
          static_cast<const T*>(b), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

// The group walk at C columns a group: 1, 2, 4, 8 for float (rows of 4 to
// 32 bytes), 1, 2, 4 for double (8 to 32). C = 1 is the shipped column
// grid's walk in this kernel's spelling, timed beside it.
template <typename T>
int launch_c(const void* row_ids, const void* col_idx, const void* vals, const void* diag,
             const void* accum, const void* vert_ptr, const void* level_ptr, int n_levels,
             int W, int C, int groups, int64_t rows, const void* b, void* x,
             void* stream) {
  switch (C) {
    case 1:
      return launch<T, 1>(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr,
                          n_levels, W, groups, rows, b, x, stream);
    case 2:
      return launch<T, 2>(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr,
                          n_levels, W, groups, rows, b, x, stream);
    case 4:
      return launch<T, 4>(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr,
                          n_levels, W, groups, rows, b, x, stream);
    case 8:
      if constexpr (sizeof(T) == 4) {
        return launch<T, 8>(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr,
                            n_levels, W, groups, rows, b, x, stream);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int sptrsv_groups_f32(const void* row_ids, const void* col_idx, const void* vals,
                      const void* diag, const void* accum, const void* vert_ptr,
                      const void* level_ptr, int n_levels, int W, int C, int groups,
                      int64_t rows, const void* b, void* x, void* stream) {
  return launch_c<float>(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr,
                         n_levels, W, C, groups, rows, b, x, stream);
}

int sptrsv_groups_f64(const void* row_ids, const void* col_idx, const void* vals,
                      const void* diag, const void* accum, const void* vert_ptr,
                      const void* level_ptr, int n_levels, int W, int C, int groups,
                      int64_t rows, const void* b, void* x, void* stream) {
  return launch_c<double>(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr,
                          n_levels, W, C, groups, rows, b, x, stream);
}

}  // extern "C"
