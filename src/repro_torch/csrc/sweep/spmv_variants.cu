// The SpMV kernel of csrc/spmv.cu at other choices of slots a step (kUnroll)
// and threads a block than the one it ships with. Built and timed by
// kernels/spmv_sweep.py only; no wrapper of the package launches it. Every
// variant is the same chain in the same order, so each keeps the bits.
#include "../spmv.cu"

#define SPMV_VARIANT(U, B)                                                                  \
  extern "C" int spmv_u##U##_t##B##_f32(const void* col, const void* val,                   \
                                        const void* slice_ptr, const void* row_len, int n,  \
                                        int W, const void* x, void* y, void* stream) {      \
    return launch<float, U, B>(col, val, slice_ptr, row_len, n, W, x, y, stream);          \
  }                                                                                         \
  extern "C" int spmv_u##U##_t##B##_f64(const void* col, const void* val,                   \
                                        const void* slice_ptr, const void* row_len, int n,  \
                                        int W, const void* x, void* y, void* stream) {      \
    return launch<double, U, B>(col, val, slice_ptr, row_len, n, W, x, y, stream);         \
  }

SPMV_VARIANT(1, 128)
SPMV_VARIANT(2, 128)
SPMV_VARIANT(4, 128)
SPMV_VARIANT(8, 128)
SPMV_VARIANT(1, 256)
SPMV_VARIANT(2, 256)
SPMV_VARIANT(4, 256)
SPMV_VARIANT(8, 256)
