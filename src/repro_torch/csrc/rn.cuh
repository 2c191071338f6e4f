// Correctly rounded arithmetic shared by the kernels of this directory.
//
// The bits of every solve rest on one fused multiply-add per entry and a
// correctly rounded add, subtract and divide: the _rn intrinsics, which the
// compiler never contracts or approximates. No source that includes this
// header may be built with --use_fast_math.
#pragma once

#include <cuda_runtime.h>

namespace rn {

__device__ __forceinline__ float fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
// (b - acc) / d, the finish of a triangular row
__device__ __forceinline__ float finish(float b, float acc, float d) {
  return __fdiv_rn(__fsub_rn(b, acc), d);
}
__device__ __forceinline__ double finish(double b, double acc, double d) {
  return __ddiv_rn(__dsub_rn(b, acc), d);
}

}  // namespace rn
