// Device helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ngt {

// Sum over the 32 lanes of a warp; the result is valid in lane 0. The
// shuffle tree is fixed, so the sum is bit-reproducible run to run.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// a * b + c rounded once, in the operands' type.
__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

// Exact float of a small unsigned integer (v < 2^23) without the
// integer-to-float conversion unit: OR it into the mantissa of 2^23 and
// subtract 2^23. Two full-rate ALU ops instead of one quarter-rate I2F.
__device__ __forceinline__ float small_u2f(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

}  // namespace ngt
