// Device code of the packed 2-bit passes, shared by the sweep's gather and
// scatter (pack2.cu) and the measurement ladder's fused step (micro.cu): the
// same bodies, so the same sums in the same order wherever they are launched.
#pragma once

#include "common.cuh"

namespace ngt {

constexpr int kRowsPerWarp = 4;

__device__ __forceinline__ uint32_t word_of(const uint4& c, int w) {
  return w == 0 ? c.x : w == 1 ? c.y : w == 2 ? c.z : c.w;
}

// Dot of one 4-byte word (columns col..col+3) against the y planes of those
// columns; y[k] holds y4[k, col..col+3].
__device__ __forceinline__ float word_dot(uint32_t w, const float4 (&y)[4]) {
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a = fmaf(small_u2f((w >> (2 * k)) & 3u), y[k].x, a);
    a = fmaf(small_u2f((w >> (8 + 2 * k)) & 3u), y[k].y, a);
    a = fmaf(small_u2f((w >> (16 + 2 * k)) & 3u), y[k].z, a);
    a = fmaf(small_u2f((w >> (24 + 2 * k)) & 3u), y[k].w, a);
  }
  return a;
}

// yt[(k * 4 + w) * nchunk + c] = y4[k, 16c + 4w .. 16c + 4w + 3]
__device__ __forceinline__ float4 y_chunk(const float* __restrict__ y4, int q, int nchunk,
                                          int idx) {
  const int c = idx % nchunk;
  const int kw = idx / nchunk;
  return *reinterpret_cast<const float4*>(y4 + (size_t)(kw >> 2) * q + 16 * c + 4 * (kw & 3));
}

static __global__ void y_transpose_kernel(const float* __restrict__ y4, float4* __restrict__ yt,
                                          int q) {
  const int nchunk = q >> 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < 16 * nchunk) yt[idx] = y_chunk(y4, q, nchunk, idx);
}

// The calling warp gathers the row groups first_row, first_row + row_stride,
// ... (kRowsPerWarp rows each): out[r] = sum_k sum_j plane_k(pk[r, j]) * y4[k, j].
// ys: the transposed y (y_chunk's order), in shared memory (kStaged) or in
// device memory. Lanes read a row in 16-byte chunks; the chunk's y values are
// loaded once for all rows of the group; a fixed-order warp reduction closes
// the sum.
template <bool kStaged>
__device__ __forceinline__ void gather_rows(const uint8_t* __restrict__ pk,
                                            const float4* __restrict__ ys,
                                            float* __restrict__ out, long long rows, int q,
                                            long long first_row, long long row_stride) {
  const int nchunk = q >> 4;
  const int lane = threadIdx.x & 31;
  for (long long r0 = first_row; r0 < rows; r0 += row_stride) {  // warp-uniform loop
    float acc[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr] = 0.f;
    for (int c = lane; c < nchunk; c += 32) {
      uint4 ch[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        ch[rr] = (r0 + rr < rows)
                     ? __ldg(reinterpret_cast<const uint4*>(pk + (r0 + rr) * q) + c)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float4 y[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int idx = (k * 4 + w) * nchunk + c;
          y[k] = kStaged ? ys[idx] : __ldg(ys + idx);
        }
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr] += word_dot(word_of(ch[rr], w), y);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const float s = warp_sum(acc[rr]);
      if (lane == 0 && r0 + rr < rows) out[r0 + rr] = s;
    }
  }
}

// The calling thread owns column word wi (16 outputs) over rows
// [r_begin, r_end) and writes its partial sums to ps, one slice's (4, q):
// ps[k, 4 wi + i] = sum_r u[r] * plane_k(pk[r, 4 wi + i]).
__device__ __forceinline__ void scatter_slice(const uint8_t* __restrict__ pk,
                                              const float* __restrict__ u,
                                              float* __restrict__ ps, long long r_begin,
                                              long long r_end, int q, int wi) {
  const int nw = q >> 2;
  float acc[16];  // acc[k * 4 + i]: plane k, column 4 * wi + i
#pragma unroll
  for (int a = 0; a < 16; ++a) acc[a] = 0.f;
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(pk) + wi;
#pragma unroll 4
  for (long long r = r_begin; r < r_end; ++r) {
    const uint32_t w = __ldg(pw + r * nw);
    const float ur = __ldg(u + r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[k * 4 + i] = fmaf(small_u2f((w >> (8 * i + 2 * k)) & 3u), ur, acc[k * 4 + i]);
    }
  }
  ps += 4 * (size_t)wi;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<float4*>(ps + (size_t)k * q) =
        make_float4(acc[k * 4], acc[k * 4 + 1], acc[k * 4 + 2], acc[k * 4 + 3]);
}

constexpr int kReduceThreads = 256;

// out[i] = sum over slices, in slice order, of partial[s, i]: the second,
// fixed-order pass of every scatter (no float atomics).
static __global__ void __launch_bounds__(kReduceThreads)
slice_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, long long slices,
                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (long long s = 0; s < slices; ++s) a += partial[s * n + i];
  out[i] = a;
}

inline cudaError_t launch_slice_reduce(const float* partial, float* out, long long slices,
                                       long long n, cudaStream_t st) {
  slice_reduce_kernel<<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
                        st>>>(partial, out, slices, n);
  return cudaGetLastError();
}

}  // namespace ngt
