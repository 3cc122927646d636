// Packed 2-bit genotype passes for Hopper (sm_90a): the gather (K1) and the
// scatter (K2) of the blocked Gibbs sweep.
//
// Storage (nextgp_tpu/ops/pack2.py): a locus row holds q bytes; byte j packs
// the dosages of individuals j, j+q, j+2q, j+3q in its 2-bit fields 0..3, so
// plane k of a row is ((byte >> 2k) & 3) and the residual is viewed planar
// as y4 (4, q).
//
// K1 gather, out[r] = sum_k sum_j plane_k(pk[r, j]) * y4[k, j].
//   Replaces the Pallas kernel `_make_matvec_kernel("vpu")` behind
//   `pack2.matvec_step` / `pack2.matvec` (nextgp_tpu/ops/pack2.py:89-125,
//   170-187, 297-325).
//   Bound: device-memory bytes of the panel (each byte read once) and, next,
//   the shared-memory reads of y (16 bytes of y per packed byte).
//   Design: one warp per group of kRowsPerWarp rows, lanes read a row in
//   16-byte chunks (coalesced), and the chunk's y values are loaded once from
//   shared memory and reused for all rows of the group. y sits in shared
//   memory transposed so that neighbouring lanes read neighbouring float4s
//   (no bank conflicts). The TPU kernel carried a partial sum across its
//   sequential q grid axis; here that axis is the in-warp loop over chunks,
//   closed by a fixed-order warp reduction. Blocks are persistent (grid-
//   stride over row groups) so y is staged once per block.
//
// K2 scatter, out[k, j] = sum_r u[r] * plane_k(pk[r, j]), planar (4, q).
//   Replaces `_make_rank_kernel("vpu")` behind `pack2.rank_update_step` /
//   `pack2.rank_update` (pack2.py:190-253, 260-277, 328-354). Rows 4..7 of
//   the TPU kernel's (8, q) output were sublane padding and are dropped.
//   Bound: device-memory bytes of the panel.
//   Design: the TPU kernel carried its sum across a sequential row grid axis.
//   Here the rows are cut into `slices` contiguous slices; each thread owns
//   one 4-byte column word (16 outputs) of one slice and writes a partial
//   (slices, 4, q); a second pass sums the partials in slice order. No float
//   atomics, so the result is bit-reproducible for a given shape.
#include "common.cuh"

namespace {

constexpr int kMatvecThreads = 256;
constexpr int kRowsPerWarp = 4;
constexpr int kRankThreads = 128;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ uint32_t word_of(const uint4& c, int w) {
  return w == 0 ? c.x : w == 1 ? c.y : w == 2 ? c.z : c.w;
}

// Dot of one 4-byte word (columns col..col+3) against the y planes of those
// columns; y[k] holds y4[k, col..col+3].
__device__ __forceinline__ float word_dot(uint32_t w, const float4 (&y)[4]) {
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a = fmaf(ngt::small_u2f((w >> (2 * k)) & 3u), y[k].x, a);
    a = fmaf(ngt::small_u2f((w >> (8 + 2 * k)) & 3u), y[k].y, a);
    a = fmaf(ngt::small_u2f((w >> (16 + 2 * k)) & 3u), y[k].z, a);
    a = fmaf(ngt::small_u2f((w >> (24 + 2 * k)) & 3u), y[k].w, a);
  }
  return a;
}

__global__ void __launch_bounds__(kMatvecThreads)
matvec_kernel(const uint8_t* __restrict__ pk, const float* __restrict__ y4,
              float* __restrict__ out, long long rows, int q) {
  // ys[(k * 4 + w) * nchunk + c] = y4[k, 16c + 4w .. 16c + 4w + 3]
  extern __shared__ float4 ys[];
  const int nchunk = q >> 4;
  for (int idx = threadIdx.x; idx < 16 * nchunk; idx += blockDim.x) {
    const int c = idx % nchunk;
    const int kw = idx / nchunk;
    ys[idx] = *reinterpret_cast<const float4*>(
        y4 + (size_t)(kw >> 2) * q + 16 * c + 4 * (kw & 3));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long wpb = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * wpb * kRowsPerWarp;
  for (long long r0 = ((long long)blockIdx.x * wpb + (threadIdx.x >> 5)) * kRowsPerWarp;
       r0 < rows; r0 += stride) {  // warp-uniform loop
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
        for (int k = 0; k < 4; ++k) y[k] = ys[(k * 4 + w) * nchunk + c];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr] += word_dot(word_of(ch[rr], w), y);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const float s = ngt::warp_sum(acc[rr]);
      if (lane == 0 && r0 + rr < rows) out[r0 + rr] = s;
    }
  }
}

__global__ void __launch_bounds__(kRankThreads)
rank_partial_kernel(const uint8_t* __restrict__ pk, const float* __restrict__ u,
                    float* __restrict__ partial, long long rows, int q,
                    long long rows_per_slice) {
  const int nw = q >> 2;
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= nw) return;
  const long long r_begin = (long long)blockIdx.y * rows_per_slice;
  const long long r_end = min(rows, r_begin + rows_per_slice);
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
        acc[k * 4 + i] = fmaf(ngt::small_u2f((w >> (8 * i + 2 * k)) & 3u), ur, acc[k * 4 + i]);
    }
  }
  float* ps = partial + (size_t)blockIdx.y * 4 * q + 4 * (size_t)wi;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<float4*>(ps + (size_t)k * q) =
        make_float4(acc[k * 4], acc[k * 4 + 1], acc[k * 4 + 2], acc[k * 4 + 3]);
}

__global__ void __launch_bounds__(kReduceThreads)
rank_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                   long long slices, long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float a = 0.f;
  for (long long s = 0; s < slices; ++s) a += partial[s * n4 + i];
  out[i] = a;
}

}  // namespace

extern "C" {

const char* ngt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// pk: (rows, q) uint8, y4: (4, q) f32, out: (rows,) f32; q a multiple of 16,
// pk and y4 16-byte aligned, rows > 0.
int ngt_pack2_matvec(const void* pk, const void* y4, void* out, long long rows,
                     long long q, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)16 * (size_t)q;  // 4 planes x q floats
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const long long wpb = kMatvecThreads / 32;
  long long blocks = (groups + wpb - 1) / wpb;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  matvec_kernel<<<(unsigned)blocks, kMatvecThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (const float*)y4, (float*)out, rows, (int)q);
  return (int)cudaGetLastError();
}

// pk: (rows, q) uint8, u: (rows,) f32, partial: (slices, 4, q) f32 scratch,
// out: (4, q) f32; q a multiple of 16, 1 <= slices <= 65535, rows > 0.
int ngt_pack2_rank_update(const void* pk, const void* u, void* partial, void* out,
                          long long rows, long long q, long long slices, void* stream) {
  const long long nw = q / 4;
  const long long rows_per_slice = (rows + slices - 1) / slices;
  const dim3 grid((unsigned)((nw + kRankThreads - 1) / kRankThreads), (unsigned)slices);
  rank_partial_kernel<<<grid, kRankThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (const float*)u, (float*)partial, rows, (int)q, rows_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n4 = 4 * q;
  rank_reduce_kernel<<<(unsigned)((n4 + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
                       (cudaStream_t)stream>>>((const float*)partial, (float*)out, slices, n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
