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
//   16-byte chunks (coalesced), and the chunk's y values are loaded once and
//   reused for all rows of the group. y is read transposed so that
//   neighbouring lanes read neighbouring float4s (no bank conflicts, and
//   coalesced from device memory). The TPU kernel carried a partial sum
//   across its sequential q grid axis; here that axis is the in-warp loop
//   over chunks, closed by a fixed-order warp reduction. Blocks are
//   persistent (grid-stride over row groups). Where the 16*q bytes of y fit a
//   block's shared memory (q <= 14,528, about 58,000 individuals) each block
//   stages y there once; above that a first kernel writes the transposed y
//   to a device-memory scratch (400 KB at 100,000 individuals, resident in
//   the 50 MB L2) and the gather reads it from there. Both paths sum in the
//   same order, so the result does not depend on which one ran.
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
#include "pack2_device.cuh"

// The bodies (`gather_rows`, `scatter_slice`, the slice reduction) live in
// pack2_device.cuh, which the measurement ladder's fused step shares.

namespace {

using ngt::kRowsPerWarp;
constexpr int kMatvecThreads = 256;
constexpr int kRankThreads = 128;

// kStaged: y is staged transposed into shared memory; otherwise it is read
// from yt, the transposed copy in device memory.
template <bool kStaged>
__global__ void __launch_bounds__(kMatvecThreads)
matvec_kernel(const uint8_t* __restrict__ pk, const float* __restrict__ y4,
              const float4* __restrict__ yt, float* __restrict__ out, long long rows, int q) {
  extern __shared__ float4 ys_smem[];
  const int nchunk = q >> 4;
  if (kStaged) {
    for (int idx = threadIdx.x; idx < 16 * nchunk; idx += blockDim.x)
      ys_smem[idx] = ngt::y_chunk(y4, q, nchunk, idx);
    __syncthreads();
  }
  const long long wpb = blockDim.x >> 5;
  ngt::gather_rows<kStaged>(pk, kStaged ? ys_smem : yt, out, rows, q,
                            ((long long)blockIdx.x * wpb + (threadIdx.x >> 5)) * kRowsPerWarp,
                            (long long)gridDim.x * wpb * kRowsPerWarp);
}

__global__ void __launch_bounds__(kRankThreads)
rank_partial_kernel(const uint8_t* __restrict__ pk, const float* __restrict__ u,
                    float* __restrict__ partial, long long rows, int q,
                    long long rows_per_slice) {
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= (q >> 2)) return;
  const long long r_begin = (long long)blockIdx.y * rows_per_slice;
  ngt::scatter_slice(pk, u, partial + (size_t)blockIdx.y * 4 * q, r_begin,
                     min(rows, r_begin + rows_per_slice), q, wi);
}

}  // namespace

extern "C" {

const char* ngt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// pk: (rows, q) uint8, y4: (4, q) f32, out: (rows,) f32; q a multiple of 16,
// pk and y4 16-byte aligned, rows > 0. yt: null to stage y in shared memory
// (16*q bytes must fit a block), else a 16-byte aligned (4, q) f32 scratch
// that receives the transposed y.
int ngt_pack2_matvec(const void* pk, const void* y4, void* yt, void* out, long long rows,
                     long long q, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const long long wpb = kMatvecThreads / 32;
  long long blocks = (groups + wpb - 1) / wpb;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  const cudaStream_t st = (cudaStream_t)stream;
  if (yt == nullptr) {
    const size_t smem = (size_t)16 * (size_t)q;  // 4 planes x q floats
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(matvec_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    matvec_kernel<true><<<(unsigned)blocks, kMatvecThreads, smem, st>>>(
        (const uint8_t*)pk, (const float*)y4, nullptr, (float*)out, rows, (int)q);
    return (int)cudaGetLastError();
  }
  const long long n = q;  // 16 * (q / 16) float4s
  ngt::y_transpose_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)y4,
                                                                       (float4*)yt, (int)q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  matvec_kernel<false><<<(unsigned)blocks, kMatvecThreads, 0, st>>>(
      (const uint8_t*)pk, (const float*)y4, (const float4*)yt, (float*)out, rows, (int)q);
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
  return (int)ngt::launch_slice_reduce((const float*)partial, (float*)out, slices, 4 * q,
                                       (cudaStream_t)stream);
}

}  // extern "C"
