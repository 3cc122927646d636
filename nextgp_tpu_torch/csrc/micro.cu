// The measurement ladder's kernels for Hopper (sm_90a): streaming passes that
// answer design questions about the sweep's two panel passes. Each replaces a
// Pallas kernel of one of the JAX repository's measurement scripts and
// computes what that kernel computes. The TPU kernels carried their sums
// across a sequential grid axis; here a gather closes its column loop inside
// one warp with a fixed-order reduction and a scatter sums row slices in a
// second fixed-order pass, as K1 and K2 did before their redesign (pack2.cu
// now closes K2's slices in the same launch). No float atomics:
// every output is bit-reproducible for a given shape. All are bound by the
// device-memory bytes of the panel they stream.
//
// gather_width<Word>  replaces `mv8` / `mv32` (scripts/micro_load32.py:38-104).
//   out[r] = sum_j sum_m ((pk[r, j] >> 2m) & 3) * yw[m, j], m over the 4W
//   two-bit fields of a W-byte word: W = 1 is the packed gather with one byte
//   per thread per load, W = 4 the same bytes as little-endian 32-bit words
//   with y as (16, q/4). Everything but the load is K1's earlier body: one warp per group
//   of four rows, y staged in shared memory (16 q bytes either way), the
//   fields' y values loaded once for the four rows, a warp reduction.
// read_step  replaces `make_dma_step` (scripts/micro_frontier.py:62-92).
//   out[r] = sum_j pk[r, j] as int32: a read-only pass, K1's access pattern
//   (16-byte loads, four rows per warp) with one __dp4a per word so that
//   arithmetic cannot bind it. The grid is the caller's.
// dense_gather  replaces `pl_r0` (scripts/micro_matvec.py:58-79).
//   out[l] = sum_n mt[l, n] * y[n], mt int8: K1's earlier design on unpacked dosages,
//   y staged transposed in shared memory (4 n bytes).
// dense_scatter  replaces `pl_corr` (scripts/micro_matvec.py:81-104).
//   out[n] = sum_l u[l] * mt[l, n]: K2's earlier design, one 4-byte column word per
//   thread over a row slice, then the fixed-order slice reduction.
// fused_step  replaces `make_fused_step` (scripts/micro_fused.py:64-129).
//   One launch gathers step t1's rows (r0 = unpack(pk[t1]) @ y4) and scatters
//   step t's rows (dy = u @ planes(pk[t])). The TPU version had to give both
//   jobs one tile grid; here blocks are split by role, even blocks scatter
//   and odd blocks gather, so both streams are in flight on every SM at
//   once. The bodies are the sequential pair's as they were before K1 and K2
//   were redesigned (below, kept verbatim: same outputs, same bits): the
//   gather reads a transposed y from device memory (200 KB at q = 12,544:
//   L1/L2 resident), the scatter gives each thread a 4-byte column word of a
//   row slice and a second pass adds the slices.
// The sequential pair's bodies as they were before K1 and K2 were redesigned
// for this card (pack2.cu): the fused step runs them, so its outputs keep
// their bits; dense_scatter shares the slice reduction.
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

namespace {

using ngt::kRowsPerWarp;
constexpr int kGatherThreads = 256;
constexpr int kScatterThreads = 128;
constexpr int kFusedThreads = 256;

template <typename Word>
__global__ void __launch_bounds__(kGatherThreads)
gather_width_kernel(const Word* __restrict__ pk, const float* __restrict__ yw,
                    float* __restrict__ out, long long rows, int nword) {
  constexpr int kFields = 4 * (int)sizeof(Word);
  extern __shared__ float ys[];  // (kFields, nword), as given
  for (int idx = threadIdx.x; idx < kFields * nword; idx += blockDim.x) ys[idx] = yw[idx];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long wpb = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * wpb * kRowsPerWarp;
  for (long long r0 = ((long long)blockIdx.x * wpb + (threadIdx.x >> 5)) * kRowsPerWarp;
       r0 < rows; r0 += stride) {  // warp-uniform loop
    float acc[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr] = 0.f;
    for (int j = lane; j < nword; j += 32) {
      uint32_t w[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        w[rr] = (r0 + rr < rows) ? (uint32_t)__ldg(pk + (r0 + rr) * nword + j) : 0u;
#pragma unroll
      for (int m = 0; m < kFields; ++m) {
        const float y = ys[m * nword + j];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr)
          acc[rr] = fmaf(ngt::small_u2f((w[rr] >> (2 * m)) & 3u), y, acc[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const float s = ngt::warp_sum(acc[rr]);
      if (lane == 0 && r0 + rr < rows) out[r0 + rr] = s;
    }
  }
}

template <typename Word>
int launch_gather_width(const void* pk, const void* yw, void* out, long long rows,
                        long long nword, long long blocks, cudaStream_t st) {
  const size_t smem = 16 * sizeof(Word) * (size_t)nword;  // 4 W rows of nword floats
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gather_width_kernel<Word>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gather_width_kernel<Word><<<(unsigned)blocks, kGatherThreads, smem, st>>>(
      (const Word*)pk, (const float*)yw, (float*)out, rows, (int)nword);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kGatherThreads)
read_step_kernel(const uint8_t* __restrict__ pk, int* __restrict__ out, long long rows, int q) {
  const int nchunk = q >> 4;
  const int lane = threadIdx.x & 31;
  const long long wpb = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * wpb * kRowsPerWarp;
  for (long long r0 = ((long long)blockIdx.x * wpb + (threadIdx.x >> 5)) * kRowsPerWarp;
       r0 < rows; r0 += stride) {  // warp-uniform loop
    unsigned acc[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr] = 0u;
    for (int c = lane; c < nchunk; c += 32) {
      uint4 ch[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        ch[rr] = (r0 + rr < rows)
                     ? __ldg(reinterpret_cast<const uint4*>(pk + (r0 + rr) * q) + c)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
#pragma unroll
        for (int w = 0; w < 4; ++w)  // the four bytes of a word, each times 1
          acc[rr] = __dp4a(ngt::word_of(ch[rr], w), 0x01010101u, acc[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      unsigned s = acc[rr];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0 && r0 + rr < rows) out[r0 + rr] = (int)s;
    }
  }
}

// Byte i of a word as a signed dosage.
__device__ __forceinline__ float s8_of(uint32_t w, int i) {
  return (float)(int)(int8_t)(w >> (8 * i));
}

__global__ void __launch_bounds__(kGatherThreads)
dense_gather_kernel(const int8_t* __restrict__ mt, const float* __restrict__ y,
                    float* __restrict__ out, long long rows, int n) {
  // yt[w * nchunk + c] = y[16c + 4w .. 16c + 4w + 3]: neighbouring lanes read
  // neighbouring float4s
  extern __shared__ float4 yt[];
  const int nchunk = n >> 4;
  for (int idx = threadIdx.x; idx < 4 * nchunk; idx += blockDim.x)
    yt[idx] = *reinterpret_cast<const float4*>(y + 16 * (idx % nchunk) + 4 * (idx / nchunk));
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
                     ? __ldg(reinterpret_cast<const uint4*>(mt + (r0 + rr) * n) + c)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float4 yv = yt[w * nchunk + c];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const uint32_t word = ngt::word_of(ch[rr], w);
          float a = acc[rr];
          a = fmaf(s8_of(word, 0), yv.x, a);
          a = fmaf(s8_of(word, 1), yv.y, a);
          a = fmaf(s8_of(word, 2), yv.z, a);
          a = fmaf(s8_of(word, 3), yv.w, a);
          acc[rr] = a;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const float s = ngt::warp_sum(acc[rr]);
      if (lane == 0 && r0 + rr < rows) out[r0 + rr] = s;
    }
  }
}

__global__ void __launch_bounds__(kScatterThreads)
dense_scatter_partial_kernel(const int8_t* __restrict__ mt, const float* __restrict__ u,
                             float* __restrict__ partial, long long rows, int n,
                             long long rows_per_slice) {
  const int nw = n >> 2;
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= nw) return;
  const long long r_begin = (long long)blockIdx.y * rows_per_slice;
  const long long r_end = min(rows, r_begin + rows_per_slice);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // columns 4 wi .. 4 wi + 3
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(mt) + wi;
#pragma unroll 4
  for (long long r = r_begin; r < r_end; ++r) {
    const uint32_t w = __ldg(pw + r * nw);
    const float ur = __ldg(u + r);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = fmaf(s8_of(w, i), ur, acc[i]);
  }
  *reinterpret_cast<float4*>(partial + (size_t)blockIdx.y * n + 4 * (size_t)wi) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// Block 2i scatters (column block i % col_blocks of row slice i / col_blocks
// of pk_s), block 2i + 1 gathers (row groups i, i + gridDim.x / 2, ... of
// pk_g).
__global__ void __launch_bounds__(kFusedThreads)
fused_step_kernel(const uint8_t* __restrict__ pk_s, const uint8_t* __restrict__ pk_g,
                  const float* __restrict__ u, const float4* __restrict__ yt,
                  float* __restrict__ r0, float* __restrict__ partial, long long rows, int q,
                  long long rows_per_slice, int col_blocks) {
  const long long id = blockIdx.x >> 1;
  if (blockIdx.x & 1) {
    const long long wpb = blockDim.x >> 5;
    ngt::gather_rows<false>(pk_g, yt, r0, rows, q, (id * wpb + (threadIdx.x >> 5)) * kRowsPerWarp,
                            (long long)(gridDim.x >> 1) * wpb * kRowsPerWarp);
    return;
  }
  const int wi = (int)(id % col_blocks) * blockDim.x + threadIdx.x;
  if (wi >= (q >> 2)) return;
  const long long slice = id / col_blocks;
  const long long r_begin = slice * rows_per_slice;
  ngt::scatter_slice(pk_s, u, partial + (size_t)slice * 4 * q, r_begin,
                     min(rows, r_begin + rows_per_slice), q, wi);
}

}  // namespace

extern "C" {

// pk: (rows, nword) words of `width` bytes (1: uint8, 4: int32), yw:
// (4 width, nword) f32, out: (rows,) f32; 16 width nword bytes of shared
// memory must fit a block; blocks > 0.
int ngt_gather_width(const void* pk, const void* yw, void* out, long long rows, long long nword,
                     long long width, long long blocks, void* stream) {
  if (width == 1)
    return launch_gather_width<uint8_t>(pk, yw, out, rows, nword, blocks, (cudaStream_t)stream);
  if (width == 4)
    return launch_gather_width<uint32_t>(pk, yw, out, rows, nword, blocks, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// pk: (rows, q) uint8, 16-byte aligned, q a multiple of 16; out: (rows,) int32.
int ngt_read_step(const void* pk, void* out, long long rows, long long q, long long blocks,
                  void* stream) {
  read_step_kernel<<<(unsigned)blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (int*)out, rows, (int)q);
  return (int)cudaGetLastError();
}

// mt: (rows, n) int8, y: (n,) f32, out: (rows,) f32; n a multiple of 16, mt
// and y 16-byte aligned; 4 n bytes of shared memory must fit a block.
int ngt_dense_gather(const void* mt, const void* y, void* out, long long rows, long long n,
                     long long blocks, void* stream) {
  const size_t smem = 4 * (size_t)n;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(dense_gather_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_gather_kernel<<<(unsigned)blocks, kGatherThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)mt, (const float*)y, (float*)out, rows, (int)n);
  return (int)cudaGetLastError();
}

// mt: (rows, n) int8, u: (rows,) f32, partial: (slices, n) f32 scratch, out:
// (n,) f32; n a multiple of 16, 1 <= slices <= 65535.
int ngt_dense_scatter(const void* mt, const void* u, void* partial, void* out, long long rows,
                      long long n, long long slices, void* stream) {
  const long long nw = n / 4;
  const long long rows_per_slice = (rows + slices - 1) / slices;
  const dim3 grid((unsigned)((nw + kScatterThreads - 1) / kScatterThreads), (unsigned)slices);
  dense_scatter_partial_kernel<<<grid, kScatterThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)mt, (const float*)u, (float*)partial, rows, (int)n, rows_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)ngt::launch_slice_reduce((const float*)partial, (float*)out, slices, n,
                                       (cudaStream_t)stream);
}

// pk_s, pk_g: the (rows, q) uint8 steps to scatter and to gather; u: (rows,)
// f32; y4: (4, q) f32; yt: (4, q) f32 scratch for the transposed y; r0:
// (rows,) f32; partial: (slices, 4, q) f32 scratch; dy: (4, q) f32. q a
// multiple of 16, everything 16-byte aligned.
int ngt_fused_step(const void* pk_s, const void* pk_g, const void* u, const void* y4, void* yt,
                   void* r0, void* partial, void* dy, long long rows, long long q,
                   long long slices, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  ngt::y_transpose_kernel<<<(unsigned)((q + 255) / 256), 256, 0, st>>>((const float*)y4,
                                                                       (float4*)yt, (int)q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long col_blocks = (q / 4 + kFusedThreads - 1) / kFusedThreads;
  const long long rows_per_slice = (rows + slices - 1) / slices;
  fused_step_kernel<<<(unsigned)(2 * col_blocks * slices), kFusedThreads, 0, st>>>(
      (const uint8_t*)pk_s, (const uint8_t*)pk_g, (const float*)u, (const float4*)yt, (float*)r0,
      (float*)partial, rows, (int)q, rows_per_slice, (int)col_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)ngt::launch_slice_reduce((const float*)partial, (float*)dy, slices, 4 * q, st);
}

}  // extern "C"
