// The measurement ladder's kernels for Hopper (sm_90a): streaming passes that
// answer design questions about the sweep's two panel passes. Each replaces a
// Pallas kernel of one of the JAX repository's measurement scripts and
// computes what that kernel computes. The TPU kernels carried their sums
// across a sequential grid axis; here a gather closes its column loop inside
// one warp with a fixed-order reduction and a scatter sums row slices in a
// second fixed-order pass, as K1 and K2 did before their redesign (pack2.cu
// now closes K2's slices in the same launch; the fused step runs K1's and
// K2's bodies as they are now). No float atomics:
// every output is bit-reproducible for a given shape. Each streams its
// panel once; what binds each on the H100 is in PERF.md.
//
// gather_width<Word>  replaces `mv8` / `mv32` (scripts/micro_load32.py:38-104).
//   out[r] = sum_j sum_m ((pk[r, j] >> 2m) & 3) * yw[m, j], m over the 4W
//   two-bit fields of a W-byte word: W = 1 is the packed gather with one byte
//   per thread per load, W = 4 the same bytes as little-endian 32-bit words
//   with y as (16, q/4). Everything but the load is K1's body (pack2_body.cuh):
//   a warp per group of four rows; panel words that do not allocate in L1,
//   lane l loading words l, l + 32, ... of each row (a warp's load is 32 W
//   contiguous bytes); a dosage one LOP3 and two FFMAs (`field`, summed 16
//   dosages at a time in `word_dot`'s order); y read as given through L1, so
//   no shared memory and no limit on q; K1's grid (as many blocks as are
//   resident), each row summed in an order of the shape alone. A lane loads
//   8 bytes of each of its four rows (8 loads at W = 1, 2 at W = 4) before
//   it uses the first, and walks a pointer per row and one for y. So the
//   cases differ in their loads: per 16 columns of a row group K1 makes
//   four 16-byte panel loads and 16 float4 y loads, W = 4 sixteen 4-byte
//   panel loads and 64 scalar y loads (from 16 rows of y), W = 1 64 of
//   each.
//   Bound, like K1, by the instructions it executes, not by the panel's bytes
//   (PERF.md).
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
//   jobs one tile grid; here blocks are split by role, spread evenly over
//   the grid, so both streams are in flight on every SM at once. The bodies
//   are K1's and K2's (pack2_body.cuh, the same code): gather blocks run K1's
//   warp per four rows over a share of the row groups, scatter blocks K2's
//   (tile, slice) blocks, and the last scatter block of each tile closes the
//   tile's slices through an integer ticket of the fused step's own. So r0
//   has K1's bits and dy K2's, and the split (a function of the shape,
//   ops/micro.py) moves no bit.
#include "pack2_body.cuh"

namespace {

namespace packed = ngt::packed;
using packed::word_of;
constexpr int kRowsPerWarp = 4;
constexpr int kGatherThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kScatterThreads = 128;

// out[i] = sum over slices, in slice order, of partial[s, i]: the second,
// fixed-order pass of dense_scatter (no float atomics).
__global__ void __launch_bounds__(kReduceThreads)
slice_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, long long slices,
                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (long long s = 0; s < slices; ++s) a += partial[s * n + i];
  out[i] = a;
}

// A panel word that does not allocate in L1, which keeps L1 for y: K1's
// ld_stream16 at one byte and at four.
__device__ __forceinline__ uint32_t ld_stream(const uint8_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ld_stream(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Dot of four bytes, each alone in a word (columns c0..c3), against y[k] =
// yw[k, c0..c3]: word_dot's order, every field read in place.
__device__ __forceinline__ float bytes_dot(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3,
                                           const float4 (&y)[4], uint32_t magic) {
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a = fmaf(packed::field(b0, 2 * k, magic), y[k].x, a);
    a = fmaf(packed::field(b1, 2 * k, magic), y[k].y, a);
    a = fmaf(packed::field(b2, 2 * k, magic), y[k].z, a);
    a = fmaf(packed::field(b3, 2 * k, magic), y[k].w, a);
  }
  return a;
}

// Panel words a lane keeps in flight of each of its four rows: 8 bytes a
// row at either width.
template <typename Word>
constexpr int kWordsInFlight = 8 / (int)sizeof(Word);

// One pass of a warp over its row group: lane words p[rr][32 u], u <
// kWordsInFlight, all loaded before any is used, then summed 16 dosages at a
// time (a 4-byte word, or four bytes) into acc against y at the same
// columns: row m of y at yj + m nword (the offsets are the same for every
// lane and stay in uniform registers, where 16 row pointers of y16 would not
// fit beside the panel words at three blocks an SM). kTail: only the columns
// with 32 u < left are in the panel; the others count as 0.
template <typename Word, bool kTail>
__device__ __forceinline__ void gather_pass(const Word* const (&p)[kRowsPerWarp],
                                            const float* yj, size_t nword,
                                            float (&acc)[kRowsPerWarp], int left, uint32_t magic) {
  constexpr int W = sizeof(Word), kWords = kWordsInFlight<Word>;
  uint32_t w[kRowsPerWarp][kWords];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
#pragma unroll
    for (int u = 0; u < kWords; ++u) w[rr][u] = (!kTail || 32 * u < left) ? ld_stream(p[rr] + 32 * u) : 0u;
  }
#pragma unroll
  for (int g = 0; g < kWords * W / 4; ++g) {
    float4 y[4];  // y[k]: the factors of field k of the unit's bytes 0..3
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = 32 * (W == 4 ? g : 4 * g + b);
        v[b] = (!kTail || c < left) ? __ldg(yj + (W == 4 ? 4 * b + k : k) * nword + c) : 0.f;
      }
      y[k] = make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      if constexpr (W == 4)
        acc[rr] += packed::word_dot(w[rr][g], y, magic);
      else
        acc[rr] += bytes_dot(w[rr][4 * g], w[rr][4 * g + 1], w[rr][4 * g + 2], w[rr][4 * g + 3], y,
                             magic);
    }
  }
}

template <typename Word>
__global__ void __launch_bounds__(packed::kGatherThreads, 3)
gather_width_kernel(const Word* __restrict__ pk, const float* __restrict__ yw,
                    float* __restrict__ out, long long rows, int nword, uint32_t magic) {
  constexpr int kSpan = 32 * kWordsInFlight<Word>;  // a warp's words of a row in one pass
  const int lane = threadIdx.x & 31;
  const int whole = nword - nword % kSpan;  // words of whole passes
  const long long wpb = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * wpb * kRowsPerWarp;
  for (long long r0 = ((long long)blockIdx.x * wpb + (threadIdx.x >> 5)) * kRowsPerWarp;
       r0 < rows; r0 += stride) {  // warp-uniform loop
    // pointers walked pass by pass; a row past the end reads the last row,
    // and its sum is not stored
    const Word* p[kRowsPerWarp];
    const float* yj = yw + lane;
    float acc[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      p[rr] = pk + min(r0 + rr, rows - 1) * nword + lane;
      acc[rr] = 0.f;
    }
    for (int j = 0; j < whole; j += kSpan) {  // warp-uniform: whole is a multiple of kSpan
      gather_pass<Word, false>(p, yj, nword, acc, 0, magic);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) p[rr] += kSpan;
      yj += kSpan;
    }
    if (whole < nword) gather_pass<Word, true>(p, yj, nword, acc, nword - whole - lane, magic);
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
  static int resident[packed::kMaxDevices];
  const int err = packed::gather_grid(gather_width_kernel<Word>, resident, rows, blocks);
  if (err != 0) return err;
  gather_width_kernel<Word><<<(unsigned)blocks, packed::kGatherThreads, 0, st>>>(
      (const Word*)pk, (const float*)yw, (float*)out, rows, (int)nword, packed::kMagic);
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
          acc[rr] = __dp4a(word_of(ch[rr], w), 0x01010101u, acc[rr]);
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
          const uint32_t word = word_of(ch[rr], w);
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

// Of the grid's blocks, `gather` run K1's body and the rest K2's, spread
// evenly: block b gathers when floor((b + 1) G / blocks) > floor(b G / blocks),
// as gather block floor(b G / blocks); else it is scatter block
// b - floor(b G / blocks), tile-fastest as in K2's grid (tiles, slices).
__global__ void __launch_bounds__(packed::kRankThreads, 2)
fused_step_kernel(const uint8_t* __restrict__ pk_s, const uint8_t* __restrict__ pk_g,
                  const float* __restrict__ u, const float* __restrict__ y4,
                  float* __restrict__ r0, float* __restrict__ partial, float* __restrict__ dy,
                  int* __restrict__ tickets, long long rows, int q, long long rows_per_slice,
                  int tiles, int slices, long long gather, uint32_t magic) {
  static_assert(packed::kGatherThreads == packed::kRankThreads, "one block size for both roles");
  __shared__ packed::RankShared sh;
  const long long blocks = gridDim.x, b = blockIdx.x;
  const long long g = b * gather / blocks;
  if ((b + 1) * gather / blocks > g) {
    const long long wpb = packed::kGatherThreads / 32;
    packed::gather_groups(pk_g, y4, r0, rows, q, magic,
                          (g * wpb + (threadIdx.x >> 5)) * packed::kGatherRows,
                          gather * wpb * packed::kGatherRows);
    return;
  }
  const long long s = b - g;
  packed::rank_block(pk_s, u, partial, dy, tickets, rows, q, rows_per_slice, magic,
                     (int)(s % tiles), s / tiles, slices, sh);
}

}  // namespace

extern "C" {

// pk: (rows, nword) words of `width` bytes (1: uint8, 4: int32), yw:
// (4 width, nword) f32, out: (rows,) f32; rows > 0. blocks: the
// grid, or 0 for as many blocks as are resident at once (K1's rule).
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
  slice_reduce_kernel<<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
                        (cudaStream_t)stream>>>((const float*)partial, (float*)out, slices, n);
  return (int)cudaGetLastError();
}

// pk_s, pk_g: the (rows, q) uint8 steps to scatter and to gather; u: (rows,)
// f32; y4: (4, q) f32; r0: (rows,) f32; dy: (4, q) f32; q a multiple of 16,
// everything 16-byte aligned, rows > 0. slices: K2's row slices of the step
// (ceil(rows / 512)); with slices > 1, partial: (slices, 4, q) f32 scratch
// and tickets: ceil(q / 512) int32 that are 0 (each launch leaves them 0),
// else both may be null. gather: the blocks that gather, >= 1.
int ngt_fused_step(const void* pk_s, const void* pk_g, const void* u, const void* y4, void* r0,
                   void* partial, void* dy, void* tickets, long long rows, long long q,
                   long long slices, long long gather, void* stream) {
  const long long tiles = (q + packed::kRankTile - 1) / packed::kRankTile;
  if (slices < 1 || gather < 1 || tiles * slices + gather >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  fused_step_kernel<<<(unsigned)(tiles * slices + gather), packed::kRankThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)pk_s, (const uint8_t*)pk_g, (const float*)u, (const float*)y4, (float*)r0,
      (float*)partial, (float*)dy, (int*)tickets, rows, (int)q, (rows + slices - 1) / slices,
      (int)tiles, (int)slices, gather, packed::kMagic);
  return (int)cudaGetLastError();
}

}  // extern "C"
