// The bodies of K1 (the packed gather) and K2 (the packed scatter), shared by
// their kernels in pack2.cu and by the measurement ladder's fused step in
// micro.cu, which runs both in one launch: one copy of the code, so the
// fused step's outputs have K1's and K2's bits. The design notes are in
// pack2.cu.
#pragma once

#include "common.cuh"

namespace ngt {
namespace packed {

constexpr int kGatherRows = 4;  // rows per warp
constexpr int kGatherThreads = 256;
constexpr int kRankWarps = 8;
constexpr int kRankThreads = 32 * kRankWarps;
constexpr int kRankTile = 512;  // packed bytes per column tile: 16 a lane
constexpr int kRankRowBatch = 2;  // rows a lane sums while it loads as many more

// The bits of 2^23. The kernels take them as an argument (kMagic, from the
// host): a LOP3 takes one immediate, so with both the field's mask and these
// bits known at compile time ptxas splits the AND and the OR into two LOP3s.
constexpr uint32_t kMagic = 0x4B000000u;

// Dosage of the 2-bit field at bit p (p <= 14) of h, exactly: OR the field,
// left in place, into the mantissa of 2^23 (2^23 + d 2^p: one LOP3), then
// (2^23 + d 2^p) 2^-p - 2^(23-p) = d in one FFMA (the product and the sum
// are exact). p is a constant wherever this is inlined; magic is kMagic.
__device__ __forceinline__ float field(uint32_t h, int p, uint32_t magic) {
  return fmaf(__uint_as_float((h & (3u << p)) | magic), __int_as_float((127 - p) << 23),
              -__int_as_float((150 - p) << 23));
}

// A 16-byte load that does not allocate in L1, which keeps L1 for y (K1).
__device__ __forceinline__ uint4 ld_stream16(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word_of(const uint4& c, int w) {
  return w == 0 ? c.x : w == 1 ? c.y : w == 2 ? c.z : c.w;
}

// Dot of one 4-byte word (columns col..col+3) against the y planes of those
// columns; y[k] holds y4[k, col..col+3]. Bytes 0 and 1 are read in place,
// bytes 2 and 3 after one shift.
__device__ __forceinline__ float word_dot(uint32_t w, const float4 (&y)[4], uint32_t magic) {
  const uint32_t hi = w >> 16;
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a = fmaf(field(w, 2 * k, magic), y[k].x, a);
    a = fmaf(field(w, 8 + 2 * k, magic), y[k].y, a);
    a = fmaf(field(hi, 2 * k, magic), y[k].z, a);
    a = fmaf(field(hi, 8 + 2 * k, magic), y[k].w, a);
  }
  return a;
}

constexpr int kMaxDevices = 64;

// K1's grid rule, for the gathers that share its block: as many blocks of
// kGatherThreads as `kernel` keeps resident on the current device at once
// (found at first use and kept in `resident`, a slot a device), at most one
// warp a row group of `rows`. A grid given by the caller (blocks > 0) stays.
// Returns 0 or the CUDA error.
template <typename Kernel>
inline int gather_grid(Kernel kernel, int (&resident)[kMaxDevices], long long rows,
                       long long& blocks) {
  if (blocks > 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGatherThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sms;
  }
  const long long wpb = kGatherThreads / 32;
  blocks = ((rows + kGatherRows - 1) / kGatherRows + wpb - 1) / wpb;
  if (blocks > resident[dev]) blocks = resident[dev];
  return 0;
}

// K1's body: the calling warp gathers the row groups starting at rows
// first, first + stride, ... (kGatherRows rows each): out[r] = sum_k sum_j
// plane_k(pk[r, j]) * y4[k, j], each row in the same order whatever the
// group's warp, so the bits do not depend on the grid.
__device__ __forceinline__ void gather_groups(const uint8_t* __restrict__ pk,
                                              const float* __restrict__ y4, float* __restrict__ out,
                                              long long rows, int q, uint32_t magic,
                                              long long first, long long stride) {
  const int nchunk = q >> 4;
  const int lane = threadIdx.x & 31;
  for (long long r0 = first; r0 < rows; r0 += stride) {  // warp-uniform loop
    float acc[kGatherRows];
#pragma unroll
    for (int rr = 0; rr < kGatherRows; ++rr) acc[rr] = 0.f;
    for (int c = lane; c < nchunk; c += 32) {
      uint4 ch[kGatherRows];
#pragma unroll
      for (int rr = 0; rr < kGatherRows; ++rr)
        ch[rr] = (r0 + rr < rows) ? ld_stream16(pk + (r0 + rr) * q + 16 * c)
                                  : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float4 y[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          y[k] = __ldg(reinterpret_cast<const float4*>(y4 + (size_t)k * q + 16 * c + 4 * w));
#pragma unroll
        for (int rr = 0; rr < kGatherRows; ++rr) acc[rr] += word_dot(word_of(ch[rr], w), y, magic);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kGatherRows; ++rr) {
      const float s = warp_sum(acc[rr]);
      if (lane == 0 && r0 + rr < rows) out[r0 + rr] = s;
    }
  }
}

// acc[k * 16 + b] += u * plane_k(byte b) for the 16 bytes of one lane's word.
__device__ __forceinline__ void scatter_word(const uint4& w, float u, float (&acc)[64],
                                             uint32_t magic) {
#pragma unroll
  for (int h = 0; h < 8; ++h) {  // half-word h holds bytes 2h and 2h + 1
    const uint32_t bits = (h & 1) ? (word_of(w, h >> 1) >> 16) : word_of(w, h >> 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[k * 16 + 2 * h] = fmaf(field(bits, 2 * k, magic), u, acc[k * 16 + 2 * h]);
      acc[k * 16 + 2 * h + 1] = fmaf(field(bits, 8 + 2 * k, magic), u, acc[k * 16 + 2 * h + 1]);
    }
  }
}

// K2's shared memory: the warp tree's stage ([warp][output][lane]: no bank
// conflicts) and whether this block closes its tile.
struct RankShared {
  float red[kRankWarps / 2][64][32];
  bool last;
};

// K2's body for one block of kRankThreads threads: column tile `tile` over
// row slice `slice` of `slices` (rows_per_slice rows each). With one slice
// the sums go to out; else to the slice's partial, and the last block of the
// tile to take its ticket adds the tile's partials in slice order into out
// and resets the ticket.
__device__ __forceinline__ void rank_block(const uint8_t* __restrict__ pk,
                                           const float* __restrict__ u,
                                           float* __restrict__ partial, float* __restrict__ out,
                                           int* __restrict__ tickets, long long rows, int q,
                                           long long rows_per_slice, uint32_t magic, int tile,
                                           long long slice, int slices, RankShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = tile * kRankTile + 16 * lane;  // q is a multiple of 16: col < q means col + 16 <= q
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  if (col < q) {
    // the warp's rows r_first, r_first + 8, ...: kRankRowBatch of them summed while the
    // next kRankRowBatch are loaded
    const long long r_end = min(rows, (slice + 1) * rows_per_slice);
    const long long r_first = slice * rows_per_slice + warp;
    const uint8_t* p = pk + col;
    uint4 nw[kRankRowBatch];
    float nu[kRankRowBatch];
#pragma unroll
    for (int b = 0; b < kRankRowBatch; ++b) {
      const long long rb = r_first + b * kRankWarps;
      nw[b] = rb < r_end ? ld_stream16(p + rb * q) : make_uint4(0u, 0u, 0u, 0u);
      nu[b] = rb < r_end ? __ldg(u + rb) : 0.f;
    }
    for (long long r = r_first; r < r_end; r += kRankRowBatch * kRankWarps) {  // warp-uniform
      uint4 w[kRankRowBatch];
      float ur[kRankRowBatch];
#pragma unroll
      for (int b = 0; b < kRankRowBatch; ++b) {
        w[b] = nw[b];
        ur[b] = nu[b];
        const long long rb = r + (kRankRowBatch + b) * kRankWarps;
        if (rb < r_end) {
          nw[b] = ld_stream16(p + rb * q);
          nu[b] = __ldg(u + rb);
        }
      }
#pragma unroll
      for (int b = 0; b < kRankRowBatch; ++b)  // each lane's rows in order
        if (r + b * kRankWarps < r_end) scatter_word(w[b], ur[b], acc, magic);
    }
  }
  // warps w and w + half add in shared memory, half = 4, 2, 1: a fixed tree
#pragma unroll
  for (int half = kRankWarps / 2; half >= 1; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int j = 0; j < 64; ++j) sh.red[warp - half][j][lane] = acc[j];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += sh.red[warp][j][lane];
    }
    __syncthreads();
  }
  float* dst = slices == 1 ? out : partial + (size_t)slice * 4 * q;
  if (warp == 0 && col < q) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float4* d = reinterpret_cast<float4*>(dst + (size_t)k * q + col);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        d[x] = make_float4(acc[k * 16 + 4 * x], acc[k * 16 + 4 * x + 1], acc[k * 16 + 4 * x + 2],
                           acc[k * 16 + 4 * x + 3]);
    }
  }
  if (slices == 1) return;
  if (warp == 0) __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) sh.last = atomicAdd(tickets + tile, 1) == slices - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  // the last block of the tile adds the slices in order: item t is plane
  // t / (kRankTile / 4), four columns from the tile's 4 (t % (kRankTile / 4))
  for (int t = threadIdx.x; t < kRankTile; t += kRankThreads) {
    const int k = t / (kRankTile / 4);
    const int c = tile * kRankTile + 4 * (t % (kRankTile / 4));
    if (c < q) {
      const float* src = partial + (size_t)k * q + c;
      const size_t step = 4 * (size_t)q;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int sl = 0; sl < slices; ++sl) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + sl * step));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      *reinterpret_cast<float4*>(out + (size_t)k * q + c) = s;
    }
  }
  if (threadIdx.x == 0) tickets[tile] = 0;  // ready for the next launch
}

}  // namespace packed
}  // namespace ngt
