// The bodies of K1 (the packed gather) and K2 (the packed scatter), shared by
// their kernels in pack2.cu and by the measurement ladder's fused step in
// micro.cu, which runs both in one launch: one copy of the code, so the
// fused step's outputs have K1's and K2's bits. The design notes are in
// pack2.cu. Each body is a template on the element type T of the vectors
// (float or double); the panel is 2-bit either way.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ngt {
namespace packed {

constexpr int kGatherRows = 4;  // rows per warp
constexpr int kGatherThreads = 256;
constexpr int kRankWarps = 8;
constexpr int kRankThreads = 32 * kRankWarps;
constexpr int kRankTile = 512;  // float: packed bytes per column tile, 16 a lane
constexpr int kRankRowBatch = 2;  // rows a lane sums while it loads as many more

// The bits of 2^23. The kernels take them as an argument (kMagic, from the
// host): a LOP3 takes one immediate, so with both the field's mask and these
// bits known at compile time ptxas splits the AND and the OR into two LOP3s.
constexpr uint32_t kMagic = 0x4B000000u;
// The high word of 2^52, the float64 kernels' magic: the field goes into
// the low word alone, so a dosage is one LOP3 (the AND) and one DFMA.
constexpr uint32_t kMagic64 = 0x43300000u;

// Dosage of the 2-bit field at bit p (p <= 14) of h, exactly: OR the field,
// left in place, into the mantissa of 2^23 (2^23 + d 2^p: one LOP3), then
// (2^23 + d 2^p) 2^-p - 2^(23-p) = d in one FFMA (the product and the sum
// are exact). p is a constant wherever this is inlined; magic is kMagic.
__device__ __forceinline__ float field(uint32_t h, int p, uint32_t magic) {
  return fmaf(__uint_as_float((h & (3u << p)) | magic), __int_as_float((127 - p) << 23),
              -__int_as_float((150 - p) << 23));
}

// The same in float64: the field, left in place, is the low word of 2^52 +
// d 2^p (magic = kMagic64 the high word), and one DFMA by 2^-p less
// 2^(52-p) gives d exactly. The dosage is exact before it meets y or u.
__device__ __forceinline__ double field64(uint32_t h, int p, uint32_t magic) {
  return fma(__hiloint2double((int)magic, (int)(h & (3u << p))),
             __longlong_as_double((long long)(1023 - p) << 52),
             -__longlong_as_double((long long)(1075 - p) << 52));
}

template <typename T>
__device__ __forceinline__ T dosage(uint32_t h, int p, uint32_t magic);
template <>
__device__ __forceinline__ float dosage<float>(uint32_t h, int p, uint32_t magic) {
  return field(h, p, magic);
}
template <>
__device__ __forceinline__ double dosage<double>(uint32_t h, int p, uint32_t magic) {
  return field64(h, p, magic);
}

// Four consecutive elements: float4, or two 16-byte halves of doubles.
struct Double4 {
  double x, y, z, w;
};
template <typename T>
struct QuadOf;
template <>
struct QuadOf<float> {
  using type = float4;
};
template <>
struct QuadOf<double> {
  using type = Double4;
};
template <typename T>
using Quad = typename QuadOf<T>::type;

// Loads through L1 (y), loads that skip L1 (the slices' partials) and
// stores of four elements at a 16-byte aligned address.
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ Double4 ldg4(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {a.x, a.y, b.x, b.y};
}
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ Double4 ldcg4(const double* p) {
  const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  return {a.x, a.y, b.x, b.y};
}
__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(double* p, const Double4& v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v.x, v.y);
  reinterpret_cast<double2*>(p)[1] = make_double2(v.z, v.w);
}

// A 16-byte load that does not allocate in L1, which keeps L1 for y (K1).
__device__ __forceinline__ uint4 ld_stream16(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// An 8-byte one, K2's lane word in float64.
__device__ __forceinline__ uint2 ld_stream8(const uint8_t* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ld_lane(const uint8_t* p, uint4) { return ld_stream16(p); }
__device__ __forceinline__ uint2 ld_lane(const uint8_t* p, uint2) { return ld_stream8(p); }

__device__ __forceinline__ uint32_t word_of(const uint4& c, int w) {
  return w == 0 ? c.x : w == 1 ? c.y : w == 2 ? c.z : c.w;
}

__device__ __forceinline__ uint32_t word_of(const uint2& c, int w) { return w == 0 ? c.x : c.y; }

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
// group's warp, so the bits do not depend on the grid. T: y4's and out's
// type, in which every product and sum is taken.
template <typename T>
__device__ __forceinline__ void gather_groups(const uint8_t* __restrict__ pk,
                                              const T* __restrict__ y4, T* __restrict__ out,
                                              long long rows, int q, uint32_t magic,
                                              long long first, long long stride) {
  const int nchunk = q >> 4;
  const int lane = threadIdx.x & 31;
  for (long long r0 = first; r0 < rows; r0 += stride) {  // warp-uniform loop
    T acc[kGatherRows];
#pragma unroll
    for (int rr = 0; rr < kGatherRows; ++rr) acc[rr] = T(0);
    for (int c = lane; c < nchunk; c += 32) {
      uint4 ch[kGatherRows];
#pragma unroll
      for (int rr = 0; rr < kGatherRows; ++rr)
        ch[rr] = (r0 + rr < rows) ? ld_stream16(pk + (r0 + rr) * q + 16 * c)
                                  : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          Quad<T> y[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) y[k] = ldg4(y4 + (size_t)k * q + 16 * c + 4 * w);
#pragma unroll
          for (int rr = 0; rr < kGatherRows; ++rr) acc[rr] += word_dot(word_of(ch[rr], w), y, magic);
        }
      } else {
        // word_dot's sums, one plane's quad of y at a time for every row, and
        // the chunk's words one at a time (not unrolled): unrolled, ptxas
        // loads the chunk's 16 quads of y ahead, 128 registers in double,
        // and spills beside the rows' words at two blocks an SM
#pragma unroll 1
        for (int w = 0; w < 4; ++w) {
          T a[kGatherRows];
#pragma unroll
          for (int rr = 0; rr < kGatherRows; ++rr) a[rr] = T(0);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const Quad<T> y = ldg4(y4 + (size_t)k * q + 16 * c + 4 * w);
#pragma unroll
            for (int rr = 0; rr < kGatherRows; ++rr) {
              const uint32_t lo = word_of(ch[rr], w), hi = lo >> 16;
              a[rr] = mad(dosage<T>(lo, 2 * k, magic), y.x, a[rr]);
              a[rr] = mad(dosage<T>(lo, 8 + 2 * k, magic), y.y, a[rr]);
              a[rr] = mad(dosage<T>(hi, 2 * k, magic), y.z, a[rr]);
              a[rr] = mad(dosage<T>(hi, 8 + 2 * k, magic), y.w, a[rr]);
            }
          }
#pragma unroll
          for (int rr = 0; rr < kGatherRows; ++rr) acc[rr] += a[rr];
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kGatherRows; ++rr) {
      const T s = warp_sum(acc[rr]);
      if (lane == 0 && r0 + rr < rows) out[r0 + rr] = s;
    }
  }
}

// The bytes of its column tile a lane of K2 owns, and the word it loads
// them in: 16 (uint4) in float, whose 64 sums fill a lane's registers at two
// blocks an SM; 8 (uint2) in float64, whose 32 sums take as many registers.
template <typename T>
struct RankLane;
// kTile: K2's column tile in packed bytes, kRankTile in float, 256 in float64.
template <>
struct RankLane<float> {
  static constexpr int kBytes = 16;
  static constexpr int kTile = 32 * kBytes;
  using Word = uint4;
};
template <>
struct RankLane<double> {
  static constexpr int kBytes = 8;
  static constexpr int kTile = 32 * kBytes;
  using Word = uint2;
};

// acc[k * LB + b] += u * plane_k(byte b) for the LB bytes of one lane's word.
template <typename T, typename W, int NO>
__device__ __forceinline__ void scatter_word(const W& w, T u, T (&acc)[NO], uint32_t magic) {
  constexpr int LB = NO / 4;
#pragma unroll
  for (int h = 0; h < LB / 2; ++h) {  // half-word h holds bytes 2h and 2h + 1
    const uint32_t bits = (h & 1) ? (word_of(w, h >> 1) >> 16) : word_of(w, h >> 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[k * LB + 2 * h] = mad(dosage<T>(bits, 2 * k, magic), u, acc[k * LB + 2 * h]);
      acc[k * LB + 2 * h + 1] = mad(dosage<T>(bits, 8 + 2 * k, magic), u, acc[k * LB + 2 * h + 1]);
    }
  }
}

// K2's shared memory: the warp tree's stage ([warp][output][lane]: no bank
// conflicts; 32 KB in float, as in float64) and whether this block closes
// its tile.
template <typename T>
struct RankSharedOf {
  T red[kRankWarps / 2][4 * RankLane<T>::kBytes][32];
  bool last;
};
using RankShared = RankSharedOf<float>;

// K2's body for one block of kRankThreads threads: column tile `tile` over
// row slice `slice` of `slices` (rows_per_slice rows each). With one slice
// the sums go to out; else to the slice's partial, and the last block of the
// tile to take its ticket adds the tile's partials in slice order into out
// and resets the ticket. T: u's, partial's and out's type.
template <typename T>
__device__ __forceinline__ void rank_block(const uint8_t* __restrict__ pk, const T* __restrict__ u,
                                           T* __restrict__ partial, T* __restrict__ out,
                                           int* __restrict__ tickets, long long rows, int q,
                                           long long rows_per_slice, uint32_t magic, int tile,
                                           long long slice, int slices, RankSharedOf<T>& sh) {
  using Word = typename RankLane<T>::Word;
  constexpr int LB = RankLane<T>::kBytes;  // bytes a lane, LB outputs a plane
  constexpr int NO = 4 * LB;
  constexpr int TILE = RankLane<T>::kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = tile * TILE + LB * lane;  // q is a multiple of 16: col < q means col + LB <= q
  T acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = T(0);
  if (col < q) {
    // the warp's rows r_first, r_first + 8, ...: kRankRowBatch of them summed while the
    // next kRankRowBatch are loaded
    const long long r_end = min(rows, (slice + 1) * rows_per_slice);
    const long long r_first = slice * rows_per_slice + warp;
    const uint8_t* p = pk + col;
    Word nw[kRankRowBatch];
    T nu[kRankRowBatch];
#pragma unroll
    for (int b = 0; b < kRankRowBatch; ++b) {
      const long long rb = r_first + b * kRankWarps;
      nw[b] = rb < r_end ? ld_lane(p + rb * q, Word{}) : Word{};
      nu[b] = rb < r_end ? __ldg(u + rb) : T(0);
    }
    for (long long r = r_first; r < r_end; r += kRankRowBatch * kRankWarps) {  // warp-uniform
      Word w[kRankRowBatch];
      T ur[kRankRowBatch];
#pragma unroll
      for (int b = 0; b < kRankRowBatch; ++b) {
        w[b] = nw[b];
        ur[b] = nu[b];
        const long long rb = r + (kRankRowBatch + b) * kRankWarps;
        if (rb < r_end) {
          nw[b] = ld_lane(p + rb * q, Word{});
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
      for (int j = 0; j < NO; ++j) sh.red[warp - half][j][lane] = acc[j];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] += sh.red[warp][j][lane];
    }
    __syncthreads();
  }
  T* dst = slices == 1 ? out : partial + (size_t)slice * 4 * q;
  if (warp == 0 && col < q) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int x = 0; x < LB / 4; ++x)
        st4(dst + (size_t)k * q + col + 4 * x,
            Quad<T>{acc[k * LB + 4 * x], acc[k * LB + 4 * x + 1], acc[k * LB + 4 * x + 2],
                    acc[k * LB + 4 * x + 3]});
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
  // t / (TILE / 4), four columns from the tile's 4 (t % (TILE / 4))
  for (int t = threadIdx.x; t < TILE; t += kRankThreads) {
    const int k = t / (TILE / 4);
    const int c = tile * TILE + 4 * (t % (TILE / 4));
    if (c < q) {
      const T* src = partial + (size_t)k * q + c;
      const size_t step = 4 * (size_t)q;
      Quad<T> s{T(0), T(0), T(0), T(0)};
#pragma unroll 8
      for (int sl = 0; sl < slices; ++sl) {
        const Quad<T> v = ldcg4(src + sl * step);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      st4(out + (size_t)k * q + c, s);
    }
  }
  if (threadIdx.x == 0) tickets[tile] = 0;  // ready for the next launch
}

}  // namespace packed
}  // namespace ngt
