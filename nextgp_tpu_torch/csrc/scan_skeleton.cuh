// The skeleton of the port's V-batched in-block scans for Hopper (sm_90a),
// shared by every scan: K3 (r_scan.cu), K6, K8 and K10 (gauss_bc_scan.cu),
// K12 and K14 (rc_scan.cu).
//
// V independent chains of B sequential loci. Locus j of chain v needs
//   pre_g = s_g + sum_{i<j} G_g[j, v, i] * u_v[i]
// for each of the scan's Gram blocks G_g (one; two for the weighted B/C scan,
// the weighted and the raw Gram, with their own offsets s_g), then a rule
// turns the pre's and the locus's coefficient row into u_v[j] and the
// locus's outputs. The Grams are locus-major (B, V, B): row j of chain v
// starts at (j * V + v) * B. The step-indexed Gram ((T, B, V, B), t) is a
// pointer offset made by the caller.
//
// Bound: latency. Each locus depends on the one before; the bytes are the
// Grams' lower triangles and one coefficient row per locus, read once. What a
// chain costs is B times the dependent chain of one locus, so the skeleton
// keeps that chain short: nothing block-wide and nothing serial on it.
//
// Design: one thread block per chain, one thread per locus, one warp per
// group of 32 consecutive loci.
//  * Right-looking sums, no reduction. Thread i keeps
//    acc_i = s_i + sum_{k<j} G[i, v, k] * u_v[k] in a register (one per
//    Gram), in ascending k, so when locus j's turn comes its pre is ready in
//    thread j: one shuffle, where a block-wide dot would take a shuffle tree,
//    a barrier and a serial sum of the warps' partials for every locus. The
//    Gram elements are the ones the plain version reads (row i, columns below
//    i); the sum's order differs.
//  * A warp runs its 32 loci alone, without a block barrier. Inside the group
//    lane i adds G[i, v, j] * u_v[j] as soon as u_v[j] is known, from the
//    group's 32 x 32 diagonal tile of each Gram in shared memory (padded to 33
//    columns: the column reads hit 32 banks). After the group one
//    __syncthreads publishes its 32 u's, and every later thread adds its 32
//    products per Gram, from 32 consecutive words of its own Gram row that it
//    loaded while it waited (eight 16-byte loads where B is a multiple of 4).
//    So a block of 256 loci passes 8 barriers, not 512.
//  * The warp that runs the next group copies that group's diagonal tiles, and
//    whatever of its coefficients the rule stages, into one of two rotating
//    shared-memory slots with cp.async while the group before it runs; the
//    barrier after a group frees the slot the group before it used. No tile
//    is held for the whole block (two Grams' tiles for 32 warps would not fit).
//  * Inside a group the tile reads walk pointers set at the group's start
//    (K12/K14's rule walks its staged coefficients the same way). Indexed
//    from the shared array's base, K12's loop rebuilt that base at each locus
//    from the CTA-id special register (`S2R SR_CgaCtaId`), whose latency then
//    sat in front of the coefficient loads on every locus's chain.
//  * Outputs per locus stay in the registers of the thread that owns it and
//    are written once, at the end. Every sum has a fixed order and nothing is
//    atomic: two runs give the same bits.
//
// A rule is a class with
//   kGrams                      1 or 2
//   Params                      the kernel's own arguments
//   Rule(prm, smem, v, B, i)    per thread: its own locus's head, if any
//   start(g)                    the thread's s_g (slot 0, or 7 for the raw Gram)
//   stage(slot, j0, lane)       by the lanes of the warp that will run the
//                               group j0 .. j0 + 31: cp.async copies only
//   begin_group(slot, j0, nj, lane)  by the warp that runs the group: points
//                               the rule's reads at the slot's first locus
//   locus(j0, jj, pre, gjj, lane) -> u_v[j0 + jj] in every lane; the lane jj
//                               keeps the locus's outputs, and the rule
//                               steps its reads on to the next locus
//   u()                         the thread's own u
//   finish(i)                   writes the thread's outputs (i < B)
// and its shared memory follows the skeleton's (skeleton_words). A rule may
// name its element type `Real` (K3 has a float and a double instance); the
// Grams, the sums, the u's and the tiles are then in that type, else in
// float. Double tiles keep the 33-element rows: a warp's 8-byte shared loads
// are served a half-warp at a time, whose 16 lanes at a stride of 33 doubles
// fall on 16 distinct bank pairs.
#pragma once

#include <cuda_pipeline.h>

#include <type_traits>

#include "common.cuh"

namespace ngt {
namespace scan {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32 * 33;  // a 32 x 32 Gram tile, rows padded to 33 elements

// A rule's element type: its `Real`, or float.
template <class Rule, class = void>
struct RealOf {
  using type = float;
};
template <class Rule>
struct RealOf<Rule, std::void_t<typename Rule::Real>> {
  using type = typename Rule::Real;
};

// The skeleton's shared memory in elements: the chain's u's (one per thread)
// and two rotating slots of `grams` diagonal tiles. The rule's elements follow.
inline size_t skeleton_words(int threads, int grams) {
  return (size_t)threads + 2 * (size_t)grams * kTile;
}

// Copy `words` consecutive elements (a multiple of 16 bytes) from device
// memory into shared memory with cp.async, 16 bytes a copy where both are
// 16-byte aligned (wide). The caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_words(T* dst, const T* src, int words, bool wide, int lane) {
  constexpr int per = 16 / (int)sizeof(T);  // elements a 16-byte copy
  if (wide) {
    for (int idx = per * lane; idx < words; idx += 32 * per)
      __pipeline_memcpy_async(dst + idx, src + idx, 16);
  } else {
    for (int idx = lane; idx < words; idx += 32)
      __pipeline_memcpy_async(dst + idx, src + idx, sizeof(T));
  }
}

// The diagonal tiles of the group j0 .. j0 + 31: tile_g[r * 33 + c] =
// G_g[j0 + r, v, j0 + c], 0 past B. Lane c copies column c, so each row is
// one coalesced read.
template <int G, typename T>
__device__ __forceinline__ void stage_tiles(T* tiles, const T* const (&gv)[G], size_t jstride,
                                            int j0, int B, int lane) {
  const int col = j0 + lane;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      T* d = tiles + g * kTile + r * 33 + lane;
      if (j0 + r < B && col < B) {
        __pipeline_memcpy_async(d, gv[g] + (size_t)(j0 + r) * jstride + col, sizeof(T));
      } else {
        *d = T(0);
      }
    }
  }
}

// A thread's 32 Gram words of a group, from a 16-byte aligned row: eight
// 16-byte loads in float, sixteen in double.
__device__ __forceinline__ void load_row(float (&gp)[32], const float* row) {
  const float4* src = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 q = __ldg(src + c);
    gp[4 * c] = q.x;
    gp[4 * c + 1] = q.y;
    gp[4 * c + 2] = q.z;
    gp[4 * c + 3] = q.w;
  }
}

__device__ __forceinline__ void load_row(double (&gp)[32], const double* row) {
  const double2* src = reinterpret_cast<const double2*>(row);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const double2 q = __ldg(src + c);
    gp[2 * c] = q.x;
    gp[2 * c + 1] = q.y;
  }
}

// The loci j0 .. j0 + nj - 1 on the calling warp; acc holds each lane's
// right-looking sums.
template <class Rule, int G, typename T>
__device__ __forceinline__ void run_group(Rule& rule, const T* tiles, int slot, int j0, int nj,
                                          int lane, T (&acc)[G]) {
  rule.begin_group(slot, j0, nj, lane);
  const T* col = tiles + lane * 33;  // col[g * kTile] = G_g[j0 + lane, v, j0 + jj]
  const T* dg = tiles;               // *dg = G_0[j0 + jj, v, j0 + jj]
  for (int jj = 0; jj < nj; ++jj) {
    T gcol[G], pre[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      gcol[g] = col[g * kTile];
      pre[g] = __shfl_sync(kFull, acc[g], jj);
    }
    const T gjj = *dg;
    const T uj = rule.locus(j0, jj, pre, gjj, lane);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = mad(gcol[g], uj, acc[g]);
    ++col;
    dg += 34;
  }
}

// One thread per locus of the block. MAXT bounds the block: at 1024 threads a
// thread has 64 registers and part of the prefetched panel spills; blocks of
// up to 256 loci take the instance that leaves the compiler free.
template <class Rule, int MAXT, typename T = typename RealOf<Rule>::type>
__global__ void __launch_bounds__(MAXT, 1)
    scan_v_kernel(const T* __restrict__ g0, const T* __restrict__ g1,
                  const typename Rule::Params prm, int V, int B, size_t jstride) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* sm = reinterpret_cast<T*>(smem_bytes);
  constexpr int G = Rule::kGrams;
  const int v = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nwarps = blockDim.x >> 5;
  T* us = sm;                   // blockDim.x: the chain's u_v
  T* tiles = us + blockDim.x;   // two slots of G diagonal tiles
  T* rsm = tiles + 2 * G * kTile;  // the rule's
  const T* gv[G];
  gv[0] = g0 + (size_t)v * B;
  if constexpr (G == 2) gv[1] = g1 + (size_t)v * B;

  Rule rule(prm, rsm, v, B, i);
  T acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = rule.start(g);
  if (warp == 0) {
    stage_tiles<G>(tiles, gv, jstride, 0, B, lane);
    rule.stage(0, 0, lane);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  // rows are 16-byte aligned
  constexpr int per = 16 / (int)sizeof(T);  // elements a 16-byte load
  bool wide = B % per == 0 && jstride % per == 0;
#pragma unroll
  for (int g = 0; g < G; ++g) wide = wide && (reinterpret_cast<uintptr_t>(gv[g]) & 15) == 0;
  for (int w = 0; w < nwarps; ++w) {
    T gp[G][32];  // G_g[i, v, 32 w .. 32 w + 31], for the threads after group w
    if (warp == w) {
      const int j0 = 32 * w;
      run_group<Rule, G>(rule, tiles + (w & 1) * G * kTile, w & 1, j0, min(32, B - j0), lane, acc);
      us[i] = rule.u();
    } else if (warp == w + 1) {
      // the next group's tiles and coefficients go into the slot group w - 1 has left
      stage_tiles<G>(tiles + (warp & 1) * G * kTile, gv, jstride, 32 * warp, B, lane);
      rule.stage(warp & 1, 32 * warp, lane);
    }
    if (warp > w && i < B) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const T* row = gv[g] + (size_t)i * jstride + 32 * w;  // this thread's Gram row
        if (wide) {
          load_row(gp[g], row);
        } else {
#pragma unroll
          for (int c = 0; c < 32; ++c) gp[g][c] = __ldg(row + c);
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (warp > w && i < B) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < 32; ++c) acc[g] = mad(gp[g][c], us[32 * w + c], acc[g]);
      }
    }
  }
  if (i < B) rule.finish(i);
}

template <class Rule, int MAXT, typename T = typename RealOf<Rule>::type>
int launch_as(const T* g0, const T* g1, const typename Rule::Params& prm, int V, int B,
              size_t jstride, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_v_kernel<Rule, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  scan_v_kernel<Rule, MAXT><<<(unsigned)V, threads, smem, stream>>>(g0, g1, prm, V, B, jstride);
  return (int)cudaGetLastError();
}

// Launch V blocks of the scan with the rule's `rule_words` of shared memory
// after the skeleton's (the ops/gibbs_kernels.py *_smem_bytes functions state
// the same sums). The Grams are locus-major (B, V, B), rows V * B apart.
// 1 <= B <= 1024.
template <class Rule>
int launch(const void* g0, const void* g1, const typename Rule::Params& prm, long long V,
           long long B, size_t rule_words, void* stream) {
  using T = typename RealOf<Rule>::type;
  const int threads = (int)((B + 31) / 32) * 32;
  const size_t smem = sizeof(T) * (skeleton_words(threads, Rule::kGrams) + rule_words);
  const size_t jstride = (size_t)(V * B);
  return threads <= 256
             ? launch_as<Rule, 256>((const T*)g0, (const T*)g1, prm, (int)V, (int)B, jstride,
                                    threads, smem, (cudaStream_t)stream)
             : launch_as<Rule, 1024>((const T*)g0, (const T*)g1, prm, (int)V, (int)B, jstride,
                                     threads, smem, (cudaStream_t)stream);
}

// Maximum over the warp by one integer `redux`: floats map to integers of the
// same order (negative floats with their magnitude bits flipped).
__device__ __forceinline__ int ordered(int bits) { return bits >= 0 ? bits : bits ^ 0x7fffffff; }

__device__ __forceinline__ float warp_max(float x) {
  return __int_as_float(ordered(__reduce_max_sync(kFull, ordered(__float_as_int(x)))));
}

// `redux` has no 64-bit form: doubles take a butterfly of fmax. A maximum is
// exact in any order, so every lane holds the same value.
__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmax(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Inclusive sums over the lanes l, l - step, l - 2 * step, ... >= l - pos.
// step = 1 with pos = k sums within a run of K lanes; step = K with pos =
// lane sums one class over the annotations.
template <typename T>
__device__ __forceinline__ T scan_up(T x, int step, int end, int pos) {
  for (int off = step; off < end; off <<= 1) {
    const T t = __shfl_up_sync(kFull, x, off);
    if (pos >= off) x += t;
  }
  return x;
}

}  // namespace scan
}  // namespace ngt
