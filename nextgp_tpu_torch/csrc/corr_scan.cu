// The in-block scan of correlated marker sets for Hopper (sm_90a): CM1, and
// the per-locus rule it reads.
//
// Replaces no Pallas kernel. CM1 is the counterpart of the `lax.scan` over a
// block's loci in `sample_corr_marker_set` (nextgp_tpu/engine/samplers/
// markers.py:893-916; NextGP.jl functions.jl:140-154): V independent chains
// of B sequential loci, each locus carrying nT effects (one per set),
//   pre_j  = adj_j + sum_{b<j} G[j, b] u_b      (adj_j = r0_j + G[j, j] bold_j)
//   bnew_j = M_j pre_j + c_j,   u_j = bold_j - bnew_j
// with G[j, b] the (nT, nT) block of the centered cross-Gram. M_j, c_j
// (0 on a padded locus) and the restore G[j, j] bold_j come packed per locus,
// [adj (nT) | bold (nT) | c (nT) | M (nT^2)], from the rule launch below
// (ops/corr_scan.corr_rule; its plain version corr_block_pack). The Gram of a
// step is (B, nT, V, B, nT): the row (j, t) of chain v is the B nT floats
// G[j, t; k, w] at ((j nT + t) V + v) B nT, (k, w) interleaved.
//
// Bound: latency. The bytes are the Grams' lower triangles (V B (B + 1) / 2
// nT^2 floats, 50.3 MB a step at V = 96, B = 256, nT = 2: 0.0150 ms at
// 3.35 TB/s) and one row a locus, read once; each locus depends on the one
// before, so B times a locus's dependent chain is the time.
//
// Design: one block per chain, one thread per locus keeping its nT
// right-looking sums in registers, one warp per group of 32 loci (the scans'
// skeleton, scan_skeleton.cuh, with nT channels), and no block barrier after
// the start:
//  * the block-step's prologue is folded in: a thread starts its sums from
//    its row's adj plus r0 - centre x sum(y) (K1's output, the step's
//    centres and a 0-d sum, in the plain version's rounding), reads the rows
//    in place from the sweep's (V, T, B, W) pack and writes beta into the
//    sweep's (V, T, B, nT) buffer;
//  * four loci a chain step: the quad's nT sums a locus are shuffled at
//    once, and every lane resolves the quad's loci one after another from
//    their staged rows, bnew_q = M_q pre_q + c_q + sum_{b<q} K[q, b] u_b,
//    with the couplings K[q, b] = M_q G[q, b] formed by the group's warp
//    before its turn (couple); then lane i adds G[i, q] u_q (nT^2 FMAs a
//    locus) from the group's rows staged in shared memory, read along row
//    (q, s) by symmetry so that the lanes read neighbouring words;
//  * look-ahead: the staged rows of group g hold the next group's columns
//    too, and the warp running group g adds G[next_i, q] u_q into nT more
//    sums a lane beside its chain. When the group ends it writes its u's and
//    those sums to shared memory and arrives at a named barrier (ids 1 and 2
//    alternate) on which the next group's warp, its rows and couplings
//    ready, waits; that warp adds its lane's sums and starts. No block
//    barrier ends a group: one there, with the next warp's serial product of
//    32 nT FMAs a channel behind it, took most of a step at V = 1. A counter
//    in shared memory also counts the groups published, for the far products;
//  * every other later warp adds each published group's 32 nT products per
//    channel into its rows' sums (the far products), as four partial sums in
//    a fixed order, waiting on the counter with a short sleep. For nT <= 2
//    (blocks of at most 256 loci) a round's block, the warp's rows at the
//    group's columns, is copied with cp.async into the warp's buffer whole
//    rows at a time, neighbouring lanes on neighbouring words, one round
//    ahead, and each lane reads its rows there; above, each thread loads its
//    rows from the Gram (each such load touches 32 cache lines);
//  * group 0's rows are staged by the whole block at the start; every other
//    group's warp stages its own rows (its group's columns and the next
//    group's, and its packed rows) with cp.async into one of kSlots rotating
//    slots as soon as the group kSlots before it has left the slot: two
//    groups ahead for nT <= 2 (three slots), one for nT = 3, none for nT = 4
//    (one slot of 128 KB: the copy waits for the hand-off there).
// The bytes are the lower triangle's: the next group's block of a staged row
// is the block of the next group's rows that no thread then reads.
// Fast forms for nT = 1 .. 4 (ops/corr_scan.FAST_NT). Above that, the
// generic form: one thread a locus's nT x nT work, its sums in device
// memory, a block barrier per locus. Every sum has a fixed order and nothing
// is atomic: two runs give the same bits. One launch per block-step.
//
// The rule launch (nT <= 4): one thread a locus builds its packed row in
// registers from beta, z, mpm, the mask, its region's covariance and varE,
// as RE2's level_rule does (level_scan.cu): the region's inverse and
// cov = sym(inv(mpm / varE + inv(var_beta[region]))) by Gauss-Jordan
// without pivots, chol(cov), NaN for a locus that is not positive definite
// (no host check: a captured sweep cannot sync). One launch a sweep.
#include <type_traits>

#include "scan_skeleton.cuh"

namespace {

constexpr int kGenericThreads = 256;
constexpr int kRuleThreads = 128;
using ngt::scan::kFull;

template <int NT>
struct Shape {
  static constexpr int W = 3 * NT + NT * NT;       // a locus's packed row
  static constexpr int TW = 64 * NT;               // a staged row: its group's columns and the next's
  static constexpr int kTileWords = 32 * NT * TW;  // a group's (32 nT) staged rows
  static constexpr int W4 = (W + 3) / 4 * 4;       // a staged packed row, whole 16-byte words
  static constexpr int kPairs = 6;                 // (b, q) of one quad of loci, b < q
  static constexpr int kQuadWords = (kPairs * NT * NT + 3) / 4 * 4;  // one quad's couplings
  static constexpr int kSlot = kTileWords + 32 * W4 + 8 * kQuadWords;
  static constexpr int kSlots = NT <= 2 ? 3 : (NT == 3 ? 2 : 1);
};

// the far products staged in shared memory (nT <= 2, blocks of at most 256
// loci): one buffer of a group's rows (32 nT, padded to FS words) at one
// group's columns for each warp from the third on
template <int NT>
struct Far {
  static constexpr int FS = 32 * NT + 4;    // a staged row: 16-byte aligned, 4 words of padding
  static constexpr int kWords = 32 * NT * FS;
  __host__ __device__ static constexpr int buffers(int threads) { return NT <= 2 && threads <= 256 && threads > 64 ? threads / 32 - 2 : 0; }
};

template <int NT>
__host__ __device__ constexpr size_t smem_words(int threads) {
  // the slots, the far buffers, the u's (one per thread and channel), the look-ahead sums, the counter
  return (size_t)Shape<NT>::kSlots * Shape<NT>::kSlot + (size_t)Far<NT>::buffers(threads) * Far<NT>::kWords +
         (size_t)threads * NT + 32 * NT + 4;
}

// N floats from shared memory at p (16-byte aligned), in 16-byte loads
template <int N>
__device__ __forceinline__ void load4(const float* p, float (&out)[N]) {
  static_assert(N % 4 == 0, "whole 16-byte words");
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 v = reinterpret_cast<const float4*>(p)[c];
    out[4 * c] = v.x, out[4 * c + 1] = v.y, out[4 * c + 2] = v.z, out[4 * c + 3] = v.w;
  }
}

// N consecutive floats at p (aligned to N floats where N is 2 or 4), in one load where it can
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) out[c] = p[c];
  }
}

// wait until the chain has published n groups: a far wait, off the chain's path
__device__ __forceinline__ void wait_published(const int* pub, int n) {
  while (*reinterpret_cast<const volatile int*>(pub) < n) __nanosleep(64);
  __threadfence_block();
}

// the hand-off between the warps of two consecutive groups: named barrier id
// (1 or 2, alternating, as barrier 0 is __syncthreads) for n threads
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

template <int NT, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
    corr_scan_kernel(const float* __restrict__ gram, const float* __restrict__ pk, long long pk_stride,
                     const float* __restrict__ r0, const float* __restrict__ cb,
                     const float* __restrict__ sum_y, float* __restrict__ beta, long long beta_stride,
                     float* __restrict__ uout, int V, int B) {
  using S = Shape<NT>;
  constexpr int W = S::W, TW = S::TW;
  constexpr bool kFarSmem = NT <= 2 && MAXT <= 256;
  using F = Far<NT>;
  extern __shared__ __align__(16) float sm[];
  const int v = blockIdx.x, i = threadIdx.x, lane = i & 31, g = i >> 5;
  float* slots = sm;
  float* fbuf = sm + S::kSlots * S::kSlot + (size_t)max(g - 2, 0) * F::kWords;  // warp g's far buffer
  // us[k NT + w]: locus k's u, the Gram rows' column order
  float* us = sm + S::kSlots * S::kSlot + (size_t)F::buffers(blockDim.x) * F::kWords;
  float* lk = us + blockDim.x * NT;       // lk[lane NT + t]: the look-ahead sums for the next group
  int* pub = reinterpret_cast<int*>(lk + 32 * NT);  // the groups the chain has published
  const size_t rlen = (size_t)B * NT;
  const float* g0 = gram + (size_t)v * rlen;  // row (j, t) at g0 + (j NT + t) V rlen
  const size_t rstride = (size_t)V * rlen;
  const float* pkv = pk + (size_t)v * pk_stride;
  const bool mine = i < B;
  // rows of the Gram are 16-byte aligned: row (j, t) starts B nT words after (j, t - 1)
  const bool wide = (rlen & 3) == 0 && (reinterpret_cast<uintptr_t>(gram) & 15) == 0;

  // group grp's rows (r, t), columns of its group and the next (row-major,
  // TW words a row), and its packed rows into slot grp % kSlots, by the warp
  // that will run it: in 16-byte copies where the Gram's rows allow
  auto stage = [&](int grp, int tid, int nth) {
    float* tile = slots + (grp % S::kSlots) * S::kSlot;
    const int j0 = 32 * grp, nr = min(32, B - j0), nc = min(64, B - j0) * NT;
    // kc 16-byte words a staged row, a constant: no division in the loop
    auto rows16 = [&](auto kc) {
      constexpr int K = decltype(kc)::value;
#pragma unroll 4
      for (int idx = tid; idx < 32 * NT * K; idx += nth) {
        const int row = idx / K, ch = idx - row * K;  // row = r nT + t
        const float* src = g0 + ((size_t)j0 * NT + row) * rstride + (size_t)j0 * NT + 4 * ch;
        __pipeline_memcpy_async(tile + row * TW + 4 * ch, src, 16);
      }
    };
    if (wide && nr == 32 && nc == TW) {
      rows16(std::integral_constant<int, TW / 4>{});
    } else if (wide && nr == 32 && nc == TW / 2) {  // the last group: no next group
      rows16(std::integral_constant<int, TW / 8>{});
    } else {
      for (int idx = tid; idx < 32 * NT * TW; idx += nth) {
        const int row = idx / TW, c = idx - row * TW;
        if (row < nr * NT && c < nc) {
          __pipeline_memcpy_async(tile + idx, g0 + ((size_t)j0 * NT + row) * rstride + (size_t)j0 * NT + c, 4);
        } else {
          tile[idx] = 0.f;
        }
      }
    }
    for (int k = tid; k < nr * W; k += nth) {  // row r to r W4: 16-byte words to read
      const int r = k / W;
      __pipeline_memcpy_async(tile + S::kTileWords + r * S::W4 + (k - r * W), pkv + (size_t)j0 * W + k, 4);
    }
    __pipeline_commit();
  };

  float acc[NT], look[NT], b_mine[NT], u_mine[NT];
  const float sy = *sum_y;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float a = 0.f;
    if (mine) {  // the plain version's adj + (r0 - cb sum(y)), rounded as it rounds
      const size_t k = ((size_t)v * B + i) * NT + t;
      a = __fadd_rn(pkv[(size_t)i * W + t], __fsub_rn(r0[k], __fmul_rn(cb[k], sy)));
    }
    acc[t] = a;
    look[t] = b_mine[t] = u_mine[t] = 0.f;
  }
  if (i == 0) *pub = 0;
  // group 0's rows, by the whole block: the first group waits for nothing else
  stage(0, i, blockDim.x);
  __pipeline_wait_prior(0);
  __syncthreads();
  // the couplings of group g's quads, once its rows have landed: lane i
  // (the quad's locus q = i mod 4) writes K[q, b] = M_i G[i, b] (nT x nT)
  // for the quad's loci b < q, K's row t at quad kQuadWords + (q (q - 1) / 2
  // + b) nT^2 + t nT
  auto couple = [&]() {
    __pipeline_wait_prior(0);
    __syncwarp();
    float* tile = slots + (g % S::kSlots) * S::kSlot;
    float m[NT][NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int r = 0; r < NT; ++r) m[t][r] = tile[S::kTileWords + lane * S::W4 + 3 * NT + t * NT + r];
    }
    float* kq = tile + S::kTileWords + 32 * S::W4 + (lane >> 2) * S::kQuadWords;
    const int q = lane & 3;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (b < q) {
        // G[i, r; b, s] read as G[b, s; i, r]: row (b, s), the lanes on neighbouring words
        float gv[NT][NT];
#pragma unroll
        for (int s = 0; s < NT; ++s) load_n(tile + (((lane & ~3) + b) * NT + s) * TW + lane * NT, gv[s]);
        float* out = kq + (q * (q - 1) / 2 + b) * NT * NT;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int s = 0; s < NT; ++s) {
            float k = 0.f;
#pragma unroll
            for (int r = 0; r < NT; ++r) k = fmaf(m[t][r], gv[s][r], k);
            out[t * NT + s] = k;
          }
        }
      }
    }
    __syncwarp();
  };

  if (0 < g && g < S::kSlots) stage(g, lane, 32);

  // the far products: group w's u's into this warp's rows, w = 0 .. g - 2, as
  // each is published; group g - 1's come from its warp's look-ahead sums.
  // For nT <= 2 a round's block (this warp's rows at group w's columns) is
  // copied into the warp's buffer whole rows at a time, neighbouring lanes on
  // neighbouring words, and each lane then reads its rows there: loaded
  // straight from the Gram by their own threads, each load took 32 cache
  // lines and held up every warp's shared-memory traffic, the chain's too
  const int nrow = min(32, B - 32 * g) * NT;  // this warp's rows that exist
  auto stage_far = [&](int w) {
    const float* src = g0 + (size_t)32 * g * NT * rstride + (size_t)32 * w * NT;
    if (wide) {
#pragma unroll 4
      for (int idx = lane; idx < 32 * NT * 8 * NT; idx += 32) {  // row rho's 16-byte word ch
        const int rho = idx / (8 * NT), ch = idx - rho * (8 * NT);
        if (rho < nrow) __pipeline_memcpy_async(fbuf + rho * F::FS + 4 * ch, src + (size_t)rho * rstride + 4 * ch, 16);
      }
    } else {
      for (int idx = lane; idx < 32 * NT * 32 * NT; idx += 32) {
        const int rho = idx / (32 * NT), c = idx - rho * (32 * NT);
        if (rho < nrow) __pipeline_memcpy_async(fbuf + rho * F::FS + c, src + (size_t)rho * rstride + c, 4);
      }
    }
    __pipeline_commit();
  };
  if (kFarSmem && g >= 2) stage_far(0);
  for (int w = 0; w + 1 < g; ++w) {
    wait_published(pub, w + 1);
    const bool staged = w == g - S::kSlots;
    if (staged) stage(g, lane, 32);  // into the slot group w has left
    if constexpr (kFarSmem) {  // this round's block landed (the tile staged after it may not have)
      if (staged) {
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncwarp();
    }
    if (mine) {
      // group w is whole (only the last group is short): its u's in 16-byte words
      const float4* ug = reinterpret_cast<const float4*>(us + 32 * w * NT);
      float part[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) part[t][0] = part[t][1] = part[t][2] = part[t][3] = 0.f;
#pragma unroll 4
      for (int c = 0; c < 8 * NT; ++c) {
        const float4 u4 = ug[c];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          float4 x;
          if constexpr (kFarSmem) {
            x = reinterpret_cast<const float4*>(fbuf + (lane * NT + t) * F::FS)[c];
          } else {
            const float* row = g0 + ((size_t)i * NT + t) * rstride + (size_t)32 * w * NT + 4 * c;
            x = wide ? __ldg(reinterpret_cast<const float4*>(row))
                     : make_float4(__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3));
          }
          part[t][0] = fmaf(x.x, u4.x, part[t][0]);
          part[t][1] = fmaf(x.y, u4.y, part[t][1]);
          part[t][2] = fmaf(x.z, u4.z, part[t][2]);
          part[t][3] = fmaf(x.w, u4.w, part[t][3]);
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[t] += (part[t][0] + part[t][1]) + (part[t][2] + part[t][3]);
    }
    if constexpr (kFarSmem) {
      __syncwarp();  // the buffer is read: the next round's block may land there
      if (w + 2 < g) stage_far(w + 1);
    }
  }

  const float* tile = slots + (g % S::kSlots) * S::kSlot;
  const float* rows = tile + S::kTileWords;  // locus k's row at rows + k W4
  const float* kq = rows + 32 * S::W4;       // quad k0 / 4's couplings at kq + k0 / 4 kQuadWords
  // G[lane, t; k, s] read as G[k, s; lane, t] (the Gram is symmetric): the
  // lanes read neighbouring words of the staged row (k, s); the next group's
  // G[32 + lane, t; k, s] at 32 nT words further on
  const float* gcol = tile + lane * NT;
  const int nj = min(32, B - 32 * g);
  const bool has_next = 32 * (g + 1) < B;
  // the hand-off: group g - 1's warp arrives once its u's and look-ahead
  // sums are written; this warp's rows and couplings are ready before it
  // waits, but for nT = 4 (one slot: it stages after the hand-off)
  if (g > 0 && S::kSlots == 1) {
    named_sync(1 + ((g - 1) & 1), 64);
    stage(g, lane, 32);
    couple();
  } else {
    couple();
    if (g > 0) named_sync(1 + ((g - 1) & 1), 64);
  }
  if (g > 0) {  // group g - 1's look-ahead sums for these rows
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] += lk[lane * NT + t];
  }

  // four loci a step: the quad's sums shuffled at once, then each locus's
  // bnew = M pre + c from its shuffled sums and the couplings with the
  // quad's earlier u's; a locus past the block's end has u = 0. Rows,
  // couplings and Gram words are read in 16- (or 8-) byte loads, each next to
  // the arithmetic that uses it: the warp issues in order, and a quad's
  // loads issued a quad ahead of its arithmetic made each group slower
  const float* rr = rows;
  for (int k0 = 0; k0 < nj; k0 += 4, rr += 4 * S::W4, kq += S::kQuadWords) {
    float p[4][NT], uq[4][NT], kk[S::kQuadWords];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int t = 0; t < NT; ++t) p[q][t] = __shfl_sync(kFull, acc[t], k0 + q);
    }
    load4(kq, kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float r[S::W4];
      load4(rr + q * S::W4, r);
      float x[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        x[t] = r[2 * NT + t];
#pragma unroll
        for (int s = 0; s < NT; ++s) x[t] = fmaf(r[3 * NT + t * NT + s], p[q][s], x[t]);
      }
#pragma unroll
      for (int b = 0; b < q; ++b) {
        const float* k = kk + (q * (q - 1) / 2 + b) * NT * NT;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int s = 0; s < NT; ++s) x[t] = fmaf(k[t * NT + s], uq[b][s], x[t]);
        }
      }
      const bool valid = k0 + q < nj;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uq[q][t] = valid ? r[NT + t] - x[t] : 0.f;
        if (lane == k0 + q) b_mine[t] = x[t], u_mine[t] = uq[q][t];
      }
      const float* grow = gcol + (k0 + q) * NT * TW;
#pragma unroll
      for (int s = 0; s < NT; ++s) {
        float ga[NT];
        load_n(grow + s * TW, ga);
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[t] = fmaf(ga[t], uq[q][s], acc[t]);
      }
      if (has_next) {
#pragma unroll
        for (int s = 0; s < NT; ++s) {
          float gl[NT];
          load_n(grow + s * TW + 32 * NT, gl);
#pragma unroll
          for (int t = 0; t < NT; ++t) look[t] = fmaf(gl[t], uq[q][s], look[t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    us[i * NT + t] = u_mine[t];
    lk[lane * NT + t] = look[t];
  }
  if (32 * (g + 1) < B) named_arrive(1 + (g & 1), 64);  // the next group's warp starts
  __threadfence_block();
  __syncwarp();
  if (lane == 0) *reinterpret_cast<volatile int*>(pub) = g + 1;  // for the far products
  if (mine) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      beta[(size_t)v * beta_stride + (size_t)i * NT + t] = b_mine[t];
      uout[((size_t)v * B + i) * NT + t] = u_mine[t];
    }
  }
}

// The generic form, any nT: locus j's rule on thread 0 (its nT x nT work),
// a barrier, then every later locus's thread adds G[i, j] u_j into its nT
// sums, kept in pre (V, B, nT) in device memory.
__global__ void __launch_bounds__(kGenericThreads)
    corr_scan_generic_kernel(const float* __restrict__ gram, const float* __restrict__ pk,
                             long long pk_stride, const float* __restrict__ r0,
                             const float* __restrict__ cb, const float* __restrict__ sum_y,
                             float* __restrict__ beta, long long beta_stride, float* __restrict__ uout,
                             float* __restrict__ pre, int V, int B, int nt) {
  const int v = blockIdx.x;
  const size_t W = 3 * (size_t)nt + (size_t)nt * nt;
  const size_t rlen = (size_t)B * nt, rstride = (size_t)V * rlen;
  const float* g0 = gram + (size_t)v * rlen;
  const float* pkv = pk + (size_t)v * pk_stride;
  float* prev = pre + (size_t)v * B * nt;
  float* bv = beta + (size_t)v * beta_stride;
  float* uv = uout + (size_t)v * B * nt;
  const float sy = *sum_y;
  for (int i = threadIdx.x; i < B; i += kGenericThreads) {
    for (int t = 0; t < nt; ++t) {
      const size_t k = ((size_t)v * B + i) * nt + t;
      prev[(size_t)i * nt + t] = __fadd_rn(pkv[i * W + t], __fsub_rn(r0[k], __fmul_rn(cb[k], sy)));
    }
  }
  __syncthreads();
  for (int j = 0; j < B; ++j) {
    if (threadIdx.x == 0) {
      const float* rr = pkv + j * W;
      for (int t = 0; t < nt; ++t) {
        float x = rr[2 * nt + t];
        for (int s = 0; s < nt; ++s) x = fmaf(rr[3 * nt + (size_t)t * nt + s], prev[(size_t)j * nt + s], x);
        bv[(size_t)j * nt + t] = x;
        uv[(size_t)j * nt + t] = rr[nt + t] - x;
      }
    }
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < B; i += kGenericThreads) {
      for (int t = 0; t < nt; ++t) {
        const float* row = g0 + ((size_t)i * nt + t) * rstride + (size_t)j * nt;
        float a = prev[(size_t)i * nt + t];
        for (int s = 0; s < nt; ++s) a = fmaf(__ldg(row + s), uv[(size_t)j * nt + s], a);
        prev[(size_t)i * nt + t] = a;
      }
    }
    __syncthreads();
  }
}

struct StepArgs {
  const float* gram;
  const float* pk;
  long long pk_stride;
  const float* r0;
  const float* cb;
  const float* sum_y;
  float* beta;
  long long beta_stride;
  float* u;
  int V, B;
};

template <int NT, int MAXT>
int launch_as(const StepArgs& a, int threads, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_words<NT>(threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_scan_kernel<NT, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  corr_scan_kernel<NT, MAXT><<<(unsigned)a.V, threads, smem, st>>>(
      a.gram, a.pk, a.pk_stride, a.r0, a.cb, a.sum_y, a.beta, a.beta_stride, a.u, a.V, a.B);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_fast(const StepArgs& a, cudaStream_t st) {
  const int threads = (a.B + 31) / 32 * 32;
  return threads <= 256 ? launch_as<NT, 256>(a, threads, st) : launch_as<NT, 1024>(a, threads, st);
}

// Gauss-Jordan inverse without pivots, in registers: a is overwritten
template <int NT>
__device__ __forceinline__ void gj_inverse(float (&a)[NT][NT], float (&inv)[NT][NT]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int s = 0; s < NT; ++s) inv[t][s] = t == s ? 1.f : 0.f;
  }
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    const float piv = 1.f / a[c][c];
#pragma unroll
    for (int s = 0; s < NT; ++s) a[c][s] *= piv, inv[c][s] *= piv;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t == c) continue;
      const float f = a[t][c];
#pragma unroll
      for (int s = 0; s < NT; ++s) {
        a[t][s] = fmaf(-f, a[c][s], a[t][s]);
        inv[t][s] = fmaf(-f, inv[c][s], inv[t][s]);
      }
    }
  }
}

// The rule of locus l, one thread: ivr = inv(var_beta[region]); cov =
// sym(inv(mpm / varE + ivr)); chol(cov), NaN from a pivot that is not
// positive; the packed row [mpm bold | bold | chol z | cov / varE], c and M
// zero on a padded locus (as corr_block_pack rounds them)
template <int NT>
__global__ void __launch_bounds__(kRuleThreads)
    corr_rule_kernel(const float* __restrict__ bold, const float* __restrict__ z,
                     const float* __restrict__ mpm, const unsigned char* __restrict__ mask,
                     const float* __restrict__ var_beta, const int* __restrict__ region,
                     const float* __restrict__ var_e, float* __restrict__ pk, long long p,
                     int n_regions) {
  constexpr int W = 3 * NT + NT * NT;
  const long long l = (long long)blockIdx.x * kRuleThreads + threadIdx.x;
  if (l >= p) return;
  const float ive = 1.f / __ldg(var_e);
  const int r = min(max(__ldg(region + l), 0), n_regions - 1);
  float a[NT][NT], ivr[NT][NT], m[NT][NT], inv[NT][NT], cov[NT][NT], ch[NT][NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int s = 0; s < NT; ++s) a[t][s] = __ldg(var_beta + ((size_t)r * NT + t) * NT + s);
  }
  gj_inverse<NT>(a, ivr);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      m[t][s] = __ldg(mpm + ((size_t)l * NT + t) * NT + s);
      a[t][s] = __fadd_rn(__fmul_rn(m[t][s], ive), ivr[t][s]);
    }
  }
  gj_inverse<NT>(a, inv);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int s = 0; s < NT; ++s) cov[t][s] = (inv[t][s] + inv[s][t]) * 0.5f;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float d = cov[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = fmaf(-ch[j][k], ch[j][k], d);
    ch[j][j] = d > 0.f ? sqrtf(d) : __int_as_float(0x7fffffff);
#pragma unroll
    for (int i = j + 1; i < NT; ++i) {
      float x = cov[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) x = fmaf(-ch[i][k], ch[j][k], x);
      ch[i][j] = x / ch[j][j];
    }
  }
  const float keep = mask[l] ? 1.f : 0.f;
  float bo[NT], zz[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) bo[t] = __ldg(bold + l * NT + t), zz[t] = __ldg(z + l * NT + t);
  float* row = pk + (size_t)l * W;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float adj = 0.f, c = 0.f;
#pragma unroll
    for (int s = 0; s < NT; ++s) adj = fmaf(m[t][s], bo[s], adj);
#pragma unroll
    for (int s = 0; s <= t; ++s) c = fmaf(ch[t][s], zz[s], c);
    row[t] = adj;
    row[NT + t] = bo[t];
    row[2 * NT + t] = __fmul_rn(c, keep);
#pragma unroll
    for (int s = 0; s < NT; ++s) row[3 * NT + t * NT + s] = __fmul_rn(__fmul_rn(cov[t][s], ive), keep);
  }
}

template <int NT>
int launch_rule(const float* bold, const float* z, const float* mpm, const unsigned char* mask,
                const float* var_beta, const int* region, const float* var_e, float* pk, long long p,
                int n_regions, cudaStream_t st) {
  const unsigned blocks = (unsigned)((p + kRuleThreads - 1) / kRuleThreads);
  corr_rule_kernel<NT><<<blocks, kRuleThreads, 0, st>>>(bold, z, mpm, mask, var_beta, region, var_e,
                                                         pk, p, n_regions);
  return (int)cudaGetLastError();
}

}  // namespace

// One block-step of CM1: gram the step's (B, nT, V, B, nT) Gram; pk the
// step's packed rows, chain v's at pk + v pk_stride (B rows of 3 nT + nT^2);
// r0, cb (V, B, nT) and sum_y (one float) fold r0 - cb sum_y into adj;
// beta out at beta + v beta_stride (B nT floats a chain), u (V, B, nT) out;
// pre (V, B, nT) scratch for nT > 4 (else unused). Float32, one device;
// 1 <= B <= 1024.
extern "C" int ngt_corr_block_step(const void* gram, const void* pk, long long pk_stride, const void* r0,
                                   const void* cb, const void* sum_y, void* beta, long long beta_stride,
                                   void* u, void* pre, long long V, long long B, long long nt,
                                   void* stream) {
  if (V < 1 || V > 65535 || B < 1 || B > 1024 || nt < 1) return (int)cudaErrorInvalidValue;
  if (r0 == nullptr || cb == nullptr || sum_y == nullptr) return (int)cudaErrorInvalidValue;
  const StepArgs a{(const float*)gram, (const float*)pk, pk_stride, (const float*)r0, (const float*)cb,
                   (const float*)sum_y, (float*)beta, beta_stride, (float*)u, (int)V, (int)B};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nt) {
    case 1: return launch_fast<1>(a, st);
    case 2: return launch_fast<2>(a, st);
    case 3: return launch_fast<3>(a, st);
    case 4: return launch_fast<4>(a, st);
    default:
      if (pre == nullptr) return (int)cudaErrorInvalidValue;
      corr_scan_generic_kernel<<<(unsigned)V, kGenericThreads, 0, st>>>(
          a.gram, a.pk, pk_stride, a.r0, a.cb, a.sum_y, a.beta, beta_stride, a.u, (float*)pre, (int)V,
          (int)B, (int)nt);
      return (int)cudaGetLastError();
  }
}

// The rule launch: bold, z (p, nT), mpm (p, nT, nT), mask (p,) bytes,
// var_beta (n_regions, nT, nT), region (p,) int32 (clamped to the regions),
// var_e one float -> pk (p, 3 nT + nT^2). Float32, 1 <= nT <= 4.
extern "C" int ngt_corr_rule(const void* bold, const void* z, const void* mpm, const void* mask,
                             const void* var_beta, const void* region, const void* var_e, void* pk,
                             long long p, long long n_regions, long long nt, void* stream) {
  if (p < 1 || n_regions < 1 || n_regions > 2147483647LL) return (int)cudaErrorInvalidValue;
  const float* b = (const float*)bold;
  const float* zz = (const float*)z;
  const float* m = (const float*)mpm;
  const unsigned char* k = (const unsigned char*)mask;
  const float* vb = (const float*)var_beta;
  const int* rg = (const int*)region;
  const float* ve = (const float*)var_e;
  float* out = (float*)pk;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nt) {
    case 1: return launch_rule<1>(b, zz, m, k, vb, rg, ve, out, p, (int)n_regions, st);
    case 2: return launch_rule<2>(b, zz, m, k, vb, rg, ve, out, p, (int)n_regions, st);
    case 3: return launch_rule<3>(b, zz, m, k, vb, rg, ve, out, p, (int)n_regions, st);
    case 4: return launch_rule<4>(b, zz, m, k, vb, rg, ve, out, p, (int)n_regions, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
