// The in-block scan of correlated marker sets for Hopper (sm_90a): CM1.
//
// Replaces no Pallas kernel. It is the counterpart of the `lax.scan` over a
// block's loci in `sample_corr_marker_set` (nextgp_tpu/engine/samplers/
// markers.py:898-916; NextGP.jl functions.jl:140-154): V independent chains
// of B sequential loci, each locus carrying nT effects (one per set),
//   pre_j  = adj_j + sum_{b<j} G[j, b] u_b      (adj_j = r0_j + G[j, j] bold_j)
//   bnew_j = M_j pre_j + c_j,   u_j = bold_j - bnew_j
// with G[j, b] the (nT, nT) block of the centered cross-Gram. M_j, c_j
// (0 on a padded locus) and adj_j come packed per locus from
// ops/corr_scan.corr_block_pack: [adj (nT) | bold (nT) | c (nT) | M (nT^2)].
// The Gram of a step is (B, nT, V, B, nT): the row (j, t) of chain v is the
// B nT floats G[j, t; k, w] at ((j nT + t) V + v) B nT, (k, w) interleaved.
//
// Bound: latency. The bytes are the Grams' lower triangles (V B (B + 1) / 2
// nT^2 floats, 50.3 MB a step at V = 96, B = 256, nT = 2: 0.0150 ms at
// 3.35 TB/s) and one row a locus, read once; each locus depends on the one
// before, so B times a locus's dependent chain is the time.
//
// Design: the scans' skeleton (scan_skeleton.cuh) with nT channels. One
// block per chain, one thread per locus keeping its nT right-looking sums
// in registers, one warp per group of 32 loci:
//  * inside a group, lane i adds G[i, j] u_j (nT^2 FMAs) as soon as u_j is
//    known, from the group's (32 nT) x (32 nT) diagonal tile in shared
//    memory, read by symmetry along the staged row (j, s) so that the lanes
//    read neighbouring words; every lane computes bnew_j =
//    M_j pre_j + c_j itself from the staged row of locus j and the nT sums
//    shuffled from lane j, so nothing but the shuffles is on the chain;
//  * after a group, one barrier publishes its u's and every later thread
//    adds its rows' 32 nT products per channel; for nT <= 2 (and blocks of
//    at most 256 loci) it loaded them while it waited, above that it loads
//    them after the barrier (they would not fit its registers); in 16-byte
//    words where B nT is a multiple of 4: a thread's rows lie far from its
//    neighbours', so every load instruction touches 32 sectors, and 4-byte
//    loads took a step at V = 96, B = 256, nT = 2 from 0.0703 to 0.0994 ms
//    on the card alone (H100 80GB HBM3, 700 W; two runs of chip_smoke.py
//    corr);
//  * the warp that runs the next group stages its tile and rows with
//    cp.async into the other of two slots while the group before it runs.
// Fast forms for nT = 1 .. 4 (ops/corr_scan.FAST_NT). Above that, the
// generic form: one thread a locus's nT x nT work, its sums in device
// memory, a block barrier per locus. Every sum has a fixed order and nothing is atomic: two runs give
// the same bits. One launch per block-step.
#include "scan_skeleton.cuh"

namespace {

constexpr int kGenericThreads = 256;
using ngt::scan::kFull;

template <int NT>
struct Shape {
  static constexpr int W = 3 * NT + NT * NT;       // a locus's packed row
  static constexpr int TW = 32 * NT;               // a tile row's words
  static constexpr int kTileWords = 32 * NT * TW;  // the (32 nT) x (32 nT) diagonal tile
  static constexpr int kSlot = kTileWords + 32 * W;
};

template <int NT, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
    corr_scan_kernel(const float* __restrict__ gram, const float* __restrict__ pk,
                     float* __restrict__ beta, float* __restrict__ uout, int V, int B) {
  using S = Shape<NT>;
  constexpr int W = S::W;
  constexpr bool kPrefetch = NT <= 2 && MAXT <= 256;
  extern __shared__ __align__(16) float sm[];
  const int v = blockIdx.x, i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int nwarps = blockDim.x >> 5;
  float* us = sm;  // us[k * NT + w]: locus k's u, the Gram rows' column order
  float* slots = sm + blockDim.x * NT;
  const size_t rlen = (size_t)B * NT;
  const float* g0 = gram + (size_t)v * rlen;  // row (j, t) at g0 + (j NT + t) V rlen
  const size_t rstride = (size_t)V * rlen;
  const float* pkv = pk + (size_t)v * B * W;
  const bool mine = i < B;
  // rows of the Gram are 16-byte aligned: row (j, t) starts B nT words after (j, t - 1)
  const bool wide = (rlen & 3) == 0 && (reinterpret_cast<uintptr_t>(gram) & 15) == 0;

  // group g's diagonal tile (rows (r, t), columns (c, w), row-major) and
  // packed rows into slot g & 1, by the warp that will run it: a whole
  // group's rows in 16-byte copies where the Gram's rows allow. Copied 4
  // bytes at a time (32 nT^2 copies a lane a group, each with its 64-bit
  // address), this staging was the chain's critical path: a step at V = 96,
  // B = 256, nT = 2 took 0.0703 ms on the card alone, 0.0317 with 16-byte
  // copies (H100 80GB HBM3, 700 W; chip_smoke.py corr)
  auto stage = [&](int g) {
    float* tile = slots + (g & 1) * S::kSlot;
    const int j0 = 32 * g;
    if (wide && j0 + 32 <= B) {
      constexpr int kChunks = 8 * NT;  // 16-byte words of a row's 32 nT floats
      for (int idx = lane; idx < 32 * NT * kChunks; idx += 32) {
        const int row = idx / kChunks, ch = idx - row * kChunks;  // row = r nT + t
        const float* src = g0 + ((size_t)j0 * NT + row) * rstride + (size_t)j0 * NT + 4 * ch;
        __pipeline_memcpy_async(tile + row * S::TW + 4 * ch, src, 16);
      }
    } else {
      for (int r = 0; r < 32; ++r) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float* src = g0 + ((size_t)(j0 + r) * NT + t) * rstride + (size_t)j0 * NT;
          float* d = tile + (r * NT + t) * S::TW;
          for (int c = lane; c < 32 * NT; c += 32) {
            if (j0 + r < B && j0 + c / NT < B) {
              __pipeline_memcpy_async(d + c, src + c, 4);
            } else {
              d[c] = 0.f;
            }
          }
        }
      }
    }
    const int words = min(32, B - j0) * W;
    for (int k = lane; k < words; k += 32) {
      __pipeline_memcpy_async(tile + S::kTileWords + k, pkv + (size_t)j0 * W + k, 4);
    }
  };

  float acc[NT], b_mine[NT], u_mine[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    acc[t] = mine ? pkv[(size_t)i * W + t] : 0.f;
    b_mine[t] = u_mine[t] = 0.f;
  }
  if (warp == 0) stage(0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  for (int w = 0; w < nwarps; ++w) {
    float gp[kPrefetch ? NT : 1][kPrefetch ? 32 * NT : 1];
    if (warp == w) {
      const float* tile = slots + (w & 1) * S::kSlot;
      const float* rr = tile + S::kTileWords;  // locus jj's row at rr + jj W
      // G[lane, t; jj, s] read as G[jj, s; lane, t] (the Gram is symmetric):
      // the lanes read neighbouring words of the staged row (jj, s)
      const float* gcol = tile + lane * NT;
      const int nj = min(32, B - 32 * w);
      for (int jj = 0; jj < nj; ++jj, rr += W) {
        float p[NT], bj[NT], uj[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) p[t] = __shfl_sync(kFull, acc[t], jj);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          float x = rr[2 * NT + t];
#pragma unroll
          for (int s = 0; s < NT; ++s) x = fmaf(rr[3 * NT + t * NT + s], p[s], x);
          bj[t] = x;
          uj[t] = rr[NT + t] - x;
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          float a = acc[t];
#pragma unroll
          for (int s = 0; s < NT; ++s) a = fmaf(gcol[(jj * NT + s) * S::TW + t], uj[s], a);
          acc[t] = a;
          if (lane == jj) b_mine[t] = bj[t], u_mine[t] = uj[t];
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) us[i * NT + t] = u_mine[t];
    } else if (warp == w + 1) {
      stage(warp);  // into the slot group w - 1 has left
    }
    const int ncol = min(32, B - 32 * w) * NT;  // the group's columns
    const bool vec = wide && ncol == 32 * NT;   // whole rows of 16-byte words
    if (kPrefetch && warp > w && mine) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float* row = g0 + ((size_t)i * NT + t) * rstride + (size_t)32 * w * NT;
        if (vec) {
#pragma unroll
          for (int c = 0; c < 8 * NT; ++c) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(row) + c);
            gp[t][4 * c] = x.x, gp[t][4 * c + 1] = x.y, gp[t][4 * c + 2] = x.z, gp[t][4 * c + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 32 * NT; ++c) gp[t][c] = c < ncol ? __ldg(row + c) : 0.f;
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (warp > w && mine) {
      const float* ug = us + 32 * w * NT;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float a = acc[t];
        if constexpr (kPrefetch) {
#pragma unroll
          for (int c = 0; c < 32 * NT; ++c) a = fmaf(gp[t][c], ug[c], a);
        } else {
          const float* row = g0 + ((size_t)i * NT + t) * rstride + (size_t)32 * w * NT;
          if (vec) {
#pragma unroll 4
            for (int c = 0; c < 8 * NT; ++c) {
              const float4 x = __ldg(reinterpret_cast<const float4*>(row) + c);
              a = fmaf(x.x, ug[4 * c], a);
              a = fmaf(x.y, ug[4 * c + 1], a);
              a = fmaf(x.z, ug[4 * c + 2], a);
              a = fmaf(x.w, ug[4 * c + 3], a);
            }
          } else {
#pragma unroll 8
            for (int c = 0; c < ncol; ++c) a = fmaf(__ldg(row + c), ug[c], a);
          }
        }
        acc[t] = a;
      }
    }
  }
  if (mine) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      beta[((size_t)v * B + i) * NT + t] = b_mine[t];
      uout[((size_t)v * B + i) * NT + t] = u_mine[t];
    }
  }
}

// The generic form, any nT: locus j's rule on thread 0 (its nT x nT work),
// a barrier, then every later locus's thread adds G[i, j] u_j into its nT
// sums, kept in pre (V, B, nT) in device memory.
__global__ void __launch_bounds__(kGenericThreads)
    corr_scan_generic_kernel(const float* __restrict__ gram, const float* __restrict__ pk,
                             float* __restrict__ beta, float* __restrict__ uout,
                             float* __restrict__ pre, int V, int B, int nt) {
  const int v = blockIdx.x;
  const size_t W = 3 * (size_t)nt + (size_t)nt * nt;
  const size_t rlen = (size_t)B * nt, rstride = (size_t)V * rlen;
  const float* g0 = gram + (size_t)v * rlen;
  const float* pkv = pk + (size_t)v * B * W;
  float* prev = pre + (size_t)v * B * nt;
  float* bv = beta + (size_t)v * B * nt;
  float* uv = uout + (size_t)v * B * nt;
  for (int i = threadIdx.x; i < B; i += kGenericThreads) {
    for (int t = 0; t < nt; ++t) prev[(size_t)i * nt + t] = pkv[i * W + t];
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

template <int NT, int MAXT>
int launch_as(const float* gram, const float* pk, float* beta, float* u, int V, int B, int threads,
              cudaStream_t st) {
  using S = Shape<NT>;
  const size_t smem = sizeof(float) * ((size_t)threads * NT + 2 * (size_t)S::kSlot);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_scan_kernel<NT, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  corr_scan_kernel<NT, MAXT><<<(unsigned)V, threads, smem, st>>>(gram, pk, beta, u, V, B);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_fast(const float* gram, const float* pk, float* beta, float* u, int V, int B,
                cudaStream_t st) {
  const int threads = (B + 31) / 32 * 32;
  return threads <= 256 ? launch_as<NT, 256>(gram, pk, beta, u, V, B, threads, st)
                        : launch_as<NT, 1024>(gram, pk, beta, u, V, B, threads, st);
}

}  // namespace

// One block-step of CM1: gram the step's (B, nT, V, B, nT) Gram, pk (V, B,
// 3 nT + nT^2) packed rows, beta and u (V, B, nT) out; pre (V, B, nT)
// scratch for nT > 4 (else unused). Float32, one device; 1 <= B <= 1024.
extern "C" int ngt_corr_block_scan_v(const void* gram, const void* pk, void* beta, void* u,
                                     void* pre, long long V, long long B, long long nt,
                                     void* stream) {
  if (V < 1 || V > 65535 || B < 1 || B > 1024 || nt < 1) return (int)cudaErrorInvalidValue;
  const float* g = (const float*)gram;
  const float* p = (const float*)pk;
  float* b = (float*)beta;
  float* uo = (float*)u;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nt) {
    case 1: return launch_fast<1>(g, p, b, uo, (int)V, (int)B, st);
    case 2: return launch_fast<2>(g, p, b, uo, (int)V, (int)B, st);
    case 3: return launch_fast<3>(g, p, b, uo, (int)V, (int)B, st);
    case 4: return launch_fast<4>(g, p, b, uo, (int)V, (int)B, st);
    default:
      if (pre == nullptr) return (int)cudaErrorInvalidValue;
      corr_scan_generic_kernel<<<(unsigned)V, kGenericThreads, 0, st>>>(g, p, b, uo, (float*)pre,
                                                                          (int)V, (int)B, (int)nt);
      return (int)cudaGetLastError();
  }
}
