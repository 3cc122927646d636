// V-batched Gaussian and BayesB/C in-block scans for Hopper (sm_90a): K6
// and K8.
//
// Replaces the Pallas kernels behind
//   K6  `gibbs_kernels.gauss_block_scan_v` (`_gauss_kernel_v`,
//       nextgp_tpu/ops/gibbs_kernels.py:367-393); V=1 is `gauss_block_scan`
//       (K5, `_gauss_kernel`, :80-109)
//   K8  `gibbs_kernels.bc_block_scan_v` (`_bc_kernel_v`, :396-425); V=1 is
//       `bc_block_scan` (K7, `_bc_kernel`, :115-164)
// both called through `_pallas_step_call` (:293-355). The weighted B/C scan
// K10 runs on the newer skeleton (csrc/bcw_scan.cu, csrc/scan_skeleton.cuh).
//
// V independent chains of B sequential loci, each locus one Gram-row dot
// against the chain's u (u[j] is still 0 when locus j runs) and a few
// scalar steps on its coefficient row s = pk[v, j, 0:8]:
//   gauss  pre = s0 + G[j].u;  beta = s3 + s2*pre
//   bc     pre = s0 + G[j].u;  inc = s2 + s3*pre^2 < s4;
//          beta = inc ? s6 + s5*pre : 0;  delta = inc
// and then u[j] = s1 - beta. Rows are laid out by
// gibbs_kernels.gauss_block_pack ([adj, bold, b, c, pad*4]) and
// bc_block_pack ([adj, bold, q0, q1, w, b, c, adj_raw]); the caller has added
// r0 to slot 0.
//
// Bound: latency: each locus depends on the one before. Design (the older
// skeleton): one thread block per chain, one thread per locus of the block;
// the chain's Gram rows stream from device memory (one chain's B x B block is
// 256 KB at B = 256, more than a block's 227 KB of shared memory), each row
// prefetched one locus ahead into a register; u and the chain's coefficient
// rows sit in shared memory; the dot is a fixed-order warp-shuffle plus
// per-warp reduction (bit-reproducible), and thread 0 applies the rule: two
// barriers per locus. Padded loci carry q0 = +inf and a uniform at 0 gives
// w = +inf, so the comparison must stay IEEE: no fast-math.
#include "common.cuh"

namespace {

enum Rule { kGauss = 0, kBC = 1 };
constexpr int kW = 8;  // coefficient row width

template <int R>
__global__ void scan8_v_kernel(const float* __restrict__ gram, const float* __restrict__ pk,
                               float* __restrict__ beta, float* __restrict__ u_out,
                               int* __restrict__ delta, int V, int B) {
  extern __shared__ float sm[];
  float* us = sm;         // B: the chain's correction vector u_v
  float* red = us + B;    // 32: per-warp partial dots against G
  float* pks = red + 32;  // B * kW: the chain's coefficient rows
  const int v = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nwarps = blockDim.x >> 5;

  const float* pkv = pk + (size_t)v * B * kW;
  for (int idx = i; idx < B * kW; idx += blockDim.x) pks[idx] = pkv[idx];
  if (i < B) us[i] = 0.f;
  // locus-major (B, V, B): row j of chain v starts at (j * V + v) * B
  const size_t jstride = (size_t)V * B;
  const float* gv = gram + (size_t)v * B;
  float g = (i < B) ? __ldg(gv + i) : 0.f;
  __syncthreads();

  for (int j = 0; j < B; ++j) {
    const bool more = i < B && j + 1 < B;
    const float gnext = more ? __ldg(gv + (size_t)(j + 1) * jstride + i) : 0.f;
    const float ui = (i < B) ? us[i] : 0.f;
    const float part = ngt::warp_sum(g * ui);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (i == 0) {
      float dot = 0.f;
      for (int w = 0; w < nwarps; ++w) dot += red[w];
      const float* s = pks + (size_t)j * kW;
      const float pre = s[0] + dot;
      float bnew;
      if (R == kGauss) {
        bnew = s[3] + s[2] * pre;
      } else {
        const bool inc = s[2] + s[3] * pre * pre < s[4];
        bnew = inc ? s[6] + s[5] * pre : 0.f;
        delta[(size_t)v * B + j] = inc ? 1 : 0;
      }
      us[j] = s[1] - bnew;
      beta[(size_t)v * B + j] = bnew;
    }
    __syncthreads();
    g = gnext;
  }
  if (i < B) u_out[(size_t)v * B + i] = us[i];
}

template <int R>
int launch(const void* gram, const void* pk, void* beta, void* u, void* delta, long long V,
           long long B, void* stream) {
  const int threads = (int)((B + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (size_t)(B + 32 + B * kW);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan8_v_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  scan8_v_kernel<R><<<(unsigned)V, threads, smem, (cudaStream_t)stream>>>(
      (const float*)gram, (const float*)pk, (float*)beta, (float*)u, (int*)delta, (int)V, (int)B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gram: (B, V, B) f32 (already offset to step t); pk: (V, B, 8) f32;
// beta, u: (V, B) f32; delta: (V, B) int32. 1 <= B <= 1024.
int ngt_gauss_block_scan_v(const void* gram, const void* pk, void* beta, void* u, long long V,
                           long long B, void* stream) {
  return launch<kGauss>(gram, pk, beta, u, nullptr, V, B, stream);
}

int ngt_bc_block_scan_v(const void* gram, const void* pk, void* beta, void* u, void* delta,
                        long long V, long long B, void* stream) {
  return launch<kBC>(gram, pk, beta, u, delta, V, B, stream);
}

}  // extern "C"
