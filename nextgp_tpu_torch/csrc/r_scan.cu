// V-batched BayesR in-block scan for Hopper (sm_90a), K3.
//
// Replaces the Pallas kernel `_make_r_kernel_v(K)` behind
// `gibbs_kernels.r_block_scan_v` (nextgp_tpu/ops/gibbs_kernels.py:472-521,
// called through `_call_v` / `_pallas_step_call`, :293-364). V=1 is the
// single-chain `r_block_scan` (`_make_r_kernel`, :209-267).
//
// V independent chains of B sequential loci. For locus j of chain v:
//   pre   = s0 + G[j, v, :] . u_v          (u_v[j] is still 0 here)
//   logl  = q0 + q1 * pre^2                (K classes), softmax
//   cls   = #{k : cdf_k < unif}, clamped to K-1
//   beta  = c[cls] + b[cls] * pre,  u_v[j] = beta_old - beta
// with the per-locus coefficient row s = pk[v, j, :] laid out as
// [adj, bold, unif, mask, pad*4 | q0(K), q1(K), b(K), c(K)]
// (gibbs_kernels.r_block_pack). The caller has already added r0 to slot 0.
//
// Bound: latency. Each locus depends on the one before, so a chain is a
// sequence of B block-wide dot products, each followed by a few scalar
// steps. Bytes are small: one 4*B-byte Gram row per locus.
// Design: one thread block per chain, one thread per locus of the block.
// The TPU kernel held the whole (B, V, B) Gram block in VMEM; one chain's
// B x B f32 block (256 KB at B=256) does not fit a block's 227 KB of shared
// memory, so the Gram stays in device memory (and L2) and each locus reads
// its contiguous row G[t, j, v, :], prefetched one locus ahead into a
// register. u_v and the chain's coefficient rows live in shared memory. The
// dot is a fixed-order warp-shuffle plus per-warp reduction (bit-
// reproducible); thread 0 then does the K-class softmax, the inverse CDF
// with the min(cls, K-1) clamp (nextgp_tpu/ops/dists.py:86-98) and writes
// u_v[j]. The step-indexed Gram ((T, B, V, B), t) is a pointer offset made
// by the caller.
#include "common.cuh"

namespace {

constexpr int kMaxClasses = 16;

__global__ void r_scan_v_kernel(const float* __restrict__ gram, const float* __restrict__ pk,
                                float* __restrict__ beta, float* __restrict__ u_out,
                                int* __restrict__ delta, int V, int B, int K) {
  extern __shared__ float sm[];
  const int W = 8 + 4 * K;
  float* us = sm;        // B: the chain's correction vector u_v
  float* red = us + B;   // 32: per-warp partial dots
  float* pks = red + 32; // B * W: the chain's coefficient rows
  const int v = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nwarps = blockDim.x >> 5;

  const float* pkv = pk + (size_t)v * B * W;
  for (int idx = i; idx < B * W; idx += blockDim.x) pks[idx] = pkv[idx];
  if (i < B) us[i] = 0.f;
  // gram is locus-major (B, V, B): row j of chain v starts at (j * V + v) * B
  const size_t jstride = (size_t)V * B;
  const float* gv = gram + (size_t)v * B;
  float g = (i < B) ? __ldg(gv + i) : 0.f;
  __syncthreads();

  for (int j = 0; j < B; ++j) {
    const float gnext = (i < B && j + 1 < B) ? __ldg(gv + (size_t)(j + 1) * jstride + i) : 0.f;
    const float part = ngt::warp_sum((i < B) ? g * us[i] : 0.f);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (i == 0) {
      float dot = 0.f;
      for (int w = 0; w < nwarps; ++w) dot += red[w];
      const float* s = pks + (size_t)j * W;
      const float pre = s[0] + dot;
      const float pre2 = pre * pre;
      float e[kMaxClasses];
      float m = s[8] + s[8 + K] * pre2;
      e[0] = m;
      for (int k = 1; k < K; ++k) {
        e[k] = s[8 + k] + s[8 + K + k] * pre2;
        m = fmaxf(m, e[k]);
      }
      float tot = 0.f;
      for (int k = 0; k < K; ++k) {
        e[k] = expf(e[k] - m);
        tot += e[k];
      }
      int cls = 0;
      float cum = 0.f;
      for (int k = 0; k < K; ++k) {
        cum += e[k] / tot;
        cls += (cum < s[2]) ? 1 : 0;
      }
      cls = min(cls, K - 1);
      const float bnew = s[8 + 3 * K + cls] + s[8 + 2 * K + cls] * pre;
      us[j] = s[1] - bnew;
      beta[(size_t)v * B + j] = bnew;
      delta[(size_t)v * B + j] = (s[3] != 0.f) ? cls + 1 : 0;
    }
    __syncthreads();
    g = gnext;
  }
  if (i < B) u_out[(size_t)v * B + i] = us[i];
}

}  // namespace

extern "C" {

// gram: (B, V, B) f32 (already offset to step t), pk: (V, B, 8 + 4K) f32;
// beta, u: (V, B) f32; delta: (V, B) int32. 1 <= B <= 1024, 1 <= K <= 16.
int ngt_r_block_scan_v(const void* gram, const void* pk, void* beta, void* u, void* delta,
                       long long V, long long B, long long K, void* stream) {
  const int threads = (int)((B + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (size_t)(B + 32 + B * (8 + 4 * K));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        r_scan_v_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  r_scan_v_kernel<<<(unsigned)V, threads, smem, (cudaStream_t)stream>>>(
      (const float*)gram, (const float*)pk, (float*)beta, (float*)u, (int*)delta, (int)V, (int)B,
      (int)K);
  return (int)cudaGetLastError();
}

}  // extern "C"
