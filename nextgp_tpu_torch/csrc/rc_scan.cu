// V-batched BayesRCpi and BayesRCplus in-block scans for Hopper (sm_90a):
// K12 and K14.
//
// Replaces the Pallas kernels behind
//   K12 `gibbs_kernels.rcpi_block_scan_v` (`_make_rcpi_kernel_v`,
//       nextgp_tpu/ops/gibbs_kernels.py:646-733); V=1 is `rcpi_block_scan`
//       (K11, `_make_rcpi_kernel`, :570-643)
//   K14 `gibbs_kernels.rcplus_block_scan_v` (`_make_rcplus_kernel_v`,
//       :867-968); V=1 is `rcplus_block_scan` (K13, `_make_rcplus_kernel`,
//       :774-864)
// both called through `_pallas_step_call` (:293-355).
//
// V independent chains of B sequential loci over A annotations and K
// variance classes. The coefficient row s = pk[v, j, :] keeps the JAX packs'
// layout (gibbs_kernels.rcpi_block_pack, rcplus_block_pack): a head of 8,
// then per-annotation sections in which each value is repeated K times
// (read here once, at slot a*K), then (A, K) sections.
//
//   rcpi (8 + 8AK): [adj, bold, ua, uv, mask, pad*3 | aprob, g1, g2, anz | q0, q1, b, c]
//     pre   = s0 + G[j, v, :] . u_v
//     e_ak  = anz_a ? exp(q0_ak + q1_ak * pre^2 - max over all a, k) : 0
//     a_sel = #{a : cdf_a < ua} over aprob_a * sum_k e_ak, clamped to A-1
//     cls   = #{k : cdf_k < uv} over e[a_sel, :], clamped to K-1
//     beta  = c[a_sel, cls] + b[a_sel, cls] * pre
//     aprob'_a = gam_a / sum(gam), gam_a = (a == a_sel ? g2_a : g1_a) * anz_a
//     delta = cls + 1, acat = a_sel + 1; on a padded locus (mask = 0) both
//     are 0 and aprob' = aprob
//   rcplus (8 + 6AK): [adj, bold, mask, pad*5 | ua, anz | q0, q1, b, c]
//     base = s0 + G[j, v, :] . u_v   (u_v[j] = 0: own coefficient excluded)
//     for a in 0..A-1, with ujc = bold at first:
//       pre_a = base + G[j, v, j] * ujc
//       cls_a = #{k : cdf_k < ua_a} over softmax_k(q0_ak + q1_ak * pre_a^2)
//       bs_a  = c[a, cls_a] + b[a, cls_a] * pre_a;  ujc -= bs_a
//     beta = sum_a bs_a, u_v[j] = ujc, delta = cls + 1 of the last active a,
//     and per annotation cls (0 where inactive), bs, nz = b[a, cls_a] > 0
// and for rcpi u_v[j] = bold - beta. The caller has added r0 to slot 0.
//
// The TPU kernels build (AK, AK) triangular masks for their prefix sums,
// and write the new probabilities AK wide to be decimated afterwards; here a
// prefix sum over a few classes is a short loop and the outputs are written
// (V, B, A) directly. The annotation draw is clamped to A-1 as the class
// draw is (the JAX pure path clamps both, nextgp_tpu/ops/dists.py:86-98; its
// TPU kernel clamps only the class).
//
// NaN on purpose: a padded locus has no non-zero annotation, so its sums are
// 0 and its normalized probabilities 0/0. Every comparison with NaN is
// false (a_sel = cls = 0), b = c = 0 there and pre is finite, so beta = 0;
// the outputs are chosen by selects on the mask, never by multiplying with
// it (NaN * 0 = NaN). So the comparisons must stay IEEE: no fast-math.
//
// Bound: latency, as K3 (csrc/r_scan.cu): each locus depends on the one
// before; the bytes are one 4*B-byte Gram row and one coefficient row per
// locus. Design, as K3's: one thread block per chain, one thread per locus
// of the block; Gram rows stream from device memory, each prefetched one
// locus ahead into a register; the dot is a fixed-order warp-shuffle plus
// per-warp reduction and thread 0 applies the rule with every sum in a fixed
// order, so two runs give the same bits. A chain's coefficient rows (B * W
// floats) would fit a block's 227 KB of shared memory only up to AK = 27
// (rcpi) or 36 (rcplus) at B = 256, so they are not held there: each locus's
// row is copied from device memory into one of two shared-memory slots with
// cp.async while thread 0 applies the rule to the locus before it, which
// costs no time (measured on the H100 against a form that held all rows)
// and leaves no limit on A * K but two rows and the scratch.
#include <cuda_pipeline.h>
#include <math.h>

#include "common.cuh"

namespace {

enum Rule { kRCpi = 0, kRCplus = 1 };

struct Outs {
  float* beta;  // (V, B)
  float* u;     // (V, B)
  int* delta;   // (V, B)
  int* ia;      // rcpi: acat (V, B);     rcplus: cls (V, B, A)
  float* fa;    // rcpi: aprob (V, B, A); rcplus: bs (V, B, A)
  int* ib;      // rcplus: nz (V, B, A)
};

// One BayesRCpi locus on thread 0. e (AK) and rowsum (A) are shared-memory
// scratch; at = v * B + j. Returns beta.
__device__ __forceinline__ float rcpi_locus(const float* s, float pre, int A, int K, float* e,
                                            float* rowsum, size_t at, const Outs& o) {
  const int AK = A * K;
  const float* aprob = s + 8;
  const float* g1 = aprob + AK;
  const float* g2 = g1 + AK;
  const float* anz = g2 + AK;
  const float* q0 = anz + AK;
  const float* q1 = q0 + AK;
  const float* bco = q1 + AK;
  const float* cco = bco + AK;
  const float pre2 = pre * pre;
  float m = -INFINITY;
  for (int i = 0; i < AK; ++i) {
    e[i] = q0[i] + q1[i] * pre2;
    m = fmaxf(m, e[i]);
  }
  float wsum = 0.f;
  for (int a = 0; a < A; ++a) {
    const bool nz = anz[a * K] != 0.f;
    float rs = 0.f;
    for (int k = 0; k < K; ++k) {
      const float x = nz ? expf(e[a * K + k] - m) : 0.f;
      e[a * K + k] = x;
      rs += x;
    }
    rowsum[a] = rs;
    wsum += aprob[a * K] * rs;
  }
  int a_sel = 0;
  float cum = 0.f;
  for (int a = 0; a < A; ++a) {
    cum += aprob[a * K] * rowsum[a] / wsum;
    a_sel += (cum < s[2]) ? 1 : 0;
  }
  a_sel = min(a_sel, A - 1);
  const float rs = rowsum[a_sel];
  int cls = 0;
  cum = 0.f;
  for (int k = 0; k < K; ++k) {
    cum += e[a_sel * K + k] / rs;
    cls += (cum < s[3]) ? 1 : 0;
  }
  cls = min(cls, K - 1);
  const int idx = a_sel * K + cls;
  const float bnew = cco[idx] + bco[idx] * pre;
  const bool on = s[4] != 0.f;
  float gsum = 0.f;
  for (int a = 0; a < A; ++a) {
    const float gam = ((a == a_sel) ? g2[a * K] : g1[a * K]) * anz[a * K];
    rowsum[a] = gam;
    gsum += gam;
  }
  for (int a = 0; a < A; ++a) o.fa[at * A + a] = on ? rowsum[a] / gsum : aprob[a * K];
  o.delta[at] = on ? cls + 1 : 0;
  o.ia[at] = on ? a_sel + 1 : 0;
  return bnew;
}

// One BayesRCplus locus on thread 0. e (K) is shared-memory scratch; gjj the
// Gram diagonal of the locus. Returns beta and writes the locus's u.
__device__ __forceinline__ float rcplus_locus(const float* s, float base, float gjj, int A, int K,
                                              float* e, size_t at, const Outs& o, float* u_j) {
  const int AK = A * K;
  const float* ua = s + 8;
  const float* anz = ua + AK;
  const float* q0 = anz + AK;
  const float* q1 = q0 + AK;
  const float* bco = q1 + AK;
  const float* cco = bco + AK;
  const bool on = s[2] != 0.f;
  float ujc = s[1];
  float total = 0.f;
  int dj = 0;
  for (int a = 0; a < A; ++a) {
    const int r = a * K;
    const float prea = base + gjj * ujc;
    const float pre2 = prea * prea;
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) {
      e[k] = q0[r + k] + q1[r + k] * pre2;
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
      cls += (cum < ua[r]) ? 1 : 0;
    }
    cls = min(cls, K - 1);
    const float bsel = bco[r + cls];  // 0 for a null class and for an inactive component
    const float bs = cco[r + cls] + bsel * prea;
    const bool active = on && anz[r] != 0.f;
    ujc -= bs;
    total += bs;
    if (active) dj = cls + 1;
    o.ia[at * A + a] = active ? cls + 1 : 0;
    o.fa[at * A + a] = bs;
    o.ib[at * A + a] = (bsel > 0.f) ? 1 : 0;
  }
  o.delta[at] = dj;
  *u_j = ujc;
  return total;
}

// One thread per locus of the block, up to 1024: the bound keeps the kernel
// within the 64 registers a thread may have at that size (uncapped it takes
// 72 and a launch at B = 1024 is refused). One block per SM is asked for and
// no more, or ptxas aims at two and spills down to 32 registers, which slows
// the one-thread rule.
template <int R>
__global__ void __launch_bounds__(1024, 1)
    rc_scan_v_kernel(const float* __restrict__ gram, const float* __restrict__ pk, Outs o, int V,
                     int B, int A, int K) {
  extern __shared__ float sm[];
  const int AK = A * K;
  const int W = 8 + (R == kRCpi ? 8 : 6) * AK;
  float* us = sm;            // B: the chain's correction vector u_v
  float* red = us + B;       // 32: per-warp partial dots
  float* gjj = red + 32;     // 4, one used: the Gram diagonal of the locus (rcplus)
  float* e = gjj + 4;        // AK: per-locus class scratch
  float* rowsum = e + AK;    // A: per-locus annotation scratch
  float* rows = rowsum + A;  // 2 * W: the rows of this locus and the next
  const int v = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nwarps = blockDim.x >> 5;
  // the threads that copy the rows: every warp but thread 0's, or its other
  // lanes in a block of one warp
  const int copier0 = blockDim.x > 32 ? 32 : 1;

  const float* pkv = pk + (size_t)v * B * W;
  for (int idx = i; idx < W; idx += blockDim.x) rows[idx] = pkv[idx];  // row 0
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
    if (R == kRCplus && i == j) gjj[0] = g;
    __syncthreads();
    if (i == 0) {
      float dot = 0.f;
      for (int w = 0; w < nwarps; ++w) dot += red[w];
      const float* s = rows + (j & 1) * W;
      const size_t at = (size_t)v * B + j;
      const float pre = s[0] + dot;
      float bnew;
      if (R == kRCpi) {
        bnew = rcpi_locus(s, pre, A, K, e, rowsum, at, o);
        us[j] = s[1] - bnew;
      } else {
        bnew = rcplus_locus(s, pre, gjj[0], A, K, e, at, o, us + j);
      }
      o.beta[at] = bnew;
    } else if (i >= copier0 && j + 1 < B) {
      // while thread 0 applies the rule: row j + 1 into the slot that locus
      // j - 1 used
      float* dst = rows + ((j + 1) & 1) * W;
      const float* src = pkv + (size_t)(j + 1) * W;
      for (int idx = i - copier0; idx < W; idx += blockDim.x - copier0)
        __pipeline_memcpy_async(dst + idx, src + idx, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    g = gnext;
  }
  if (i < B) o.u[(size_t)v * B + i] = us[i];
}

template <int R>
int launch(const void* gram, const void* pk, const Outs& o, long long V, long long B, long long A,
           long long K, void* stream) {
  const int threads = (int)((B + 31) / 32) * 32;
  const long long AK = A * K;
  const long long W = 8 + (R == kRCpi ? 8 : 6) * AK;
  const size_t smem = sizeof(float) * (size_t)(B + 36 + AK + A + 2 * W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rc_scan_v_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rc_scan_v_kernel<R><<<(unsigned)V, threads, smem, (cudaStream_t)stream>>>(
      (const float*)gram, (const float*)pk, o, (int)V, (int)B, (int)A, (int)K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gram: (B, V, B) f32 (already offset to step t); pk: (V, B, 8 + 8AK) f32;
// beta, u: (V, B) f32; delta, acat: (V, B) int32; aprob: (V, B, A) f32.
// 1 <= B <= 1024.
int ngt_rcpi_block_scan_v(const void* gram, const void* pk, void* beta, void* u, void* delta,
                          void* acat, void* aprob, long long V, long long B, long long A,
                          long long K, void* stream) {
  const Outs o{(float*)beta, (float*)u, (int*)delta, (int*)acat, (float*)aprob, nullptr};
  return launch<kRCpi>(gram, pk, o, V, B, A, K, stream);
}

// pk: (V, B, 8 + 6AK) f32; beta, u: (V, B) f32; delta: (V, B) int32; cls, nz:
// (V, B, A) int32; bs: (V, B, A) f32.
int ngt_rcplus_block_scan_v(const void* gram, const void* pk, void* beta, void* u, void* delta,
                            void* cls, void* bs, void* nz, long long V, long long B, long long A,
                            long long K, void* stream) {
  const Outs o{(float*)beta, (float*)u, (int*)delta, (int*)cls, (float*)bs, (int*)nz};
  return launch<kRCplus>(gram, pk, o, V, B, A, K, stream);
}

}  // extern "C"
