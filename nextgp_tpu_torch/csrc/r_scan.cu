// V-batched BayesR in-block scan for Hopper (sm_90a), K3.
//
// Replaces the Pallas kernel `_make_r_kernel_v(K)` behind
// `gibbs_kernels.r_block_scan_v` (nextgp_tpu/ops/gibbs_kernels.py:472-521,
// called through `_call_v` / `_pallas_step_call`, :293-364). V=1 is the
// single-chain `r_block_scan` (K4, `_make_r_kernel`, :209-267).
//
// V independent chains of B sequential loci. For locus j of chain v:
//   pre   = s0 + sum_{i<j} G[j, v, i] * u_v[i]
//   logl  = q0 + q1 * pre^2                (K classes), softmax
//   cls   = #{k : cdf_k < unif}, clamped to K-1
//   beta  = c[cls] + b[cls] * pre,  u_v[j] = beta_old - beta
//   delta = mask ? cls + 1 : 0
// with the per-locus coefficient row s = pk[v, j, :] laid out as
// [adj, bold, unif, mask, pad*4 | q0(K), q1(K), b(K), c(K)]
// (gibbs_kernels.r_block_pack). The caller has already added r0 to slot 0.
// This is K12's rule with one annotation.
//
// Bound: latency, as for every scan: the skeleton (csrc/scan_skeleton.cuh)
// keeps one block per chain, right-looking sums, a warp per group of 32 loci
// and one barrier per group. The rule, by K:
//  * K <= kLaneMaxK: in every lane's registers, K known at compile time. The
//    warp that runs a group has copied the group's whole rows (32 * (8 + 4K)
//    floats, contiguous in pk) into one of two shared-memory slots with
//    cp.async while the group before it ran; after the one shuffle of pre
//    every lane reads the locus's row as broadcast words and applies the rule
//    alone: K FMAs, a maximum tree, K independent expf, the K - 1 running
//    sums, and the class as the first k with cum_k >= u * total (the running
//    sums never fall, so that is #{k : cum_k < u * total}) by a chain of
//    selects. No cross-lane step, and every lane holds u_v[j].
//  * K > kLaneMaxK: lane 0 applies the rule serially to the row, which the
//    warp copies into one of two shared-memory slots with cp.async one locus
//    ahead; shared memory then holds two rows and K words of scratch. No
//    path of the package runs such a K (BayesR's classes are four); it is
//    here so that any K the JAX package takes runs on the card.
// A product `cum < u * total` replaces the plain version's `cum / total < u`:
// a draw can differ only where a uniform lies within rounding of a CDF edge.
// Coefficients are staged per group or per locus, so no chain's rows need fit
// shared memory, and K has no cap.
#include <math.h>

#include "scan_skeleton.cuh"

namespace {

using ngt::scan::kFull;

constexpr int kLaneMaxK = 8;  // the largest K whose rule runs in one lane's registers

struct RParams {
  const float* pk;  // (V, B, 8 + 4K)
  float* beta;      // (V, B)
  float* u;         // (V, B)
  int* delta;       // (V, B)
  int K;
  bool wide;  // pk is 16-byte aligned
};

// What every form shares: the thread's own slot 0, its outputs, the writes.
struct RBase {
  static constexpr int kGrams = 1;
  using Params = RParams;

  Params p;
  const float* pkv;
  float* sm;
  int v, B, W;
  float s0;
  float beta = 0.f, uo = 0.f;
  int delta = 0;

  __device__ __forceinline__ RBase(const Params& prm, float* smem, int v_, int B_, int i)
      : p(prm), sm(smem), v(v_), B(B_) {
    W = 8 + 4 * p.K;
    pkv = p.pk + (size_t)v * B * W;
    s0 = i < B ? __ldg(pkv + (size_t)i * W) : 0.f;
  }

  __device__ __forceinline__ float start(int) const { return s0; }
  __device__ __forceinline__ float u() const { return uo; }

  __device__ __forceinline__ void keep(int lane, int jj, float bnew, float uj, int dj) {
    if (lane == jj) {
      beta = bnew;
      uo = uj;
      delta = dj;
    }
  }

  __device__ __forceinline__ void finish(int i) {
    const size_t at = (size_t)v * B + i;
    p.beta[at] = beta;
    p.u[at] = uo;
    p.delta[at] = delta;
  }
};

// The rule in every lane's registers, KC = K classes; the group's rows in
// one of two slots of 32 rows.
template <int KC>
struct RLane : RBase {
  using RBase::RBase;
  int slot = 0;  // of the group that runs

  __device__ __forceinline__ void stage(int slot, int j0, int lane) {
    const int nj = min(32, B - j0);
    ngt::scan::stage_words(sm + slot * 32 * W, pkv + (size_t)j0 * W, nj * W, p.wide, lane);
  }

  __device__ __forceinline__ void begin_group(int slot_, int, int, int) { slot = slot_; }

  __device__ __forceinline__ float locus(int, int jj, const float (&pre_g)[1], float, int lane) {
    const float* s = sm + (slot * 32 + jj) * W;
    const float pre = pre_g[0];
    const float pre2 = pre * pre;
    float t[KC], e[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      e[k] = fmaf(s[8 + KC + k], pre2, s[8 + k]);
      t[k] = e[k];
    }
#pragma unroll
    for (int step = 1; step < KC; step *= 2) {
#pragma unroll
      for (int k = 0; k + step < KC; k += 2 * step) t[k] = fmaxf(t[k], t[k + step]);
    }
    const float m = t[0];
    float cum[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float x = expf(e[k] - m);
      if (k == 0) {
        cum[0] = x;
      } else {
        cum[k] = cum[k - 1] + x;
      }
    }
    const float thr = s[2] * cum[KC - 1];
    int cls = KC - 1;
    float bnew = fmaf(s[8 + 2 * KC + KC - 1], pre, s[8 + 3 * KC + KC - 1]);
#pragma unroll
    for (int k = KC - 2; k >= 0; --k) {
      if (!(cum[k] < thr)) {
        cls = k;
        bnew = fmaf(s[8 + 2 * KC + k], pre, s[8 + 3 * KC + k]);
      }
    }
    const float uj = s[1] - bnew;
    keep(lane, jj, bnew, uj, s[3] != 0.f ? cls + 1 : 0);
    return uj;
  }
};

// The rule on lane 0 (K > kLaneMaxK), one row at a time through two slots,
// K words of scratch after them.
struct RSerial : RBase {
  using RBase::RBase;
  int nj = 0;

  __device__ __forceinline__ void stage(int, int, int) {}

  __device__ __forceinline__ void begin_group(int, int j0, int nj_, int lane) {
    nj = nj_;
    for (int idx = lane; idx < W; idx += 32)
      __pipeline_memcpy_async(sm + idx, pkv + (size_t)j0 * W + idx, 4);
    __pipeline_commit();
  }

  __device__ __forceinline__ float locus(int j0, int jj, const float (&pre_g)[1], float, int lane) {
    const int K = p.K;
    // row j has arrived; row j + 1 goes into the other slot meanwhile
    __pipeline_wait_prior(0);
    __syncwarp();
    const float* s = sm + (jj & 1) * W;
    if (jj + 1 < nj) {
      float* dst = sm + ((jj + 1) & 1) * W;
      for (int idx = lane; idx < W; idx += 32)
        __pipeline_memcpy_async(dst + idx, pkv + (size_t)(j0 + jj + 1) * W + idx, 4);
    }
    __pipeline_commit();
    float bnew = 0.f, uj = 0.f;
    int dj = 0;
    if (lane == 0) {
      float* e = sm + 2 * W;
      const float pre = pre_g[0];
      const float pre2 = pre * pre;
      float m = -INFINITY;
      for (int k = 0; k < K; ++k) {
        e[k] = fmaf(s[8 + K + k], pre2, s[8 + k]);
        m = fmaxf(m, e[k]);
      }
      float tot = 0.f;
      for (int k = 0; k < K; ++k) {
        e[k] = expf(e[k] - m);
        tot += e[k];
      }
      const float thr = s[2] * tot;
      int cls = 0;
      float cum = 0.f;
      for (int k = 0; k < K; ++k) {
        cum += e[k];
        cls += (cum < thr) ? 1 : 0;
      }
      cls = min(cls, K - 1);
      bnew = fmaf(s[8 + 2 * K + cls], pre, s[8 + 3 * K + cls]);
      uj = s[1] - bnew;
      dj = s[3] != 0.f ? cls + 1 : 0;
    }
    bnew = __shfl_sync(kFull, bnew, 0);
    uj = __shfl_sync(kFull, uj, 0);
    dj = __shfl_sync(kFull, dj, 0);
    keep(lane, jj, bnew, uj, dj);
    return uj;
  }
};

template <class Rule>
int launch(const void* gram, const RParams& prm, long long V, long long B, size_t rule_words,
           void* stream) {
  return ngt::scan::launch<Rule>(gram, nullptr, prm, V, B, rule_words, stream);
}

}  // namespace

extern "C" {

// gram: (B, V, B) f32 (already offset to step t), pk: (V, B, 8 + 4K) f32;
// beta, u: (V, B) f32; delta: (V, B) int32. 1 <= B <= 1024, K >= 1.
// gibbs_kernels.r_scan_smem_bytes states the shared memory each form takes.
int ngt_r_block_scan_v(const void* gram, const void* pk, void* beta, void* u, void* delta,
                       long long V, long long B, long long K, void* stream) {
  const RParams prm{(const float*)pk, (float*)beta, (float*)u, (int*)delta, (int)K,
                   (reinterpret_cast<uintptr_t>(pk) & 15) == 0};
  const long long W = 8 + 4 * K;
  const size_t staged = (size_t)(2 * 32 * W);
  switch (K <= kLaneMaxK ? K : 0) {
    case 1: return launch<RLane<1>>(gram, prm, V, B, staged, stream);
    case 2: return launch<RLane<2>>(gram, prm, V, B, staged, stream);
    case 3: return launch<RLane<3>>(gram, prm, V, B, staged, stream);
    case 4: return launch<RLane<4>>(gram, prm, V, B, staged, stream);
    case 5: return launch<RLane<5>>(gram, prm, V, B, staged, stream);
    case 6: return launch<RLane<6>>(gram, prm, V, B, staged, stream);
    case 7: return launch<RLane<7>>(gram, prm, V, B, staged, stream);
    case 8: return launch<RLane<8>>(gram, prm, V, B, staged, stream);
    default: return launch<RSerial>(gram, prm, V, B, (size_t)(2 * W + K), stream);
  }
}

}  // extern "C"
