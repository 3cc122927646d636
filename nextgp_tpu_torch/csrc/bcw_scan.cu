// V-batched weighted BayesB/C in-block scan for Hopper (sm_90a), K10.
//
// Replaces the Pallas kernel `_bc_kernel_wv` behind
// `gibbs_kernels.bc_block_scan_wv` (nextgp_tpu/ops/gibbs_kernels.py:428-469,
// called through `_pallas_step_call`, :293-355). V=1 is the single-chain
// `bc_block_scan_w` (K9, `_bc_kernel_w`, :167-203).
//
// V independent chains of B sequential loci, each with two dot products
// against the chain's u (u[j] is still 0 when locus j runs), one against the
// weighted Gram G and one against the raw Gram Graw, and the rule on its row
// s = pk[v, j, 0:8] = [adj, bold, q0, q1, w, b, c, adj_raw]
// (gibbs_kernels.bc_block_pack with mpm_raw):
//   pre  = s0 + sum_{i<j} G[j, v, i] u[i],  prer = s7 + sum_{i<j} Graw[j, v, i] u[i]
//   inc  = s2 + s3 * prer^2 < s4;  beta = inc ? s6 + s5 * pre : 0;  delta = inc
//   u[j] = s1 - beta
// The caller has added r0 to slot 0 and r0_raw to slot 7.
//
// Bound: latency, as for every scan: the skeleton (csrc/scan_skeleton.cuh)
// with two Grams, so each thread keeps two right-looking sums and the warp
// that runs a group reads two diagonal tiles. The rule is one compare and one
// select, so a locus's chain is the two shuffles of pre and prer and a few
// dependent FMAs. The warp that runs a group copies the group's 32 rows (one
// contiguous KB of pk) into one of two shared-memory slots with cp.async while
// the group before it runs; the rule reads them as broadcast words.
//
// Two tiles per warp held for the whole block would need 2 x 32 x 4,224 bytes
// at B = 1,024, more than a block's 227 KB: the skeleton's tiles rotate
// through two slots instead. The later threads prefetch 32 words of each Gram
// row per group (64 registers); at 1,024 threads, where a thread has 64, the
// compiler spills part of them (ptxas -v in _build/<hash>/ptxas.log).
//
// Padded loci carry q0 = +inf and a uniform at 0 gives w = +inf, so the
// comparison must stay IEEE: no fast-math.
#include "scan_skeleton.cuh"

namespace {

constexpr int kW = 8;  // coefficient row width

struct BcwParams {
  const float* pk;  // (V, B, 8)
  float* beta;      // (V, B)
  float* u;         // (V, B)
  int* delta;       // (V, B)
  bool wide;        // pk is 16-byte aligned
};

struct BcwRule {
  static constexpr int kGrams = 2;
  using Params = BcwParams;

  Params p;
  const float* pkv;
  float* sm;  // two slots of 32 rows
  int slot = 0;  // of the group that runs
  int v, B;
  float s0 = 0.f, s7 = 0.f;
  float beta = 0.f, uo = 0.f;
  int delta = 0;

  __device__ __forceinline__ BcwRule(const Params& prm, float* smem, int v_, int B_, int i)
      : p(prm), sm(smem), v(v_), B(B_) {
    pkv = p.pk + (size_t)v * B * kW;
    if (i < B) {
      s0 = __ldg(pkv + (size_t)i * kW);
      s7 = __ldg(pkv + (size_t)i * kW + 7);
    }
  }

  __device__ __forceinline__ float start(int g) const { return g == 0 ? s0 : s7; }
  __device__ __forceinline__ float u() const { return uo; }

  __device__ __forceinline__ void stage(int slot, int j0, int lane) {
    const int nj = min(32, B - j0);
    ngt::scan::stage_words(sm + slot * 32 * kW, pkv + (size_t)j0 * kW, nj * kW, p.wide, lane);
  }

  __device__ __forceinline__ void begin_group(int slot_, int, int, int) { slot = slot_; }

  __device__ __forceinline__ float locus(int, int jj, const float (&pre)[2], float, int lane) {
    const float* s = sm + (slot * 32 + jj) * kW;
    const float prer = pre[1];
    const bool inc = s[2] + s[3] * prer * prer < s[4];
    const float bnew = inc ? s[6] + s[5] * pre[0] : 0.f;
    const float uj = s[1] - bnew;
    if (lane == jj) {
      beta = bnew;
      uo = uj;
      delta = inc ? 1 : 0;
    }
    return uj;
  }

  __device__ __forceinline__ void finish(int i) {
    const size_t at = (size_t)v * B + i;
    p.beta[at] = beta;
    p.u[at] = uo;
    p.delta[at] = delta;
  }
};

}  // namespace

extern "C" {

// gram, graw: (B, V, B) f32 (already offset to step t); pk: (V, B, 8) f32;
// beta, u: (V, B) f32; delta: (V, B) int32. 1 <= B <= 1024 (shared memory:
// the skeleton's with two Grams and two groups' rows, 23 KB at B = 1,024).
int ngt_bc_block_scan_wv(const void* gram, const void* graw, const void* pk, void* beta, void* u,
                         void* delta, long long V, long long B, void* stream) {
  const BcwParams prm{(const float*)pk, (float*)beta, (float*)u, (int*)delta,
                      (reinterpret_cast<uintptr_t>(pk) & 15) == 0};
  return ngt::scan::launch<BcwRule>(gram, graw, prm, V, B, (size_t)(2 * 32 * kW), stream);
}

}  // extern "C"
