// V-batched Gaussian, BayesB/C and weighted BayesB/C in-block scans for
// Hopper (sm_90a): K6, K8 and K10, three rule classes on the scan skeleton
// (csrc/scan_skeleton.cuh).
//
// Replaces the Pallas kernels behind
//   K6   `gibbs_kernels.gauss_block_scan_v` (`_gauss_kernel_v`,
//        nextgp_tpu/ops/gibbs_kernels.py:367-393); V=1 is `gauss_block_scan`
//        (K5, `_gauss_kernel`, :80-109)
//   K8   `gibbs_kernels.bc_block_scan_v` (`_bc_kernel_v`, :396-425); V=1 is
//        `bc_block_scan` (K7, `_bc_kernel`, :115-164)
//   K10  `gibbs_kernels.bc_block_scan_wv` (`_bc_kernel_wv`, :428-469); V=1
//        is `bc_block_scan_w` (K9, `_bc_kernel_w`, :167-203)
// all called through `_pallas_step_call` (:293-355).
//
// V independent chains of B sequential loci. Locus j of chain v has the
// right-looking sums of the skeleton against the chain's u (u[j] is still 0
// when locus j runs),
//   pre  = s0 + sum_{i<j} G[j, v, i] u[i]
//   prer = s7 + sum_{i<j} Graw[j, v, i] u[i]     (K10 only: the raw Gram)
// and a rule on its coefficient row s = pk[v, j, 0:8]:
//   gauss  beta = s3 + s2 * pre
//   bc     inc = s2 + s3 * p^2 < s4;  beta = inc ? s6 + s5 * pre : 0;  delta = inc
//          with p = pre (K8) or prer (K10)
// and then u[j] = s1 - beta. Rows are laid out by
// gibbs_kernels.gauss_block_pack ([adj, bold, b, c, pad*4]) and
// bc_block_pack ([adj, bold, q0, q1, w, b, c, adj_raw]); the caller has added
// r0 to slot 0 and, for K10, r0_raw to slot 7.
//
// Bound: latency, as for every scan: the skeleton keeps one block per chain,
// right-looking sums in a register per thread (two for K10), a warp per
// group of 32 loci and one barrier per group, and each locus's outputs stay
// with the thread that owns it until one write at the end. The rules are an
// FMA (gauss) or a compare and a select (bc), so a locus's chain is the
// shuffle of pre (and prer) and a few dependent FMAs. The warp that runs a
// group copies the group's 32 rows (one contiguous KB of pk) into one of two
// shared-memory slots with cp.async while the group before it runs; the rule
// reads a locus's row as two broadcast 16-byte words. K8 and K10 are one
// rule, a template over the number of Grams.
//
// At 1,024 threads, where a thread has 64 registers, the compiler spills part
// of K10's two prefetched 32-word Gram rows (ptxas -v in
// _build/<hash>/ptxas.log); K6's and K8's one row fits.
//
// Padded loci carry q0 = +inf and a uniform at 0 gives w = +inf, so the
// comparison must stay IEEE: no fast-math.
#include "scan_skeleton.cuh"

namespace {

constexpr int kW = 8;  // coefficient row width

struct Params8 {
  const float* pk;  // (V, B, 8)
  float* beta;      // (V, B)
  float* u;         // (V, B)
  int* delta;       // (V, B); none for the Gaussian scan
  bool wide;        // pk is 16-byte aligned
};

// What the rules share: the thread's own offsets (slot 0, and slot 7 for the
// raw Gram), the group's rows in one of two slots of 32 rows, beta and u.
template <int G>
struct Rows8 {
  static constexpr int kGrams = G;
  using Params = Params8;

  Params p;
  const float* pkv;
  float* sm;     // two slots of 32 rows
  int slot = 0;  // of the group that runs
  int v, B;
  float s0 = 0.f, s7 = 0.f;
  float beta = 0.f, uo = 0.f;

  __device__ __forceinline__ Rows8(const Params& prm, float* smem, int v_, int B_, int i)
      : p(prm), sm(smem), v(v_), B(B_) {
    pkv = p.pk + (size_t)v * B * kW;
    if (i < B) {
      s0 = __ldg(pkv + (size_t)i * kW);
      if constexpr (G == 2) s7 = __ldg(pkv + (size_t)i * kW + 7);
    }
  }

  __device__ __forceinline__ float start(int g) const { return g == 0 ? s0 : s7; }
  __device__ __forceinline__ float u() const { return uo; }

  __device__ __forceinline__ void stage(int slot, int j0, int lane) {
    const int nj = min(32, B - j0);
    ngt::scan::stage_words(sm + slot * 32 * kW, pkv + (size_t)j0 * kW, nj * kW, p.wide, lane);
  }

  __device__ __forceinline__ void begin_group(int slot_, int, int, int) { slot = slot_; }

  // Locus jj's staged row as two 16-byte words, [adj, bold, s2, s3] and
  // [s4, s5, s6, adj_raw]: every word the rule may need is in a register
  // before the rule's compare, none is loaded behind it.
  __device__ __forceinline__ void row(int jj, float4& lo, float4& hi) const {
    const float4* s = reinterpret_cast<const float4*>(sm + (slot * 32 + jj) * kW);
    lo = s[0];
    hi = s[1];
  }

  __device__ __forceinline__ void write(int i) const {
    const size_t at = (size_t)v * B + i;
    p.beta[at] = beta;
    p.u[at] = uo;
  }
};

// K6: beta = c + b * pre.
struct GaussRule : Rows8<1> {
  using Rows8::Rows8;

  __device__ __forceinline__ float locus(int, int jj, const float (&pre)[1], float, int lane) {
    float4 lo, hi;
    row(jj, lo, hi);
    const float bnew = lo.w + lo.z * pre[0];
    const float uj = lo.y - bnew;
    if (lane == jj) {
      beta = bnew;
      uo = uj;
    }
    return uj;
  }

  __device__ __forceinline__ void finish(int i) const { write(i); }
};

// K8 (G = 1) and K10 (G = 2, the indicator from the raw Gram's sum).
template <int G>
struct BcRule : Rows8<G> {
  using Rows8<G>::Rows8;
  int delta = 0;

  __device__ __forceinline__ float locus(int, int jj, const float (&pre)[G], float, int lane) {
    float4 lo, hi;
    this->row(jj, lo, hi);
    const float prer = pre[G - 1];
    const bool inc = lo.z + lo.w * prer * prer < hi.x;
    const float bnew = inc ? hi.z + hi.y * pre[0] : 0.f;
    const float uj = lo.y - bnew;
    if (lane == jj) {
      this->beta = bnew;
      this->uo = uj;
      delta = inc ? 1 : 0;
    }
    return uj;
  }

  __device__ __forceinline__ void finish(int i) const {
    this->write(i);
    this->p.delta[(size_t)this->v * this->B + i] = delta;
  }
};

template <class Rule>
int launch(const void* gram, const void* graw, const void* pk, void* beta, void* u, void* delta,
           long long V, long long B, void* stream) {
  const Params8 prm{(const float*)pk, (float*)beta, (float*)u, (int*)delta,
                    (reinterpret_cast<uintptr_t>(pk) & 15) == 0};
  return ngt::scan::launch<Rule>(gram, graw, prm, V, B, (size_t)(2 * 32 * kW), stream);
}

}  // namespace

extern "C" {

// gram, graw: (B, V, B) f32 (already offset to step t); pk: (V, B, 8) f32;
// beta, u: (V, B) f32; delta: (V, B) int32. 1 <= B <= 1024 (shared memory:
// the skeleton's and two groups' rows, 15 KB at B = 1,024 with one Gram and
// 23 KB with two).
int ngt_gauss_block_scan_v(const void* gram, const void* pk, void* beta, void* u, long long V,
                           long long B, void* stream) {
  return launch<GaussRule>(gram, nullptr, pk, beta, u, nullptr, V, B, stream);
}

int ngt_bc_block_scan_v(const void* gram, const void* pk, void* beta, void* u, void* delta,
                        long long V, long long B, void* stream) {
  return launch<BcRule<1>>(gram, nullptr, pk, beta, u, delta, V, B, stream);
}

int ngt_bc_block_scan_wv(const void* gram, const void* graw, const void* pk, void* beta, void* u,
                         void* delta, long long V, long long B, void* stream) {
  return launch<BcRule<2>>(gram, graw, pk, beta, u, delta, V, B, stream);
}

}  // extern "C"
