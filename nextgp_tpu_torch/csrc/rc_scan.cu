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
// then per-annotation sections in which each value is repeated K times, then
// (A, K) sections; slot a*K + k of a section belongs to annotation a and
// class k.
//
//   rcpi (8 + 8AK): [adj, bold, ua, uv, mask, pad*3 | aprob, g1, g2, anz | q0, q1, b, c]
//     pre   = s0 + sum_{i<j} G[j, v, i] * u_v[i]
//     e_ak  = anz_a ? exp(q0_ak + q1_ak * pre^2 - max over all a, k) : 0
//     a_sel = #{a : cdf_a < ua} over aprob_a * sum_k e_ak, clamped to A-1
//     cls   = #{k : cdf_k < uv} over e[a_sel, :], clamped to K-1
//     beta  = c[a_sel, cls] + b[a_sel, cls] * pre
//     aprob'_a = gam_a / sum(gam), gam_a = (a == a_sel ? g2_a : g1_a) * anz_a
//     delta = cls + 1, acat = a_sel + 1; on a padded locus (mask = 0) both
//     are 0 and aprob' = aprob
//   rcplus (8 + 6AK): [adj, bold, mask, pad*5 | ua, anz | q0, q1, b, c]
//     base = s0 + sum_{i<j} G[j, v, i] * u_v[i]  (own coefficient excluded)
//     for a in 0..A-1, with ujc = bold at first:
//       pre_a = base + G[j, v, j] * ujc
//       cls_a = #{k : cdf_k < ua_a} over softmax_k(q0_ak + q1_ak * pre_a^2)
//       bs_a  = c[a, cls_a] + b[a, cls_a] * pre_a;  ujc -= bs_a
//     beta = sum_a bs_a, u_v[j] = ujc, delta = cls + 1 of the last active a,
//     and per annotation cls (0 where inactive), bs, nz = b[a, cls_a] > 0
// and for rcpi u_v[j] = bold - beta. The caller has added r0 to slot 0.
//
// The annotation draw is clamped to A-1 as the class draw is (the JAX pure
// path clamps both, nextgp_tpu/ops/dists.py:86-98; its TPU kernel clamps only
// the class).
//
// NaN on purpose: a padded locus has no non-zero annotation, so its sums are
// 0 and every probability of it 0/0. Every comparison made for it is false
// (a_sel = cls = 0), b = c = 0 there and pre is finite, so beta = 0; the
// outputs are chosen by selects on the mask, never by multiplying with it
// (NaN * 0 = NaN). So the comparisons must stay IEEE: no fast-math.
//
// Bound: latency, as for every scan (csrc/scan_skeleton.cuh: one block per
// chain, right-looking sums, a warp per group of 32 loci, one barrier per
// group, outputs written once by each locus's owner). The rules:
//  * The rule on the warp (A * K <= 32), one lane per (annotation, class):
//    each lane forms its own q0 + q1 * pre^2, the maximum is one integer
//    `redux` on an order-preserving image of the floats, one expf per lane,
//    the class sums a segmented shuffle scan over K lanes, the annotation
//    sums a scan with stride K, and both inverse CDFs a ballot and a
//    popcount of `cum < u * total` (a product where the kernel before divided
//    per class; a padded locus gives 0 < 0, false, as 0/0 < u was). rcplus's A
//    components stay sequential, as the method has them; each takes the lanes
//    of its annotation. A group's coefficients (six words per lane and locus,
//    a per-annotation value from its first copy at slot a * K) are copied into
//    one of two shared-memory slots with cp.async by the warp that will run
//    the group, while the group before it runs: the rule reads them at
//    shared-memory latency, its loop holds no address arithmetic for device
//    memory, and no coefficient row is held whole.
//  * A * K > 32: lane 0 applies the rule serially to the row, which the warp
//    copies into one of two shared-memory slots with cp.async one locus ahead;
//    shared memory then needs two rows and the scratch.
//  * rcpi's new annotation probabilities are formed by each locus's owner at
//    the end, off the chain. rcplus's three per-annotation outputs go out from
//    A lanes at once.
#include <math.h>

#include "scan_skeleton.cuh"

namespace {

using ngt::scan::kFull;
using ngt::scan::scan_up;
using ngt::scan::warp_max;

enum Rule { kRCpi = 0, kRCplus = 1 };

struct Outs {
  float* beta;  // (V, B)
  float* u;     // (V, B)
  int* delta;   // (V, B)
  int* ia;      // rcpi: acat (V, B);     rcplus: cls (V, B, A)
  float* fa;    // rcpi: aprob (V, B, A); rcplus: bs (V, B, A)
  int* ib;      // rcplus: nz (V, B, A)
};

// What the owner of a locus keeps until the end of the kernel.
struct Mine {
  float beta, u;
  int delta, a_sel;
};

// A lane's share of one coefficient row: the slot `lane` = a * K + k of each
// (A, K) section the rule reads, and its annotation's x0 (aprob for rcpi, ua
// for rcplus) and non-zero flag nz. A per-annotation value is read at slot
// a * K, its first copy, as the row's layout has it.
struct Coef {
  float x0, nz, q0, q1, b, c;
};
constexpr int kCoefWords = 6 * 32;           // one locus's Coefs, lane-major per field
constexpr int kCoefGroup = 32 * kCoefWords;  // a group's

// Copy the Coefs of the loci j0 .. j0 + 31 into buf with cp.async; each lane
// copies the words it will read itself, so once it has waited for its own
// copies it needs no barrier. The caller commits and waits.
template <int R>
__device__ __forceinline__ void stage_coefs(const float* __restrict__ pkv, float* buf, int j0,
                                            int B, int W, int AK, int K, int lane) {
  if (lane >= AK) return;
  const int first = lane / K * K;
  const int nz_at = (R == kRCpi ? 3 : 1) * AK + first;
  const int cls_at = (R == kRCpi ? 4 : 2) * AK + lane;
  const int nj = min(32, B - j0);
  for (int jj = 0; jj < nj; ++jj) {
    const float* s = pkv + (size_t)(j0 + jj) * W + 8;
    float* d = buf + jj * kCoefWords + lane;
    __pipeline_memcpy_async(d, s + first, 4);
    __pipeline_memcpy_async(d + 32, s + nz_at, 4);
    __pipeline_memcpy_async(d + 64, s + cls_at, 4);
    __pipeline_memcpy_async(d + 96, s + cls_at + AK, 4);
    __pipeline_memcpy_async(d + 128, s + cls_at + 2 * AK, 4);
    __pipeline_memcpy_async(d + 160, s + cls_at + 3 * AK, 4);
  }
}

__device__ __forceinline__ Coef read_coef(const float* buf, int jj, int AK, int lane) {
  Coef r{0.f, 0.f, -INFINITY, 0.f, 0.f, 0.f};  // a lane past A * K takes no part
  if (lane < AK) {
    const float* d = buf + jj * kCoefWords + lane;
    r.x0 = d[0];
    r.nz = d[32];
    r.q0 = d[64];
    r.q1 = d[96];
    r.b = d[128];
    r.c = d[160];
  }
  return r;
}

// The lanes' positions in the (annotation, class) grid of one warp.
struct Grid {
  int a, k;
  bool valid;
};

// One BayesRCpi locus on the warp. Returns beta to every lane.
__device__ __forceinline__ float rcpi_warp(const Coef& s, const Grid& g, int lane, float pre,
                                           float ua, float uv, int A, int K, int* a_sel_out,
                                           int* cls_out) {
  const int AK = A * K;
  const float e = fmaf(s.q1, pre * pre, s.q0);
  const float bl = fmaf(s.b, pre, s.c);
  const float m = warp_max(e);
  const float x = (s.nz != 0.f) ? expf(e - m) : 0.f;
  const float cum = scan_up(x, 1, K, g.k);  // within the annotation
  const float rs = __shfl_sync(kFull, cum, g.valid ? g.a * K + K - 1 : lane);
  const float wcum = scan_up(s.x0 * rs, K, AK, lane);  // over the annotations
  const float wsum = __shfl_sync(kFull, wcum, AK - 1);
  const unsigned ba = __ballot_sync(kFull, g.valid && g.k == 0 && wcum < ua * wsum);
  const unsigned bc = __ballot_sync(kFull, g.valid && cum < uv * rs);
  const int a_sel = min(__popc(ba), A - 1);
  const unsigned seg = K == 32 ? kFull : ((1u << K) - 1u);
  const int cls = min(__popc((bc >> (a_sel * K)) & seg), K - 1);
  *a_sel_out = a_sel;
  *cls_out = cls;
  return __shfl_sync(kFull, bl, a_sel * K + cls);
}

// One BayesRCplus locus on the warp: the A components in turn, each on the
// lanes of its annotation. Lane a keeps component a's outputs and lanes < A
// write them. Returns beta; *u_j is the locus's u.
__device__ __forceinline__ float rcplus_warp(const Coef& s, const Grid& g, int lane, float base,
                                             float gjj, float bold, bool on, int A, int K,
                                             size_t at, const Outs& o, float* u_j, int* delta) {
  const unsigned act = __ballot_sync(kFull, g.valid && g.k == 0 && s.nz != 0.f);
  float ujc = bold, total = 0.f, my_bs = 0.f;
  int dj = 0, my_cls = 0, my_nz = 0;
  for (int a = 0; a < A; ++a) {
    const int first = a * K;
    const bool mine = g.valid && g.a == a;
    const float prea = fmaf(gjj, ujc, base);
    const float e = mine ? fmaf(s.q1, prea * prea, s.q0) : -INFINITY;
    const float bl = fmaf(s.b, prea, s.c);
    const float m = warp_max(e);
    const float x = mine ? expf(e - m) : 0.f;
    const float cum = scan_up(x, 1, K, g.k);
    const float tot = __shfl_sync(kFull, cum, first + K - 1);
    const int cls = min(__popc(__ballot_sync(kFull, mine && cum < s.x0 * tot)), K - 1);
    const float bs = __shfl_sync(kFull, bl, first + cls);
    const float bsel = __shfl_sync(kFull, s.b, first + cls);  // 0: null class or inactive
    const bool active = on && ((act >> first) & 1u);
    ujc -= bs;
    total += bs;
    if (active) dj = cls + 1;
    if (lane == a) {
      my_cls = active ? cls + 1 : 0;
      my_bs = bs;
      my_nz = (bsel > 0.f) ? 1 : 0;
    }
  }
  if (lane < A) {
    o.ia[at * A + lane] = my_cls;
    o.fa[at * A + lane] = my_bs;
    o.ib[at * A + lane] = my_nz;
  }
  *u_j = ujc;
  *delta = dj;
  return total;
}

// One BayesRCpi locus on one thread (A * K > 32), from the row s in shared
// memory. e (AK) and rowsum (A) are shared-memory scratch. Returns beta.
__device__ __forceinline__ float rcpi_serial(const float* s, float pre, int A, int K, float* e,
                                             float* rowsum, int* a_sel_out, int* cls_out) {
  const int AK = A * K;
  const float* aprob = s + 8;
  const float* anz = aprob + 3 * AK;
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
    cum += aprob[a * K] * rowsum[a];
    a_sel += (cum < s[2] * wsum) ? 1 : 0;
  }
  a_sel = min(a_sel, A - 1);
  const float rs = rowsum[a_sel];
  int cls = 0;
  cum = 0.f;
  for (int k = 0; k < K; ++k) {
    cum += e[a_sel * K + k];
    cls += (cum < s[3] * rs) ? 1 : 0;
  }
  cls = min(cls, K - 1);
  *a_sel_out = a_sel;
  *cls_out = cls;
  const int idx = a_sel * K + cls;
  return cco[idx] + bco[idx] * pre;
}

// One BayesRCplus locus on one thread (A * K > 32). e (K) is shared-memory
// scratch; gjj the Gram diagonal of the locus. Returns beta.
__device__ __forceinline__ float rcplus_serial(const float* s, float base, float gjj, int A, int K,
                                               float* e, size_t at, const Outs& o, float* u_j,
                                               int* delta) {
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
    const float prea = fmaf(gjj, ujc, base);
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
      cum += e[k];
      cls += (cum < ua[r] * tot) ? 1 : 0;
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
  *delta = dj;
  *u_j = ujc;
  return total;
}

// rcpi's new annotation probabilities of one locus, by the thread that owns
// it, from its row in device memory.
__device__ __forceinline__ void rcpi_aprob(const float* __restrict__ s, int A, int K, int a_sel,
                                           float* __restrict__ out) {
  const int AK = A * K;
  const float* aprob = s + 8;
  const float* g1 = aprob + AK;
  const float* g2 = g1 + AK;
  const float* anz = g2 + AK;
  if (s[4] == 0.f) {
    for (int a = 0; a < A; ++a) out[a] = aprob[a * K];
    return;
  }
  float gsum = 0.f;
  for (int a = 0; a < A; ++a) gsum += ((a == a_sel) ? g2[a * K] : g1[a * K]) * anz[a * K];
  for (int a = 0; a < A; ++a) out[a] = ((a == a_sel) ? g2[a * K] : g1[a * K]) * anz[a * K] / gsum;
}

// The rules of K12 and K14 on the scan skeleton (csrc/scan_skeleton.cuh).
// head (bold, ua, uv, mask) is the head of the thread's own row; the rule's
// shared memory is two groups' staged Coefs (A * K <= 32) or the serial
// rule's scratch and two rows (A * K > 32).
template <int R>
struct RcRule {
  static constexpr int kGrams = 1;
  struct Params {
    const float* pk;  // (V, B, W)
    Outs o;
    int A, K;
  };

  const float* pkv;
  Outs o;
  float* sm;
  const float* coefs = nullptr;  // the staged Coefs of the locus that runs next
  int v, B, A, K, AK, W;
  bool on_warp;
  Grid g;
  float s0;
  float4 head;  // bold, ua, uv, mask of the thread's locus
  Mine mine;

  __device__ __forceinline__ RcRule(const Params& p, float* smem, int v_, int B_, int i)
      : o(p.o), sm(smem), v(v_), B(B_), A(p.A), K(p.K) {
    AK = A * K;
    W = 8 + (R == kRCpi ? 8 : 6) * AK;
    on_warp = AK <= 32;
    const int lane = i & 31;
    g.valid = lane < AK;
    g.a = lane / K;
    g.k = lane - g.a * K;
    pkv = p.pk + (size_t)v * B * W;
    s0 = 0.f;
    head = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < B) {
      const float* s = pkv + (size_t)i * W;
      s0 = __ldg(s);
      head.x = __ldg(s + 1);
      if (R == kRCpi) {
        head.y = __ldg(s + 2);
        head.z = __ldg(s + 3);
        head.w = __ldg(s + 4);
      } else {
        head.w = __ldg(s + 2);
      }
    }
    mine = Mine{0.f, 0.f, 0, 0};
  }

  __device__ __forceinline__ float start(int) const { return s0; }

  __device__ __forceinline__ void stage(int slot, int j0, int lane) {
    if (on_warp) stage_coefs<R>(pkv, sm + slot * kCoefGroup, j0, B, W, AK, K, lane);
  }

  // the group's staged Coefs, or the serial rule's first row of the group
  __device__ __forceinline__ void begin_group(int slot, int j0, int, int lane) {
    coefs = sm + slot * kCoefGroup;
    if (!on_warp) {
      float* rows = sm + AK + A;
      for (int idx = lane; idx < W; idx += 32)
        __pipeline_memcpy_async(rows + idx, pkv + (size_t)j0 * W + idx, 4);
      __pipeline_commit();
    }
  }

  __device__ __forceinline__ float locus(int j0, int jj, const float (&pre_g)[1], float gjj,
                                         int lane) {
    const int j = j0 + jj;
    const size_t at = (size_t)v * B + j;
    const float pre = pre_g[0];
    const float bold = __shfl_sync(kFull, head.x, jj);
    const bool on = __shfl_sync(kFull, head.w, jj) != 0.f;
    float bnew = 0.f, uj = 0.f;
    int a_sel = 0, cls = 0, dj = 0;
    if (on_warp) {
      const Coef c0 = read_coef(coefs, 0, AK, lane);
      coefs += kCoefWords;
      if (R == kRCpi) {
        const float ua = __shfl_sync(kFull, head.y, jj);
        const float uv = __shfl_sync(kFull, head.z, jj);
        bnew = rcpi_warp(c0, g, lane, pre, ua, uv, A, K, &a_sel, &cls);
        uj = bold - bnew;
        dj = on ? cls + 1 : 0;
      } else {
        bnew = rcplus_warp(c0, g, lane, pre, gjj, bold, on, A, K, at, o, &uj, &dj);
      }
    } else {
      float* e = sm;             // AK
      float* rowsum = e + AK;    // A
      float* rows = rowsum + A;  // 2 * W
      // row j has arrived; row j + 1 goes into the other slot meanwhile
      __pipeline_wait_prior(0);
      __syncwarp();
      const float* s = rows + (jj & 1) * W;
      if (j + 1 < min(B, j0 + 32)) {
        float* dst = rows + ((jj + 1) & 1) * W;
        for (int idx = lane; idx < W; idx += 32)
          __pipeline_memcpy_async(dst + idx, pkv + (size_t)(j + 1) * W + idx, 4);
      }
      __pipeline_commit();
      if (lane == 0) {
        if (R == kRCpi) {
          bnew = rcpi_serial(s, pre, A, K, e, rowsum, &a_sel, &cls);
          uj = bold - bnew;
          dj = on ? cls + 1 : 0;
        } else {
          bnew = rcplus_serial(s, pre, gjj, A, K, e, at, o, &uj, &dj);
        }
      }
      bnew = __shfl_sync(kFull, bnew, 0);
      uj = __shfl_sync(kFull, uj, 0);
      dj = __shfl_sync(kFull, dj, 0);
      a_sel = __shfl_sync(kFull, a_sel, 0);
    }
    if (lane == jj) {
      mine.beta = bnew;
      mine.u = uj;
      mine.delta = dj;
      mine.a_sel = a_sel;
    }
    return uj;
  }

  __device__ __forceinline__ float u() const { return mine.u; }

  __device__ __forceinline__ void finish(int i) {
    const size_t at = (size_t)v * B + i;
    o.beta[at] = mine.beta;
    o.u[at] = mine.u;
    o.delta[at] = mine.delta;
    if (R == kRCpi) {
      o.ia[at] = head.w != 0.f ? mine.a_sel + 1 : 0;
      rcpi_aprob(pkv + (size_t)i * W, A, K, mine.a_sel, o.fa + at * A);
    }
  }
};

template <int R>
int launch(const void* gram, const void* pk, const Outs& o, long long V, long long B, long long A,
           long long K, void* stream) {
  const long long AK = A * K;
  const long long W = 8 + (R == kRCpi ? 8 : 6) * AK;
  // gibbs_kernels.rc_scan_smem_bytes is the skeleton's words and these
  const size_t rule_words = AK <= 32 ? (size_t)(2 * kCoefGroup) : (size_t)(AK + A + 2 * W);
  const typename RcRule<R>::Params prm{(const float*)pk, o, (int)A, (int)K};
  return ngt::scan::launch<RcRule<R>>(gram, nullptr, prm, V, B, rule_words, stream);
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
