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
//
// Float64 (`ngt_rcpi_block_scan_v_f64`, `ngt_rcplus_block_scan_v_f64`): the
// same rules and skeleton on double Grams, rows, beta, u, aprob and bs
// (delta, acat, cls and nz stay int32), one body templated on the element
// type (exp, fma, fmax; no fast math). The warp's maximum is a butterfly of
// fmax over __shfl_xor_sync (scan_skeleton.cuh's warp_max), as `redux` has
// no 64-bit form; a maximum is exact in any order, so the draws stay
// deterministic. The staged coefficients (six a lane and locus), the serial
// rule's scratch and rows take twice the bytes: 123,392 at B = 1,024 with the
// rule on a warp (gibbs_kernels.rc_scan_smem_bytes).
#include <math.h>

#include "scan_skeleton.cuh"

namespace {

using ngt::mad;
using ngt::scan::kFull;
using ngt::scan::scan_up;
using ngt::scan::warp_max;

enum Rule { kRCpi = 0, kRCplus = 1 };

__device__ __forceinline__ float expof(float x) { return expf(x); }
__device__ __forceinline__ double expof(double x) { return exp(x); }
__device__ __forceinline__ float maxof(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double maxof(double a, double b) { return fmax(a, b); }

// T: float or double, the type of the Gram, the rows and the real outputs.
template <typename T>
struct Outs {
  T* beta;    // (V, B)
  T* u;       // (V, B)
  int* delta;  // (V, B)
  int* ia;     // rcpi: acat (V, B);     rcplus: cls (V, B, A)
  T* fa;       // rcpi: aprob (V, B, A); rcplus: bs (V, B, A)
  int* ib;     // rcplus: nz (V, B, A)
};

// What the owner of a locus keeps until the end of the kernel.
template <typename T>
struct Mine {
  T beta, u;
  int delta, a_sel;
};

// A lane's share of one coefficient row: the slot `lane` = a * K + k of each
// (A, K) section the rule reads, and its annotation's x0 (aprob for rcpi, ua
// for rcplus) and non-zero flag nz. A per-annotation value is read at slot
// a * K, its first copy, as the row's layout has it.
template <typename T>
struct Coef {
  T x0, nz, q0, q1, b, c;
};
constexpr int kCoefWords = 6 * 32;           // one locus's Coefs, lane-major per field (elements)
constexpr int kCoefGroup = 32 * kCoefWords;  // a group's

// Copy the Coefs of the loci j0 .. j0 + 31 into buf with cp.async; each lane
// copies the elements it will read itself, so once it has waited for its own
// copies it needs no barrier. The caller commits and waits.
template <int R, typename T>
__device__ __forceinline__ void stage_coefs(const T* __restrict__ pkv, T* buf, int j0, int B, int W,
                                            int AK, int K, int lane) {
  if (lane >= AK) return;
  const int first = lane / K * K;
  const int nz_at = (R == kRCpi ? 3 : 1) * AK + first;
  const int cls_at = (R == kRCpi ? 4 : 2) * AK + lane;
  const int nj = min(32, B - j0);
  for (int jj = 0; jj < nj; ++jj) {
    const T* s = pkv + (size_t)(j0 + jj) * W + 8;
    T* d = buf + jj * kCoefWords + lane;
    __pipeline_memcpy_async(d, s + first, sizeof(T));
    __pipeline_memcpy_async(d + 32, s + nz_at, sizeof(T));
    __pipeline_memcpy_async(d + 64, s + cls_at, sizeof(T));
    __pipeline_memcpy_async(d + 96, s + cls_at + AK, sizeof(T));
    __pipeline_memcpy_async(d + 128, s + cls_at + 2 * AK, sizeof(T));
    __pipeline_memcpy_async(d + 160, s + cls_at + 3 * AK, sizeof(T));
  }
}

template <typename T>
__device__ __forceinline__ Coef<T> read_coef(const T* buf, int jj, int AK, int lane) {
  Coef<T> r{T(0), T(0), T(-INFINITY), T(0), T(0), T(0)};  // a lane past A * K takes no part
  if (lane < AK) {
    const T* d = buf + jj * kCoefWords + lane;
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
template <typename T>
__device__ __forceinline__ T rcpi_warp(const Coef<T>& s, const Grid& g, int lane, T pre, T ua, T uv,
                                       int A, int K, int* a_sel_out, int* cls_out) {
  const int AK = A * K;
  const T e = mad(s.q1, pre * pre, s.q0);
  const T bl = mad(s.b, pre, s.c);
  const T m = warp_max(e);
  const T x = (s.nz != T(0)) ? expof(e - m) : T(0);
  const T cum = scan_up(x, 1, K, g.k);  // within the annotation
  const T rs = __shfl_sync(kFull, cum, g.valid ? g.a * K + K - 1 : lane);
  const T wcum = scan_up(s.x0 * rs, K, AK, lane);  // over the annotations
  const T wsum = __shfl_sync(kFull, wcum, AK - 1);
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
template <typename T>
__device__ __forceinline__ T rcplus_warp(const Coef<T>& s, const Grid& g, int lane, T base, T gjj,
                                         T bold, bool on, int A, int K, size_t at, const Outs<T>& o,
                                         T* u_j, int* delta) {
  const unsigned act = __ballot_sync(kFull, g.valid && g.k == 0 && s.nz != T(0));
  T ujc = bold, total = T(0), my_bs = T(0);
  int dj = 0, my_cls = 0, my_nz = 0;
  for (int a = 0; a < A; ++a) {
    const int first = a * K;
    const bool mine = g.valid && g.a == a;
    const T prea = mad(gjj, ujc, base);
    const T e = mine ? mad(s.q1, prea * prea, s.q0) : T(-INFINITY);
    const T bl = mad(s.b, prea, s.c);
    const T m = warp_max(e);
    const T x = mine ? expof(e - m) : T(0);
    const T cum = scan_up(x, 1, K, g.k);
    const T tot = __shfl_sync(kFull, cum, first + K - 1);
    const int cls = min(__popc(__ballot_sync(kFull, mine && cum < s.x0 * tot)), K - 1);
    const T bs = __shfl_sync(kFull, bl, first + cls);
    const T bsel = __shfl_sync(kFull, s.b, first + cls);  // 0: null class or inactive
    const bool active = on && ((act >> first) & 1u);
    ujc -= bs;
    total += bs;
    if (active) dj = cls + 1;
    if (lane == a) {
      my_cls = active ? cls + 1 : 0;
      my_bs = bs;
      my_nz = (bsel > T(0)) ? 1 : 0;
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
template <typename T>
__device__ __forceinline__ T rcpi_serial(const T* s, T pre, int A, int K, T* e, T* rowsum,
                                         int* a_sel_out, int* cls_out) {
  const int AK = A * K;
  const T* aprob = s + 8;
  const T* anz = aprob + 3 * AK;
  const T* q0 = anz + AK;
  const T* q1 = q0 + AK;
  const T* bco = q1 + AK;
  const T* cco = bco + AK;
  const T pre2 = pre * pre;
  T m = T(-INFINITY);
  for (int i = 0; i < AK; ++i) {
    e[i] = q0[i] + q1[i] * pre2;
    m = maxof(m, e[i]);
  }
  T wsum = T(0);
  for (int a = 0; a < A; ++a) {
    const bool nz = anz[a * K] != T(0);
    T rs = T(0);
    for (int k = 0; k < K; ++k) {
      const T x = nz ? expof(e[a * K + k] - m) : T(0);
      e[a * K + k] = x;
      rs += x;
    }
    rowsum[a] = rs;
    wsum += aprob[a * K] * rs;
  }
  int a_sel = 0;
  T cum = T(0);
  for (int a = 0; a < A; ++a) {
    cum += aprob[a * K] * rowsum[a];
    a_sel += (cum < s[2] * wsum) ? 1 : 0;
  }
  a_sel = min(a_sel, A - 1);
  const T rs = rowsum[a_sel];
  int cls = 0;
  cum = T(0);
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
template <typename T>
__device__ __forceinline__ T rcplus_serial(const T* s, T base, T gjj, int A, int K, T* e, size_t at,
                                           const Outs<T>& o, T* u_j, int* delta) {
  const int AK = A * K;
  const T* ua = s + 8;
  const T* anz = ua + AK;
  const T* q0 = anz + AK;
  const T* q1 = q0 + AK;
  const T* bco = q1 + AK;
  const T* cco = bco + AK;
  const bool on = s[2] != T(0);
  T ujc = s[1];
  T total = T(0);
  int dj = 0;
  for (int a = 0; a < A; ++a) {
    const int r = a * K;
    const T prea = mad(gjj, ujc, base);
    const T pre2 = prea * prea;
    T m = T(-INFINITY);
    for (int k = 0; k < K; ++k) {
      e[k] = q0[r + k] + q1[r + k] * pre2;
      m = maxof(m, e[k]);
    }
    T tot = T(0);
    for (int k = 0; k < K; ++k) {
      e[k] = expof(e[k] - m);
      tot += e[k];
    }
    int cls = 0;
    T cum = T(0);
    for (int k = 0; k < K; ++k) {
      cum += e[k];
      cls += (cum < ua[r] * tot) ? 1 : 0;
    }
    cls = min(cls, K - 1);
    const T bsel = bco[r + cls];  // 0 for a null class and for an inactive component
    const T bs = cco[r + cls] + bsel * prea;
    const bool active = on && anz[r] != T(0);
    ujc -= bs;
    total += bs;
    if (active) dj = cls + 1;
    o.ia[at * A + a] = active ? cls + 1 : 0;
    o.fa[at * A + a] = bs;
    o.ib[at * A + a] = (bsel > T(0)) ? 1 : 0;
  }
  *delta = dj;
  *u_j = ujc;
  return total;
}

// rcpi's new annotation probabilities of one locus, by the thread that owns
// it, from its row in device memory.
template <typename T>
__device__ __forceinline__ void rcpi_aprob(const T* __restrict__ s, int A, int K, int a_sel,
                                           T* __restrict__ out) {
  const int AK = A * K;
  const T* aprob = s + 8;
  const T* g1 = aprob + AK;
  const T* g2 = g1 + AK;
  const T* anz = g2 + AK;
  if (s[4] == T(0)) {
    for (int a = 0; a < A; ++a) out[a] = aprob[a * K];
    return;
  }
  T gsum = T(0);
  for (int a = 0; a < A; ++a) gsum += ((a == a_sel) ? g2[a * K] : g1[a * K]) * anz[a * K];
  for (int a = 0; a < A; ++a) out[a] = ((a == a_sel) ? g2[a * K] : g1[a * K]) * anz[a * K] / gsum;
}

// The rules of K12 and K14 on the scan skeleton (csrc/scan_skeleton.cuh), in
// T. head (bold, ua, uv, mask) is the head of the thread's own row; the
// rule's shared memory is two groups' staged Coefs (A * K <= 32) or the
// serial rule's scratch and two rows (A * K > 32).
template <int R, typename T>
struct RcRule {
  static constexpr int kGrams = 1;
  using Real = T;
  struct Params {
    const T* pk;  // (V, B, W)
    Outs<T> o;
    int A, K;
  };

  const T* pkv;
  Outs<T> o;
  T* sm;
  const T* coefs = nullptr;  // the staged Coefs of the locus that runs next
  int v, B, A, K, AK, W;
  bool on_warp;
  Grid g;
  T s0;
  T bold, ua, uv, mask;  // the head of the thread's locus
  Mine<T> mine;

  __device__ __forceinline__ RcRule(const Params& p, T* smem, int v_, int B_, int i)
      : o(p.o), sm(smem), v(v_), B(B_), A(p.A), K(p.K) {
    AK = A * K;
    W = 8 + (R == kRCpi ? 8 : 6) * AK;
    on_warp = AK <= 32;
    const int lane = i & 31;
    g.valid = lane < AK;
    g.a = lane / K;
    g.k = lane - g.a * K;
    pkv = p.pk + (size_t)v * B * W;
    s0 = bold = ua = uv = mask = T(0);
    if (i < B) {
      const T* s = pkv + (size_t)i * W;
      s0 = __ldg(s);
      bold = __ldg(s + 1);
      if (R == kRCpi) {
        ua = __ldg(s + 2);
        uv = __ldg(s + 3);
        mask = __ldg(s + 4);
      } else {
        mask = __ldg(s + 2);
      }
    }
    mine = Mine<T>{T(0), T(0), 0, 0};
  }

  __device__ __forceinline__ T start(int) const { return s0; }

  __device__ __forceinline__ void stage(int slot, int j0, int lane) {
    if (on_warp) stage_coefs<R>(pkv, sm + slot * kCoefGroup, j0, B, W, AK, K, lane);
  }

  // the group's staged Coefs, or the serial rule's first row of the group
  __device__ __forceinline__ void begin_group(int slot, int j0, int, int lane) {
    coefs = sm + slot * kCoefGroup;
    if (!on_warp) {
      T* rows = sm + AK + A;
      for (int idx = lane; idx < W; idx += 32)
        __pipeline_memcpy_async(rows + idx, pkv + (size_t)j0 * W + idx, sizeof(T));
      __pipeline_commit();
    }
  }

  __device__ __forceinline__ T locus(int j0, int jj, const T (&pre_g)[1], T gjj, int lane) {
    const int j = j0 + jj;
    const size_t at = (size_t)v * B + j;
    const T pre = pre_g[0];
    const T bold_j = __shfl_sync(kFull, bold, jj);
    const bool on = __shfl_sync(kFull, mask, jj) != T(0);
    T bnew = T(0), uj = T(0);
    int a_sel = 0, cls = 0, dj = 0;
    if (on_warp) {
      const Coef<T> c0 = read_coef(coefs, 0, AK, lane);
      coefs += kCoefWords;
      if (R == kRCpi) {
        const T ua_j = __shfl_sync(kFull, ua, jj);
        const T uv_j = __shfl_sync(kFull, uv, jj);
        bnew = rcpi_warp(c0, g, lane, pre, ua_j, uv_j, A, K, &a_sel, &cls);
        uj = bold_j - bnew;
        dj = on ? cls + 1 : 0;
      } else {
        bnew = rcplus_warp(c0, g, lane, pre, gjj, bold_j, on, A, K, at, o, &uj, &dj);
      }
    } else {
      T* e = sm;             // AK
      T* rowsum = e + AK;    // A
      T* rows = rowsum + A;  // 2 * W
      // row j has arrived; row j + 1 goes into the other slot meanwhile
      __pipeline_wait_prior(0);
      __syncwarp();
      const T* s = rows + (jj & 1) * W;
      if (j + 1 < min(B, j0 + 32)) {
        T* dst = rows + ((jj + 1) & 1) * W;
        for (int idx = lane; idx < W; idx += 32)
          __pipeline_memcpy_async(dst + idx, pkv + (size_t)(j + 1) * W + idx, sizeof(T));
      }
      __pipeline_commit();
      if (lane == 0) {
        if (R == kRCpi) {
          bnew = rcpi_serial(s, pre, A, K, e, rowsum, &a_sel, &cls);
          uj = bold_j - bnew;
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

  __device__ __forceinline__ T u() const { return mine.u; }

  __device__ __forceinline__ void finish(int i) {
    const size_t at = (size_t)v * B + i;
    o.beta[at] = mine.beta;
    o.u[at] = mine.u;
    o.delta[at] = mine.delta;
    if (R == kRCpi) {
      o.ia[at] = mask != T(0) ? mine.a_sel + 1 : 0;
      rcpi_aprob(pkv + (size_t)i * W, A, K, mine.a_sel, o.fa + at * A);
    }
  }
};

template <int R, typename T>
int launch(const void* gram, const void* pk, const Outs<T>& o, long long V, long long B, long long A,
           long long K, void* stream) {
  const long long AK = A * K;
  const long long W = 8 + (R == kRCpi ? 8 : 6) * AK;
  // gibbs_kernels.rc_scan_smem_bytes is the skeleton's elements and these
  const size_t rule_words = AK <= 32 ? (size_t)(2 * kCoefGroup) : (size_t)(AK + A + 2 * W);
  const typename RcRule<R, T>::Params prm{(const T*)pk, o, (int)A, (int)K};
  return ngt::scan::launch<RcRule<R, T>>(gram, nullptr, prm, V, B, rule_words, stream);
}

template <typename T>
int rcpi(const void* gram, const void* pk, void* beta, void* u, void* delta, void* acat, void* aprob,
         long long V, long long B, long long A, long long K, void* stream) {
  const Outs<T> o{(T*)beta, (T*)u, (int*)delta, (int*)acat, (T*)aprob, nullptr};
  return launch<kRCpi>(gram, pk, o, V, B, A, K, stream);
}

template <typename T>
int rcplus(const void* gram, const void* pk, void* beta, void* u, void* delta, void* cls, void* bs,
           void* nz, long long V, long long B, long long A, long long K, void* stream) {
  const Outs<T> o{(T*)beta, (T*)u, (int*)delta, (int*)cls, (T*)bs, (int*)nz};
  return launch<kRCplus>(gram, pk, o, V, B, A, K, stream);
}

}  // namespace

extern "C" {

// gram: (B, V, B) f32 (already offset to step t); pk: (V, B, 8 + 8AK) f32;
// beta, u: (V, B) f32; delta, acat: (V, B) int32; aprob: (V, B, A) f32.
// 1 <= B <= 1024.
int ngt_rcpi_block_scan_v(const void* gram, const void* pk, void* beta, void* u, void* delta,
                          void* acat, void* aprob, long long V, long long B, long long A,
                          long long K, void* stream) {
  return rcpi<float>(gram, pk, beta, u, delta, acat, aprob, V, B, A, K, stream);
}

// The same with gram, pk, beta, u and aprob f64.
int ngt_rcpi_block_scan_v_f64(const void* gram, const void* pk, void* beta, void* u, void* delta,
                              void* acat, void* aprob, long long V, long long B, long long A,
                              long long K, void* stream) {
  return rcpi<double>(gram, pk, beta, u, delta, acat, aprob, V, B, A, K, stream);
}

// pk: (V, B, 8 + 6AK) f32; beta, u: (V, B) f32; delta: (V, B) int32; cls, nz:
// (V, B, A) int32; bs: (V, B, A) f32.
int ngt_rcplus_block_scan_v(const void* gram, const void* pk, void* beta, void* u, void* delta,
                            void* cls, void* bs, void* nz, long long V, long long B, long long A,
                            long long K, void* stream) {
  return rcplus<float>(gram, pk, beta, u, delta, cls, bs, nz, V, B, A, K, stream);
}

// The same with gram, pk, beta, u and bs f64.
int ngt_rcplus_block_scan_v_f64(const void* gram, const void* pk, void* beta, void* u, void* delta,
                                void* cls, void* bs, void* nz, long long V, long long B, long long A,
                                long long K, void* stream) {
  return rcplus<double>(gram, pk, beta, u, delta, cls, bs, nz, V, B, A, K, stream);
}

}  // extern "C"
