// Draws keyed on the device for Hopper (sm_90a): the random numbers of one
// draw site of a Gibbs sweep, with the site's key folded on the card.
//
// Replaces no Pallas kernel. It is the counterpart of `jax.random` under
// `fold_in` (nextgp_tpu/engine/rng.py:31-36), which derives a site's key from
// a traced sweep index on the device: here the key is
//
//   site_seed(seed, site) = splitmix64 folded over (seed, sweep, stage,
//                           index, path...), shifted right by one
//
// (nextgp_tpu_torch/engine/rng.py), with the sweep read from a device counter
// at run time, so that a sweep captured in a CUDA graph names the right sites
// at every replay. The host passes splitmix64(seed) and the site's static
// tail (stage, index, path); every thread folds the key itself.
//
// Numbers: Philox4x32-10 keyed by the key's two 32-bit halves, the counter
// (element low word, attempt, tag, element high word). Tag 0 gives the
// uniforms and normals, tag 1 a gamma's attempts, tag 2 its alpha < 1 boost.
//   uniform  24 bits k of word 0 to (k + 1) * 2^-24, in (0, 1]: never 0
//   normal   Box-Muller on words 0 and 1, sqrt(-2 log u1) * cos(2 pi u2)
//   gamma    Marsaglia-Tsang: attempt j draws a normal from words 0, 1 and
//            a uniform from word 2 and retries until it accepts; alpha < 1
//            takes G(alpha + 1) * U^(1/alpha). An element's value depends
//            on (key, element) alone. The result is clamped below at the
//            smallest normal float, as torch._standard_gamma does.
// The plain version (rng.keyed_draw_plain) defines the numbers in float64,
// rounded to float32 at the end. Uniforms are its bits. Box-Muller runs here
// in float32 (logf and cospif within an ulp, sqrtf and the products
// correctly rounded): a normal is within a few ulp of the plain version's,
// relatively. A gamma attempt takes that normal and runs the acceptance in
// float64 as the plain version does, with the rounding of every product and
// sum written out (no contraction into FMAs).
//
// Bound: a draw is a dependent chain of a few hundred cycles (the counter's
// load, 1 + n_tail splitmix64 folds, ten Philox rounds, Box-Muller), and the
// main path's draws are of 1 to 49,152 elements: one thread's chain and the
// launch set the time, not the bytes (PERF.md). What was measured to set it,
// and what this design does about each:
//   - the tail was indexed at run time, which put it in local memory: a store
//     and a load per value in every thread. A kernel per tail length folds
//     it in straight-line code, each value read from the launch's
//     parameters; a gamma's shape is loaded before, so that its latency
//     overlaps the folds. The folds themselves, 1 + n_tail dependent
//     splitmix64s, stay on every draw's path (PERF.md §6);
//   - Box-Muller in float64 (libdevice's log and cos are long dependent
//     polynomials on the FP64 pipe, half the FP32 pipe's lanes) took half
//     of a normal's chain: it runs in float32;
//   - a gamma attempt's two float64 logs: the squeeze u < 1 - 0.0331 x^4
//     accepts most attempts without them. Its bound lies below the full
//     test's for every d >= 2/3, the least d here, so it accepts only
//     attempts that the full test accepts, and the accepting attempt is
//     the full test's;
//   - a warp waited for its lane with the most attempts (one wave at the
//     main path's sizes, so the slowest warp is the kernel's time): after
//     each lane's first attempt, the warp shares its lanes among the
//     elements still pending, 32 / k lanes each for k of them, each lane an
//     attempt j0 + its offset; a ballot takes the lowest attempt that
//     accepts, which is the serial loop's.
// One launch per draw site. A split draw (ngt_keyed_rng_rows: the rows of
// jax.random.split(key, rows)[r] below one site, e.g. every region's
// inverse-Wishart of a correlated marker set) is one launch for all its
// rows: element e is element e % n of row e / n, and its thread folds the
// row index into the key at the tail's row slot. Its warps may span rows,
// so a gamma's shared retries take the pending element's key with it. The
// single-site entry point is the template's kRows = false instance, its
// code and bits unchanged. A float64 draw (ngt_keyed_rng_f64,
// ngt_keyed_rng_rows_f64, for a chain in float64) computes the same numbers
// and stores them as float64, its gamma shapes read as float64: a uniform
// or normal is the float32 draw widened, a gamma the float64 g the float32
// draw rounds (clamped at the smallest normal double). No arithmetic
// changes, so the float32 draws keep their bits.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTail = 8;
constexpr int kThreads = 128;  // 384 blocks at 49,152 draws: three an SM
constexpr int kMaxAttempts = 1000;  // a gamma that has not accepted by then is NaN
constexpr unsigned kFull = 0xFFFFFFFFu;
enum Kind { kUniform = 0, kNormal = 1, kGamma = 2 };

struct Tail {
  unsigned long long v[kMaxTail];
};

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Words {
  uint32_t w[4];
};

__device__ __forceinline__ Words philox(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                                        uint32_t c2, uint32_t c3) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

// 24 bits k of a word to (k + 1) * 2^-24, exactly, in float32 and float64.
__device__ __forceinline__ float unit_f(uint32_t w) { return (float)((w >> 8) + 1u) * 0x1p-24f; }
__device__ __forceinline__ double unit(uint32_t w) { return (double)unit_f(w); }

__device__ __forceinline__ float box_muller(uint32_t w0, uint32_t w1) {
  return sqrtf(-2.0f * logf(unit_f(w0))) * cospif(2.0f * unit_f(w1));
}

// Attempt j of Marsaglia-Tsang for the element (lo, hi) with d = a - 1/3
// and c = 1/sqrt(9d): whether it accepts, and then g = d v^3.
__device__ __forceinline__ bool attempt(uint32_t k0, uint32_t k1, uint32_t lo, uint32_t hi, int j,
                                        double d, double c, double& g) {
  const Words w = philox(k0, k1, lo, (uint32_t)j, 1u, hi);
  const double x = (double)box_muller(w.w[0], w.w[1]);
  double v = __dadd_rn(1.0, __dmul_rn(c, x));
  if (!(v > 0.0)) return false;
  v = __dmul_rn(__dmul_rn(v, v), v);
  const double u = unit(w.w[2]);
  const double x2 = __dmul_rn(x, x);
  const bool acc = u < __dsub_rn(1.0, __dmul_rn(0.0331, __dmul_rn(x2, x2))) ||
                   log(u) < __dadd_rn(__dmul_rn(__dmul_rn(0.5, x), x),
                                      __dmul_rn(d, __dadd_rn(__dsub_rn(1.0, v), log(v))));
  if (acc) g = __dmul_rn(d, v);
  return acc;
}

// The position of the (s + 1)-th set bit of mask, s < popc(mask): the
// largest p with at most s set bits below it.
__device__ __forceinline__ int nth_set(unsigned mask, int s) {
  int p = 0;
#pragma unroll
  for (int b = 16; b >= 1; b >>= 1)
    if (__popc(mask & ((1u << (p + b)) - 1u)) <= s) p += b;
  return p;
}

// The site's key: splitmix64 folded over the sweep (read from the device
// counter) and the kTail tail values, each read from the launch's
// parameters, and shifted right by one.
template <int kTail>
__device__ __forceinline__ uint64_t site_key(const long long* sweep, unsigned long long h0,
                                             Tail tail) {
  uint64_t h = splitmix64(h0 ^ (uint64_t)__ldg(sweep));
#pragma unroll
  for (int t = 0; t < kTail; ++t) h = splitmix64(h ^ tail.v[t]);
  return h >> 1;
}

// The key of a split draw's row: the tail's value at `slot` is the row.
template <int kTail>
__device__ __forceinline__ uint64_t row_key(const long long* sweep, unsigned long long h0,
                                            Tail tail, int slot, unsigned long long row) {
  uint64_t h = splitmix64(h0 ^ (uint64_t)__ldg(sweep));
#pragma unroll
  for (int t = 0; t < kTail; ++t) h = splitmix64(h ^ (t == slot ? row : tail.v[t]));
  return h >> 1;
}

// A gamma's value stored as T (NaN where no attempt accepted).
__device__ __forceinline__ float store_gamma(double g, bool ok, float) {
  return ok ? fmaxf((float)g, FLT_MIN) : nanf("");
}
__device__ __forceinline__ double store_gamma(double g, bool ok, double) {
  return ok ? fmax(g, DBL_MIN) : nan("");
}

// kRows: a split draw of `rows` rows of n elements (the grid covers rows * n
// threads); else one site's n elements. T: float or double, the output's
// and the shapes' type.
template <int kTail, bool kRows, typename T>
__global__ void __launch_bounds__(kThreads)
keyed_rng_kernel(const long long* __restrict__ sweep, unsigned long long h0, Tail tail, int kind,
                 const T* __restrict__ alpha, T* __restrict__ out, int* __restrict__ iters,
                 long long n, int row_slot, long long rows) {
  const long long el = (long long)blockIdx.x * kThreads + threadIdx.x;  // the output element
  const long long i = kRows ? el % n : el;  // its index within its row
  const unsigned long long row = kRows ? (unsigned long long)(el / n) : 0ull;
  const long long total = kRows ? n * rows : n;
  const uint32_t lo = (uint32_t)i, hi = (uint32_t)((unsigned long long)i >> 32);
  auto key = [&]() {
    if constexpr (kRows) {
      return row_key<kTail>(sweep, h0, tail, row_slot, row < (unsigned long long)rows ? row : 0ull);
    } else {
      return site_key<kTail>(sweep, h0, tail);
    }
  };
  if (kind != kGamma) {
    if (el >= total) return;
    const uint64_t h = key();
    const Words w = philox((uint32_t)h, (uint32_t)(h >> 32), lo, 0u, 0u, hi);
    if (kind == kUniform)
      out[el] = (T)unit_f(w.w[0]);
    else
      out[el] = (T)box_muller(w.w[0], w.w[1]);
    return;
  }
  // A gamma's warp works whole (its lanes share attempts by shuffles). The
  // shape is loaded before the key is folded, so that its latency and d and
  // c's float64 square root and division overlap the folds.
  const bool live = el < total;
  const double a_in = live ? (double)__ldg(alpha + el) : 1.0;
  const uint64_t h = key();
  const uint32_t k0 = (uint32_t)h, k1 = (uint32_t)(h >> 32);
  const bool valid = live && a_in > 0.0 && !isinf(a_in);  // NaN fails a_in > 0
  const bool boost = a_in < 1.0;
  const double a = boost ? __dadd_rn(a_in, 1.0) : a_in;
  const double d = __dsub_rn(a, 1.0 / 3.0);
  const double c = 1.0 / sqrt(__dmul_rn(9.0, d));
  double g = nan("");
  int att = -1;
  bool done = !valid;
  if (valid && attempt(k0, k1, lo, hi, 0, d, c, g)) {
    att = 0;
    done = true;
  }
  // The warp's lanes take the pending elements' next attempts together:
  // slot s of the k pending elements gets lanes s m .. s m + m - 1, m = 32 / k,
  // lane s m + r its attempt next + r.
  const int lane = threadIdx.x & 31;
  int next = 1;
  for (unsigned pending = __ballot_sync(kFull, !done); pending;
       pending = __ballot_sync(kFull, !done)) {
    const int k = __popc(pending), m = 32 / k;
    const int slot = lane / m;
    const int e = nth_set(pending, slot < k ? slot : 0);
    const double ed = __shfl_sync(kFull, d, e), ec = __shfl_sync(kFull, c, e);
    const uint32_t elo = __shfl_sync(kFull, lo, e), ehi = __shfl_sync(kFull, hi, e);
    const int j = __shfl_sync(kFull, next, e) + lane % m;
    // a split draw's warp may span rows: the element's key goes with it
    const uint32_t ek0 = kRows ? __shfl_sync(kFull, k0, e) : k0;
    const uint32_t ek1 = kRows ? __shfl_sync(kFull, k1, e) : k1;
    double gv = 0.0;
    const bool acc = slot < k && j < kMaxAttempts && attempt(ek0, ek1, elo, ehi, j, ed, ec, gv);
    const unsigned accepted = __ballot_sync(kFull, acc);
    const int mine = __popc(pending & ((1u << lane) - 1u));  // this lane's slot, if pending
    const unsigned seg = done ? 0u : (accepted >> (mine * m)) & (m == 32 ? kFull : (1u << m) - 1u);
    const int win = seg ? mine * m + __ffs(seg) - 1 : lane;
    const double gw = __shfl_sync(kFull, gv, win);
    if (!done) {
      if (seg) {
        g = gw;
        att = next + win - mine * m;
        done = true;
      } else if ((next += m) >= kMaxAttempts) {
        done = true;  // no attempt accepted: NaN
      }
    }
  }
  if (!live) return;
  if (boost && att >= 0) {
    const double ub = unit(philox(k0, k1, lo, 0u, 2u, hi).w[0]);
    g = __dmul_rn(g, exp(__ddiv_rn(log(ub), a_in)));
  }
  out[el] = store_gamma(g, att >= 0, T());
  if (iters) iters[el] = att;
}

template <int kTail, bool kRows, typename T>
int launch(const void* sweep, unsigned long long h0, const Tail& t, long long kind,
           const void* alpha, void* out, void* iters, long long n, int row_slot, long long rows,
           cudaStream_t stream) {
  const long long total = kRows ? n * rows : n;
  keyed_rng_kernel<kTail, kRows, T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      (const long long*)sweep, h0, t, (int)kind, (const T*)alpha, (T*)out, (int*)iters, n,
      row_slot, rows);
  return (int)cudaGetLastError();
}

template <bool kRows, typename T = float>
int launch_tail(const void* sweep, unsigned long long h0, const unsigned long long* tail,
                long long n_tail, long long kind, const void* alpha, void* out, void* iters,
                long long n, int row_slot, long long rows, void* stream) {
  if (n_tail < 0 || n_tail > kMaxTail || n < 1 || rows < 1 || kind < kUniform || kind > kGamma ||
      (kRows && (row_slot < 0 || row_slot >= n_tail || n * rows >= (1LL << 40))))
    return (int)cudaErrorInvalidValue;
  Tail t{};
  for (int k = 0; k < n_tail; ++k) t.v[k] = tail[k];
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_tail) {  // one kernel per tail length: the fold is straight-line code
    case 0: return launch<0, kRows, T>(sweep, h0, t, kind, alpha, out, iters, n, row_slot, rows, st);
    case 1: return launch<1, kRows, T>(sweep, h0, t, kind, alpha, out, iters, n, row_slot, rows, st);
    case 2: return launch<2, kRows, T>(sweep, h0, t, kind, alpha, out, iters, n, row_slot, rows, st);
    case 3: return launch<3, kRows, T>(sweep, h0, t, kind, alpha, out, iters, n, row_slot, rows, st);
    case 4: return launch<4, kRows, T>(sweep, h0, t, kind, alpha, out, iters, n, row_slot, rows, st);
    case 5: return launch<5, kRows, T>(sweep, h0, t, kind, alpha, out, iters, n, row_slot, rows, st);
    case 6: return launch<6, kRows, T>(sweep, h0, t, kind, alpha, out, iters, n, row_slot, rows, st);
    case 7: return launch<7, kRows, T>(sweep, h0, t, kind, alpha, out, iters, n, row_slot, rows, st);
    default: return launch<8, kRows, T>(sweep, h0, t, kind, alpha, out, iters, n, row_slot, rows, st);
  }
}

}  // namespace

extern "C" {

// sweep: one int64 on the device (the sweep counter); h0 = splitmix64(seed);
// tail: n_tail <= 8 host values (stage, index, path...); kind 0 uniform,
// 1 normal, 2 gamma (alpha: n float32 shapes); out: n float32; iters: n
// int32 accepting attempts of a gamma (-1 where none accepted), or null.
// n >= 1.
int ngt_keyed_rng(const void* sweep, unsigned long long h0, const unsigned long long* tail,
                  long long n_tail, long long kind, const void* alpha, void* out, void* iters,
                  long long n, void* stream) {
  return launch_tail<false>(sweep, h0, tail, n_tail, kind, alpha, out, iters, n, 0, 1, stream);
}

// A split draw: `rows` rows of n draws each, row r keyed with tail[row_slot]
// = r (alpha, out and iters rows x n, row-major).
int ngt_keyed_rng_rows(const void* sweep, unsigned long long h0, const unsigned long long* tail,
                       long long n_tail, long long row_slot, long long rows, long long kind,
                       const void* alpha, void* out, void* iters, long long n, void* stream) {
  return launch_tail<true>(sweep, h0, tail, n_tail, kind, alpha, out, iters, n, (int)row_slot, rows,
                           stream);
}

// The same two draws stored as float64 (alpha: float64 shapes; out: float64).
int ngt_keyed_rng_f64(const void* sweep, unsigned long long h0, const unsigned long long* tail,
                      long long n_tail, long long kind, const void* alpha, void* out, void* iters,
                      long long n, void* stream) {
  return launch_tail<false, double>(sweep, h0, tail, n_tail, kind, alpha, out, iters, n, 0, 1,
                                    stream);
}

int ngt_keyed_rng_rows_f64(const void* sweep, unsigned long long h0, const unsigned long long* tail,
                           long long n_tail, long long row_slot, long long rows, long long kind,
                           const void* alpha, void* out, void* iters, long long n, void* stream) {
  return launch_tail<true, double>(sweep, h0, tail, n_tail, kind, alpha, out, iters, n,
                                   (int)row_slot, rows, stream);
}

}  // extern "C"
