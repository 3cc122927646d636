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
// Everything after the integer steps runs in float64 with the rounding of
// every product and sum written out (no contraction into FMAs), in the order
// of the plain version (rng.keyed_draw_plain), and is rounded to float32 at
// the store: the plain version on the card gives the same numbers.
//
// Bound: bytes written (and alpha read), one thread per element; a draw is
// a few hundred integer operations and, for a gamma, a few attempts. One
// launch per draw site.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTail = 8;
constexpr int kThreads = 256;
constexpr int kMaxAttempts = 1000;  // a gamma that has not accepted by then is NaN
enum Kind { kUniform = 0, kNormal = 1, kGamma = 2 };

struct Tail {
  unsigned long long v[kMaxTail];
  int n;
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

__device__ __forceinline__ double unit(uint32_t w) {
  return __dmul_rn((double)((w >> 8) + 1u), 0x1p-24);
}

__device__ __forceinline__ double box_muller(uint32_t w0, uint32_t w1) {
  const double r = sqrt(__dmul_rn(-2.0, log(unit(w0))));
  return __dmul_rn(r, cos(__dmul_rn(6.283185307179586, unit(w1))));
}

__global__ void __launch_bounds__(kThreads)
keyed_rng_kernel(const long long* __restrict__ sweep, unsigned long long h0, Tail tail, int kind,
                 const float* __restrict__ alpha, float* __restrict__ out, int* __restrict__ iters,
                 long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint64_t h = splitmix64(h0 ^ (uint64_t)*sweep);
  for (int t = 0; t < tail.n; ++t) h = splitmix64(h ^ tail.v[t]);
  h >>= 1;
  const uint32_t k0 = (uint32_t)h, k1 = (uint32_t)(h >> 32);
  const uint32_t lo = (uint32_t)i, hi = (uint32_t)((unsigned long long)i >> 32);
  if (kind == kUniform) {
    out[i] = (float)unit(philox(k0, k1, lo, 0u, 0u, hi).w[0]);
    return;
  }
  if (kind == kNormal) {
    const Words w = philox(k0, k1, lo, 0u, 0u, hi);
    out[i] = (float)box_muller(w.w[0], w.w[1]);
    return;
  }
  const double a_in = (double)alpha[i];
  if (!(a_in > 0.0) || isinf(a_in)) {  // NaN, zero, negative or infinite shape
    out[i] = nanf("");
    if (iters) iters[i] = -1;
    return;
  }
  const bool boost = a_in < 1.0;
  const double a = boost ? __dadd_rn(a_in, 1.0) : a_in;
  const double d = __dsub_rn(a, 1.0 / 3.0);
  const double c = 1.0 / sqrt(__dmul_rn(9.0, d));
  double g = nan("");
  int j = 0;
  for (; j < kMaxAttempts; ++j) {
    const Words w = philox(k0, k1, lo, (uint32_t)j, 1u, hi);
    const double x = box_muller(w.w[0], w.w[1]);
    double v = __dadd_rn(1.0, __dmul_rn(c, x));
    if (!(v > 0.0)) continue;
    v = __dmul_rn(__dmul_rn(v, v), v);
    const double rhs = __dadd_rn(__dmul_rn(__dmul_rn(0.5, x), x),
                                 __dmul_rn(d, __dadd_rn(__dsub_rn(1.0, v), log(v))));
    if (log(unit(w.w[2])) < rhs) {
      g = __dmul_rn(d, v);
      break;
    }
  }
  if (boost && j < kMaxAttempts) {
    const double ub = unit(philox(k0, k1, lo, 0u, 2u, hi).w[0]);
    g = __dmul_rn(g, exp(__ddiv_rn(log(ub), a_in)));
  }
  out[i] = j < kMaxAttempts ? fmaxf((float)g, FLT_MIN) : nanf("");
  if (iters) iters[i] = j < kMaxAttempts ? j : -1;
}

}  // namespace

extern "C" {

// sweep: one int64 on the device (the sweep counter); h0 = splitmix64(seed);
// tail: n_tail <= 8 host values (stage, index, path...); kind 0 uniform,
// 1 normal, 2 gamma (alpha: n float32 shapes); out: n float32; iters: n
// int32 accepting attempts of a gamma, or null. n >= 1.
int ngt_keyed_rng(const void* sweep, unsigned long long h0, const unsigned long long* tail,
                  long long n_tail, long long kind, const void* alpha, void* out, void* iters,
                  long long n, void* stream) {
  if (n_tail < 0 || n_tail > kMaxTail || n < 1 || kind < kUniform || kind > kGamma)
    return (int)cudaErrorInvalidValue;
  Tail t{};
  for (int k = 0; k < n_tail; ++k) t.v[k] = tail[k];
  t.n = (int)n_tail;
  const long long blocks = (n + kThreads - 1) / kThreads;
  keyed_rng_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)sweep, h0, t, (int)kind, (const float*)alpha, (float*)out, (int*)iters, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
