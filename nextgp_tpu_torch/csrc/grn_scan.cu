// GRN1: the GRN sampler's SNP scan (Lambda2's single-site Gibbs pass over
// every SNP of every gene) in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the counterpart of the `lax.scan` of
// `gene_scan` (nextgp_tpu/grn/sampler.py:169-188), vmapped over genes, which
// the JAX package compiles into its step. Written as plain PyTorch the loop
// is S dependent steps of several launches each.
//
// What it computes. gram = Xc Xc' (S, S), of which only the lower triangle
// (diagonal included) is read; for each gene g the rows r0 = Xc ycorr_g, z
// (the normal draws) and bold (the gene's old effects), each (G, S) with
// the genes as rows; var_e, one value read on the card. The scan's u ends as
// d = bold - bnew, where
//   d_q = -(r0_q + sum_{j<q} gram[q, j] d_j) / gram[q, q] - z_q sqrt(var_e / gram[q, q])
// that is tril(gram) D = -(R0 + Z o sqrt(var_e diag(gram))): one forward
// substitution with G right-hand sides, all of them on one triangle. It
// writes d and bnew = bold - d. Each sum runs in order of j, a fused
// multiply-add a term, so a call gives the same bits every time. A SNP whose
// diagonal is 0 (a monomorphic SNP) divides by it, as the JAX package does:
// its draw and every later one of the gene are not finite.
//
// Bound: the chain. A call reads the triangle once (S(S+1)/2 words, which
// every gene's block reads through L2) and 3 G S words, and writes 2 G S:
// 0.48 MB at G = 100, S = 200 in float32, 0.14 us at 3.35 TB/s. Its S steps
// depend one on the next: a step's d needs the last one's, through an add,
// a divide and a subtract after its own multiply-add.
//
// Design: one block a gene, nt = min(32 ceil(S / 32), 256) threads; thread
// t owns SNPs t, t + nt, ..., K of them (K = 1, 2, 4 or 8: S <= 2,048), and
// keeps each one's sum acc_j = sum_{i<q} gram[j, i] d_i, r0_j, bold_j,
// gram[j, j] and z_j sqrt(var_e / gram[j, j]) in registers. At step q the
// owner of q forms d_q and writes it to shared memory; after one barrier
// every thread adds gram[j, q] d_q into each of its sums. The slot is
// double-buffered, so a step costs one barrier. Each thread reads its rows'
// words of column q from global memory (L2: all genes read one triangle),
// the next step's column before this step's barrier, unconditionally (the
// row index clamped); every slot adds the step's term (a sum already used
// takes it harmlessly), so no load waits on a compare. Staging the triangle
// in shared memory first cost more than it saved (one load in flight a lane:
// PERF.md §6). Above 2,048 SNPs the sums live in scratch (G x S words)
// and each thread walks its SNPs in a loop.
#include <cuda_runtime.h>

namespace grn {

constexpr int kThreads = 256;  // most threads in a gene's block
constexpr int kMaxK = 8;       // most SNPs a thread keeps in registers

__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ gram, const T* __restrict__ r0, const T* __restrict__ z,
                const T* __restrict__ bold, const T* __restrict__ var_e, T* __restrict__ bnew,
                T* __restrict__ d, int S) {
  __shared__ T sh_d[2];  // step q's d in slot q & 1
  const int nt = blockDim.x, tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * S;
  const T ve = *var_e;
  T acc[K], r[K], gd[K], t[K], b[K], gq[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = min(tid + k * nt, S - 1);  // a slot past S is never an owner
    acc[k] = T(0);
    r[k] = r0[row + j];
    b[k] = bold[row + j];
    gd[k] = gram[(long long)j * S + j];
    t[k] = z[row + j] * root(ve / gd[k]);
    gq[k] = gram[(long long)j * S];  // column 0
  }
  int owner = 0, kq = 0;  // step q's owner: thread q % nt, its slot q / nt
  for (int q = 0; q < S; ++q) {
    const int qn = min(q + 1, S - 1);
    T gn[K];  // column qn, read ahead
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = max(min(tid + k * nt, S - 1), qn);
      gn[k] = gram[(long long)j * S + qn];
    }
    if (tid == owner) {
      T a = acc[0], rq = r[0], g = gd[0], tq = t[0], bq = b[0];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        if (k == kq) {
          a = acc[k];
          rq = r[k];
          g = gd[k];
          tq = t[k];
          bq = b[k];
        }
      }
      const T dq = -(rq + a) / g - tq;
      sh_d[q & 1] = dq;
      d[row + q] = dq;
      bnew[row + q] = bq - dq;
    }
    __syncthreads();
    // every slot takes the term: a sum of a SNP j <= q is no longer read
    // (the owner read its own before the barrier), so no compare guards the
    // slot read from shared memory
    const T dq = sh_d[q & 1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = madd(gq[k], dq, acc[k]);
      gq[k] = gn[k];
    }
    if (++owner == nt) {
      owner = 0;
      ++kq;
    }
  }
}

// Any S: the sums in scratch (acc, G x S).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_wide_kernel(const T* __restrict__ gram, const T* __restrict__ r0, const T* __restrict__ z,
                     const T* __restrict__ bold, const T* __restrict__ var_e, T* __restrict__ bnew,
                     T* __restrict__ d, T* __restrict__ acc, int S) {
  __shared__ T sh_d[2];
  const int nt = blockDim.x, tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * S;
  T* a = acc + row;
  for (int j = tid; j < S; j += nt) a[j] = T(0);  // each sum is its owner's alone
  const T ve = *var_e;
  int owner = 0;
  for (int q = 0; q < S; ++q) {
    if (tid == owner) {
      const T g = gram[(long long)q * S + q];
      const T tq = z[row + q] * root(ve / g);
      const T dq = -(r0[row + q] + a[q]) / g - tq;
      sh_d[q & 1] = dq;
      d[row + q] = dq;
      bnew[row + q] = bold[row + q] - dq;
    }
    __syncthreads();
    const T dq = sh_d[q & 1];
    for (int j = tid; j < S; j += nt) {
      if (j > q) a[j] = madd(gram[(long long)j * S + q], dq, a[j]);
    }
    if (++owner == nt) owner = 0;
  }
}

template <typename T>
int scan(const void* gram, const void* r0, const void* z, const void* bold, const void* var_e,
         void* bnew, void* d, void* scratch, long long G, long long S, cudaStream_t st) {
  const T* g = (const T*)gram;
  const T* r = (const T*)r0;
  const T* zz = (const T*)z;
  const T* b = (const T*)bold;
  const T* ve = (const T*)var_e;
  T* bn = (T*)bnew;
  T* dd = (T*)d;
  const int nt = (int)(S < kThreads ? (S + 31) / 32 * 32 : kThreads);
  const long long k = (S + nt - 1) / nt;
  const int s = (int)S;
  const unsigned blocks = (unsigned)G;
  if (k > kMaxK) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    scan_wide_kernel<T><<<blocks, nt, 0, st>>>(g, r, zz, b, ve, bn, dd, (T*)scratch, s);
  } else if (k == 1) {
    scan_kernel<T, 1><<<blocks, nt, 0, st>>>(g, r, zz, b, ve, bn, dd, s);
  } else if (k == 2) {
    scan_kernel<T, 2><<<blocks, nt, 0, st>>>(g, r, zz, b, ve, bn, dd, s);
  } else if (k <= 4) {
    scan_kernel<T, 4><<<blocks, nt, 0, st>>>(g, r, zz, b, ve, bn, dd, s);
  } else {
    scan_kernel<T, 8><<<blocks, nt, 0, st>>>(g, r, zz, b, ve, bn, dd, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace grn

// Scratch words (of the call's type) one call needs: G x S above 2,048
// SNPs, where the sums leave the registers, else none.
extern "C" long long ngt_grn_scan_scratch_words(long long G, long long S) {
  const long long nt = S < grn::kThreads ? (S + 31) / 32 * 32 : grn::kThreads;
  return (S + nt - 1) / nt > grn::kMaxK ? G * S : 0;
}

// One GRN1 call: gram (S, S) row-major (its lower triangle read); r0, z,
// bold, bnew and d (G, S) row-major; var_e one value; scratch
// ngt_grn_scan_scratch_words(G, S) words; every pointer float32 (f64 = 0) or
// float64 (f64 = 1) on one device. One launch.
extern "C" int ngt_grn_scan(const void* gram, const void* r0, const void* z, const void* bold,
                            const void* var_e, void* bnew, void* d, void* scratch, long long G,
                            long long S, long long f64, void* stream) {
  if (G < 1 || S < 1 || G > 0x7fffffffLL || S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return f64 ? grn::scan<double>(gram, r0, z, bold, var_e, bnew, d, scratch, G, S, st)
             : grn::scan<float>(gram, r0, z, bold, var_e, bnew, d, scratch, G, S, st);
}
