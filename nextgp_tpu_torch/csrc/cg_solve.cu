// CG1: the CG random-effect sampler's whole conjugate-gradient solve in one
// cooperative launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the counterpart of the `lax.while_loop`
// of `cg_solve` (nextgp_tpu/ops/cg.py:34-50) under `sample_random_cg`
// (nextgp_tpu/engine/samplers/random_effects.py:45-106), which the JAX
// package compiles into its chain, stopping rule and all. Written as plain
// PyTorch the loop reads its stopping rule on the host every iteration (a
// sync), so no CUDA graph could hold it; here every block decides the rule
// itself, from sums every block computes alike, and a captured sweep holds
// the whole solve.
//
// The system: (diag + ivu K) x = b, where diag = diag(Z'D^-1 Z) / varE (Z is
// one-hot, so Z'D^-1 Z is diagonal) and K (A^-1 or I) is held in padded rows
// (idx, val) of width kw, of which the first len[i] are live. diag and ivu
// are read through pointers (this sweep's draws); tol and max_iter are the
// plan's. The recurrence is the JAX one, in its order:
//   r = b - A x0, p = r, rz = r.r, limit = tol * max(||b||, 1e-30)
//   while sqrt(rz) > limit and it < max_iter:
//     ap = A p; alpha = rz / p.ap; x += alpha p; r -= alpha ap
//     rz' = r.r; p = r + (rz' / rz) p; rz = rz'; it += 1
// and writes x, the iteration count and sqrt(rz).
//
// Bound: bytes. An iteration reads the live entries of K (4 + s bytes each,
// s = 8 in float64: 7 MB at 100,000 animals) and a few q-vectors (p, r, x,
// diag, len; x, r, p written), about 13 MB at 100,000 animals in float64,
// 3.9 us at 3.35 TB/s, most of it resident in the 50 MB L2. The loop is a
// chain of dependent iterations, each three grid-wide waits apart.
//
// Design (a simple, correct first kernel; speed is later work):
//   - One cooperative launch, its grid the blocks the card holds at once
//     (as RE1's, csrc/level_scan.cu), or fewer where the rows need fewer.
//     CUDA runs every block of it at once or refuses the launch, so a
//     block can wait on the others; a stream capture takes it as a
//     cooperative graph node.
//   - Matvec: eight lanes a row (rows are 1 to ~100 entries wide, 5.8 on
//     average in a 5-generation pedigree), each lane summing every eighth
//     live entry in order, then a fixed shuffle tree within the eight.
//   - Dot products: each thread sums its rows in order, each block its
//     threads by a fixed tree into one partial in scratch; after a grid
//     barrier every block sums all partials in one fixed order, so every
//     block holds the same alpha, beta and stop decision with no second
//     barrier. No float atomics anywhere: two runs on one grid give the
//     same bits.
//   - Three grid barriers an iteration: after p.ap's partials (ap complete),
//     after r.r's partials, after p is updated (the next matvec gathers it).
//     A barrier is an integer counter in scratch, zeroed by the caller each
//     call, raised once per block; the wait traps after a few seconds (an
//     error, never a hang). What changes during the launch (p, r, x, ap, the
//     partials) is read through L2 (ld.global.cg), never through L1.
//   - Every product is rounded before it is added (no contraction into an
//     FMA), as the plain version (ops/cg.cg_solve_sparse_plain) and the
//     JAX package round them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 8;
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;
constexpr long long kPollLimit = 1LL << 23;  // a few seconds of reads in L2
enum { kPap = 0, kRr = 1, kBb = 2 };  // partial-sum slots

template <typename T>
struct CgArgs {
  const T* diag;
  const int* idx;  // (q, kw)
  const T* val;    // (q, kw)
  const int* len;  // (q,)
  const T* ivu;    // one value
  const T* b;
  T* x;            // x0 on entry, the solution on exit
  T* r;
  T* p;
  T* ap;
  T* part;         // 3 x gridDim.x partial sums
  T* rnorm;        // one value
  unsigned long long* barrier;  // zero on entry
  int* iters;      // one value
  long long q;
  int kw;
  T tol;
  int max_iter;
};

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Every block arrives once; return when all gridDim.x have, for the
// `target`-th time in all (target counts arrivals since the call began).
__device__ __forceinline__ void grid_barrier(unsigned long long* bar, unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1ull);
    long long n = 0;
    while (ld_acquire(bar) < target) {
      if (++n > kPollLimit) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Products and sums rounded one at a time: nvcc would contract a * b + c.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's threads' values summed by a fixed tree, written to
// part[slot * gridDim.x + blockIdx.x].
template <typename T>
__device__ __forceinline__ void block_partial(T v, T* sh, T* part, int slot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T s = warp_sum(lane < kWarps ? sh[lane] : T(0));
    if (lane == 0) part[slot * gridDim.x + blockIdx.x] = s;
  }
  __syncthreads();  // sh is free again
}

// The partials of a slot summed in one fixed order (lane l: every 32nd,
// then the tree), the same in every block; every thread gets the sum.
template <typename T>
__device__ __forceinline__ T grid_total(const T* part, int slot, T* sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    T s = T(0);
    for (int i = lane; i < (int)gridDim.x; i += 32) s += __ldcg(part + slot * gridDim.x + i);
    s = warp_sum(s);
    if (lane == 0) sh[kWarps] = s;
  }
  __syncthreads();
  const T out = sh[kWarps];
  __syncthreads();
  return out;
}

// sum_{k < len_i} val[i, k] v[idx[i, k]] on the eight lanes of row i's
// group (all eight get it); v is read through L2.
template <typename T>
__device__ __forceinline__ T row_dot(const CgArgs<T>& a, long long i, const T* v, int lane8,
                                     unsigned gmask) {
  const int n = __ldg(a.len + i);
  const int* ri = a.idx + i * a.kw;
  const T* rv = a.val + i * a.kw;
  T s = T(0);
  for (int k = lane8; k < n; k += kLanesPerRow) s = add(s, mul(__ldg(rv + k), __ldcg(v + __ldg(ri + k))));
  s += __shfl_xor_sync(gmask, s, 4);
  s += __shfl_xor_sync(gmask, s, 2);
  s += __shfl_xor_sync(gmask, s, 1);
  return s;
}

template <typename T>
__device__ __forceinline__ T root(T v);
template <>
__device__ __forceinline__ float root<float>(float v) { return sqrtf(v); }
template <>
__device__ __forceinline__ double root<double>(double v) { return sqrt(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_kernel(const CgArgs<T> a) {
  __shared__ T sh[kWarps + 1];
  const int lane8 = threadIdx.x & (kLanesPerRow - 1);  // the lane's place in its row's eight
  const unsigned gmask = 0xffu << (threadIdx.x & 24);  // the row's eight lanes of the warp
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const long long row_step = (long long)gridDim.x * kRowsPerBlock;
  const long long el0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long el_step = (long long)gridDim.x * kThreads;
  const T ivu = __ldg(a.ivu);
  unsigned long long arrivals = 0;

  // r = b - A x0, p = r; partials of r.r and b.b
  T rr = T(0), bb = T(0);
  for (long long i = row0; i < a.q; i += row_step) {
    const T kx = row_dot(a, i, a.x, lane8, gmask);
    if (lane8 == 0) {
      const T bi = __ldg(a.b + i);
      const T ri = sub(bi, add(mul(__ldg(a.diag + i), __ldcg(a.x + i)), mul(ivu, kx)));
      a.r[i] = ri;
      a.p[i] = ri;
      rr = add(rr, mul(ri, ri));
      bb = add(bb, mul(bi, bi));
    }
  }
  block_partial(rr, sh, a.part, kRr);
  block_partial(bb, sh, a.part, kBb);
  grid_barrier(a.barrier, arrivals += gridDim.x);
  T rz = grid_total(a.part, kRr, sh);
  const T bnorm = root(grid_total(a.part, kBb, sh));
  const T limit = mul(a.tol, bnorm > T(1e-30) ? bnorm : T(1e-30));

  int it = 0;
  while (root(rz) > limit && it < a.max_iter) {
    // ap = A p; partials of p.ap
    T pap = T(0);
    for (long long i = row0; i < a.q; i += row_step) {
      const T kp = row_dot(a, i, a.p, lane8, gmask);
      if (lane8 == 0) {
        const T pi = __ldcg(a.p + i);
        const T api = add(mul(__ldg(a.diag + i), pi), mul(ivu, kp));
        a.ap[i] = api;
        pap = add(pap, mul(pi, api));
      }
    }
    block_partial(pap, sh, a.part, kPap);
    grid_barrier(a.barrier, arrivals += gridDim.x);
    const T alpha = rz / grid_total(a.part, kPap, sh);

    // x += alpha p, r -= alpha ap; partials of r.r
    T rn = T(0);
    for (long long i = el0; i < a.q; i += el_step) {
      const T pi = __ldcg(a.p + i);
      a.x[i] = add(__ldcg(a.x + i), mul(alpha, pi));
      const T ri = sub(__ldcg(a.r + i), mul(alpha, __ldcg(a.ap + i)));
      a.r[i] = ri;
      rn = add(rn, mul(ri, ri));
    }
    block_partial(rn, sh, a.part, kRr);
    grid_barrier(a.barrier, arrivals += gridDim.x);
    const T rz_new = grid_total(a.part, kRr, sh);
    const T beta = rz_new / rz;
    rz = rz_new;
    ++it;
    if (!(root(rz) > limit && it < a.max_iter)) break;  // every block alike: no p, no barrier

    // p = r + beta p
    for (long long i = el0; i < a.q; i += el_step) a.p[i] = add(__ldcg(a.r + i), mul(beta, __ldcg(a.p + i)));
    grid_barrier(a.barrier, arrivals += gridDim.x);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.iters = it;
    *a.rnorm = root(rz);
  }
}

// Blocks of cg_kernel<T> the card holds at once, per device, asked once
// (the first call comes before any capture: a captured sweep is run eagerly
// first).
template <typename T>
long long resident_blocks() {
  static long long on[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -1;
  if (on[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_kernel<T>, kThreads, 0) !=
            cudaSuccess)
      return -1;
    on[dev] = (long long)sms * per_sm;
  }
  return on[dev];
}

template <typename T>
int launch(long long q, int kw, const void* diag, const void* idx, const void* val,
           const void* len, const void* ivu, const void* b, void* x, void* scratch, void* barrier,
           void* iters, double tol, int max_iter, int grid, cudaStream_t st) {
  const long long resident = resident_blocks<T>();
  if (resident < 1 || grid < 1 || grid > resident) return (int)cudaErrorInvalidValue;
  T* s = (T*)scratch;  // r, p, ap (q each), the partials (3 grid), ||r||
  const CgArgs<T> a{(const T*)diag, (const int*)idx, (const T*)val, (const int*)len,
                    (const T*)ivu,  (const T*)b,     (T*)x,         s,
                    s + q,          s + 2 * q,       s + 3 * q,     s + 3 * q + 3LL * grid,
                    (unsigned long long*)barrier, (int*)iters, q, kw, (T)tol, max_iter};
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, cg_kernel<T>, a);
}

}  // namespace

extern "C" {

// The grid of one solve over q rows: the resident grid, or the blocks the
// rows fill if fewer; -1 if the card cannot be asked.
long long ngt_cg_solve_grid(long long q, long long f64) {
  const long long resident = f64 ? resident_blocks<double>() : resident_blocks<float>();
  if (resident < 1) return -1;
  const long long need = (q + kRowsPerBlock - 1) / kRowsPerBlock;
  return need < resident ? (need > 0 ? need : 1) : resident;
}

// One solve of (diag + ivu K) x = b, K in padded rows (idx int32 and val
// (q, kw), len (q,) int32 live lengths). x holds x0 on entry and the
// solution on exit; scratch holds 3 q + 3 grid + 1 values (||r|| last);
// barrier is one zeroed uint64; iters one int32. Every float is float64
// where f64, else float32; every pointer on one device. grid comes from
// ngt_cg_solve_grid.
int ngt_cg_solve(long long f64, long long q, long long kw, const void* diag, const void* idx,
                 const void* val, const void* len, const void* ivu, const void* b, void* x,
                 void* scratch, void* barrier, void* iters, double tol, long long max_iter,
                 long long grid, void* stream) {
  if (q < 1 || kw < 1 || max_iter < 0 || max_iter > (1LL << 30) || grid < 1 || grid > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return launch<double>(q, (int)kw, diag, idx, val, len, ivu, b, x, scratch, barrier, iters, tol,
                          (int)max_iter, (int)grid, st);
  return launch<float>(q, (int)kw, diag, idx, val, len, ivu, b, x, scratch, barrier, iters, tol,
                       (int)max_iter, (int)grid, st);
}

}  // extern "C"
