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
// writes d and bnew = bold - d. A SNP whose diagonal is 0 (a monomorphic
// SNP) has an infinite reciprocal, as the JAX package divides by 0: its
// draw and every later one of the gene are not finite.
//
// The triangle comes laid out once a chain (ops/grn_scan.grn_layout, from
// the chain's constant gram): tiles of 32 x 32, each row block's tiles
// left of the diagonal in a row, a tile's row r as 16-byte words that the
// 32 lanes of a warp read as one coalesced run; then per tile i its
// diagonal tile and the tile below it, column-major; then 1 / gram[q, q] and
// its square root, 0 past S. So no step divides and no read is strided.
//
// Bound: the chain. A call reads the triangle (S(S+1)/2 words) and 3 G S
// words and writes 2 G S: 0.48 MB at G = 100, S = 200 in float32, 0.14 us at
// 3.35 TB/s. Its S steps depend one on the next: a round of kRound SNPs
// costs one shuffle and kRound multiply-adds on the chain.
//
// Design: one block a gene, on one chain warp and kWorkers far-sum warps,
// in tiles of 32 SNPs with one named barrier a tile:
//  - the chain warp holds tile i: lane r owns SNP 32 i + r and its
//    w_r = -(r0 + the sums of the earlier tiles) / gram[q, q] - the noise
//    term. At step s lane s's w is d_s once it holds the terms of
//    d_0 .. d_{s-1}; each lane adds -gram[r, s] / gram[r, r] d_s to its w
//    (one multiply-add) and gram[32 (i + 1) + r, s] d_s to the next tile's
//    sum (the look-ahead), from the tiles (and the tile's reciprocals) that
//    a cp.async copy brought into shared memory while the tile before ran.
//    The steps go in rounds of kRound: the round's w's come to every lane
//    in kRound shuffles at once, and every lane finishes the round's d's
//    from their couplings (the same multiply-adds in the same order as one
//    step at a time: the same bits), so a round's chain is one shuffle and
//    kRound multiply-adds;
//  - meanwhile the far-sum warps form the next tile's sums over the tiles
//    before tile i: warp w takes tiles w, w + kWorkers, ..., its lane r
//    reads row r of each tile as 16-byte words (its next two tiles' in
//    flight in float32, one in float64, while it adds this one's, the queue
//    running on across the barriers) and the d's as 16-byte broadcasts from
//    shared memory;
//  - at the barrier the chain warp takes the warps' partial sums in warp
//    order for the next tile.
// The gene's d's sit in shared memory (S words) while the call runs: up to
// ngt_grn_scan_smem_snps SNPs (24,384 in float64 and 53,440 in float32 on
// an H100's 227 KB); past it the same kernel keeps them in scratch (device
// memory through L1). Every sum has a fixed order and nothing is atomic: a
// call gives the same bits every time, and a gene's d's do not depend on
// the other genes of the call.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// Internal linkage: a second build of this file loaded into the same process
// (chip_smoke.py's DIR and ablation builds) keeps its own kernels.
namespace {
namespace grn {

constexpr int kT = 32;            // SNPs a tile
constexpr int kTT = kT * kT;      // words a tile
constexpr int kWorkers = 7;       // far-sum warps a block
constexpr int kThreads = 32 * (kWorkers + 1);
constexpr int kRound = 4;         // SNPs a chain round: their w's shuffled at once
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float part_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ double part_of(const double2& v, int e) { return e == 0 ? v.x : v.y; }

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// A tile's slot of shared memory: its diagonal tile, the tile below it,
// and its SNPs' 1 / gram[q, q] and square roots.
constexpr int kSlot = 2 * kTT + 2 * kT;

// Tile i's slot from the layout (its chain tiles, src, and reciprocals,
// rinv and srinv) with cp.async, 16 bytes a copy; the caller commits and
// waits.
template <typename T>
__device__ __forceinline__ void copy_chain_tiles(T* dst, const T* src, const T* rinv, const T* srinv,
                                                 int lane) {
  constexpr int kWords = 16 / sizeof(T), kCopies = 2 * kTT / kWords;
#pragma unroll
  for (int j = 0; j < kCopies / 32; ++j) {
    const int c = (j * 32 + lane) * kWords;
    __pipeline_memcpy_async(dst + c, src + c, 16);
  }
  if (lane < kT / kWords) {
    __pipeline_memcpy_async(dst + 2 * kTT + lane * kWords, rinv + lane * kWords, 16);
    __pipeline_memcpy_async(dst + 2 * kTT + kT + lane * kWords, srinv + lane * kWords, 16);
  }
}

// The chain warp: tile by tile, w for its 32 SNPs, the 32 steps, d and bnew
// out; the next tile's chain tiles and inputs fetched while a tile runs.
// r0, z, bold, bnew and d are the gene's rows.
template <typename T>
__device__ __forceinline__ void run_chain(const T* chain, const T* rinv_all, const T* srinv_all,
                                          T* stage, const T* part, T* dbuf, const T* r0,
                                          const T* z, const T* bold, const T* var_e, T* bnew,
                                          T* d, int S, int nt, int lane) {
  const T sve = root(*var_e);
  copy_chain_tiles(stage, chain, rinv_all, srinv_all, lane);
  __pipeline_commit();
  const int qc = min(lane, S - 1);
  T rn = r0[qc], zn = z[qc], bn = bold[qc];  // the next tile's r0, z and bold
  T nxt = T(0);                              // and its look-ahead sum
  __pipeline_wait_prior(0);
  named_sync(1, kThreads);
  for (int i = 0; i < nt; ++i) {
    const int slot = i & 1;
    if (i + 1 < nt)
      copy_chain_tiles(stage + (slot ^ 1) * kSlot, chain + (long long)(i + 1) * 2 * kTT, rinv_all + (i + 1) * kT,
                       srinv_all + (i + 1) * kT, lane);
    __pipeline_commit();
    const int q = i * kT + lane;
    const T* tile = stage + slot * kSlot;  // tile[s * kT + r] = gram[32 i + r, 32 i + s]
    const T* rinv_t = tile + 2 * kTT;      // this tile's 1 / gram[q, q], then their roots
    const T rinv = rinv_t[lane], noise = sve * rinv_t[kT + lane];
    const T bo = bn;
    T acc = rn;
#pragma unroll
    for (int k = 0; k < kWorkers; ++k) acc += part[(slot * kWorkers + k) * kT + lane];
    acc += nxt;
    T w = madd(-acc, rinv, -(zn * noise)), myd = T(0);
    nxt = T(0);
    {  // the next tile's inputs (clamped in range past the last tile; not used there)
      const int qnc = min(q + kT, S - 1);
      rn = r0[qnc];
      zn = z[qnc];
      bn = bold[qnc];
    }
#pragma unroll
    for (int s0 = 0; s0 < kT; s0 += kRound) {
      // the round's couplings, the same in every lane: c[a][b] is lane
      // s0 + a's coefficient of d_{s0 + b}, -gram[s0 + a, s0 + b] / gram[s0 + a, s0 + a]
      T c[kRound][kRound];
#pragma unroll
      for (int a = 1; a < kRound; ++a) {
        const T ra = rinv_t[s0 + a];
#pragma unroll
        for (int b = 0; b < a; ++b) c[a][b] = -tile[(s0 + b) * kT + s0 + a] * ra;
      }
      T dr[kRound];  // the round's d's: its w's, then each one's terms from the round's earlier d's
#pragma unroll
      for (int a = 0; a < kRound; ++a) dr[a] = __shfl_sync(kFull, w, s0 + a);
#pragma unroll
      for (int a = 1; a < kRound; ++a) {
#pragma unroll
        for (int b = 0; b < a; ++b) dr[a] = madd(c[a][b], dr[b], dr[a]);
      }
#pragma unroll
      for (int a = 0; a < kRound; ++a) {
        const int s = s0 + a;
        w = madd(-tile[s * kT + lane] * rinv, dr[a], w);
        nxt = madd(tile[kTT + s * kT + lane], dr[a], nxt);
        myd = lane == s ? dr[a] : myd;
      }
    }
    dbuf[q] = myd;
    if (q < S) {
      d[q] = myd;
      bnew[q] = bo - myd;
    }
    __pipeline_wait_prior(0);
    named_sync(1, kThreads);
  }
}

// A far-sum warp (wk of kWorkers): while the chain runs tile i, its share
// of tile i + 1's sums over the tiles k < i, into part[(i + 1) & 1][wk].
// Its tiles, step by step (step i's: k = wk, wk + kWorkers, ... < i, in row
// block i + 1), form one queue whose rows it reads kAhead tiles ahead,
// across the steps' barriers (the layout is constant over the call).
template <typename T>
__device__ __forceinline__ void run_far(const T* lay, T* part, const T* dbuf, int nt, int wk, int lane) {
  using V = typename Vec<T>::type;
  constexpr int kWords = 16 / sizeof(T), kVecs = kT / kWords;  // a tile row's 16-byte words
  constexpr int kAhead = sizeof(T) == 4 ? 2 : 1;               // tiles read ahead
  V l[kAhead + 1][kVecs];
  int qi = wk + 1, qk = wk;  // the queue's next tile to read: step qi's tile qk
  auto read_next = [&](V(&dst)[kVecs]) {
    const bool live = qi + 1 < nt;  // past the queue's end: row block 1's tile 0, read and not added
    const long long at = live ? (long long)kTT * (qi + 1) * qi / 2 + (long long)qk * kTT : kTT;
    const V* t = reinterpret_cast<const V*>(lay + at) + lane;
#pragma unroll
    for (int m = 0; m < kVecs; ++m) dst[m] = __ldg(t + m * kT);
    qk += kWorkers;
    if (qk >= qi) {
      ++qi;
      qk = wk;
    }
  };
  if (nt > 2) {  // else no step has tiles (nor the layout a row block 1 at nt = 1)
#pragma unroll
    for (int a = 0; a < kAhead; ++a) read_next(l[a]);
  }
  part[wk * kT + lane] = T(0);
  named_sync(1, kThreads);
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) {
      T p = T(0);
      for (int k = wk; k < i; k += kWorkers) {
        read_next(l[kAhead]);
        const T* dk = dbuf + k * kT;
#pragma unroll
        for (int m = 0; m < kVecs; ++m) {
          const V dv = *reinterpret_cast<const V*>(dk + m * kWords);
#pragma unroll
          for (int e = 0; e < kWords; ++e) p = madd(part_of(l[0][m], e), part_of(dv, e), p);
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
#pragma unroll
          for (int m = 0; m < kVecs; ++m) l[a][m] = l[a + 1][m];
        }
      }
      part[(((i + 1) & 1) * kWorkers + wk) * kT + lane] = p;
    }
    named_sync(1, kThreads);
  }
}

// Shared memory: two tiles' slots, the partial sums (two slots) and, unless
// in scratch, the gene's d's (sp words).
template <typename T>
size_t smem_bytes(long long sp, bool scratch) {
  return sizeof(T) * (size_t)(2 * kSlot + 2 * kWorkers * kT + (scratch ? 0 : sp));
}

template <typename T, bool kScratch>
__global__ void __launch_bounds__(kThreads, 1)
    scan_kernel(const T* __restrict__ lay, const T* __restrict__ r0, const T* __restrict__ z,
                const T* __restrict__ bold, const T* __restrict__ var_e, T* __restrict__ bnew,
                T* __restrict__ d, T* scratch, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);  // [slot][diagonal tile, tile below][s][r], reciprocals
  T* part = stage + 2 * kSlot;            // [slot][warp][r]
  const int nt = (S + kT - 1) / kT, sp = nt * kT;
  T* dbuf = kScratch ? scratch + (long long)blockIdx.x * sp : part + 2 * kWorkers * kT;
  const T* chain = lay + (long long)kTT * nt * (nt - 1) / 2;
  const T* rinv_all = chain + 2LL * kTT * nt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    const long long row = (long long)blockIdx.x * S;
    run_chain<T>(chain, rinv_all, rinv_all + sp, stage, part, dbuf, r0 + row, z + row, bold + row, var_e,
                 bnew + row, d + row, S, nt, lane);
  } else {
    run_far<T>(lay, part, dbuf, nt, warp - 1, lane);
  }
}

int optin_bytes(long long* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *out = optin;
  return (int)err;
}

// The kernel's dynamic shared memory may go to the device's most: one limit
// for every call, so that no launch (a graph's either) outgrows a limit
// that a smaller call set.
template <typename T, bool kScratch>
int launch(long long optin, const void* lay, const void* r0, const void* z, const void* bold, const void* var_e,
           void* bnew, void* d, void* scratch, long long G, long long S, cudaStream_t st) {
  auto kern = scan_kernel<T, kScratch>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)optin);
  if (err != cudaSuccess) return (int)err;
  const long long sp = (S + kT - 1) / kT * kT;
  kern<<<(unsigned)G, kThreads, smem_bytes<T>(sp, kScratch), st>>>((const T*)lay, (const T*)r0, (const T*)z,
                                                                   (const T*)bold, (const T*)var_e, (T*)bnew,
                                                                   (T*)d, (T*)scratch, (int)S);
  return (int)cudaGetLastError();
}

// The scratch form exactly where one gene's d's do not fit in shared memory.
template <typename T>
int scan(const void* lay, const void* r0, const void* z, const void* bold, const void* var_e, void* bnew,
         void* d, void* scratch, long long G, long long S, cudaStream_t st) {
  long long optin = 0;
  const int err = optin_bytes(&optin);
  if (err) return err;
  const bool in_scratch = smem_bytes<T>((S + kT - 1) / kT * kT, false) > (size_t)optin;
  if (in_scratch != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  return in_scratch ? launch<T, true>(optin, lay, r0, z, bold, var_e, bnew, d, scratch, G, S, st)
                    : launch<T, false>(optin, lay, r0, z, bold, var_e, bnew, d, scratch, G, S, st);
}

}  // namespace grn
}  // namespace

// The most SNPs whose d's fit in shared memory on the current device
// (float64 where f64 is 1); past it a call takes scratch. -1 without a
// device.
extern "C" long long ngt_grn_scan_smem_snps(long long f64) {
  long long optin = 0;
  if (grn::optin_bytes(&optin)) return -1;
  const long long word = f64 ? 8 : 4;
  const long long rest = (long long)(f64 ? grn::smem_bytes<double>(0, false) : grn::smem_bytes<float>(0, false));
  return (optin - rest) / word / grn::kT * grn::kT;
}

// One GRN1 call: layout from ops/grn_scan.grn_layout of gram (S, S); r0, z,
// bold, bnew and d (G, S) row-major; var_e one value; scratch G x (S padded
// to 32) words where S > ngt_grn_scan_smem_snps(f64), else null; every
// pointer float32 (f64 = 0) or float64 (f64 = 1) on one device. One launch,
// a block a gene.
extern "C" int ngt_grn_scan(const void* layout, const void* r0, const void* z, const void* bold,
                            const void* var_e, void* bnew, void* d, void* scratch, long long G,
                            long long S, long long f64, void* stream) {
  if (G < 1 || S < 1 || G > 0x7fffffffLL || S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return f64 ? grn::scan<double>(layout, r0, z, bold, var_e, bnew, d, scratch, G, S, st)
             : grn::scan<float>(layout, r0, z, bold, var_e, bnew, d, scratch, G, S, st);
}
