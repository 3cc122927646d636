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
// Bound: bytes. A solve reads the live entries of K once (4 + s bytes each,
// s = 8 in float64: 7 MB at 100,000 animals), in its prologue; an iteration
// reads and writes a few q-vectors, 5.6 MB at 100,000 animals in float64
// (1.7 us at 3.35 TB/s, most of it resident in the 50 MB L2) and 56 MB at
// 1,000,000. The loop is a chain of dependent iterations, each two
// grid-wide waits apart.
//
// Design. The first kernel (eight lanes a row, element-indexed vector
// passes, three grid barriers an iteration, partials summed by one warp in a
// serial loop) took 0.0268 ms an iteration at 100,000 animals, 14 % of its
// bound. Its ablations took out 0.019 ms with the matvec (three dependent
// loads a row pass: length, then index and value, then the gathered p),
// 0.015 with the barriers and 0.011 with the serial sums (H100; PERF.md).
// This one:
//   - Rows by ownership. The rows are cut into one contiguous range a block
//     (ops/cg.cg_layout: equal shares of max(len, 1) + 2 a row), and each
//     block's chunks get a region of scratch; the plan makes both once, for
//     the card's grid. A block computes ap, x and r of its own rows only, in
//     one index space: only p and r are read by other blocks.
//   - K staged once a solve. In the launch's prologue each block compacts
//     its rows' live entries (a row with none gets one zero entry) into
//     chunks of 12 consecutive entries, the index word's top bit marking a
//     row's last entry, each chunk with its first row (and whether that row
//     began in an earlier chunk). The first chunks go to shared memory, as
//     many as it holds (all of them at 100,000 animals, ~40 % at 1,000,000),
//     the rest to the block's region of a copy in scratch, which is then
//     read coalesced (chunk-major planes) with evict-first loads. The padded
//     tables are read once.
//   - Matvec by chunks: a thread takes a chunk, issues its 12 gathers at once,
//     sums each row's run in order and writes the sums of the rows that end
//     in it; a run that goes on into the next chunk leaves its sum as the
//     chunk's tail, and the row's last chunk (which the prologue tells how
//     many chunks back the row began) adds the tails of its earlier chunks in
//     order after one block barrier. Threads take their chunks one after the
//     other with no barrier between, so that the warps' loads overlap. A
//     row 100 entries wide costs its chunks, not a warp's 100 steps; then
//     each row's own work (p, ap, x, r), two rows' loads in flight at once.
//     512 threads a block and chunks of 12 keep a thread within 128
//     registers and take the 100,000-animal system's blocks in one round.
//   - Two grid barriers an iteration. p is never written for other blocks
//     before it is read: (r_k, p_{k-1}) of every row sit side by side in one
//     16-byte pair (two buffers, k % 2), and a gather rebuilds
//     p_k = r_k + beta p_{k-1} from the pair with the same rounded operations
//     the row's owner uses, so the bits are those of a written p, and the
//     barrier after the p update is gone. One 16-byte load a gathered entry,
//     as the 8-byte one before it: no more sectors.
//   - Totals: after a barrier each of the first warps loads 32 of the grid's
//     partials at once, sums them by a fixed shuffle tree, and every thread
//     adds the warps' sums in order: the same sum in every block, one L2
//     round trip instead of a serial loop.
//   - A barrier is an integer counter in scratch, zeroed by the caller each
//     call (a memset in a captured sweep), raised once per block with a
//     release reduction and polled with acquire loads; the wait traps after a
//     few seconds (an error, never a hang). Data other blocks wrote is read
//     through L2 (ld.global.cg).
//   - No float atomics: every sum has one order, fixed by the grid and the
//     rows (two runs on one grid give the same bits). Every product is
//     rounded before it is added (no contraction into an FMA), as the plain
//     version (ops/cg.cg_solve_sparse_plain) and the JAX package round them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // one block an SM; 128 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 12;     // entries a thread takes at once: 6,144 a round
constexpr unsigned kEnd = 0x80000000u;  // in an index word: the row's last entry
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kPollLimit = 1LL << 23;  // a few seconds of reads in L2
enum { kPap = 0, kRr = 1, kBb = 2 };  // partial-sum slots

template <typename T>
struct Vec2;
template <>
struct Vec2<double> { using type = double2; };
template <>
struct Vec2<float> { using type = float2; };
template <typename T>
using pair_t = typename Vec2<T>::type;

template <typename T>
struct CgArgs {
  const T* diag;
  const int* idx;  // (q, kw)
  const T* val;    // (q, kw)
  const int* len;  // (q,)
  const T* ivu;    // one value
  const T* b;
  T* x;            // x0 on entry, the solution on exit
  const int* cuts;  // (grid - 1,) block b owns rows cuts[b - 1] .. cuts[b] - 1 (cuts[-1] = 0, cuts[grid - 1] = q)
  const long long* first;  // (grid + 1,) block b's chunk slots are first[b] .. first[b + 1] - 1
  pair_t<T>* pr[2];  // (r_k, p_{k-1}) of every row in pr[k % 2]
  T* ap;           // (q,)
  T* part;         // 3 x grid partial sums
  unsigned* cidx;  // the streamed chunks' heads, backs and index words: 2 + kChunk per chunk slot
  T* cval;         // their values: kChunk per chunk slot
  T* ctail;        // every chunk's tail: one per chunk slot
  T* clate;        // a chunk's first run where its row began earlier and ends in it
  T* rnorm;        // one value
  unsigned long long* barrier;  // zero on entry
  int* iters;      // one value
  long long q;
  int kw;
  int staged;      // chunks a block keeps in shared memory
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
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(bar) : "memory");
    long long n = 0;
    while (ld_acquire(bar) < target) {
      if (++n > kPollLimit) __trap();
    }
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
__device__ __forceinline__ T root(T v);
template <>
__device__ __forceinline__ float root<float>(float v) { return sqrtf(v); }
template <>
__device__ __forceinline__ double root<double>(double v) { return sqrt(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_down_sync(kFull, v, off));
  return v;
}

// The block's threads' values summed by a fixed tree, written to
// part[slot * gridDim.x + blockIdx.x] (by thread 0, which then releases it
// at the grid barrier that follows).
template <typename T>
__device__ __forceinline__ void block_partial(T v, T* red, T* part, int slot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T s = warp_sum(lane < kWarps ? red[lane] : T(0));
    if (lane == 0) part[slot * gridDim.x + blockIdx.x] = s;
  }
}

// The partials of a slot summed in one fixed order, the same in every
// block: warp w loads partials 32 w + lane at once and sums them by a
// shuffle tree; every thread adds the warps' sums in order. red: kWarps
// values of shared memory no other code uses.
template <typename T>
__device__ __forceinline__ T grid_total(const T* part, int slot, T* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = gridDim.x, nw = (G + 31) / 32;
  if (warp < nw) {
    const int i = 32 * warp + lane;
    const T s = warp_sum(i < G ? __ldcg(part + slot * G + i) : T(0));
    if (lane == 0) red[warp] = s;
  }
  __syncthreads();
  T s = red[0];
  for (int w = 1; w < nw; ++w) s = add(s, red[w]);
  __syncthreads();  // red is free again
  return s;
}

// A block's chunks: chunk c's head (its first row, local to the block, << 1,
// | 1 where that row began in an earlier chunk), its back (how many chunks
// back that row began, where it also ends in chunk c; else 0), kChunk index
// words and kChunk values; chunks below ns in shared memory (planes of ns),
// the rest in the block's region of the streamed copy (planes of cap, read
// with evict-first loads, so that they do not push the gathered pairs out
// of L2).
template <typename T>
struct Chunks {
  unsigned* sw;  // shared: head[ns], back[ns], then word[j][ns]
  T* sv;         // shared: val[j][ns]
  int ns;
  unsigned* gw;  // streamed: head[cap], back[cap], then word[j][cap]
  T* gv;         // streamed: val[j][cap]
  T* gt;         // every chunk's tail, [cap]
  T* gl;         // every chunk's late first run, [cap]
  long long cap;

  __device__ __forceinline__ unsigned head(int c) const { return c < ns ? sw[c] : __ldcs(gw + (c - ns)); }
  __device__ __forceinline__ unsigned back(int c) const {
    return c < ns ? sw[ns + c] : __ldcs(gw + cap + (c - ns));
  }
  __device__ __forceinline__ void put_head(int c, unsigned head_word, unsigned back_word) const {
    if (c < ns) {
      sw[c] = head_word;
      sw[ns + c] = back_word;
    } else {
      gw[c - ns] = head_word;
      gw[cap + c - ns] = back_word;
    }
  }
  __device__ __forceinline__ void put(int c, int j, unsigned w, T v) const {
    if (c < ns) {
      sw[(2 + j) * ns + c] = w;
      sv[j * ns + c] = v;
    } else {
      gw[(2 + j) * cap + (c - ns)] = w;
      gv[j * cap + (c - ns)] = v;
    }
  }
};

// Exclusive prefix of v over the block's threads in order; total: the sum.
__device__ __forceinline__ long long block_scan(long long v, long long* sh, long long& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < kWarps ? sh[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kWarps) sh[lane] = s;
  }
  __syncthreads();
  const long long before = warp > 0 ? sh[warp - 1] : 0;
  total = sh[kWarps - 1];
  __syncthreads();
  return before + inc - v;
}

// The prologue: the block's rows' live entries, compacted in row order
// (a row of none gets one entry (own index, 0)), into chunks. Each thread
// takes a contiguous run of rows. Returns the block's entry count.
template <typename T>
__device__ long long stage_rows(const CgArgs<T>& a, const Chunks<T>& ch, long long R0, long long R1,
                                long long* sh) {
  const long long per = (R1 - R0 + kThreads - 1) / kThreads;
  const long long lo = R0 + per * threadIdx.x < R1 ? R0 + per * threadIdx.x : R1;
  const long long hi = lo + per < R1 ? lo + per : R1;
  long long n = 0;
  for (long long i = lo; i < hi; ++i) n += max(__ldg(a.len + i), 1);
  long long total = 0;
  long long e = block_scan(n, sh, total);
  if ((total + kChunk - 1) / kChunk > ch.cap) __trap();  // a layout made for other rows
  for (long long i = lo; i < hi; ++i) {
    const int len = __ldg(a.len + i), m = max(len, 1);
    const int* ri = a.idx + i * a.kw;
    const T* rv = a.val + i * a.kw;
    const long long first = e / kChunk, last = (e + m - 1) / kChunk;
    for (int k = 0; k < m; ++k, ++e) {
      const int c = (int)(e / kChunk), j = (int)(e % kChunk);
      if (j == 0)
        ch.put_head(c, (unsigned)((i - R0) << 1) | (k > 0),
                    k > 0 && c == last ? (unsigned)(c - first) : 0u);
      ch.put(c, j, (unsigned)(len ? __ldg(ri + k) : (int)i) | (k == m - 1 ? kEnd : 0u),
             len ? __ldg(rv + k) : T(0));
    }
  }
  __syncthreads();
  return total;
}

// The sums of one chunk's runs: words w and values v of its n entries,
// gathered entries g; a row that ends here is written to sums[row], the
// first run of a row that began in an earlier chunk to gl[c] (back > 0), a
// run that goes on to gt[c].
template <typename T>
__device__ __forceinline__ void chunk_runs(const Chunks<T>& ch, int c, int n, unsigned h, unsigned back,
                                           const unsigned (&w)[kChunk], const T (&v)[kChunk],
                                           const T (&g)[kChunk], T* sums) {
  int row = (int)(h >> 1);
  bool first = true, open = false;
  T s = T(0);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < n) {
      const T prod = mul(v[j], g[j]);
      s = open ? add(s, prod) : prod;
      open = true;
      if (w[j] & kEnd) {
        if (first && back) {
          ch.gl[c] = s;
        } else {
          sums[row] = s;
        }
        ++row;
        first = false;
        open = false;
      }
    }
  }
  if (open) ch.gt[c] = s;
}

// One matvec over the block's chunks: gather(j) gives the vector's entry j;
// each row's sum over its entries goes to sums[row] (row local to the
// block). A thread takes chunks threadIdx.x, + kThreads, ... with no barrier
// between: its words first (shared memory, or evict-first loads of the
// streamed copy), then its gathers all issued, then its values; then, after
// one barrier, each row that began in an earlier chunk than it ends in adds
// the tails of its earlier chunks, in order, to its last run.
template <typename T, typename Gather>
__device__ __forceinline__ void walk(const Chunks<T>& ch, long long E, int NC, T* sums, Gather gather) {
  for (int c = threadIdx.x; c < NC; c += kThreads) {
    const long long left = E - (long long)kChunk * c;
    const int n = left < kChunk ? (int)left : kChunk;
    unsigned w[kChunk];
    T v[kChunk], g[kChunk];
    unsigned h, back;
    if (c < ch.ns) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) w[j] = j < n ? ch.sw[(2 + j) * ch.ns + c] : 0u;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n) g[j] = gather((long long)(w[j] & ~kEnd));
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) v[j] = j < n ? ch.sv[j * ch.ns + c] : T(0);
      h = ch.sw[c];
      back = ch.sw[ch.ns + c];
    } else {
      const long long o = c - ch.ns;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) w[j] = j < n ? __ldcs(ch.gw + (2 + j) * ch.cap + o) : 0u;
      h = __ldcs(ch.gw + o);
      back = __ldcs(ch.gw + ch.cap + o);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n) g[j] = gather((long long)(w[j] & ~kEnd));
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) v[j] = j < n ? __ldcs(ch.gv + j * ch.cap + o) : T(0);
    }
    chunk_runs(ch, c, n, h, back, w, v, g, sums);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NC; c += kThreads) {
    const unsigned back = ch.back(c);
    if (back) {
      T kp = __ldcg(ch.gt + (c - back));
      for (int cc = c - (int)back + 1; cc < c; ++cc) kp = add(kp, __ldcg(ch.gt + cc));
      sums[ch.head(c) >> 1] = add(kp, __ldcg(ch.gl + c));
    }
  }
  __syncthreads();  // every row's sum is in
}

// f(i, u) for the block's rows, i = lo + threadIdx.x + k kThreads in order,
// kRowBatch rows at a time: load(i) for all of them first (their loads all
// in flight), then use(i, loaded) for each in order.
constexpr int kRowBatch = 2;
template <typename Load, typename Use>
__device__ __forceinline__ void row_pass(long long lo, long long hi, Load load, Use use) {
  for (long long i0 = lo + threadIdx.x; i0 < hi; i0 += (long long)kRowBatch * kThreads) {
    decltype(load(i0)) got[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const long long i = i0 + (long long)k * kThreads;
      if (i < hi) got[k] = load(i);
    }
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const long long i = i0 + (long long)k * kThreads;
      if (i < hi) use(i, got[k]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) cg_kernel(const CgArgs<T> a) {
  extern __shared__ __align__(16) unsigned char sm[];
  using P = pair_t<T>;
  T* redp = reinterpret_cast<T*>(sm);  // block partials
  T* redt = redp + kWarps;       // totals
  T* redt2 = redt + kWarps;      // the second total of the first barrier
  T* sv = redt2 + kWarps;
  long long* scan = reinterpret_cast<long long*>(sv + (size_t)kChunk * a.staged);
  unsigned* sw = reinterpret_cast<unsigned*>(scan + kWarps);

  const int G = gridDim.x, blk = blockIdx.x;
  const long long R0 = blk == 0 ? 0 : a.cuts[blk - 1];
  const long long R1 = blk == G - 1 ? a.q : a.cuts[blk];
  const long long cbase = a.first[blk];
  const long long cap = a.first[blk + 1] - cbase;
  Chunks<T> ch{sw,  sv, a.staged, a.cidx + (2 + kChunk) * cbase, a.cval + kChunk * cbase,
               a.ctail + cbase, a.clate + cbase, cap};
  const long long E = stage_rows(a, ch, R0, R1, scan);
  const int NC = (int)((E + kChunk - 1) / kChunk);
  const T ivu = __ldg(a.ivu);
  unsigned long long arrivals = 0;

  // r = b - A x0 (pr[0].x), partials of r.r and b.b; a row's K x0 sum goes
  // through ap
  T rr = T(0), bb = T(0);
  {
    struct In { T kx, bi, di, xi; };
    T* r0 = reinterpret_cast<T*>(a.pr[0]);
    walk(ch, E, NC, a.ap + R0, [&](long long j) { return __ldcg(a.x + j); });
    row_pass(R0, R1,
             [&](long long i) { return In{a.ap[i], __ldg(a.b + i), __ldg(a.diag + i), __ldcg(a.x + i)}; },
             [&](long long i, const In& in) {
               const T ri = sub(in.bi, add(mul(in.di, in.xi), mul(ivu, in.kx)));
               r0[2 * i] = ri;
               rr = add(rr, mul(ri, ri));
               bb = add(bb, mul(in.bi, in.bi));
             });
  }
  block_partial(rr, redp, a.part, kRr);
  __syncthreads();
  block_partial(bb, redp, a.part, kBb);
  grid_barrier(a.barrier, arrivals += G);
  T rz = grid_total(a.part, kRr, redt);
  const T bnorm = root(grid_total(a.part, kBb, redt2));
  const T limit = mul(a.tol, bnorm > T(1e-30) ? bnorm : T(1e-30));

  int it = 0;
  T beta = T(0);
  while (root(rz) > limit && it < a.max_iter) {
    const P* prv = a.pr[it & 1];  // (r_k, p_{k-1})
    P* pnx = a.pr[(it & 1) ^ 1];  // (r_{k+1}, p_k)
    const bool it0 = it == 0;
    // p_k = r_k + beta p_{k-1} (p_0 = r_0), rebuilt from a pair wherever it is read
    auto p_of = [&](const P pr) { return it0 ? pr.x : add(pr.x, mul(beta, pr.y)); };

    // ap = A p of the block's rows (a row's K p sum first, through ap);
    // p_k written beside r_{k+1}; partials of p.ap
    struct Row { T kp, di; P own; };
    T pap = T(0);
    walk(ch, E, NC, a.ap + R0, [&](long long j) { return p_of(__ldcg(prv + j)); });
    row_pass(R0, R1,
             [&](long long i) { return Row{a.ap[i], __ldcs(a.diag + i), __ldcg(prv + i)}; },
             [&](long long i, const Row& in) {
               const T pi = p_of(in.own);
               const T api = add(mul(in.di, pi), mul(ivu, in.kp));
               a.ap[i] = api;
               reinterpret_cast<T*>(pnx + i)[1] = pi;
               pap = add(pap, mul(pi, api));
             });
    block_partial(pap, redp, a.part, kPap);
    grid_barrier(a.barrier, arrivals += G);
    const T alpha = rz / grid_total(a.part, kPap, redt);

    // x += alpha p, r -= alpha ap over the block's rows; partials of r.r
    struct Upd { T pi, xi, ri, api; };
    T rn = T(0);
    row_pass(R0, R1,
             [&](long long i) {
               return Upd{reinterpret_cast<const T*>(pnx + i)[1], __ldcs(a.x + i),
                          __ldcg(reinterpret_cast<const T*>(prv + i)), a.ap[i]};
             },
             [&](long long i, const Upd& in) {
               __stcs(a.x + i, add(in.xi, mul(alpha, in.pi)));
               const T ri = sub(in.ri, mul(alpha, in.api));
               reinterpret_cast<T*>(pnx + i)[0] = ri;
               rn = add(rn, mul(ri, ri));
             });
    block_partial(rn, redp, a.part, kRr);
    grid_barrier(a.barrier, arrivals += G);
    const T rz_new = grid_total(a.part, kRr, redt);
    beta = rz_new / rz;
    rz = rz_new;
    ++it;
  }
  if (blk == 0 && threadIdx.x == 0) {
    *a.iters = it;
    *a.rnorm = root(rz);
  }
}

// Shared memory of a block that stages `staged` chunks.
template <typename T>
size_t smem_bytes(long long staged) {
  return (size_t)(3 * kWarps) * sizeof(T) + (size_t)kWarps * sizeof(long long) +
         (size_t)staged * (kChunk * sizeof(T) + (2 + kChunk) * sizeof(unsigned));
}

// The chunks a block can stage, and the grid (the blocks the card holds at
// once with that much shared memory), per device, asked once (the first call
// comes before any capture: a captured sweep is run eagerly first).
template <typename T>
int shape(long long* staged_max, long long* grid) {
  static long long st[64], gr[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (gr[dev] == 0) {
    int sms = 0, optin = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess)
      return (int)err;
    const size_t per_chunk = smem_bytes<T>(1) - smem_bytes<T>(0);
    const long long chunks = ((long long)optin - (long long)smem_bytes<T>(0)) / (long long)per_chunk;
    if (chunks < 1) return (int)cudaErrorInvalidConfiguration;
    const size_t bytes = smem_bytes<T>(chunks);
    if ((err = cudaFuncSetAttribute(cg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_kernel<T>, kThreads, bytes)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    st[dev] = chunks;
    gr[dev] = (long long)sms * per_sm;
  }
  *staged_max = st[dev];
  *grid = gr[dev];
  return 0;
}

// Scratch layout, in bytes, 256-aligned regions: the two pair buffers, ap,
// the partials, the streamed chunks' words, their values, the chunks' tails
// and late first runs.
template <typename T>
struct Layout {
  size_t pr0, pr1, ap, part, cidx, cval, ctail, clate, total;
};

inline size_t up256(size_t n) { return (n + 255) / 256 * 256; }

template <typename T>
Layout<T> layout(long long q, long long slots, long long grid) {
  Layout<T> l;
  l.pr0 = 0;
  l.pr1 = up256(l.pr0 + (size_t)q * sizeof(pair_t<T>));
  l.ap = up256(l.pr1 + (size_t)q * sizeof(pair_t<T>));
  l.part = up256(l.ap + (size_t)q * sizeof(T));
  l.cidx = up256(l.part + (size_t)3 * grid * sizeof(T));
  l.cval = up256(l.cidx + (size_t)(2 + kChunk) * slots * sizeof(unsigned));
  l.ctail = up256(l.cval + (size_t)kChunk * slots * sizeof(T));
  l.clate = up256(l.ctail + (size_t)slots * sizeof(T));
  l.total = up256(l.clate + (size_t)slots * sizeof(T));
  return l;
}

template <typename T>
int launch(long long q, int kw, const void* diag, const void* idx, const void* val, const void* len,
           const void* ivu, const void* b, void* x, const void* cuts, const void* first, void* scratch,
           void* barrier, void* iters, void* rnorm, double tol, int max_iter, long long grid,
           long long slots, long long staged, cudaStream_t st) {
  long long staged_max = 0, resident = 0;
  const int err = shape<T>(&staged_max, &resident);
  if (err) return err;
  if (grid != resident) return (int)cudaErrorInvalidValue;
  const long long ns = staged < 0 || staged > staged_max ? staged_max : staged;
  const Layout<T> l = layout<T>(q, slots, grid);
  unsigned char* s = (unsigned char*)scratch;
  const CgArgs<T> a{(const T*)diag, (const int*)idx, (const T*)val, (const int*)len, (const T*)ivu,
                    (const T*)b, (T*)x, (const int*)cuts, (const long long*)first,
                    {(pair_t<T>*)(s + l.pr0), (pair_t<T>*)(s + l.pr1)}, (T*)(s + l.ap),
                    (T*)(s + l.part), (unsigned*)(s + l.cidx), (T*)(s + l.cval), (T*)(s + l.ctail),
                    (T*)(s + l.clate), (T*)rnorm,
                    (unsigned long long*)barrier, (int*)iters, q, kw, (int)ns, (T)tol, max_iter};
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<T>(ns);
  cfg.stream = st;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, cg_kernel<T>, a);
}

}  // namespace

extern "C" {

// The grid of every solve: the blocks the card holds at once, one an SM;
// -1 if the card cannot be asked.
long long ngt_cg_solve_grid(long long f64) {
  long long staged = 0, grid = 0;
  const int err = f64 ? shape<double>(&staged, &grid) : shape<float>(&staged, &grid);
  return err ? -1 : grid;
}

// Bytes of scratch one solve over q rows needs on a grid, its blocks' chunks
// in `slots` chunk slots.
long long ngt_cg_solve_scratch_bytes(long long f64, long long q, long long slots, long long grid) {
  return f64 ? (long long)layout<double>(q, slots, grid).total
             : (long long)layout<float>(q, slots, grid).total;
}

// One solve of (diag + ivu K) x = b, K in padded rows (idx int32 and val
// (q, kw), len (q,) int32 live lengths). x holds x0 on entry and the
// solution on exit; cuts (grid - 1,) int32 are the blocks' row cuts and
// first (grid + 1,) int64 their first chunk slots, of `slots` in all
// (ops/cg.cg_layout: at least ceil(a block's entries / 12) slots a block, a
// row of none holding one); scratch holds ngt_cg_solve_scratch_bytes for
// those slots; barrier is one zeroed uint64; iters one int32; rnorm one
// float. A block given fewer slots than its chunks traps. staged: chunks a
// block keeps in shared memory, -1 for as many as it holds (fewer force the
// streamed path). Every float is float64 where f64, else float32; every
// pointer on one device. grid comes from ngt_cg_solve_grid.
int ngt_cg_solve(long long f64, long long q, long long kw, const void* diag, const void* idx,
                 const void* val, const void* len, const void* ivu, const void* b, void* x,
                 const void* cuts, const void* first, void* scratch, void* barrier, void* iters,
                 void* rnorm, double tol, long long max_iter, long long grid, long long slots,
                 long long staged, void* stream) {
  if (q < 1 || kw < 1 || q > (1LL << 31) - 1 || max_iter < 0 ||
      max_iter > (1LL << 30) || grid < 1 || grid > (1 << 30) || slots < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return launch<double>(q, (int)kw, diag, idx, val, len, ivu, b, x, cuts, first, scratch, barrier,
                          iters, rnorm, tol, (int)max_iter, grid, slots, staged, st);
  return launch<float>(q, (int)kw, diag, idx, val, len, ivu, b, x, cuts, first, scratch, barrier, iters,
                       rnorm, tol, (int)max_iter, grid, slots, staged, st);
}

}  // extern "C"
