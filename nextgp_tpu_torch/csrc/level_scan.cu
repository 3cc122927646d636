// The level scans of the random effects for Hopper (sm_90a): RE1, an
// uncorrelated effect's, and RE2 (at the end of the file), a correlated
// group's.
//
// Replaces no Pallas kernel. It is the counterpart of the `lax.scan` over
// levels in `sample_random_uni` (nextgp_tpu/engine/samplers/random_effects.py:
// 29-37; NextGP.jl's sampleU, functions.jl:57-72): levels i = 0 .. q-1 in
// order, each a Gauss-Seidel step against the prior coupling,
//   rhs  = yi[i] - ivu * sum_{k != i} A[i, k] u[k]
//   lhs  = zpz[i] * ive + A[i, i] * ivu
//   u[i] = rhs / lhs + z[i] * sqrt(1 / lhs)
// where the levels before i hold their new u and those after i their old
// one. A is the dense symmetric inverse structure (q, q) (I, A^-1 or
// G^-1), ive = 1/varE and ivu = 1/varU are read on the card (so that a
// replayed graph reads this sweep's values). With a = 1 / lhs,
// c = yi * a + z * sqrt(a) and b = ivu * a, a level is one FMA,
// u[i] = c[i] - b[i] * pre[i], pre[i] the sum above.
//
// Bound: bytes. The function needs A's lower triangle (by symmetry), once:
// q^2 / 2 floats, 200 MB at q = 10,000 (0.060 ms at 3.35 TB/s). This form
// reads all of A once, as the reference's loop does (0.119 ms); the chain of
// q dependent levels is latency.
//
// Design: two launches, the second persistent with a look-ahead.
//  1. prep, a warp per row: up[r] = sum_{k > r} A[r, k] u_old[k] (the strict
//     upper triangle), the level's (c, b), the row's part of the band (its
//     32 (L + 1) columns up to its group's end, copied 16-byte aligned
//     whatever q), and the row's published u and far sum set to an empty
//     mark.
//  2. scan, one grid no larger than the card holds at once. The levels go in
//     groups of 32; a row block is a group's 32 rows, a segment its 32
//     columns. Block 0 runs the chain on one warp and feeds it from two
//     others; every warp of the other blocks owns row blocks R > L (L =
//     kLook) and adds into them, segment by segment as the chain publishes
//     them, the new u of every segment s <= R - L - 1 ("far"). The chain's
//     SM reads only the groups' bands, 32 x 32 (L + 1) floats a group; the
//     rest of A goes through the other SMs. Row r of group g sums, in this
//     order,
//       ((up[r] + far[r]) + win[r]) + carry[r], then its group's new u's
//     win: segments g - L .. g - 2, by block 0's window warp, all but the
//     last before the chain ends group g - 2; carry: segment g - 1, added by
//     the chain warp itself while it runs group g - 1 (an FMA per level
//     beside the chain, off its dependent path). Block 0's warps:
//       0 chain: a lane per level of the group, its pre in a register. The
//         levels go four at a time: four shuffles fetch their pre's at once,
//         and within the four, u[j + m] = (c - b pre) - sum_{l < m} e_ml u[j + l]
//         with e_ml = b[j + m] A[j + m, j + l], so that the four cost one
//         shuffle's latency and five FMAs on the dependent path. Lane 0
//         keeps each four u's in shared memory (one 16-byte store: a select
//         of its own u in every lane cost ~600 cycles a group on the
//         in-order path of an H100), and the group's u go to device memory
//         as it ends
//       1 window
//       2 stager: cp.async of the next groups' bands, (c, b) and up into a
//         ring of kSlots, kSlots - 2 groups in flight, then the group's e
//     meeting on counters in shared memory. The chain loads group g + 1's
//     far sums while it runs group g, and an owner the next segment's u
//     while it sums the last: a read of device memory is a round trip of
//     ~700 cycles, and one a group on the chain's path capped it at ~1,900
//     cycles a group (H100). An owner warp stages its 32 x 32 blocks through
//     shared memory ahead of time (coalesced rows, padded to 36 words),
//     waits for a segment's u, and when its last segment is in writes
//     far[R]. No flag and no fence: a published word is its own flag. prep
//     fills the published u's and far sums with an empty mark, a NaN that
//     no arithmetic on the card yields (it returns the canonical NaN), and a
//     reader polls its 32 words with relaxed loads at device scope until no
//     lane sees the mark; each word is written once, so a word read is the
//     word written. The marks are set in the call, so a replayed graph needs
//     no reset from the host. Block 0 and the owners wait for each other,
//     so every block of the grid must be resident at once: the scan is a
//     cooperative launch, which the driver runs with all its blocks on the
//     card or refuses with an error (a grid larger than the card holds), and
//     which a stream capture takes as a cooperative graph node. A wait then
//     only ever lasts for work in flight; one that outlasts ~1 s all the same
//     traps (an error, never a hang).
// Every sum has a fixed order and nothing is atomic: two runs give the same
// bits, whatever the timing. The plain version
// (ops/random_scan.level_scan_plain) runs the same blocks in the same order.
// One call is two launches.
//
// Float64 (`ngt_level_scan_f64`): the same body, templated on the element
// type T, with A, u, the sums, (c, b) and every staged word in double. What
// differs is what a 227 KB block and an 8-byte word force:
//  * the ring: slots_of<T>() takes the most slots, up to kMaxSlots, whose
//    chain side fits kSmemLimit: 7 in float (199,936 bytes, as before), 4 in
//    double (216,960), so two groups are in flight where float has five;
//  * the staged rows: 34 doubles apart (272 bytes: 16-byte aligned, and a
//    warp's 16-byte reads of eight rows fall on eight distinct 4-bank
//    groups), where float's are 36 words apart; a 16-byte copy moves two
//    doubles, so a band row takes 16 lanes;
//  * the published words: a 64-bit empty mark (kEmpty64, a signalling NaN;
//    the card's arithmetic returns the canonical 0x7fffffffffffffff), read
//    and written by ld/st.relaxed.gpu.global.b64, one access a word, so that
//    a word read is still the word written;
//  * the resident-block count: asked once per device per instance (another
//    shared-memory size, another occupancy).
// The float instance's arithmetic, order and bits are those of the float
// kernel before the template.
#include <cuda_pipeline.h>

#include "common.cuh"
#include "scan_skeleton.cuh"  // RE2's staging helpers

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;   // rows per block of the prep launch
constexpr int kLook = 5;       // L: groups between a segment's publication and its far rows' chain
constexpr int kBand = kLook + 1;  // segments of a group's band: g - L .. g
constexpr int kMaxSlots = 7;   // block 0's ring of group bands, at most
constexpr int kURing = kLook + 2;  // groups of new u block 0 keeps
constexpr int kOwnSlots = 4;   // an owner warp's ring of staged blocks
constexpr int kMaxOwn = 16;    // row blocks per owner warp
constexpr int kWarps = 4;      // warps per block of the scan launch: one per scheduler
constexpr size_t kSmemLimit = 232448;  // the shared memory an H100 block may opt in to
constexpr int kEmpty = 0x7fbad0e5;  // a NaN: no arithmetic on the card yields it
constexpr long long kEmpty64 = 0x7ff7bad0e5bad0e5LL;  // its float64 counterpart
constexpr long long kSpinLimit = 1LL << 25;  // ~1 s of reads in shared memory
constexpr long long kPollLimit = 1LL << 22;  // ~1 s of reads in device memory
static_assert(kLook >= 2 && kURing >= kLook + 1, "the window is segments g - L .. g - 2");

// What the element type decides: words per staged row (16-byte aligned,
// conflict-free 16-byte reads) and elements per 16-byte copy.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kStride = 36;
};
template <>
struct Elem<double> {
  static constexpr int kStride = 34;
};
template <typename T>
constexpr int kStrideOf = Elem<T>::kStride;
template <typename T>
constexpr int kBlockWordsOf = 32 * kStrideOf<T>;
template <typename T>
constexpr int kPerCopy = 16 / (int)sizeof(T);

__device__ __forceinline__ bool is_empty(float v) { return __float_as_int(v) == kEmpty; }
__device__ __forceinline__ bool is_empty(double v) { return __double_as_longlong(v) == kEmpty64; }
template <typename T>
__device__ __forceinline__ T empty_word();
template <>
__device__ __forceinline__ float empty_word<float>() { return __int_as_float(kEmpty); }
template <>
__device__ __forceinline__ double empty_word<double>() { return __longlong_as_double(kEmpty64); }

template <typename T>
__device__ __forceinline__ T nan_word();
template <>
__device__ __forceinline__ float nan_word<float>() { return __int_as_float(0x7fffffff); }
template <>
__device__ __forceinline__ double nan_word<double>() { return __longlong_as_double(0x7fffffffffffffffLL); }

__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }

using ngt::mad;

__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ double ld_relaxed(const double* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return __longlong_as_double(v);
}

__device__ __forceinline__ void st_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed(double* p, double v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(__double_as_longlong(v)) : "memory");
}

// Four consecutive elements of shared memory, 16-byte aligned: one 16-byte
// read in float, two in double.
template <typename T>
struct Four {
  T x, y, z, w;
};
__device__ __forceinline__ Four<float> ld4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Four<double> ld4(const double* p) {
  const double2 a = *reinterpret_cast<const double2*>(p), b = *reinterpret_cast<const double2*>(p + 2);
  return {a.x, a.y, b.x, b.y};
}
__device__ __forceinline__ void st4(float* p, float x, float y, float z, float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}
__device__ __forceinline__ void st4(double* p, double x, double y, double z, double w) {
  *reinterpret_cast<double2*>(p) = make_double2(x, y);
  *reinterpret_cast<double2*>(p + 2) = make_double2(z, w);
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(double* p, double x, double y) {
  *reinterpret_cast<double2*>(p) = make_double2(x, y);
}

// A group's band in block 0: blocks j = 0 .. L of A[rows of g, segment
// g - L + j] (j = L the diagonal block), the levels' (c, b) (interleaved),
// up, win, and the e of its eight quads (e[8 k + m (m - 1) / 2 + l] for
// level 4 k + m).
template <typename T>
struct Slot {
  T blk[kBand * kBlockWordsOf<T>];
  T cb[64];
  T e[64];
  T up[32];
  T win[32];
};
enum { kStaged, kWinOk, kDone, kCounters };

template <typename T>
__host__ __device__ constexpr size_t chain_bytes(int slots) {
  return slots * sizeof(Slot<T>) + kURing * 32 * sizeof(T) + 32 * sizeof(int);
}
// The most slots, up to kMaxSlots, whose chain side fits a block
template <typename T>
__host__ __device__ constexpr int slots_of() {
  int s = kMaxSlots;
  while (s > 3 && chain_bytes<T>(s) > kSmemLimit) --s;
  return s;
}
template <typename T>
__host__ __device__ constexpr size_t owner_words() { return kOwnSlots * kBlockWordsOf<T> + kMaxOwn * 32; }
template <typename T>
__host__ __device__ constexpr size_t scan_smem() {
  return chain_bytes<T>(slots_of<T>()) > kWarps * owner_words<T>() * sizeof(T)
             ? chain_bytes<T>(slots_of<T>()) : kWarps * owner_words<T>() * sizeof(T);
}
static_assert(slots_of<float>() == kMaxSlots && scan_smem<float>() == 199936, "the float ring as before");
static_assert(slots_of<double>() >= 3 && scan_smem<double>() <= kSmemLimit,
              "the chain reads two groups' bands, and one more is in flight");

// Wait until a counter of block 0 reaches v, sleeping between reads (the
// chain warp spins on its two counters itself, without sleeping).
__device__ __forceinline__ void wait_ge(const volatile int* c, int v) {
  long long n = 0;
  while (*c < v) {
    if (++n > kSpinLimit) __trap();
    __nanosleep(32);
  }
  __threadfence_block();
}

// Raise a counter of block 0 to v once the warp's shared-memory writes are seen.
__device__ __forceinline__ void raise(volatile int* c, int v, int lane) {
  __threadfence_block();
  __syncwarp();
  if (lane == 0) *c = v;
}

// The 32 published words p[0 .. 31], lane l's in lane l, once every lane
// sees its word written. No sleep between reads: the readers are the chain
// and the owners whose sums it waits for.
template <typename T>
__device__ __forceinline__ T wait_words(const T* p, int lane) {
  long long n = 0;
  for (;;) {
    const T v = ld_relaxed(p + lane);
    if (__all_sync(kFull, !is_empty(v))) return v;
    if (++n > kPollLimit) __trap();
  }
}

// Copy a group's band (kBand 32 x 32 blocks, rows 32 elements apart) into
// dst (rows kStride elements apart) with 16-byte cp.async: in float eight
// lanes a row, four rows a copy; in double 16 lanes a row, two rows a copy.
// Unrolled, every copy is one instruction at a constant offset from the
// lane's first: with the offsets computed per copy the stager fell behind
// the chain at L = 5 (H100).
template <typename T>
__device__ __forceinline__ void stage_band(T* dst, const T* src, int lane) {
  constexpr int S = kStrideOf<T>, P = kPerCopy<T>, LR = 32 / P;  // lanes a row
  T* d = dst + (lane / LR) * S + (lane % LR) * P;
  const T* s = src + (lane / LR) * 32 + (lane % LR) * P;
#pragma unroll
  for (int b = 0; b < kBand; ++b) {
#pragma unroll
    for (int i = 0; i < 32 / P; ++i) {
      __pipeline_memcpy_async(d + b * kBlockWordsOf<T> + i * P * S, s + b * 1024 + i * P * 32, 16);
    }
  }
}

// A[r0 .. r0 + 31, c0 .. c0 + 31] from A itself: 16-byte copies where A's
// rows are 16-byte aligned (wide: q a multiple of 16 bytes' elements and A
// aligned), else one element a copy, a lane a column. A block inside A
// takes the unrolled copies with no bounds checks (an owner's blocks all do
// but in the last row block).
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, const T* A, long long q, long long r0, long long c0,
                                            bool wide, int lane) {
  constexpr int S = kStrideOf<T>, P = kPerCopy<T>, LR = 32 / P;
  if (r0 + 32 <= q && c0 + 32 <= q) {
    if (wide) {
      const T* s = A + (r0 + lane / LR) * q + c0 + (lane % LR) * P;
      T* d = dst + (lane / LR) * S + (lane % LR) * P;
#pragma unroll
      for (int i = 0; i < 32 / P; ++i, s += P * q) __pipeline_memcpy_async(d + i * P * S, s, 16);
    } else {
      const T* s = A + r0 * q + c0 + lane;
#pragma unroll
      for (int row = 0; row < 32; ++row, s += q) __pipeline_memcpy_async(dst + row * S + lane, s, sizeof(T));
    }
    return;
  }
  if (wide) {
#pragma unroll
    for (int t = lane; t < 32 * LR; t += 32) {
      const int row = t / LR, col = (t % LR) * P;
      T* d = dst + row * S + col;
      if (r0 + row < q && c0 + col < q) {
        __pipeline_memcpy_async(d, A + (r0 + row) * q + c0 + col, 16);
      } else {
#pragma unroll
        for (int k = 0; k < P; ++k) d[k] = T(0);
      }
    }
  } else {
#pragma unroll 4
    for (int row = 0; row < 32; ++row) {
      T* d = dst + row * S + lane;
      if (r0 + row < q && c0 + lane < q) {
        __pipeline_memcpy_async(d, A + (r0 + row) * q + c0 + lane, sizeof(T));
      } else {
        *d = T(0);
      }
    }
  }
}

// sum_c row[c] * u_c; row: 32 elements in shared memory, u_c in lane c's uc;
// four interleaved partial sums added in a fixed order.
template <typename T>
__device__ __forceinline__ T row_dot_lanes(const T* row, T uc) {
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
  for (int c = 0; c < 32; c += 4) {
    const Four<T> a = ld4(row + c);
    s0 = mad(a.x, __shfl_sync(kFull, uc, c), s0);
    s1 = mad(a.y, __shfl_sync(kFull, uc, c + 1), s1);
    s2 = mad(a.z, __shfl_sync(kFull, uc, c + 2), s2);
    s3 = mad(a.w, __shfl_sync(kFull, uc, c + 3), s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// sum_c row[c] * u[c], both 32 elements in shared memory (u read by every
// lane alike), in four interleaved partial sums added in a fixed order.
template <typename T>
__device__ __forceinline__ T row_dot_shared(const T* row, const T* u) {
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
  for (int c = 0; c < 32; c += 4) {
    const Four<T> a = ld4(row + c);
    const Four<T> v = ld4(u + c);
    s0 = mad(a.x, v.x, s0);
    s1 = mad(a.y, v.y, s1);
    s2 = mad(a.z, v.z, s2);
    s3 = mad(a.w, v.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// 1. prep: a warp per row r < 32 G. Lane l sums the columns r + 1 + l,
// r + 33 + l, ... in four partial sums, then the warp's fixed shuffle tree.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    prep_kernel(const T* __restrict__ A, long long q, int G, const T* __restrict__ u,
                const T* __restrict__ yi, const T* __restrict__ zpz, const T* __restrict__ z,
                const T* __restrict__ ive, const T* __restrict__ ivu, T* __restrict__ up,
                T* __restrict__ cb, T* __restrict__ unew, T* __restrict__ far, T* __restrict__ band) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= 32LL * G) return;
  const long long g = r >> 5;
  T* brow = band + (g * kBand * 32 + (r & 31)) * 32;  // band[g][j][r & 31][c]
  const T* row = A + r * q;
#pragma unroll
  for (int j = 0; j < kBand; ++j) {
    const long long c = 32 * (g - kLook + j) + lane;
    brow[j * 1024 + lane] = r < q && c >= 0 && c < q ? __ldg(row + c) : T(0);
  }
  if (lane == 0) unew[r] = far[r] = empty_word<T>();
  if (r >= q) {  // a pad level: u = 0 - 0 * pre, and nothing added to it
    if (lane == 0) {
      up[r] = T(0);
      st2(cb + 2 * r, T(0), T(0));
    }
    return;
  }
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  long long c = r + 1 + lane;
  for (; c + 96 < q; c += 128) {
    s0 = mad(__ldg(row + c), __ldg(u + c), s0);
    s1 = mad(__ldg(row + c + 32), __ldg(u + c + 32), s1);
    s2 = mad(__ldg(row + c + 64), __ldg(u + c + 64), s2);
    s3 = mad(__ldg(row + c + 96), __ldg(u + c + 96), s3);
  }
  for (; c < q; c += 32) s0 = mad(__ldg(row + c), __ldg(u + c), s0);
  const T s = ngt::warp_sum((s0 + s1) + (s2 + s3));
  if (lane == 0) {
    up[r] = s;
    const T iv = __ldg(ivu);
    const T a = T(1) / (__ldg(zpz + r) * __ldg(ive) + __ldg(row + r) * iv);
    st2(cb + 2 * r, __ldg(yi + r) * a + __ldg(z + r) * sqrt_of(a), iv * a);
  }
}

template <typename T>
struct ScanArgs {
  const T* A;
  long long q;
  int G;           // groups, ceil(q / 32)
  int owners;      // owner warps: every warp of blocks 1 ..
  bool wide;       // 16-byte copies of A's rows
  const T* up;     // (32 G,) from prep
  const T* cb;     // (32 G, 2) from prep
  const T* band;   // (G, L + 1, 32, 32) from prep
  T* far;          // (32 G,) the owners' sums, published
  T* unew;         // (32 G,) the new u, published
  T* u;            // (q,) the new u
};

// Block 0, warp 0: the chain, four levels a step.
template <typename T>
__device__ __forceinline__ void chain_warp(const ScanArgs<T>& a, Slot<T>* slots, T (*uring)[32],
                                           volatile int* ctr, int lane) {
  constexpr int S = slots_of<T>(), kStride = kStrideOf<T>, kBlockWords = kBlockWordsOf<T>;
  // far of row block g (0 up to L: no segment is that far back), loaded a group ahead
  auto far_load = [&](int g) { return g > kLook && g < a.G ? ld_relaxed(a.far + 32LL * g + lane) : T(0); };
  T carry = 0, far_next = 0;
  for (int g = 0; g < a.G; ++g) {
    const bool next = g + 1 < a.G;
    long long n = 0;
    while (ctr[kStaged] < (next ? g + 2 : g + 1) || ctr[kWinOk] < g + 1) {
      if (++n > kSpinLimit) __trap();
    }
    __threadfence_block();
    T far = far_next;
    if (g > kLook && !__all_sync(kFull, !is_empty(far))) {
      far = wait_words(a.far + 32LL * g, lane);
    }
    far_next = far_load(g + 1);
    const Slot<T>& s = slots[g % S];
    T acc = ((s.up[lane] + far) + s.win[lane]) + carry;
    T d[32], dn[32];
    const T* drow = s.blk + kLook * kBlockWords + lane * kStride;  // A[32 g + lane, 32 g + c]
    const T* nrow = slots[(g + 1) % S].blk + (kLook - 1) * kBlockWords + lane * kStride;
#pragma unroll
    for (int c = 0; c < 32; c += 4) {  // every word loaded before the select
      const Four<T> x = ld4(drow + c), y = ld4(nrow + c);
      d[c] = x.x, d[c + 1] = x.y, d[c + 2] = x.z, d[c + 3] = x.w;
      dn[c] = next ? y.x : T(0), dn[c + 1] = next ? y.y : T(0);
      dn[c + 2] = next ? y.z : T(0), dn[c + 3] = next ? y.w : T(0);
    }
    carry = 0;
    T* ug = uring[g % kURing];  // the window's reads of this slot's old group are done
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      const Four<T> k01 = ld4(s.cb + 2 * j), k23 = ld4(s.cb + 2 * j + 4);  // (c, b) of levels j .. j + 3
      const Four<T> ea = ld4(s.e + 2 * j), eb = ld4(s.e + 2 * j + 4);      // e10 e20 e21 e30, e31 e32
      const T p0 = __shfl_sync(kFull, acc, j), p1 = __shfl_sync(kFull, acc, j + 1);
      const T p2 = __shfl_sync(kFull, acc, j + 2), p3 = __shfl_sync(kFull, acc, j + 3);
      const T u0 = mad(-k01.y, p0, k01.x);
      T t1 = mad(-k01.w, p1, k01.z), t2 = mad(-k23.y, p2, k23.x), t3 = mad(-k23.w, p3, k23.z);
      const T u1 = mad(-ea.x, u0, t1);
      t2 = mad(-ea.y, u0, t2);
      t3 = mad(-ea.w, u0, t3);
      const T u2 = mad(-ea.z, u1, t2);
      t3 = mad(-eb.x, u1, t3);
      const T u3 = mad(-eb.y, u2, t3);
      if (lane == 0) st4(ug + j, u0, u1, u2, u3);
      acc = mad(d[j], u0, acc);  // the later levels of this group
      acc = mad(d[j + 1], u1, acc);
      acc = mad(d[j + 2], u2, acc);
      acc = mad(d[j + 3], u3, acc);
      carry = mad(dn[j], u0, carry);  // the next group's rows
      carry = mad(dn[j + 1], u1, carry);
      carry = mad(dn[j + 2], u2, carry);
      carry = mad(dn[j + 3], u3, carry);
    }
    raise(ctr + kDone, g + 1, lane);
    const T mine = ug[lane];
    st_relaxed(a.unew + 32LL * g + lane, mine);
    if (32LL * g + lane < a.q) a.u[32LL * g + lane] = mine;
  }
}

// Block 0, warp 1: win of row block g, its sum over segments g - L .. g - 2
// in order: the first L - 2 as soon as the band is in (groups up to g - 3
// are done by then), the last once group g - 2 is, so that one block's sum
// lies between the chain's end of group g - 2 and its start of group g.
template <typename T>
__device__ __forceinline__ void window_warp(const ScanArgs<T>& a, Slot<T>* slots, T (*uring)[32],
                                            volatile int* ctr, int lane) {
  constexpr int S = slots_of<T>(), kStride = kStrideOf<T>, kBlockWords = kBlockWordsOf<T>;
  for (int g = 0; g < 2 && g < a.G; ++g) slots[g].win[lane] = T(0);
  raise(ctr + kWinOk, a.G < 2 ? a.G : 2, lane);
  for (int g = 2; g < a.G; ++g) {
    wait_ge(ctr + kStaged, g + 1);
    Slot<T>& s = slots[g % S];
    T win = 0;
#pragma unroll
    for (int j = 0; j < kLook - 2; ++j) {  // segments g - L .. g - 3
      const int sg = g - kLook + j;
      if (sg >= 0) win += row_dot_shared(s.blk + j * kBlockWords + lane * kStride, uring[sg % kURing]);
    }
    long long n = 0;
    while (ctr[kDone] < g - 1) {  // group g - 2 done; no sleep: the chain is a group from its start
      if (++n > kSpinLimit) __trap();
    }
    __threadfence_block();
    s.win[lane] = win + row_dot_shared(s.blk + (kLook - 2) * kBlockWords + lane * kStride,
                                       uring[(g - 2) % kURing]);
    raise(ctr + kWinOk, g + 1, lane);
  }
}

// The e of a staged group's quads: lane r = 4 k + m (m >= 1) writes
// e_ml = b[r] A[r, 4 k + l] for l < m.
template <typename T>
__device__ __forceinline__ void quad_coupling(Slot<T>& s, int lane) {
  const int m = lane & 3;
  const T b = s.cb[2 * lane + 1];
  const T* row = s.blk + kLook * kBlockWordsOf<T> + lane * kStrideOf<T> + (lane & ~3);
  for (int l = 0; l < m; ++l) s.e[8 * (lane >> 2) + m * (m - 1) / 2 + l] = b * row[l];
}

// Block 0, warp 2: the bands of the groups ahead, into slot g % S once group
// g - S is done, S - 2 groups in flight; "staged" counts the groups whose
// copies are in and whose e is written.
template <typename T>
__device__ __forceinline__ void stager_warp(const ScanArgs<T>& a, Slot<T>* slots, volatile int* ctr, int lane) {
  constexpr int S = slots_of<T>(), kInFlight = S - 2, P = kPerCopy<T>;
  constexpr int kCb = 64 / P, kUp = 32 / P;  // 16-byte copies of (c, b) and of up
  for (int g = 0; g < a.G; ++g) {
    wait_ge(ctr + kDone, g - S + 1);
    Slot<T>& s = slots[g % S];
    stage_band(s.blk, a.band + (size_t)g * kBand * 1024, lane);
    for (int i = lane; i < kCb + kUp; i += 32) {
      if (i < kCb) {
        __pipeline_memcpy_async(s.cb + P * i, a.cb + 64LL * g + P * i, 16);
      } else {
        __pipeline_memcpy_async(s.up + P * (i - kCb), a.up + 32LL * g + P * (i - kCb), 16);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(kInFlight - 1);
    const int in = g - kInFlight + 1;  // the group now in
    if (in >= 0) {
      __syncwarp();
      quad_coupling(slots[in % S], lane);
      raise(ctr + kStaged, in + 1, lane);
    }
  }
  __pipeline_wait_prior(0);
  __syncwarp();
  for (int in = a.G - kInFlight + 1 > 0 ? a.G - kInFlight + 1 : 0; in < a.G; ++in) {
    quad_coupling(slots[in % S], lane);
  }
  raise(ctr + kStaged, a.G, lane);
}

// Every warp of blocks 1 ..: owner `ow` of the row blocks R = L + 1 + ow +
// k * owners. Its work items (s, k) go in ascending s, then k: the segment
// s's block of row block R_k for every R_k with s <= R_k - L - 1. They are
// staged kOwnSlots - 1 ahead; a segment's u is awaited before its first
// item is summed.
template <typename T>
__device__ __forceinline__ void owner_warp(const ScanArgs<T>& a, T* smem, int ow, int lane) {
  constexpr int kStride = kStrideOf<T>, kBlockWords = kBlockWordsOf<T>;
  const int R0 = kLook + 1 + ow, W = a.owners;
  if (R0 >= a.G) return;
  const int nown = (a.G - 1 - R0) / W + 1;
  const int s_end = R0 + (nown - 1) * W - kLook;  // items have s < s_end
  T* ring = smem;
  T* accs = smem + kOwnSlots * kBlockWords;
  auto first_k = [&](int s) {
    const int need = s + kLook + 1 - R0;
    return need <= 0 ? 0 : (need + W - 1) / W;
  };
  int is = 0, ik = 0;  // the next item to stage
  auto stage_next = [&](int slot) {
    if (is < s_end) {
      stage_block(ring + slot * kBlockWords, a.A, a.q, 32LL * (R0 + ik * W), 32LL * is, a.wide, lane);
      if (++ik == nown) ik = first_k(++is);
    }
    __pipeline_commit();
  };
#pragma unroll 1
  for (int t = 0; t < kOwnSlots - 1; ++t) stage_next(t);
  int cs = 0, ck = 0, seen = -1;
  T us = 0, us_next = empty_word<T>();  // the next segment's u, loaded ahead
#pragma unroll 1
  for (int t = 0; cs < s_end; ++t) {
    stage_next((t + kOwnSlots - 1) % kOwnSlots);
    __pipeline_wait_prior(kOwnSlots - 1);
    __syncwarp();
    if (cs != seen) {
      us = __all_sync(kFull, !is_empty(us_next)) ? us_next : wait_words(a.unew + 32LL * cs, lane);
      us_next = cs + 1 < s_end ? ld_relaxed(a.unew + 32LL * (cs + 1) + lane) : T(0);
      seen = cs;
    }
    const int R = R0 + ck * W;
    const T dot = row_dot_lanes(ring + (t % kOwnSlots) * kBlockWords + lane * kStride, us);
    const T acc = cs == 0 ? dot : accs[ck * 32 + lane] + dot;
    if (cs == R - kLook - 1) {
      st_relaxed(a.far + 32LL * R + lane, acc);  // pad rows: 0
    } else {
      accs[ck * 32 + lane] = acc;
    }
    __syncwarp();  // the slot is read; the next stage may refill it
    if (++ck == nown) ck = first_k(++cs);
  }
}

// 2. scan: block 0 the chain and its two feeders, the rest owners.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps, 1) scan_kernel(const ScanArgs<T> a) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr int S = slots_of<T>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x > 0) {
    owner_warp(a, reinterpret_cast<T*>(sm) + warp * owner_words<T>(), (blockIdx.x - 1) * kWarps + warp, lane);
    return;
  }
  Slot<T>* slots = reinterpret_cast<Slot<T>*>(sm);
  T(*uring)[32] = reinterpret_cast<T(*)[32]>(sm + S * sizeof(Slot<T>));  // 16-byte aligned
  volatile int* ctr = reinterpret_cast<volatile int*>(sm + S * sizeof(Slot<T>) + kURing * 32 * sizeof(T));
  if (threadIdx.x < kCounters) ctr[threadIdx.x] = 0;
  __syncthreads();
  switch (warp) {
    case 0: chain_warp(a, slots, uring, ctr, lane); break;
    case 1: window_warp(a, slots, uring, ctr, lane); break;
    case 2: stager_warp(a, slots, ctr, lane); break;
    default: break;  // block 0's fourth warp: the owner blocks' shape, no role
  }
}

// Blocks of `kernel` the current device holds at once with `smem` bytes of
// shared memory each, asked once per device per instance (before any
// capture): `resident_on` is the instance's own (a function template's
// static at internal linkage).
template <typename K>
int resident_blocks(K kernel, size_t smem, long long (&resident_on)[64], long long* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident_on[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps, smem);
    if (err != cudaSuccess) return (int)err;
    resident_on[dev] = (long long)sms * per_sm;
  }
  *out = resident_on[dev];
  return 0;
}

// The scan's cooperative launch: one chain block and `helpers` owner blocks
template <typename K, typename Args>
int launch_coop(K kernel, const Args& a, long long helpers, size_t smem, cudaStream_t st) {
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(1 + helpers));
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

// Owner blocks for the row blocks with far sums, at most kMaxOwn each, in a
// grid the card holds at once (the cooperative launch refuses a larger one);
// -1 where no such grid exists.
long long owner_blocks(int G, long long resident) {
  const long long far_blocks = G > kLook + 1 ? G - kLook - 1 : 0;
  const long long wanted = (far_blocks + kWarps - 1) / kWarps;
  const long long helpers = wanted < resident - 1 ? wanted : resident - 1;
  return resident < 1 || far_blocks > helpers * kWarps * kMaxOwn ? -1 : helpers;
}

// One level scan in T: u (q,) is updated in place from its old values;
// scratch holds ngt_level_scan_scratch_words(q) elements of T.
template <typename T>
int level_scan(const T* A, long long q, const T* yi, const T* zpz, const T* z, T* u, T* scratch,
               const T* ive, const T* ivu, cudaStream_t st) {
  const int G = (int)((q + 31) / 32);
  T* up = scratch;
  T* far = up + 32LL * G;
  T* cb = far + 32LL * G;
  T* unew = cb + 64LL * G;
  T* band = unew + 32LL * G;
  const long long rows = 32LL * G;
  prep_kernel<T><<<(unsigned)((rows + kRowWarps - 1) / kRowWarps), 32 * kRowWarps, 0, st>>>(
      A, q, G, u, yi, zpz, z, ive, ivu, up, cb, unew, far, band);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static long long resident_on[64];
  constexpr size_t smem = scan_smem<T>();
  long long resident = 0;
  if (const int e = resident_blocks(scan_kernel<T>, smem, resident_on, &resident)) return e;
  const long long helpers = owner_blocks(G, resident);
  if (helpers < 0) return (int)cudaErrorInvalidValue;
  const ScanArgs<T> a{A, q, G, (int)(helpers * kWarps),
                      q % kPerCopy<T> == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0,
                      up, cb, band, far, unew, u};
  return launch_coop(scan_kernel<T>, a, helpers, smem, st);
}

}  // namespace

// Scratch elements one call needs, in the instance's own type (the same
// count for float and double): up, far, (c, b) and the published u per
// padded level, and the band.
extern "C" long long ngt_level_scan_scratch_words(long long q) {
  const long long G = (q + 31) / 32;
  return 5 * 32 * G + G * kBand * 1024;
}

// One level scan: u (q,) is updated in place from its old values; scratch
// holds ngt_level_scan_scratch_words(q) floats. A (q, q) row-major, every
// pointer float32 on one device.
extern "C" int ngt_level_scan(const void* A, long long q, const void* yi, const void* zpz,
                              const void* z, void* u, void* scratch, const void* ive,
                              const void* ivu, void* stream) {
  return level_scan<float>((const float*)A, q, (const float*)yi, (const float*)zpz, (const float*)z,
                           (float*)u, (float*)scratch, (const float*)ive, (const float*)ivu,
                           (cudaStream_t)stream);
}

// The same with every pointer float64 (scratch: as many doubles).
extern "C" int ngt_level_scan_f64(const void* A, long long q, const void* yi, const void* zpz,
                                  const void* z, void* u, void* scratch, const void* ive,
                                  const void* ivu, void* stream) {
  return level_scan<double>((const double*)A, q, (const double*)yi, (const double*)zpz,
                            (const double*)z, (double*)u, (double*)scratch, (const double*)ive,
                            (const double*)ivu, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// RE2: the level scan of a correlated random group (nT effects per level).
//
// Replaces no Pallas kernel. It is the counterpart of the `lax.scan` over
// levels in `sample_random_corr` (nextgp_tpu/engine/samplers/random_effects.py:
// 120-133; NextGP.jl's tuple sampleU, functions.jl:75-88): levels i = 0 .. q-1
// in order, with u[:, i] = 0,
//   s_i  = sum_k A[i, k] u[:, k]          (nT sums sharing one read of row i)
//   u[:, i] = m_i - W_i s_i
// where the levels before i hold their new u and those after i their old
// one. m_i = cov_i yi[:, i] / varE + chol(cov_i) z_i and W_i = cov_i iVarU,
// cov_i = sym(inv(zpz_i / varE + A[i, i] iVarU)), depend on no u. For nT <=
// kFastNT the prep launch builds them (one thread a level, in registers,
// from yi, zpz, z, varE and iVarU read on the card, so that a replayed graph
// reads this sweep's values); above, the caller computes them for every
// level before the call (ops/random_scan.corr_level_rule, batched on the
// card). Either way they are packed per level as rule[i] = (m_i (nT), W_i
// (nT x nT, row-major)).
//
// Bound: bytes, A's lower triangle once (the sums are linear in u with scalar
// A entries, so the nT channels share every read of A): q^2 / 2 floats,
// 200 MB at q = 10,000 (0.060 ms at 3.35 TB/s), as for RE1; not nT times it.
// The chain of q dependent levels is latency.
//
// Design, nT <= kFastNT: RE1's (above) with nT channels, templated over nT:
// a prep launch (the band, the marks, nT upper-triangle sums a row, one
// read of it, and the level's rule), then one cooperative look-ahead launch
// whose block 0 runs the chain on one warp, four levels a step as RE1's:
// 4 nT shuffles fetch the four levels' sums at once, and within the four
// u_{j+m} = (m - W s)_{j+m} - sum_{l < m} e_ml u_{j+l}, e_ml =
// A[j+m, j+l] W_{j+m} (nT x nT blocks the stager forms from the staged rule
// rows and diagonal block, off the dependent path), so that the four cost
// one shuffle latency and about 4 nT + 4 dependent FMAs; while the other
// blocks' warps add each published group of u's into the later rows
// for all nT channels from one read of each 32 x 32 block of A. The first
// design, in tiles of 1,024 levels on one block each (RE1's first design),
// spent 80 % of its time reading the tiles' rows through one SM: 1.61 ms at
// q = 10,000, nT = 2; the second (the rule batched in torch, about 12
// launches before the scan, and the chain a level a step) 0.77 (H100 80GB
// HBM3, 700 W; PERF.md).
// Above kFastNT, the generic form: the row sums one channel per grid row (A
// read nT times) and, in tiles of kTile levels, the chain one level at a
// time on one thread ("one thread a level's nT x nT work"), its sums in
// device memory, a block barrier per level. Every sum has a fixed order and
// nothing is atomic: two runs give the same bits.
// Float64 (`ngt_corr_level_scan_f64`): both forms templated on the element
// type as RE1's; the ring takes the most slots that fit (float: 7 at nT <=
// 3, 6 at nT = 4, as before; double, rows 34 apart: 4 at nT <= 2, two
// groups in flight, and 3 at nT = 3 and 4, one), and the prep's rule
// (inverse, Cholesky) is in double.
// Internal linkage, as RE1's: a template's static (scan_coop's resident_on)
// in a named namespace is one object across every library loaded in a
// process, so a second build of this file (chip_smoke.py's DIR) would skip
// setting its own kernels' shared-memory limit.
namespace {
namespace re2 {

constexpr int kTile = 1024;  // levels per tile: one block's chain
constexpr int kRowWarps = 8;  // rows per block of the row-dot launches
constexpr int kFastNT = 4;
constexpr int kGenericThreads = 256;

// pre[t][r] (=, or += when accumulate) sum_{c in [lo, c1)} A[r, c] u[t][c]
// for rows r0 <= r < r0 + nrows and the channel t = blockIdx.y; lo =
// max(c0, r + 1) when strict (the strict upper triangle), else c0. u and pre
// are (nT, q) row-major. A warp per row: lane l sums the columns lo + l,
// lo + l + 32, ... in two partial sums, then the warp's fixed shuffle tree.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    row_dots_kernel(const T* __restrict__ A, long long q, const T* __restrict__ u, T* __restrict__ pre,
                    long long r0, long long nrows, long long c0, long long c1, bool strict,
                    bool accumulate) {
  const int lane = threadIdx.x & 31;
  const long long r = r0 + (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= r0 + nrows) return;
  const long long lo = strict && r + 1 > c0 ? r + 1 : c0;
  const T* row = A + r * q;
  const T* uc = u + blockIdx.y * q;
  T s0 = 0, s1 = 0;
  long long c = lo + lane;
  for (; c + 32 < c1; c += 64) {
    s0 = mad(__ldg(row + c), __ldg(uc + c), s0);
    s1 = mad(__ldg(row + c + 32), __ldg(uc + c + 32), s1);
  }
  if (c < c1) s0 = mad(__ldg(row + c), __ldg(uc + c), s0);
  const T sum = ngt::warp_sum(s0 + s1);
  if (lane == 0) {
    T* p = pre + blockIdx.y * q + r;
    *p = accumulate ? *p + sum : sum;
  }
}

template <typename T>
int row_dots(const T* A, long long q, int nt, const T* u, T* pre, long long r0, long long nrows,
             long long c0, long long c1, bool strict, bool accumulate, cudaStream_t stream) {
  const dim3 grid((unsigned)((nrows + kRowWarps - 1) / kRowWarps), (unsigned)nt);
  row_dots_kernel<T><<<grid, 32 * kRowWarps, 0, stream>>>(A, q, u, pre, r0, nrows, c0, c1, strict,
                                                          accumulate);
  return (int)cudaGetLastError();
}

// The generic chain over one tile, any nT: level j's u on thread j (its nT x
// nT rule from device memory), a barrier, then every later thread adds
// A[i, j] u_j into its nT sums, kept in pre (its own column).
template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
    generic_chain_kernel(const T* __restrict__ A, long long q, int nt, long long s0, int nl,
                         const T* __restrict__ rule, T* __restrict__ pre, T* __restrict__ unew) {
  const long long K = nt + (long long)nt * nt;
  for (int j = 0; j < nl; ++j) {
    const long long lj = s0 + j;
    if (threadIdx.x == 0) {
      const T* rr = rule + lj * K;
      for (int t = 0; t < nt; ++t) {
        T v = rr[t];
        for (int s = 0; s < nt; ++s) v = mad(-rr[nt + (long long)t * nt + s], pre[s * q + lj], v);
        unew[t * q + lj] = v;
      }
    }
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < nl; i += kGenericThreads) {
      const T a = __ldg(A + (s0 + i) * q + lj);
      for (int t = 0; t < nt; ++t) pre[t * q + s0 + i] = mad(a, unew[t * q + lj], pre[t * q + s0 + i]);
    }
    __syncthreads();
  }
}

template <typename T>
int scan_generic(const T* A, long long q, int nt, const T* rule, const T* u, T* unew, T* pre,
                 cudaStream_t st) {
  int err = row_dots(A, q, nt, u, pre, 0, q, 0, q, true, false, st);
  if (err) return err;
  for (long long s0 = 0; s0 < q; s0 += kTile) {
    const int nl = (int)(q - s0 < kTile ? q - s0 : kTile);
    generic_chain_kernel<T><<<1, kGenericThreads, 0, st>>>(A, q, nt, s0, nl, rule, pre, unew);
    if ((err = (int)cudaGetLastError())) return err;
    if (s0 + nl < q &&
        (err = row_dots(A, q, nt, (const T*)unew, pre, s0 + nl, q - s0 - nl, s0, s0 + nl, false, true, st)))
      return err;
  }
  return 0;
}


// ---- the cooperative form (nT <= kFastNT): RE1's prep and look-ahead launch
// with nT channels. The same roles, counters, marks and waits as RE1 (the
// helpers above); what differs: every published word, far sum, up and win
// is nT words (channel-major, (nT, 32 G)); prep also writes each level's
// rule row (m, W), which is staged with its group's band in place of
// (c, b), and the stager forms the quads' e as nT x nT blocks; the chain's
// four levels of a step carry nT channels each. The window and the owners
// read each 32 x 32 block of A once for all nT channels. The ring holds the
// most slots that fit (coop_slots).

template <typename T, int NT>
struct CoopSlot {
  static constexpr int K = NT + NT * NT;
  T blk[kBand * kBlockWordsOf<T>];
  T rule[32 * K];
  T e[8 * 6 * NT * NT];  // quad k's e_ml at ((6 k + m (m - 1) / 2 + l) nT + t) nT + s
  T up[NT][32];
  T win[NT][32];
};

template <typename T, int NT>
__host__ __device__ constexpr size_t coop_chain_bytes(int slots) {
  return slots * sizeof(CoopSlot<T, NT>) + (size_t)kURing * NT * 32 * sizeof(T) + 32 * sizeof(int);
}
template <typename T, int NT>
__host__ __device__ constexpr int coop_slots() {
  int s = kMaxSlots;
  while (s > 3 && coop_chain_bytes<T, NT>(s) > kSmemLimit) --s;
  return s;
}
template <typename T, int NT>
__host__ __device__ constexpr size_t coop_owner_words() {
  return (size_t)kOwnSlots * kBlockWordsOf<T> + (size_t)kMaxOwn * NT * 32;
}
template <typename T, int NT>
__host__ __device__ constexpr size_t coop_smem() {
  return coop_chain_bytes<T, NT>(coop_slots<T, NT>()) > kWarps * coop_owner_words<T, NT>() * sizeof(T)
             ? coop_chain_bytes<T, NT>(coop_slots<T, NT>()) : kWarps * coop_owner_words<T, NT>() * sizeof(T);
}
static_assert(coop_slots<float, 3>() == kMaxSlots && coop_slots<float, 4>() == kMaxSlots - 1 &&
                  coop_smem<float, 1>() == 199488 && coop_smem<float, 2>() == 209792 &&
                  coop_smem<float, 3>() == 224576 && coop_smem<float, 4>() == 209536,
              "the float rings as before");
static_assert(coop_smem<double, 1>() <= kSmemLimit && coop_smem<double, 2>() <= kSmemLimit &&
                  coop_smem<double, 3>() <= kSmemLimit && coop_smem<double, 4>() <= kSmemLimit,
              "every double ring fits a block");

template <typename T, int NT>
struct CoopArgs {
  const T* A;
  long long q;
  int G;
  int owners;
  bool wide;
  const T* up;    // (NT, 32 G)
  const T* rule;  // (32 G, NT + NT^2)
  const T* band;  // (G, L + 1, 32, 32)
  T* far;         // (NT, 32 G), published
  T* unew;        // (NT, 32 G), published
  T* u;           // (NT, q) the new u
};

// The rule of level r, in one thread's registers: lhs = zpz_r / varE +
// A[r, r] iVarU; cov = sym(inv(lhs)) (Gauss-Jordan without pivots: lhs is
// positive definite); chol(cov), NaN from a pivot that is not positive (a
// level that is not positive definite gives NaN, as no host check can
// stop a captured sweep); m = cov yi[:, r] / varE + chol z[r], W = cov iVarU,
// written as out = (m, W row-major).
template <typename T, int NT>
__device__ __forceinline__ void level_rule(const T* __restrict__ zpz, T arr, const T* __restrict__ ivu, T ve,
                                           const T* __restrict__ yi, long long q, long long r,
                                           const T* __restrict__ z, T* __restrict__ out) {
  T L[NT][NT], inv[NT][NT], cov[NT][NT], ch[NT][NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      L[t][s] = __ldg(zpz + t * NT + s) / ve + arr * __ldg(ivu + t * NT + s);
      inv[t][s] = t == s ? T(1) : T(0);
    }
  }
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    const T piv = T(1) / L[c][c];
#pragma unroll
    for (int s = 0; s < NT; ++s) L[c][s] *= piv, inv[c][s] *= piv;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t == c) continue;
      const T f = L[t][c];
#pragma unroll
      for (int s = 0; s < NT; ++s) {
        L[t][s] = mad(-f, L[c][s], L[t][s]);
        inv[t][s] = mad(-f, inv[c][s], inv[t][s]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int s = 0; s < NT; ++s) cov[t][s] = (inv[t][s] + inv[s][t]) * T(0.5);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    T d = cov[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = mad(-ch[j][k], ch[j][k], d);
    ch[j][j] = d > T(0) ? sqrt_of(d) : nan_word<T>();
#pragma unroll
    for (int i = j + 1; i < NT; ++i) {
      T v = cov[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) v = mad(-ch[i][k], ch[j][k], v);
      ch[i][j] = v / ch[j][j];
    }
  }
  T yv[NT], zv[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) yv[t] = __ldg(yi + t * q + r) / ve, zv[t] = __ldg(z + r * NT + t);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    T m = 0;
#pragma unroll
    for (int s = 0; s < NT; ++s) m = mad(cov[t][s], yv[s], m);
#pragma unroll
    for (int s = 0; s <= t; ++s) m = mad(ch[t][s], zv[s], m);
    out[t] = m;
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      T w = 0;
#pragma unroll
      for (int k = 0; k < NT; ++k) w = mad(cov[t][k], __ldg(ivu + k * NT + s), w);
      out[NT + t * NT + s] = w;
    }
  }
}

// prep: RE1's band and marks, the nT upper-triangle sums of each row, and
// the level's rule row (zero for a pad level)
template <typename T, int NT>
__global__ void __launch_bounds__(32 * kRowWarps)
    coop_prep_kernel(const T* __restrict__ A, long long q, int G, const T* __restrict__ u,
                     const T* __restrict__ yi, const T* __restrict__ zpz, const T* __restrict__ z,
                     const T* __restrict__ var_e, const T* __restrict__ ivu, T* __restrict__ rule,
                     T* __restrict__ up, T* __restrict__ unew, T* __restrict__ far, T* __restrict__ band) {
  constexpr int K = NT + NT * NT;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const long long R = 32LL * G;
  if (r >= R) return;
  const long long g = r >> 5;
  T* brow = band + (g * kBand * 32 + (r & 31)) * 32;
  const T* row = A + r * q;
#pragma unroll
  for (int j = 0; j < kBand; ++j) {
    const long long c = 32 * (g - kLook + j) + lane;
    brow[j * 1024 + lane] = r < q && c >= 0 && c < q ? __ldg(row + c) : T(0);
  }
  if (lane < NT) unew[lane * R + r] = far[lane * R + r] = empty_word<T>();
  if (r >= q) {  // a pad level: its rule row is zero, so u = 0
    if (lane < NT) up[lane * R + r] = T(0);
    if (lane < K) rule[r * K + lane] = T(0);
    return;
  }
  T s0[NT], s1[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) s0[t] = s1[t] = T(0);
  long long c = r + 1 + lane;
  for (; c + 32 < q; c += 64) {
    const T a0 = __ldg(row + c), a1 = __ldg(row + c + 32);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      s0[t] = mad(a0, __ldg(u + t * q + c), s0[t]);
      s1[t] = mad(a1, __ldg(u + t * q + c + 32), s1[t]);
    }
  }
  if (c < q) {
    const T a0 = __ldg(row + c);
#pragma unroll
    for (int t = 0; t < NT; ++t) s0[t] = mad(a0, __ldg(u + t * q + c), s0[t]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const T sum = ngt::warp_sum(s0[t] + s1[t]);
    if (lane == 0) up[t * R + r] = sum;
  }
  if (lane == 0) {
    level_rule<T, NT>(zpz + r * NT * NT, __ldg(row + r), ivu, __ldg(var_e), yi, q, r, z, rule + r * K);
  }
}

// sum_c row[c] * u_t[c] for the nT channels (u_t: 32 elements in shared
// memory), one read of the row, four partial sums each, added into acc
template <typename T, int NT>
__device__ __forceinline__ void rows_dot_shared(const T* row, const T (*u)[32], T (&acc)[NT]) {
  T s[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = T(0);
#pragma unroll
  for (int c = 0; c < 32; c += 4) {
    const Four<T> a = ld4(row + c);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const Four<T> v = ld4(u[t] + c);
      s[t][0] = mad(a.x, v.x, s[t][0]);
      s[t][1] = mad(a.y, v.y, s[t][1]);
      s[t][2] = mad(a.z, v.z, s[t][2]);
      s[t][3] = mad(a.w, v.w, s[t][3]);
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] += (s[t][0] + s[t][1]) + (s[t][2] + s[t][3]);
}

// sum_c row[c] * u_t(c) for the nT channels, u_t(c) in lane c's uc[t]
template <typename T, int NT>
__device__ __forceinline__ void rows_dot_lanes(const T* row, const T (&uc)[NT], T (&out)[NT]) {
  T s[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = T(0);
#pragma unroll
  for (int c = 0; c < 32; c += 4) {
    const Four<T> a = ld4(row + c);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      s[t][0] = mad(a.x, __shfl_sync(kFull, uc[t], c), s[t][0]);
      s[t][1] = mad(a.y, __shfl_sync(kFull, uc[t], c + 1), s[t][1]);
      s[t][2] = mad(a.z, __shfl_sync(kFull, uc[t], c + 2), s[t][2]);
      s[t][3] = mad(a.w, __shfl_sync(kFull, uc[t], c + 3), s[t][3]);
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) out[t] = (s[t][0] + s[t][1]) + (s[t][2] + s[t][3]);
}

// Block 0, warp 0: the chain, four levels a step
template <typename T, int NT>
__device__ __forceinline__ void coop_chain_warp(const CoopArgs<T, NT>& a, CoopSlot<T, NT>* slots,
                                                T (*uring)[NT][32], volatile int* ctr, int lane) {
  constexpr int K = CoopSlot<T, NT>::K, S = coop_slots<T, NT>();
  constexpr int kStride = kStrideOf<T>, kBlockWords = kBlockWordsOf<T>;
  const long long R = 32LL * a.G;
  T carry[NT], far_next[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) carry[t] = far_next[t] = T(0);
  for (int g = 0; g < a.G; ++g) {
    const bool next = g + 1 < a.G;
    long long n = 0;
    while (ctr[kStaged] < (next ? g + 2 : g + 1) || ctr[kWinOk] < g + 1) {
      if (++n > kSpinLimit) __trap();
    }
    __threadfence_block();
    T far[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      far[t] = far_next[t];
      if (g > kLook && !__all_sync(kFull, !is_empty(far[t]))) {
        far[t] = wait_words(a.far + t * R + 32LL * g, lane);
      }
      far_next[t] = g + 1 > kLook && g + 1 < a.G ? ld_relaxed(a.far + t * R + 32LL * (g + 1) + lane) : T(0);
    }
    const CoopSlot<T, NT>& s = slots[g % S];
    T acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] = ((s.up[t][lane] + far[t]) + s.win[t][lane]) + carry[t];
    T d[32], dn[32];
    const T* drow = s.blk + kLook * kBlockWords + lane * kStride;
    const T* nrow = slots[(g + 1) % S].blk + (kLook - 1) * kBlockWords + lane * kStride;
#pragma unroll
    for (int c = 0; c < 32; c += 4) {  // every word loaded before the select
      const Four<T> x = ld4(drow + c), y = ld4(nrow + c);
      d[c] = x.x, d[c + 1] = x.y, d[c + 2] = x.z, d[c + 3] = x.w;
      dn[c] = next ? y.x : T(0), dn[c + 1] = next ? y.y : T(0);
      dn[c + 2] = next ? y.z : T(0), dn[c + 3] = next ? y.w : T(0);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) carry[t] = T(0);
    T(*ug)[32] = uring[g % kURing];
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      const T* rr = s.rule + j * K;                 // rule rows of levels j .. j + 3
      const T* ee = s.e + (j / 4) * 6 * NT * NT;    // their quad's e
      T p[4][NT], u[4][NT];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int t = 0; t < NT; ++t) p[m][t] = __shfl_sync(kFull, acc[t], j + m);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {  // (m - W s) of each level, its sums from before the quad
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          T v = rr[m * K + t];
#pragma unroll
          for (int k = 0; k < NT; ++k) v = mad(-rr[m * K + NT + t * NT + k], p[m][k], v);
          u[m][t] = v;
        }
      }
#pragma unroll
      for (int m = 1; m < 4; ++m) {  // the quad's earlier levels
#pragma unroll
        for (int l = 0; l < m; ++l) {
          const T* e = ee + (m * (m - 1) / 2 + l) * NT * NT;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
#pragma unroll
            for (int k = 0; k < NT; ++k) u[m][t] = mad(-e[t * NT + k], u[l][k], u[m][t]);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < NT; ++t) st4(&ug[t][j], u[0][t], u[1][t], u[2][t], u[3][t]);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[t] = mad(d[j + m], u[m][t], acc[t]);  // the later levels of this group
          carry[t] = mad(dn[j + m], u[m][t], carry[t]);  // the next group's rows
        }
      }
    }
    raise(ctr + kDone, g + 1, lane);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const T mine = ug[t][lane];
      st_relaxed(a.unew + t * R + 32LL * g + lane, mine);
      if (32LL * g + lane < a.q) a.u[t * a.q + 32LL * g + lane] = mine;
    }
  }
}

// Block 0, warp 1: win of row block g over segments g - L .. g - 2, as RE1's
template <typename T, int NT>
__device__ __forceinline__ void coop_window_warp(const CoopArgs<T, NT>& a, CoopSlot<T, NT>* slots,
                                                 T (*uring)[NT][32], volatile int* ctr, int lane) {
  constexpr int kStride = kStrideOf<T>, kBlockWords = kBlockWordsOf<T>;
  for (int g = 0; g < 2 && g < a.G; ++g) {
#pragma unroll
    for (int t = 0; t < NT; ++t) slots[g].win[t][lane] = T(0);
  }
  raise(ctr + kWinOk, a.G < 2 ? a.G : 2, lane);
  for (int g = 2; g < a.G; ++g) {
    wait_ge(ctr + kStaged, g + 1);
    CoopSlot<T, NT>& s = slots[g % coop_slots<T, NT>()];
    T win[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) win[t] = T(0);
#pragma unroll
    for (int j = 0; j < kLook - 2; ++j) {
      const int sg = g - kLook + j;
      if (sg >= 0) rows_dot_shared<T, NT>(s.blk + j * kBlockWords + lane * kStride, uring[sg % kURing], win);
    }
    long long n = 0;
    while (ctr[kDone] < g - 1) {
      if (++n > kSpinLimit) __trap();
    }
    __threadfence_block();
    rows_dot_shared<T, NT>(s.blk + (kLook - 2) * kBlockWords + lane * kStride, uring[(g - 2) % kURing], win);
#pragma unroll
    for (int t = 0; t < NT; ++t) s.win[t][lane] = win[t];
    raise(ctr + kWinOk, g + 1, lane);
  }
}

// The e of a staged group's quads: lane r = 4 k + m (m >= 1) writes
// e_ml = A[r, 4 k + l] W_r for l < m.
template <typename T, int NT>
__device__ __forceinline__ void coop_quad_coupling(CoopSlot<T, NT>& s, int lane) {
  constexpr int K = CoopSlot<T, NT>::K;
  const int m = lane & 3;
  const T* w = s.rule + lane * K + NT;
  const T* row = s.blk + kLook * kBlockWordsOf<T> + lane * kStrideOf<T> + (lane & ~3);
  for (int l = 0; l < m; ++l) {
    const T a = row[l];
    T* e = s.e + (6 * (lane >> 2) + m * (m - 1) / 2 + l) * NT * NT;
#pragma unroll
    for (int i = 0; i < NT * NT; ++i) e[i] = a * w[i];
  }
}

// Block 0, warp 2: the bands, rule rows and up sums of the groups ahead,
// then the quads' e; "staged" counts the groups whose copies are in and
// whose e is written
template <typename T, int NT>
__device__ __forceinline__ void coop_stager_warp(const CoopArgs<T, NT>& a, CoopSlot<T, NT>* slots,
                                                 volatile int* ctr, int lane) {
  constexpr int K = CoopSlot<T, NT>::K, S = coop_slots<T, NT>(), in_flight = S - 2, P = kPerCopy<T>;
  constexpr int kRow = 32 / P;  // 16-byte copies of 32 elements
  const long long R = 32LL * a.G;
  for (int g = 0; g < a.G; ++g) {
    wait_ge(ctr + kDone, g - S + 1);
    CoopSlot<T, NT>& s = slots[g % S];
    stage_band(s.blk, a.band + (size_t)g * kBand * 1024, lane);
    for (int i = lane; i < kRow * K; i += 32) {  // 32 K elements
      __pipeline_memcpy_async(s.rule + P * i, a.rule + 32LL * g * K + P * i, 16);
    }
    for (int i = lane; i < kRow * NT; i += 32) {
      __pipeline_memcpy_async(&s.up[i / kRow][P * (i % kRow)], a.up + (i / kRow) * R + 32LL * g + P * (i % kRow),
                              16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(in_flight - 1);
    const int in = g - in_flight + 1;
    if (in >= 0) {
      __syncwarp();
      coop_quad_coupling<T, NT>(slots[in % S], lane);
      raise(ctr + kStaged, in + 1, lane);
    }
  }
  __pipeline_wait_prior(0);
  __syncwarp();
  for (int in = a.G - in_flight + 1 > 0 ? a.G - in_flight + 1 : 0; in < a.G; ++in) {
    coop_quad_coupling<T, NT>(slots[in % S], lane);
  }
  raise(ctr + kStaged, a.G, lane);
}

// Every warp of blocks 1 ..: owner `ow`, as RE1's, with nT sums a row
template <typename T, int NT>
__device__ __forceinline__ void coop_owner_warp(const CoopArgs<T, NT>& a, T* smem, int ow, int lane) {
  constexpr int kStride = kStrideOf<T>, kBlockWords = kBlockWordsOf<T>;
  const int R0 = kLook + 1 + ow, W = a.owners;
  if (R0 >= a.G) return;
  const long long RR = 32LL * a.G;
  const int nown = (a.G - 1 - R0) / W + 1;
  const int s_end = R0 + (nown - 1) * W - kLook;
  T* ring = smem;
  T* accs = smem + kOwnSlots * kBlockWords;  // accs[(k NT + t) 32 + lane]
  auto first_k = [&](int s) {
    const int need = s + kLook + 1 - R0;
    return need <= 0 ? 0 : (need + W - 1) / W;
  };
  int is = 0, ik = 0;
  auto stage_next = [&](int slot) {
    if (is < s_end) {
      stage_block(ring + slot * kBlockWords, a.A, a.q, 32LL * (R0 + ik * W), 32LL * is, a.wide, lane);
      if (++ik == nown) ik = first_k(++is);
    }
    __pipeline_commit();
  };
#pragma unroll 1
  for (int t = 0; t < kOwnSlots - 1; ++t) stage_next(t);
  int cs = 0, ck = 0, seen = -1;
  T us[NT], us_next[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) us[t] = T(0), us_next[t] = empty_word<T>();
#pragma unroll 1
  for (int it = 0; cs < s_end; ++it) {
    stage_next((it + kOwnSlots - 1) % kOwnSlots);
    __pipeline_wait_prior(kOwnSlots - 1);
    __syncwarp();
    if (cs != seen) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        us[t] = __all_sync(kFull, !is_empty(us_next[t])) ? us_next[t] : wait_words(a.unew + t * RR + 32LL * cs, lane);
        us_next[t] = cs + 1 < s_end ? ld_relaxed(a.unew + t * RR + 32LL * (cs + 1) + lane) : T(0);
      }
      seen = cs;
    }
    const int Rb = R0 + ck * W;
    T dot[NT];
    rows_dot_lanes<T, NT>(ring + (it % kOwnSlots) * kBlockWords + lane * kStride, us, dot);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      T* slot = accs + (ck * NT + t) * 32 + lane;
      const T acc = cs == 0 ? dot[t] : *slot + dot[t];
      if (cs == Rb - kLook - 1) {
        st_relaxed(a.far + t * RR + 32LL * Rb + lane, acc);
      } else {
        *slot = acc;
      }
    }
    __syncwarp();
    if (++ck == nown) ck = first_k(++cs);
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(32 * kWarps, 1) coop_scan_kernel(const CoopArgs<T, NT> a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x > 0) {
    coop_owner_warp<T, NT>(a, reinterpret_cast<T*>(sm) + warp * coop_owner_words<T, NT>(),
                           (blockIdx.x - 1) * kWarps + warp, lane);
    return;
  }
  constexpr int S = coop_slots<T, NT>();
  CoopSlot<T, NT>* slots = reinterpret_cast<CoopSlot<T, NT>*>(sm);
  T(*uring)[NT][32] = reinterpret_cast<T(*)[NT][32]>(sm + S * sizeof(CoopSlot<T, NT>));
  volatile int* ctr = reinterpret_cast<volatile int*>(sm + S * sizeof(CoopSlot<T, NT>) +
                                                      (size_t)kURing * NT * 32 * sizeof(T));
  if (threadIdx.x < kCounters) ctr[threadIdx.x] = 0;
  __syncthreads();
  switch (warp) {
    case 0: coop_chain_warp<T, NT>(a, slots, uring, ctr, lane); break;
    case 1: coop_window_warp<T, NT>(a, slots, uring, ctr, lane); break;
    case 2: coop_stager_warp<T, NT>(a, slots, ctr, lane); break;
    default: break;
  }
}

// scratch: up, far, the published u (nT x 32 G each), the band and the
// rule rows (32 G x (nT + nT^2))
template <typename T, int NT>
int scan_coop(const T* A, long long q, const T* yi, const T* zpz, const T* z, const T* var_e, const T* ivu,
              const T* u, T* unew, T* scratch, cudaStream_t st) {
  const int G = (int)((q + 31) / 32);
  const long long R = 32LL * G;
  T* up = scratch;
  T* far = up + NT * R;
  T* pub = far + NT * R;
  T* band = pub + NT * R;
  T* rule = band + (long long)G * kBand * 1024;
  coop_prep_kernel<T, NT><<<(unsigned)((R + kRowWarps - 1) / kRowWarps), 32 * kRowWarps, 0, st>>>(
      A, q, G, u, yi, zpz, z, var_e, ivu, rule, up, pub, far, band);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static long long resident_on[64];
  constexpr size_t smem = coop_smem<T, NT>();
  long long resident = 0;
  if (const int e = resident_blocks(coop_scan_kernel<T, NT>, smem, resident_on, &resident)) return e;
  const long long helpers = owner_blocks(G, resident);
  if (helpers < 0) return (int)cudaErrorInvalidValue;
  const CoopArgs<T, NT> a{A, q, G, (int)(helpers * kWarps),
                          q % kPerCopy<T> == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0,
                          up, rule, band, far, pub, unew};
  return launch_coop(coop_scan_kernel<T, NT>, a, helpers, smem, st);
}

template <typename T>
int corr_level_scan(const void* A, long long q, long long nt, const void* yi, const void* zpz, const void* z,
                    const void* var_e, const void* ivu, const void* rule, const void* u, void* unew,
                    void* pre, void* stream) {
  if (q < 1 || nt < 1 || q > (1LL << 31) / kRowWarps) return (int)cudaErrorInvalidValue;
  const T* a = (const T*)A;
  const T* y = (const T*)yi;
  const T* zz = (const T*)zpz;
  const T* zs = (const T*)z;
  const T* ve = (const T*)var_e;
  const T* iv = (const T*)ivu;
  const T* uo = (const T*)u;
  T* un = (T*)unew;
  T* p = (T*)pre;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (nt) {
    case 1: return scan_coop<T, 1>(a, q, y, zz, zs, ve, iv, uo, un, p, st);
    case 2: return scan_coop<T, 2>(a, q, y, zz, zs, ve, iv, uo, un, p, st);
    case 3: return scan_coop<T, 3>(a, q, y, zz, zs, ve, iv, uo, un, p, st);
    case 4: return scan_coop<T, 4>(a, q, y, zz, zs, ve, iv, uo, un, p, st);
    default: return scan_generic<T>(a, q, (int)nt, (const T*)rule, uo, un, p, st);
  }
}

}  // namespace re2
}  // namespace

// Whether the caller passes RE2 its packed rule at nT (the generic form); for
// nT <= kFastNT the prep launch builds it.
extern "C" long long ngt_corr_level_scan_takes_rule(long long nt) { return nt > re2::kFastNT; }

// Scratch elements one RE2 call needs, in the instance's own type (the same
// count for float and double): the cooperative form's up, far sums and
// published u (nT per padded level), its band and its rule rows; the
// generic form's sums.
extern "C" long long ngt_corr_level_scan_scratch_words(long long q, long long nt) {
  const long long G = (q + 31) / 32;
  return nt <= re2::kFastNT ? 3 * nt * 32 * G + G * kBand * 1024 + 32 * G * (nt + nt * nt) : nt * q;
}

// Dynamic shared memory one block of the scan launch takes: RE1's (nt = 0)
// or RE2's at nt <= 4 (0 for the generic form, which takes none), in the
// float (f64 = 0) or double instance. ops/random_scan.level_scan_smem_bytes
// states the same.
extern "C" long long ngt_level_scan_smem_bytes(long long nt, long long f64) {
  switch (nt) {
    case 0: return (long long)(f64 ? scan_smem<double>() : scan_smem<float>());
    case 1: return (long long)(f64 ? re2::coop_smem<double, 1>() : re2::coop_smem<float, 1>());
    case 2: return (long long)(f64 ? re2::coop_smem<double, 2>() : re2::coop_smem<float, 2>());
    case 3: return (long long)(f64 ? re2::coop_smem<double, 3>() : re2::coop_smem<float, 3>());
    case 4: return (long long)(f64 ? re2::coop_smem<double, 4>() : re2::coop_smem<float, 4>());
    default: return 0;
  }
}

// The shared memory a block may opt in to on the current device.
extern "C" long long ngt_smem_optin_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  return optin;
}

// One correlated level scan (RE2): A (q, q) row-major; yi (nT, q), zpz (q,
// nT, nT), z (q, nT), var_e (one value) and ivu (nT, nT), from which the prep
// launch builds the rule for nT <= 4; rule: for nT > 4 the packed rule
// (ceil(q / 32) * 32, nT + nT^2), rows past q zero (ops/random_scan.
// corr_level_rule), else unused; u the old (nT, q); unew the new (nT, q);
// scratch ngt_corr_level_scan_scratch_words(q, nT) floats. Every pointer
// float32 on one device. Two launches for nT <= 4, 2 ceil(q / 1024) above.
extern "C" int ngt_corr_level_scan(const void* A, long long q, long long nt, const void* yi,
                                   const void* zpz, const void* z, const void* var_e, const void* ivu,
                                   const void* rule, const void* u, void* unew, void* pre,
                                   void* stream) {
  return re2::corr_level_scan<float>(A, q, nt, yi, zpz, z, var_e, ivu, rule, u, unew, pre, stream);
}

// The same with every pointer float64 (scratch: as many doubles).
extern "C" int ngt_corr_level_scan_f64(const void* A, long long q, long long nt, const void* yi,
                                       const void* zpz, const void* z, const void* var_e, const void* ivu,
                                       const void* rule, const void* u, void* unew, void* pre,
                                       void* stream) {
  return re2::corr_level_scan<double>(A, q, nt, yi, zpz, z, var_e, ivu, rule, u, unew, pre, stream);
}
