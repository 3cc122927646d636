// The level scan of an uncorrelated random effect for Hopper (sm_90a): RE1.
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
// replayed graph reads this sweep's values).
//
// Design: blocked right-looking, in tiles of up to 1,024 levels.
//   pre[i] = sum_{k > i} A[i, k] u_old[k]   (the strict upper triangle, one
//            launch over all rows, a warp per row)
//   for each tile [s, e):
//     the tile's levels in order on the scan skeleton (scan_skeleton.cuh):
//       one block, a thread per level holding pre[i] plus its right-looking
//       in-tile sum, a warp per 32 levels with the diagonal tile in shared
//       memory and one barrier per group; the rule is the three lines above
//       folded into u[i] = c[i] - b[i] * pre (LevelRule), K6's Gaussian rule
//       with ivu * A as the coupling
//     pre[r] += sum_{c in [s, e)} A[r, c] u_new[c] for every later row r
//       (a warp per row, all rows of the later tiles at once)
// so each level sees its earlier levels' new values and its later levels'
// old ones, as the reference's loop does. Every sum has a fixed order and
// nothing is atomic: two runs give the same bits. The plain version
// (ops/random_scan.level_scan_plain) runs the same blocks in the same order.
//
// Bound: bytes. The function needs A's lower triangle (by symmetry), once:
// q^2 / 2 floats, 200 MB at q = 10,000 (0.060 ms at 3.35 TB/s). This form
// reads all of A once, as the reference's loop does (0.119 ms), the upper
// triangle in the first launch and the lower one in the panels, each at the
// whole card's rate; the tiles' sequential chains (a shuffle and two
// dependent FMAs per level) are latency. One call is 2 * ceil(q / 1024)
// launches.
#include "scan_skeleton.cuh"

namespace {

constexpr long long kTileLevels = 1024;
constexpr int kRowWarps = 8;  // rows per block of the row-dot launches

// pre[r] (=, or += when accumulate) sum_{c in [lo, c1)} A[r, c] * u[c] for
// rows r0 <= r < r0 + nrows, lo = max(c0, r + 1) when strict (the strict
// upper triangle), else c0. A warp per row: lane l sums the columns lo + l,
// lo + l + 32, ... in four partial sums, then the warp's fixed shuffle tree.
__global__ void __launch_bounds__(32 * kRowWarps)
    row_dots_kernel(const float* __restrict__ A, long long ld, const float* __restrict__ u,
                    float* __restrict__ pre, long long r0, long long nrows, long long c0,
                    long long c1, bool strict, bool accumulate) {
  const int lane = threadIdx.x & 31;
  const long long r = r0 + (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= r0 + nrows) return;
  const long long lo = strict && r + 1 > c0 ? r + 1 : c0;
  const float* row = A + r * ld;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  long long c = lo + lane;
  for (; c + 96 < c1; c += 128) {
    s0 = fmaf(__ldg(row + c), __ldg(u + c), s0);
    s1 = fmaf(__ldg(row + c + 32), __ldg(u + c + 32), s1);
    s2 = fmaf(__ldg(row + c + 64), __ldg(u + c + 64), s2);
    s3 = fmaf(__ldg(row + c + 96), __ldg(u + c + 96), s3);
  }
  for (; c < c1; c += 32) s0 = fmaf(__ldg(row + c), __ldg(u + c), s0);
  const float s = ngt::warp_sum((s0 + s1) + (s2 + s3));
  if (lane == 0) pre[r] = accumulate ? pre[r] + s : s;
}

int row_dots(const float* A, long long q, const float* u, float* pre, long long r0, long long nrows,
             long long c0, long long c1, bool strict, bool accumulate, cudaStream_t stream) {
  const long long blocks = (nrows + kRowWarps - 1) / kRowWarps;
  row_dots_kernel<<<(unsigned)blocks, 32 * kRowWarps, 0, stream>>>(A, q, u, pre, r0, nrows, c0, c1,
                                                                   strict, accumulate);
  return (int)cudaGetLastError();
}

struct LevelParams {
  const float* pre;   // (B,) at the tile's first level
  const float* diag;  // A[s, s]: level i's diagonal is diag[i * (ld + 1)]
  long long ld;       // A's row stride, q
  const float* yi;    // (B,) Z' ycorr / varE
  const float* zpz;   // (B,) diag of Z'Z (weighted)
  const float* z;     // (B,) standard normals
  float* u;           // (B,) the new u, written at the end
  const float* ive;   // () 1 / varE
  const float* ivu;   // () 1 / varU
};

// The rule of one level on the skeleton. Nothing of a level's update but
// its pre depends on the levels before it, so thread i folds the rest into
// two numbers before the scan starts,
//   a = 1 / (zpz[i] * ive + A[i, i] * ivu)
//   c = yi[i] * a + z[i] * sqrt(a),   b = ivu * a,
// and the level's turn is one FMA, u[i] = c - b * pre, where the division
// and the square root would sit on the chain of every level. Thread i writes
// its (c, b) into shared memory at i, and warp w runs the levels of its own
// threads, so the skeleton's first __syncwarp orders the writes before the
// reads. Nothing is staged per group.
struct LevelRule {
  static constexpr int kGrams = 1;
  using Params = LevelParams;

  Params p;
  const float2* cb;
  float s0 = 0.f, uo = 0.f;

  __device__ __forceinline__ LevelRule(const Params& prm, float* smem, int, int B, int i)
      : p(prm), cb(reinterpret_cast<const float2*>(smem)) {
    if (i < B) {
      s0 = __ldg(p.pre + i);
      const float ive = __ldg(p.ive), ivu = __ldg(p.ivu);
      const float a = 1.f / (__ldg(p.zpz + i) * ive + __ldg(p.diag + (size_t)i * (p.ld + 1)) * ivu);
      reinterpret_cast<float2*>(smem)[i] =
          make_float2(__ldg(p.yi + i) * a + __ldg(p.z + i) * sqrtf(a), ivu * a);
    }
  }

  __device__ __forceinline__ float start(int) const { return s0; }
  __device__ __forceinline__ float u() const { return uo; }
  __device__ __forceinline__ void stage(int, int, int) {}
  __device__ __forceinline__ void begin_group(int, int, int, int) {}

  __device__ __forceinline__ float locus(int j0, int jj, const float (&pre)[1], float, int lane) {
    const float2 k = cb[j0 + jj];
    const float uj = fmaf(-k.y, pre[0], k.x);
    if (lane == jj) uo = uj;
    return uj;
  }

  __device__ __forceinline__ void finish(int i) const { p.u[i] = uo; }
};

}  // namespace

// One level scan: u (q,) is updated in place from its old values; pre (q,)
// is scratch. A (q, q) row-major, every pointer float32 on one device.
extern "C" int ngt_level_scan(const void* A, long long q, const void* yi, const void* zpz,
                              const void* z, void* u, void* pre, const void* ive, const void* ivu,
                              void* stream) {
  const float* a = (const float*)A;
  float* uu = (float*)u;
  float* pp = (float*)pre;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = row_dots(a, q, uu, pp, 0, q, 0, q, true, false, st);
  if (err) return err;
  for (long long s = 0; s < q; s += kTileLevels) {
    const long long e = s + kTileLevels < q ? s + kTileLevels : q;
    const LevelParams prm{pp + s, a + s * q + s, q, (const float*)yi + s, (const float*)zpz + s,
                          (const float*)z + s, uu + s, (const float*)ive, (const float*)ivu};
    err = ngt::scan::launch_strided<LevelRule>(a + s * q + s, nullptr, prm, 1, e - s, q,
                                               2 * (e - s), stream);
    if (err) return err;
    if (e < q) {
      err = row_dots(a, q, uu, pp, e, q - e, s, e, false, true, st);
      if (err) return err;
    }
  }
  return 0;
}
