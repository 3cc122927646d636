// Packed 2-bit genotype passes for Hopper (sm_90a): the gather (K1) and the
// scatter (K2) of the blocked Gibbs sweep.
//
// Storage (nextgp_tpu/ops/pack2.py): a locus row holds q bytes; byte j packs
// the dosages of individuals j, j+q, j+2q, j+3q in its 2-bit fields 0..3, so
// plane k of a row is ((byte >> 2k) & 3) and the residual is viewed planar
// as y4 (4, q).
//
// Both passes stream the panel once and do two floating-point operations per
// dosage. The unpack is what cost most: the earlier bodies paid a shift and
// a mask per dosage on the integer pipe, which has half the lanes of the
// FP32 pipe, so they were integer-bound. Here a dosage costs one LOP3
// (`field`): the field is left in place and OR-ed into the mantissa of 2^23,
// and one FFMA by 2^-p turns 2^23 + d 2^p into d exactly; one shift per
// half-word keeps every field inside the mantissa. That leaves three
// instructions per dosage (LOP3, two FFMAs): what bounds both passes on the
// H100 is the instruction rate and latency, not the panel's bytes (at one
// instruction a cycle per scheduler, ~1.2x the byte time; measured times in
// PERF.md).
//
// K1 gather, out[r] = sum_k sum_j plane_k(pk[r, j]) * y4[k, j].
//   Replaces the Pallas kernel `_make_matvec_kernel("vpu")` behind
//   `pack2.matvec_step` / `pack2.matvec` (nextgp_tpu/ops/pack2.py:89-125,
//   170-187, 297-325).
//   Design: one warp per group of kGatherRows rows; lanes read a row in
//   16-byte chunks (coalesced) with loads that do not allocate in L1, and
//   the chunk's y values, read from y4 as given through L1 (16 q bytes: 40 KB
//   at 10,000 individuals, 200 KB at 50,000), serve every row of the group.
//   No block stages y in shared memory, so residency is set by registers
//   alone at every width (three blocks of eight warps per SM), and there is
//   no second kernel. The TPU kernel carried a partial sum across its
//   sequential q grid axis; here that axis is the in-warp loop over chunks,
//   closed by a fixed-order warp reduction: each row is summed in the order
//   of the earlier body, so the bits are the same. A row's sum does not
//   depend on the grid (blocks are persistent and grid-stride over row
//   groups), so the grid is a parameter.
//
// K2 scatter, out[k, j] = sum_r u[r] * plane_k(pk[r, j]), planar (4, q).
//   Replaces `_make_rank_kernel("vpu")` behind `pack2.rank_update_step` /
//   `pack2.rank_update` (pack2.py:190-253, 260-277, 328-354). Rows 4..7 of
//   the TPU kernel's (8, q) output were sublane padding and are dropped.
//   Design: the TPU kernel carried its sum across a sequential row grid axis.
//   Here block (c, s) owns column tile c (kRankTile bytes: a 16-byte word,
//   64 outputs, per lane) over row slice s (512 rows: `rank_grid` in
//   ops/pack2.py, a function of the shape). Its eight warps take every
//   eighth row, each lane summing its rows in order while the next ones
//   load, and a fixed tree in shared memory adds the warps. The block writes
//   its slice's partial; an integer ticket per tile (not a float atomic) lets
//   the last block of the tile add the partials in slice order and reset the
//   ticket. So there is one launch, and the result depends on the shape
//   alone.
#include "common.cuh"

namespace {

constexpr int kGatherRows = 4;  // rows per warp
constexpr int kGatherThreads = 256;
constexpr int kRankWarps = 8;
constexpr int kRankThreads = 32 * kRankWarps;
constexpr int kRankTile = 512;  // packed bytes per column tile: 16 a lane
constexpr int kRankRowBatch = 2;  // rows a lane sums while it loads as many more

// The bits of 2^23. The kernels take them as an argument (kMagic, from the
// host): a LOP3 takes one immediate, so with both the field's mask and these
// bits known at compile time ptxas splits the AND and the OR into two LOP3s.
constexpr uint32_t kMagic = 0x4B000000u;

// Dosage of the 2-bit field at bit p (p <= 14) of h, exactly: OR the field,
// left in place, into the mantissa of 2^23 (2^23 + d 2^p: one LOP3), then
// (2^23 + d 2^p) 2^-p - 2^(23-p) = d in one FFMA (the product and the sum
// are exact). p is a constant wherever this is inlined; magic is kMagic.
__device__ __forceinline__ float field(uint32_t h, int p, uint32_t magic) {
  return fmaf(__uint_as_float((h & (3u << p)) | magic), __int_as_float((127 - p) << 23),
              -__int_as_float((150 - p) << 23));
}

// A 16-byte load that does not allocate in L1, which keeps L1 for y (K1).
__device__ __forceinline__ uint4 ld_stream16(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word_of(const uint4& c, int w) {
  return w == 0 ? c.x : w == 1 ? c.y : w == 2 ? c.z : c.w;
}

// Dot of one 4-byte word (columns col..col+3) against the y planes of those
// columns; y[k] holds y4[k, col..col+3]. Bytes 0 and 1 are read in place,
// bytes 2 and 3 after one shift.
__device__ __forceinline__ float word_dot(uint32_t w, const float4 (&y)[4], uint32_t magic) {
  const uint32_t hi = w >> 16;
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a = fmaf(field(w, 2 * k, magic), y[k].x, a);
    a = fmaf(field(w, 8 + 2 * k, magic), y[k].y, a);
    a = fmaf(field(hi, 2 * k, magic), y[k].z, a);
    a = fmaf(field(hi, 8 + 2 * k, magic), y[k].w, a);
  }
  return a;
}

__global__ void __launch_bounds__(kGatherThreads, 3)
matvec_kernel(const uint8_t* __restrict__ pk, const float* __restrict__ y4,
              float* __restrict__ out, long long rows, int q, uint32_t magic) {
  const int nchunk = q >> 4;
  const int lane = threadIdx.x & 31;
  const long long wpb = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * wpb * kGatherRows;
  for (long long r0 = ((long long)blockIdx.x * wpb + (threadIdx.x >> 5)) * kGatherRows;
       r0 < rows; r0 += stride) {  // warp-uniform loop
    float acc[kGatherRows];
#pragma unroll
    for (int rr = 0; rr < kGatherRows; ++rr) acc[rr] = 0.f;
    for (int c = lane; c < nchunk; c += 32) {
      uint4 ch[kGatherRows];
#pragma unroll
      for (int rr = 0; rr < kGatherRows; ++rr)
        ch[rr] = (r0 + rr < rows) ? ld_stream16(pk + (r0 + rr) * q + 16 * c)
                                  : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float4 y[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          y[k] = __ldg(reinterpret_cast<const float4*>(y4 + (size_t)k * q + 16 * c + 4 * w));
#pragma unroll
        for (int rr = 0; rr < kGatherRows; ++rr) acc[rr] += word_dot(word_of(ch[rr], w), y, magic);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kGatherRows; ++rr) {
      const float s = ngt::warp_sum(acc[rr]);
      if (lane == 0 && r0 + rr < rows) out[r0 + rr] = s;
    }
  }
}

// acc[k * 16 + b] += u * plane_k(byte b) for the 16 bytes of one lane's word.
__device__ __forceinline__ void scatter_word(const uint4& w, float u, float (&acc)[64],
                                             uint32_t magic) {
#pragma unroll
  for (int h = 0; h < 8; ++h) {  // half-word h holds bytes 2h and 2h + 1
    const uint32_t bits = (h & 1) ? (word_of(w, h >> 1) >> 16) : word_of(w, h >> 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[k * 16 + 2 * h] = fmaf(field(bits, 2 * k, magic), u, acc[k * 16 + 2 * h]);
      acc[k * 16 + 2 * h + 1] = fmaf(field(bits, 8 + 2 * k, magic), u, acc[k * 16 + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(kRankThreads, 2)
rank_kernel(const uint8_t* __restrict__ pk, const float* __restrict__ u,
            float* __restrict__ partial, float* __restrict__ out, int* __restrict__ tickets,
            long long rows, int q, long long rows_per_slice, uint32_t magic) {
  __shared__ float red[kRankWarps / 2][64][32];  // [warp][output][lane]: no bank conflicts
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const long long slice = blockIdx.y;
  const int slices = gridDim.y;
  const int col = tile * kRankTile + 16 * lane;  // q is a multiple of 16: col < q means col + 16 <= q
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  if (col < q) {
    // the warp's rows r_first, r_first + 8, ...: kRankRowBatch of them summed while the
    // next kRankRowBatch are loaded
    const long long r_end = min(rows, (slice + 1) * rows_per_slice);
    const long long r_first = slice * rows_per_slice + warp;
    const uint8_t* p = pk + col;
    uint4 nw[kRankRowBatch];
    float nu[kRankRowBatch];
#pragma unroll
    for (int b = 0; b < kRankRowBatch; ++b) {
      const long long rb = r_first + b * kRankWarps;
      nw[b] = rb < r_end ? ld_stream16(p + rb * q) : make_uint4(0u, 0u, 0u, 0u);
      nu[b] = rb < r_end ? __ldg(u + rb) : 0.f;
    }
    for (long long r = r_first; r < r_end; r += kRankRowBatch * kRankWarps) {  // warp-uniform
      uint4 w[kRankRowBatch];
      float ur[kRankRowBatch];
#pragma unroll
      for (int b = 0; b < kRankRowBatch; ++b) {
        w[b] = nw[b];
        ur[b] = nu[b];
        const long long rb = r + (kRankRowBatch + b) * kRankWarps;
        if (rb < r_end) {
          nw[b] = ld_stream16(p + rb * q);
          nu[b] = __ldg(u + rb);
        }
      }
#pragma unroll
      for (int b = 0; b < kRankRowBatch; ++b)  // each lane's rows in order
        if (r + b * kRankWarps < r_end) scatter_word(w[b], ur[b], acc, magic);
    }
  }
  // warps w and w + half add in shared memory, half = 4, 2, 1: a fixed tree
#pragma unroll
  for (int half = kRankWarps / 2; half >= 1; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int j = 0; j < 64; ++j) red[warp - half][j][lane] = acc[j];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += red[warp][j][lane];
    }
    __syncthreads();
  }
  float* dst = slices == 1 ? out : partial + (size_t)slice * 4 * q;
  if (warp == 0 && col < q) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float4* d = reinterpret_cast<float4*>(dst + (size_t)k * q + col);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        d[x] = make_float4(acc[k * 16 + 4 * x], acc[k * 16 + 4 * x + 1], acc[k * 16 + 4 * x + 2],
                           acc[k * 16 + 4 * x + 3]);
    }
  }
  if (slices == 1) return;
  if (warp == 0) __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + tile, 1) == slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block of the tile adds the slices in order: item t is plane
  // t / (kRankTile / 4), four columns from the tile's 4 (t % (kRankTile / 4))
  for (int t = threadIdx.x; t < kRankTile; t += kRankThreads) {
    const int k = t / (kRankTile / 4);
    const int c = tile * kRankTile + 4 * (t % (kRankTile / 4));
    if (c < q) {
      const float* src = partial + (size_t)k * q + c;
      const size_t step = 4 * (size_t)q;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int sl = 0; sl < slices; ++sl) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + sl * step));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      *reinterpret_cast<float4*>(out + (size_t)k * q + c) = s;
    }
  }
  if (threadIdx.x == 0) tickets[tile] = 0;  // ready for the next launch
}

}  // namespace

extern "C" {

const char* ngt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// pk: (rows, q) uint8, y4: (4, q) f32, out: (rows,) f32; q a multiple of 16,
// pk and y4 16-byte aligned, rows > 0. blocks: the grid, or 0 for as many
// blocks as are resident at once (at most one warp per row group).
int ngt_pack2_matvec(const void* pk, const void* y4, void* out, long long rows, long long q,
                     long long blocks, void* stream) {
  if (blocks <= 0) {
    static int resident[64];  // per device: blocks resident at once, found at first use
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matvec_kernel, kGatherThreads, 0);
      if (err != cudaSuccess) return (int)err;
      resident[dev] = per_sm * sms;
    }
    const long long groups = (rows + kGatherRows - 1) / kGatherRows;
    const long long wpb = kGatherThreads / 32;
    blocks = (groups + wpb - 1) / wpb;
    if (blocks > resident[dev]) blocks = resident[dev];
  }
  matvec_kernel<<<(unsigned)blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (const float*)y4, (float*)out, rows, (int)q, kMagic);
  return (int)cudaGetLastError();
}

// pk: (rows, q) uint8, u: (rows,) f32, out: (4, q) f32; q a multiple of 16,
// pk 16-byte aligned, rows > 0, 1 <= slices <= 65535. With slices > 1,
// partial: (slices, 4, q) f32 scratch and tickets: ceil(q / 512) int32 that
// are 0 (each launch leaves them 0); else both may be null.
int ngt_pack2_rank_update(const void* pk, const void* u, void* partial, void* out, void* tickets,
                          long long rows, long long q, long long slices, void* stream) {
  const dim3 grid((unsigned)((q + kRankTile - 1) / kRankTile), (unsigned)slices);
  rank_kernel<<<grid, kRankThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (const float*)u, (float*)partial, (float*)out, (int*)tickets, rows,
      (int)q, (rows + slices - 1) / slices, kMagic);
  return (int)cudaGetLastError();
}

}  // extern "C"
