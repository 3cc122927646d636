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
//
// Float64 (the `_f64` entry points): the same bodies on double y, u and
// outputs, every product and sum taken in double; the panel stays 2-bit, so
// both read the same packed bytes and twice the vector bytes. A dosage is
// one LOP3 and one DFMA (`field64`: the field in the low word of 2^52), its
// product a second DFMA. The H100 issues a DFMA at half the FFMA's rate, so
// each pass runs up to about twice its float32 time. K1's float64 instance
// keeps two blocks an SM (a lane's y quads take twice the registers); K2's
// lane owns 8 bytes of a 256-byte tile, so its 32 double sums take the
// registers and shared memory the float instance's 64 take.
//
// The bodies live in pack2_body.cuh, which the ladder's fused step
// (micro.cu) runs too.
#include "pack2_body.cuh"

namespace {

using namespace ngt::packed;

template <typename T, int MIN_BLOCKS>
__global__ void __launch_bounds__(kGatherThreads, MIN_BLOCKS)
matvec_kernel(const uint8_t* __restrict__ pk, const T* __restrict__ y4, T* __restrict__ out,
              long long rows, int q, uint32_t magic) {
  const long long wpb = blockDim.x >> 5;
  gather_groups(pk, y4, out, rows, q, magic,
                ((long long)blockIdx.x * wpb + (threadIdx.x >> 5)) * kGatherRows,
                (long long)gridDim.x * wpb * kGatherRows);
}

template <typename T>
__global__ void __launch_bounds__(kRankThreads, 2)
rank_kernel(const uint8_t* __restrict__ pk, const T* __restrict__ u, T* __restrict__ partial,
            T* __restrict__ out, int* __restrict__ tickets, long long rows, int q,
            long long rows_per_slice, uint32_t magic) {
  __shared__ RankSharedOf<T> sh;
  rank_block(pk, u, partial, out, tickets, rows, q, rows_per_slice, magic, blockIdx.x, blockIdx.y,
             gridDim.y, sh);
}

template <typename T, int MIN_BLOCKS>
int matvec(const void* pk, const void* y4, void* out, long long rows, long long q, long long blocks,
           void* stream, uint32_t magic) {
  static int resident[kMaxDevices];  // one per instance
  const int err = gather_grid(matvec_kernel<T, MIN_BLOCKS>, resident, rows, blocks);
  if (err != 0) return err;
  matvec_kernel<T, MIN_BLOCKS><<<(unsigned)blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (const T*)y4, (T*)out, rows, (int)q, magic);
  return (int)cudaGetLastError();
}

template <typename T>
int rank_update(const void* pk, const void* u, void* partial, void* out, void* tickets,
                long long rows, long long q, long long slices, void* stream, uint32_t magic) {
  constexpr int tile = RankLane<T>::kTile;
  const dim3 grid((unsigned)((q + tile - 1) / tile), (unsigned)slices);
  rank_kernel<T><<<grid, kRankThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pk, (const T*)u, (T*)partial, (T*)out, (int*)tickets, rows, (int)q,
      (rows + slices - 1) / slices, magic);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ngt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// pk: (rows, q) uint8, y4: (4, q) f32, out: (rows,) f32; q a multiple of 16,
// pk and y4 16-byte aligned, rows > 0. blocks: the grid, or 0 for as many
// blocks as are resident at once (at most one warp per row group).
int ngt_pack2_matvec(const void* pk, const void* y4, void* out, long long rows, long long q,
                     long long blocks, void* stream) {
  return matvec<float, 3>(pk, y4, out, rows, q, blocks, stream, kMagic);
}

// The same with y4 and out f64.
int ngt_pack2_matvec_f64(const void* pk, const void* y4, void* out, long long rows, long long q,
                         long long blocks, void* stream) {
  return matvec<double, 2>(pk, y4, out, rows, q, blocks, stream, kMagic64);
}

// pk: (rows, q) uint8, u: (rows,) f32, out: (4, q) f32; q a multiple of 16,
// pk 16-byte aligned, rows > 0, 1 <= slices <= 65535. With slices > 1,
// partial: (slices, 4, q) f32 scratch and tickets: ceil(q / 512) int32 that
// are 0 (each launch leaves them 0); else both may be null.
int ngt_pack2_rank_update(const void* pk, const void* u, void* partial, void* out, void* tickets,
                          long long rows, long long q, long long slices, void* stream) {
  return rank_update<float>(pk, u, partial, out, tickets, rows, q, slices, stream, kMagic);
}

// The same with u, partial and out f64 and ceil(q / 256) tickets.
int ngt_pack2_rank_update_f64(const void* pk, const void* u, void* partial, void* out,
                              void* tickets, long long rows, long long q, long long slices,
                              void* stream) {
  return rank_update<double>(pk, u, partial, out, tickets, rows, q, slices, stream, kMagic64);
}

}  // extern "C"
