// What the fp32 tensor-core flash-attention kernels (flash_fwd_tc32.cu,
// flash_bwd_tc32.cu, flash_bwd_tc32_d128.cu) share: the bf16 planes of an
// fp32 tile, the register split of an fp32 accumulator into the A planes of
// the next product, the six plane products of one fp32-grade product (A and
// B from shared memory, or A from registers with B transposed), the per-tile
// sum on the CUDA cores, and the 4-D TMA maps and copies of the planes.
//
// Each fp32 operand x is held as three bf16 planes, x0 = bf16(x),
// x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (mx_split_bf16x3 in
// flash_bwd_tc32.cu writes them to device memory), whose sum is x; a
// product a.b is the six plane products ai.bj with i + j <= 2, each exact
// in fp32, summed in the fp32 accumulator smallest first. A tile is 64 rows
// of three planes of 64 bf16 columns, each plane one 128-byte-swizzled
// 8 KB block as TMA writes it (flash_bwd_tc32_d128.cu lays out its own
// tiles of two 64-column halves per plane).
#pragma once

#include "flash_tc_common.cuh"

namespace mxflash {
namespace tc32 {

using namespace mxflash::tc;
using bf16 = __nv_bfloat16;

constexpr uint32_t PL = HALF_BYTES;  // one bf16 plane of a 64 x 64 tile
constexpr uint32_t TB = 3 * PL;      // a tile: its three planes

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// An fp32 accumulator (a 64x64 tile, P or dS) as the three bf16 planes of
// the A fragments of the four k16 steps of the next product (to_a's layout).
__device__ __forceinline__ void split_a(const float (&d)[32], uint32_t (&a)[3][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = d[8 * kk + 2 * i], y = d[8 * kk + 2 * i + 1];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
        a[p][kk][i] = bf2_bits(h);
        const float2 f = __bfloat1622float2(h);
        x -= f.x;
        y -= f.y;
      }
    }
}

__device__ __forceinline__ void reg_fence3(uint32_t (&a)[3][4][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) reg_fence(a[p]);
}

// ------------------------------------------------------ the six products

// d (+)= A_I . B_J over a 64-deep tile: A and B K-major planes.
template <int I, int J>
__device__ __forceinline__ void ss_term(float (&d)[32], uint32_t a, uint32_t b,
                                        bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_ss<bf16>(d, desc(a + I * PL + kk * 32), desc(b + J * PL + kk * 32),
                 (first && kk == 0) ? 0 : 1);
}

// d = A . B^T (both 64-row tiles of three planes, summed over their columns):
// the six terms, smallest first.
__device__ __forceinline__ void mma6_ss(float (&d)[32], uint32_t a, uint32_t b) {
  ss_term<2, 0>(d, a, b, true);
  ss_term<0, 2>(d, a, b, false);
  ss_term<1, 1>(d, a, b, false);
  ss_term<1, 0>(d, a, b, false);
  ss_term<0, 1>(d, a, b, false);
  ss_term<0, 0>(d, a, b, false);
}

template <int I, int J>
__device__ __forceinline__ void rs_term(float (&d)[32], const uint32_t (&a)[3][4][4],
                                        uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<bf16>(d, a[I][kk], desc(b + J * PL + kk * 16 * 128),
                 (first && kk == 0) ? 0 : 1);
}

// d = A . B: A the split planes in registers, B a 64-row tile of three
// planes read MN-major (the rows are the summed dimension); overwrites d.
__device__ __forceinline__ void mma6_rs(float (&d)[32], const uint32_t (&a)[3][4][4],
                                        uint32_t b) {
  rs_term<2, 0>(d, a, b, true);
  rs_term<0, 2>(d, a, b, false);
  rs_term<1, 1>(d, a, b, false);
  rs_term<1, 0>(d, a, b, false);
  rs_term<0, 1>(d, a, b, false);
  rs_term<0, 0>(d, a, b, false);
}

// sum += the product of one tile. The tensor cores' sums are not rounded
// to nearest (on the card, a long chain of wgmma into one accumulator drifts
// several times further from the plain fp32 result than the CUDA-core
// kernel), so each tile's product starts a fresh accumulator and is added
// to the running sum on the CUDA cores.
__device__ __forceinline__ void add_tile(float (&sum)[32], const float (&t)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] += t[i];
}

// ------------------------------------------------------------ copies

// One box (64 columns x the map's rows) of plane p of a (D, T, BH, 3) map at
// (column c, row r, head bh).
__device__ __forceinline__ void tma_plane(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r, int bh, int p,
                                          int c = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r), "r"(bh), "r"(p)
      : "memory");
}

// A whole tile: its three planes, one after the other.
__device__ __forceinline__ void tma_planes(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int row, int bh) {
#pragma unroll
  for (int p = 0; p < 3; ++p) tma_plane(dst + p * PL, map, bar, row, bh, p);
}

// ------------------------------------------------------------------ host side

// The (D, T, BH, 3) map of the bf16 planes of a (BH, T, D) operand, the
// planes `plane` elements apart: boxes of 64 columns x `rows` rows of one
// plane, 128-byte swizzle, zero fill out of bounds.
inline cudaError_t make_planes_map(CUtensorMap* map, const void* ptr, int BH, int T, int D,
                                   long long plane, int rows = TILE) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH, 3};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2,
                                 (cuuint64_t)plane * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What the fp32 tensor-core kernels take: D <= max_d (64, or 128 for
// flash_bwd_tc32_d128.cu) with D % 8 == 0 (TMA needs 16-byte row strides of
// the planes).
inline bool bad_dims(int BH, int Tq, int Tk, int D, int max_d = 64) {
  return BH <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > max_d || D % 8 != 0;
}

}  // namespace tc32
}  // namespace mxflash
