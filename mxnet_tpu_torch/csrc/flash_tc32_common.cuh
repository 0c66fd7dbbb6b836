// What the fp32 tensor-core flash-attention kernels (flash_fwd_tc32.cu,
// flash_fwd_tc32_d128.cu, flash_bwd_tc32.cu, flash_bwd_tc32_d128.cu) share:
// the bf16 planes of an fp32 tile, the register split of an fp32
// accumulator into the A planes of the next product, the six plane products
// of one fp32-grade product (A and B from shared memory, or A from registers
// with B transposed), the per-tile sum on the CUDA cores, and the 4-D TMA
// maps and copies of the planes.
//
// Each fp32 operand x is held as three bf16 planes, x0 = bf16(x),
// x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (mx_split_bf16x3 in
// flash_bwd_tc32.cu writes them to device memory), whose sum is x; a
// product a.b is the six plane products ai.bj with i + j <= 2, each exact
// in fp32, summed in the fp32 accumulator smallest first. A tile is 64 rows
// of three planes of 64 bf16 columns, each plane one 128-byte-swizzled
// 8 KB block as TMA writes it; the kernels for 64 < D <= 128 use tiles of
// two 64-column halves per plane ("tiles two halves wide" below).
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

// The K/V tiles of `rows` keys that q rows [r0, r0 + 64) need in the
// forward: all of Tk, or (causal) the keys up to their last row below Tq.
__device__ __forceinline__ int kv_tiles(int r0, int Tq, int Tk, int causal, int rows) {
  const int end = causal ? min(Tk, min(Tq, r0 + TILE)) : Tk;
  return (end + rows - 1) / rows;
}

// ------------------------------------------ the forward's online softmax

// One K/V tile's softmax step of the forward (flash_fwd_tc32.cu,
// flash_fwd_tc32_d128.cu) on this thread's part of S = Q.K^T, N registers
// of a 64 x 2N tile whose keys start at k0: keys >= Tk, and (causal) keys
// past a row, get s = -inf; the running max m (base 2, scaled) and this
// thread's part of the running sum l move on, s becomes
// p = 2^(s*scale*log2(e) - m), and corr is the factor the running O takes.
// q0 is the warpgroup's first row, row this thread's first.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int q0, int row,
                                             int Tk, int causal, float scale_log2) {
  const int lane = threadIdx.x & 31;
  const bool edge = (k0 + 2 * N > Tk) || (causal && k0 + 2 * N - 1 > q0);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (edge) {
      const int col = k0 + acc_col(i) + 2 * (lane & 3);
      if (col >= Tk || (causal && col > row + acc_row(i))) s[i] = -INFINITY;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float mu[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float m_new = fmaxf(m[e], mx[e] * scale_log2);
    mu[e] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
    corr[e] = ex2(m[e] - mu[e]);
    m[e] = m_new;
    l[e] *= corr[e];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], scale_log2, -mu[e]));
    l[e] += p;
    s[i] = p;
  }
}

// The forward's epilogue for this thread's two rows from `row` (block rows
// from r0; O of H 64-column halves): out = O / l and lse = m * ln 2 + ln l,
// the natural log as flash_fwd.cu writes it (each rounding at a smaller
// magnitude than (m + log2 l) * ln 2's). o and lse point at the head's rows.
template <int H>
__device__ __forceinline__ void store_out(float* o, float* lse, float (&acc)[H][32],
                                          const float (&m)[2], const float (&l)[2], int r0,
                                          int row, int Tq, int D) {
  const int lane = threadIdx.x & 31;
  float lt[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lt[e] = l[e];
    lt[e] += __shfl_xor_sync(0xffffffffu, lt[e], 1);
    lt[e] += __shfl_xor_sync(0xffffffffu, lt[e], 2);
    lt[e] = fmaxf(lt[e], 1e-20f);
    if ((lane & 3) == 0 && row + 8 * e < Tq) {
      const float mf = m[e] == -INFINITY ? 0.f : m[e];
      lse[row + 8 * e] = mf * LN2 + logf(lt[e]);
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] /= lt[(i >> 1) & 1];
  // rows from r0: the second warpgroup's warps (4-7) land on rows 64-127
  store_tile<float, 64 * H>(o, acc, r0, Tq, D, 1.f);
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

// --------------------------------------------- tiles two halves wide

// The layout of the kernels for 64 < D <= 128 (flash_fwd_tc32_d128.cu,
// flash_bwd_tc32_d128.cu): each plane of a tile is two 64-column halves,
// a resident tile has 64 rows (48 KB) and a swept one SW = 32 rows (24 KB);
// S (or dP) is a 64 x 32 product (m64n32k16, 16 registers), P (or dS) its
// planes in 3 x 2 k16 steps, and a product summed over the swept rows runs
// one 64-column half at a time.

constexpr int SW = 32;                  // rows of a swept tile
constexpr uint32_t RH = HALF_BYTES;     // a 64-column half of a 64-row plane
constexpr uint32_t SH = SW * 128;       // a 64-column half of a 32-row plane
constexpr uint32_t RPL = 2 * RH, SPL = 2 * SH;  // a plane: two halves
constexpr uint32_t RT = 3 * RPL;        // a resident tile: 48 KB
constexpr uint32_t ST = 3 * SPL;        // a swept tile: 24 KB

// A tile's three planes, each as two 64-column boxes (half h at column 64h),
// into [plane][half] blocks of HALF bytes.
template <uint32_t HALF>
__device__ __forceinline__ void tma_tile_halves(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int row, int bh) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_plane(dst + (2 * p + h) * HALF, map, bar, row, bh, p, 64 * h);
}

__device__ __forceinline__ void reg_fence16(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence_a(uint32_t (&a)[3][2][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[p][k][i])::"memory");
}

// d (+)= A . B, m64n32k16 on bf16, A and B K-major in shared memory;
// scale_d == 0 overwrites d.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A_I . B_J^T over the 128 columns: A a resident 64-row tile, B a
// swept 32-row tile, both K-major; eight k16 steps, four per half.
template <int I, int J>
__device__ __forceinline__ void ss_term(float (&d)[16], uint32_t a, uint32_t b,
                                        bool first) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t c = (kk & 3) * 32;
    mma_ss_n32(d, desc(a + I * RPL + (kk >> 2) * RH + c),
               desc(b + J * SPL + (kk >> 2) * SH + c), (first && kk == 0) ? 0 : 1);
  }
}

// d = A . B^T (64 x 32): the six plane products, smallest first.
__device__ __forceinline__ void mma6_ss(float (&d)[16], uint32_t a, uint32_t b) {
  ss_term<2, 0>(d, a, b, true);
  ss_term<0, 2>(d, a, b, false);
  ss_term<1, 1>(d, a, b, false);
  ss_term<1, 0>(d, a, b, false);
  ss_term<0, 1>(d, a, b, false);
  ss_term<0, 0>(d, a, b, false);
}

template <int I, int J>
__device__ __forceinline__ void rs_term(float (&d)[32], const uint32_t (&a)[3][2][4],
                                        uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    mma_rs<bf16>(d, a[I][kk], desc(b + J * SPL + kk * 16 * 128),
                 (first && kk == 0) ? 0 : 1);
}

// d = A . B (64 x 64): A the split planes of a 64 x 32 tile in registers, b
// one 64-column half of a swept 32-row tile read MN-major (its rows are the
// summed dimension); overwrites d.
__device__ __forceinline__ void mma6_rs(float (&d)[32], const uint32_t (&a)[3][2][4],
                                        uint32_t b) {
  rs_term<2, 0>(d, a, b, true);
  rs_term<0, 2>(d, a, b, false);
  rs_term<1, 1>(d, a, b, false);
  rs_term<1, 0>(d, a, b, false);
  rs_term<0, 1>(d, a, b, false);
  rs_term<0, 0>(d, a, b, false);
}

// A 64 x 32 fp32 accumulator (P or dS) as the three bf16 planes of the A
// fragments of the two k16 steps of the next product.
__device__ __forceinline__ void split_a(const float (&d)[16], uint32_t (&a)[3][2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
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

// ------------------------------------------------------------------ host side

// The (D, T, BH, 3) map of the bf16 planes of a (BH, T, D) operand, the
// planes `plane` elements apart: boxes of 64 columns x `rows` rows of one
// plane, 128-byte swizzle, zero fill out of bounds.
inline cudaError_t make_planes_map(CUtensorMap* map, const void* ptr, int BH, int T, int D,
                                   long long plane, int rows = TILE) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cudaError_t bound = bind_device(ptr);
  if (bound != cudaSuccess) return bound;
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
// flash_fwd_tc32_d128.cu and flash_bwd_tc32_d128.cu) with D % 8 == 0 (TMA
// needs 16-byte row strides of the planes).
inline bool bad_dims(int BH, int Tq, int Tk, int D, int max_d = 64) {
  return BH <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > max_d || D % 8 != 0;
}

}  // namespace tc32
}  // namespace mxflash
