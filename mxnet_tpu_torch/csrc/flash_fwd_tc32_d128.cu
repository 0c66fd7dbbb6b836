// Flash-attention forward for Hopper (sm_90a) in fp32 on the tensor cores,
// for head dims 65-128: flash_fwd_tc32.cu's arithmetic (bf16x6) on tiles
// whose planes are two 64-column halves wide, laid out as
// flash_bwd_tc32_d128.cu lays out its tiles.
//
// Replaces: for fp32 inputs with D % 8 == 0 and 64 < D <= 128, the Pallas
// TPU kernel `_flash_fwd` in mxnet_tpu/ops/pallas_kernels.py:126 (body
// `_fwd_kernel` :83, call :137). It computes the same function:
//   out[r] = softmax(q[r] . K^T * scale  (causal / tail masked)) . V
//   lse[r] = log sum_c exp(q[r] . k[c] * scale)          (fp32, natural log)
// with online softmax, so no Tq x Tk matrix reaches device memory. lse means
// exactly what flash_fwd.cu writes: the backward kernels rebuild
// p = exp(s - lse) from it. The reference pads D to 128 for D > 64
// (`_plan_blocks`, pallas_kernels.py:350); here TMA's zero fill pads each
// tile's columns D..127, which adds nothing to any product, and the stores
// write only columns < D.
//
// Arithmetic: flash_fwd_tc32.cu's. q, k and v come as three bf16 planes
// each (mx_split_bf16x3, in flash_bwd_tc32.cu's library, one launch per
// forward); S = Q.K^T and each tile's P.V are the six plane products ai.bj
// with i + j <= 2, each exact in fp32, summed in the fp32 accumulator
// smallest first; P is split into planes in registers. Each 32-key tile's
// P.V starts a fresh accumulator per 64-column half, added on the CUDA cores
// as O = O*corr + O_tile (a long wgmma chain into one accumulator drifts:
// add_tile's note in flash_tc32_common.cuh).
//
// Bound on an H100 SXM (700 W): two products of 2*BH*Tq*Tk*D flops each
// (halved for causal). At B=8, H=12, T=512, D=128 that is 12.9 GFLOP:
// 0.078 ms at the bf16 tensor cores' 989 TFLOP/s over the six plane
// products (165 TFLOP/s), 0.192 ms at the 67 TFLOP/s FFMA peak of
// flash_fwd.cu, against 100 MB of fp32 q, k, v and out (0.030 ms at
// 3.35 TB/s; the kernel reads the planes, 1.5x the inputs). Beside the
// products each 64 x 32 tile needs 2048 exp2, the register split of P and
// the rescale of the 64-column-wide O.
//
// Design against that bound. At D = 128 a 64-row tile of three planes is
// 48 KB, so flash_fwd_tc32.cu's layout (two resident q tiles, a 64-row K/V
// ring of two stages) would need 288 KB of the 227 KB a block may have.
// - Two consumer warpgroups per block (256 threads), each with its own
//   64-row q tile, whose three planes stay resident (2 x 48 KB); they share
//   one ring of K and V planes in 32-row tiles (24 KB each), two stages
//   double-buffered through TMA behind `mbarrier`s (96 KB): 197,632 B of
//   dynamic shared memory, one block per SM. The tensor cores run one
//   warpgroup's products while the other computes its softmax. On the
//   card, one warpgroup per block was much slower, and issuing both halves'
//   P.V before one wait no faster.
// - S = Q.K^T: m64n32k16 products over the 128 columns (8 k16 steps x 6
//   plane products), 16 fp32 registers; scale*log2(e) multiplies the
//   accumulator, never q. A product with both operands in shared memory
//   reads 2 KB of A and 1 KB of B in 16 tensor-core clocks, more than the
//   ~128 B a clock shared memory delivers, so Q's plane 0 is read once into
//   registers (32 a thread, load_q0) and its three products (q0.k0, q0.k1,
//   q0.k2) take A from there: a third less shared-memory traffic per tile.
// - Online softmax in base 2 in registers, as flash_fwd_tc32.cu: quad
//   shuffles for the row max, one FFMA and one MUFU `ex2.approx` an element,
//   the running sum l over the fp32 p.
// - O_tile = P.V: P split into 3 planes x 2 k16 steps (24 registers), V
//   read MN-major through wgmma's transpose flag; one m64n64k16 product per
//   64-column half into a fresh 32-register tile, then O_h = O_h*corr +
//   O_tile on the CUDA cores. O is 64 registers a thread.
// - Masks, causal skipping and heaviest-tiles-first order follow
//   flash_fwd_tc32.cu: keys >= Tk get s = -inf, rows >= Tq (zero-filled by
//   TMA) are never stored, a warpgroup skips the K/V tiles its rows cannot
//   see (causal, top-left aligned) and the block loads none past its last
//   row.
// - D % 8 == 0 (TMA needs 16-byte row strides of the planes), D <= 128;
//   every pointer 16-byte aligned.
// - Epilogue: out = O / l, lse = m * ln 2 + ln l, both fp32.
#include "flash_tc32_common.cuh"

namespace {

using namespace mxflash;
using namespace mxflash::tc;
using namespace mxflash::tc32;

constexpr int NWG = 2;  // consumer warpgroups per block, one q tile each
// Shared memory of a block: Q[NWG] (64 rows), K[2], V[2] (32 rows) and
// alignment slack.
constexpr size_t SMEM = NWG * RT + 4 * ST + 1024;

// d (+)= A . B, m64n32k16 on bf16, A from registers (four 16-bit pairs), B
// K-major in shared memory (no transpose). scale_d == 0 overwrites d.
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d += Q_0 . B_J^T over the 128 columns, Q's plane 0 from registers.
template <int J>
__device__ __forceinline__ void rs_term_q0(float (&d)[16], const uint32_t (&q0)[8][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_rs_n32(d, q0[kk], desc(b + J * SPL + (kk >> 2) * SH + (kk & 3) * 32), 1);
}

// d = Q . B^T (64 x 32), the six plane products smallest first, the three
// of Q's plane 0 from registers.
__device__ __forceinline__ void mma6_s_q0(float (&d)[16], const uint32_t (&q0)[8][4],
                                          uint32_t a, uint32_t b) {
  ss_term<2, 0>(d, a, b, true);
  rs_term_q0<2>(d, q0, b);
  ss_term<1, 1>(d, a, b, false);
  ss_term<1, 0>(d, a, b, false);
  rs_term_q0<1>(d, q0, b);
  rs_term_q0<0>(d, q0, b);
}

// Q's plane 0 (a 64-row resident tile at a) as the A fragments of the 8 k16
// steps over its 128 columns, read from the 128-byte swizzle TMA wrote.
__device__ __forceinline__ void load_q0(uint32_t (&q0)[8][4], uint32_t a) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * wl + (lane >> 2) + 8 * (i & 1);
      const int col = (kk & 3) * 16 + 8 * (i >> 1) + 2 * (lane & 3);
      const uint32_t at = a + (kk >> 2) * RH + row * 128 +
                          ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2));
      asm volatile("ld.shared.b32 %0, [%1];" : "=r"(q0[kk][i]) : "r"(at));
    }
}

__device__ __forceinline__ void reg_fence_q0(uint32_t (&q0)[8][4]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(q0[k][i])::"memory");
}

// Planes of q: (3, ..., BH, Tq, D); of k, v: (3, ..., BH, Tk, D); o: (BH, Tq,
// D) fp32; lse: (BH, Tq) fp32. NWG consumer warpgroups, one q tile each.
// Shared memory: Q[NWG], then K[2], V[2], three planes of two halves each.
__global__ void __launch_bounds__(NWG * NT, 1)
flash_fwd_tc32_d128_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           float* __restrict__ o, float* __restrict__ lse, int BH,
                           int Tq, int Tk, int D, float scale_log2, int causal) {
  constexpr int ROWS = NWG * TILE;  // q rows per block
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // Q, K/V buffer 0, 1

  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base + NWG * RT, sV = sK + 2 * ST;
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t bar_kv[2] = {smem_addr(&bars[1]), smem_addr(&bars[2])};

  const int tid = threadIdx.x, wg = tid / NT, warp = tid >> 5, lane = tid & 31;
  const int nb = (Tq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x % BH;
  const int r0 = (nb - 1 - blockIdx.x / BH) * ROWS;  // heaviest causal blocks first
  const int q0 = r0 + wg * TILE;                     // this warpgroup's tile
  const uint32_t sQ = base + wg * RT;
  // the second tile may lie wholly past Tq: it is then neither loaded nor
  // computed, and its warpgroup only keeps the block's barriers
  const bool live1 = r0 + TILE < Tq;
  const int n0 = kv_tiles(r0, Tq, Tk, causal, SW);
  const int n1 = live1 ? kv_tiles(r0 + TILE, Tq, Tk, causal, SW) : 0;
  const int n_kv = max(n0, n1);        // every tile loaded is waited for
  const int my_n = wg == 0 ? n0 : n1;  // the tiles this warpgroup computes

  if (tid == 0) {
    mbar_init(bar_q);
    mbar_init(bar_kv[0]);
    mbar_init(bar_kv[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, live1 ? 2 * RT : RT);
    tma_tile_halves<RH>(base, &tm_q, bar_q, r0, bh);
    if (live1) tma_tile_halves<RH>(base + RT, &tm_q, bar_q, r0 + TILE, bh);
    mbar_expect_tx(bar_kv[0], 2 * ST);
    tma_tile_halves<SH>(sK, &tm_k, bar_kv[0], 0, bh);
    tma_tile_halves<SH>(sV, &tm_v, bar_kv[0], 0, bh);
  }

  // this thread's two rows, block-relative: warps 4-7 (the second
  // warpgroup) start at row 64, as store_tile counts them
  const int rr = 16 * warp + (lane >> 2);
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  // running max (base 2, scaled) and this thread's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  uint32_t q0r[8][4];  // Q's plane 0, the A operand of three S products
  if (my_n > 0) {
    mbar_wait(bar_q, 0);
    load_q0(q0r, sQ);
  }
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * SW, b = it & 1;
    const uint32_t kb = sK + b * ST, vb = sV + b * ST;
    if (it + 1 < n_kv) {
      __syncthreads();  // both warpgroups are past their products on buffer b ^ 1
      if (tid == 0) {
        mbar_expect_tx(bar_kv[b ^ 1], 2 * ST);
        tma_tile_halves<SH>(sK + (b ^ 1) * ST, &tm_k, bar_kv[b ^ 1], k0 + SW, bh);
        tma_tile_halves<SH>(sV + (b ^ 1) * ST, &tm_v, bar_kv[b ^ 1], k0 + SW, bh);
      }
    }
    if (it >= my_n) continue;  // keys this warpgroup's rows cannot see
    mbar_wait(bar_kv[b], (it >> 1) & 1);

    float s[16];
    reg_fence_q0(q0r);
    wg_fence();
    mma6_s_q0(s, q0r, sQ, kb);
    wg_commit();
    wg_wait<0>();
    reg_fence_q0(q0r);
    reg_fence16(s);

    float corr[2];
    softmax_tile(s, m, l, corr, k0, q0, r0 + rr, Tk, causal, scale_log2);

    // O_h = O_h * corr + P.V_h, each half's product in a fresh accumulator
    uint32_t a[3][2][4];
    split_a(s, a);
    reg_fence_a(a);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t[32];
      wg_fence();
      mma6_rs(t, a, vb + h * SH);
      wg_commit();
      wg_wait<0>();
      reg_fence_a(a);
      reg_fence(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = fmaf(acc[h][i], corr[(i >> 1) & 1], t[i]);
    }
  }
  if (my_n == 0) return;
  store_out(o + (size_t)bh * Tq * D, lse + (size_t)bh * Tq, acc, m, l, r0, r0 + rr, Tq, D);
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for (bytes).
long long mx_flash_fwd_tc32_d128_smem_bytes() { return (long long)SMEM; }

// q, k, v: plane 0 of each operand's bf16 planes (mx_split_bf16x3 in
// flash_bwd_tc32.cu), the planes `plane` elements apart; o fp32 (BH, Tq, D),
// lse fp32 (BH, Tq). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
int mx_flash_fwd_tc32_d128(const void* q, const void* k, const void* v, long long plane,
                           void* o, void* lse, int BH, int Tq, int Tk, int D, float scale,
                           int causal, void* stream) {
  if (bad_dims(BH, Tq, Tk, D, 128) || misaligned({q, k, v, o}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = make_planes_map(&mq, q, BH, Tq, D, plane, TILE)) != cudaSuccess) return (int)e;
  if ((e = make_planes_map(&mk, k, BH, Tk, D, plane, SW)) != cudaSuccess) return (int)e;
  if ((e = make_planes_map(&mv, v, BH, Tk, D, plane, SW)) != cudaSuccess) return (int)e;
  // above 48 KB of dynamic shared memory needs the opt-in; set on every
  // launch so that it holds on whichever device is current
  e = cudaFuncSetAttribute(flash_fwd_tc32_d128_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((Tq + NWG * TILE - 1) / (NWG * TILE)) * BH;
  flash_fwd_tc32_d128_kernel<<<(unsigned)blocks, NWG * NT, SMEM,
                               static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<float*>(o), static_cast<float*>(lse), BH, Tq, Tk, D,
      scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
