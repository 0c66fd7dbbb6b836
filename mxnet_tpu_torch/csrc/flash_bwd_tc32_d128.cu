// Flash-attention backward for Hopper (sm_90a) in fp32 on the tensor cores,
// for head dims 65-128: flash_bwd_tc32.cu's arithmetic (bf16x6) on tiles
// whose planes are two 64-column halves wide.
//
// Replaces: for fp32 inputs with D % 8 == 0 and 64 < D <= 128, the two Pallas
// TPU kernels of `_flash_bwd` in mxnet_tpu/ops/pallas_kernels.py:243, with the
// two-pass split of flash_bwd_tc.cu (no atomics, deterministic):
//   mx_flash_bwd_tc32_d128_dq  (`_bwd_dq_kernel` :170, call :257): one block
//       per (b*h, 64-row q tile), sweeping 32-key K/V tiles: dq = scale*ds.k;
//   mx_flash_bwd_tc32_d128_dkv (`_bwd_dkv_kernel` :204, call :277): one block
//       per (b*h, 64-key tile), K and V resident, sweeping 32-row q/dO tiles:
//       dv = p^T . dO,  dk = scale * ds^T . q.
// Both recompute p = exp(q.k^T*scale - lse) and ds = p * (dO.v^T - delta),
// delta = rowsum(dO * O) given (fp32, (BH, Tq)). The reference pads D to 128
// for D > 64 (`_plan_blocks`, pallas_kernels.py:350); here TMA's zero fill
// pads each tile's columns D..127, which adds nothing to any product.
//
// Arithmetic: flash_bwd_tc32.cu's. q, k, v and dO come as three bf16 planes
// each (mx_split_bf16x3, in flash_bwd_tc32.cu's library, one launch per
// backward); every product is the six plane products ai.bj with i + j <= 2,
// each exact in fp32, summed in the fp32 accumulator smallest first; P and dS
// are split into planes in registers. The products summed over the swept
// tiles (dQ, dV, dK) start a fresh accumulator for each 32-row tile and each
// 64-column half, added to the running sum on the CUDA cores (add_tile).
//
// Bound on an H100 SXM (700 W): 3 products (dQ pass) and 4 (dK/dV pass) of
// 2*BH*Tq*Tk*D flops each (halved for causal). At B=8, H=12, T=512, D=128
// that is 19.3 / 25.8 GFLOP: 0.117 / 0.156 ms at the bf16 tensor cores'
// 989 TFLOP/s over six plane products (165 TFLOP/s), 0.288 / 0.385 ms at the
// 67 TFLOP/s FFMA peak, against some 126 / 151 MB of fp32 inputs and outputs
// per pass (0.04 ms at 3.35 TB/s).
//
// Design against that bound. At D = 128 a 64-row tile of three planes is
// 48 KB, so flash_bwd_tc32.cu's layout (two resident tiles, two swept tiles
// double-buffered) would need 288 KB of the 227 KB a block may have; and its
// dK/dV pass's registers (the dK and dV sums, now 64 + 64 a thread, beside a
// 64 x 128 fresh tile, S^T, dP^T and the planes of P^T) would be over 255.
// - The swept operand comes in 32-row tiles (24 KB), double-buffered: two
//   resident 64-row tiles (96 KB) and a ring of 2 x 2 swept ones (96 KB),
//   197,632 B of dynamic shared memory, one block per SM.
// - S and dP (S^T, dP^T) are m64n32k16 wgmma products over the 128 columns
//   (A and B K-major from shared memory): 16 fp32 registers each, and P, dS
//   split into 3 planes x 2 k16 steps (24 registers).
// - dQ, dV, dK (m64n64k16, A from registers, B MN-major through the transpose
//   flag) run one 64-column half at a time into one fresh 32-register tile,
//   which add_tile adds to that half's sum. Live at the peak of the dK/dV
//   pass: dK and dV (128), the fresh tile (32), dS^T (16), the planes (24).
// - One warpgroup per block, thread 0 issues the TMA copies (4-D maps of the
//   planes with 64-column boxes of 64 or 32 rows), completion on mbarriers;
//   tile i+1 loads while tile i computes.
// - Masks, causal skipping and heaviest-tiles-first order as flash_bwd_tc32.cu.
// - D % 8 == 0 (TMA needs 16-byte row strides of the planes), D <= 128; every
//   pointer 16-byte aligned.
#include "flash_tc32_common.cuh"

namespace {

using namespace mxflash;
using namespace mxflash::tc;
using namespace mxflash::tc32;

constexpr size_t SMEM = 2 * RT + 4 * ST + 1024;  // + alignment slack

// sum[h] += a . (half h of the swept tile b), for both halves, each through
// the fresh tile t.
__device__ __forceinline__ void add_product(float (&sum)[2][32], uint32_t (&a)[3][2][4],
                                            uint32_t b) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[32];
    wg_fence();
    mma6_rs(t, a, b + h * SH);
    wg_commit();
    wg_wait<0>();
    reg_fence_a(a);
    reg_fence(t);
    add_tile(sum[h], t);
  }
}

// ---------------------------------------------------------------- dQ pass

// Planes of q, dout: (3, ..., BH, Tq, D); of k, v: (3, ..., BH, Tk, D);
// lse, delta: (BH, Tq) fp32; dq: (BH, Tq, D) fp32.
// Shared memory: Q, dO (64 rows), then K[2], V[2] (32 rows).
__global__ void __launch_bounds__(NT, 1)
flash_bwd_tc32_d128_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dq,
                              int BH, int Tq, int Tk, int D, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // resident tiles, K/V buffer 0, 1

  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + RT, sK = base + 2 * RT,
                 sV = base + 2 * RT + 2 * ST;
  const uint32_t bar_res = smem_addr(&bars[0]);
  const uint32_t bar_kv[2] = {smem_addr(&bars[1]), smem_addr(&bars[2])};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (Tq + TILE - 1) / TILE;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * TILE;  // heaviest causal tiles first
  const int kv_end = causal ? min(Tk, q0 + TILE) : Tk;
  const int n_kv = (kv_end + SW - 1) / SW;

  if (tid == 0) {
    mbar_init(bar_res);
    mbar_init(bar_kv[0]);
    mbar_init(bar_kv[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_res, 2 * RT);
    tma_tile_halves<RH>(sQ, &tm_q, bar_res, q0, bh);
    tma_tile_halves<RH>(sdO, &tm_do, bar_res, q0, bh);
    mbar_expect_tx(bar_kv[0], 2 * ST);
    tma_tile_halves<SH>(sK, &tm_k, bar_kv[0], 0, bh);
    tma_tile_halves<SH>(sV, &tm_v, bar_kv[0], 0, bh);
  }

  // this thread's two rows (tile-relative), their L and delta
  const int rr = 16 * warp + (lane >> 2);
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;
  const float L[2] = {row_L(lb, q0 + rr, Tq), row_L(lb, q0 + rr + 8, Tq)};
  const float Dl[2] = {q0 + rr < Tq ? db[q0 + rr] : 0.f,
                       q0 + rr + 8 < Tq ? db[q0 + rr + 8] : 0.f};

  const float sl2 = scale * LOG2E;
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  mbar_wait(bar_res, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * SW, b = it & 1;
    const uint32_t kb = sK + b * ST, vb = sV + b * ST;
    if (it + 1 < n_kv) {
      __syncthreads();  // every warp is past its products on buffer b ^ 1
      if (tid == 0) {
        mbar_expect_tx(bar_kv[b ^ 1], 2 * ST);
        tma_tile_halves<SH>(sK + (b ^ 1) * ST, &tm_k, bar_kv[b ^ 1], k0 + SW, bh);
        tma_tile_halves<SH>(sV + (b ^ 1) * ST, &tm_v, bar_kv[b ^ 1], k0 + SW, bh);
      }
    }
    mbar_wait(bar_kv[b], (it >> 1) & 1);

    float s[16], dp[16];
    wg_fence();
    mma6_ss(s, sQ, kb);
    wg_commit();
    mma6_ss(dp, sdO, vb);
    wg_commit();
    wg_wait<1>();
    reg_fence16(s);

    const bool edge = (k0 + SW > Tk) || (causal && k0 + SW - 1 > q0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], sl2, -L[e]));
      if (edge) {
        const int col = k0 + acc_col(i) + 2 * (lane & 3);
        if (col >= Tk || (causal && col > q0 + rr + 8 * e)) p = 0.f;
      }
      s[i] = p;
    }
    wg_wait<0>();
    reg_fence16(dp);
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] *= dp[i] - Dl[(i >> 1) & 1];  // ds

    uint32_t a[3][2][4];
    split_a(s, a);
    reg_fence_a(a);
    add_product(acc, a, kb);  // dS.K, one half at a time
  }

  store_tile<float, 128>(dq + (size_t)bh * Tq * D, acc, q0, Tq, D, scale);
}

// ------------------------------------------------------------- dK/dV pass

// As the dQ pass; dk, dv: (BH, Tk, D) fp32. Shared memory: K, V (64 rows),
// then Q[2], dO[2] (32 rows); the row terms L and delta of the current q tile
// in rowL/rowD[2][32].
__global__ void __launch_bounds__(NT, 1)
flash_bwd_tc32_d128_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, float* __restrict__ dk,
                               float* __restrict__ dv, int BH, int Tq, int Tk, int D,
                               float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // K/V, q/dO buffer 0, 1
  __shared__ float rowL[2][SW], rowD[2][SW];

  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + RT, sQ = base + 2 * RT,
                 sdO = base + 2 * RT + 2 * ST;
  const uint32_t bar_res = smem_addr(&bars[0]);
  const uint32_t bar_q[2] = {smem_addr(&bars[1]), smem_addr(&bars[2])};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * TILE;  // causal: the lowest key tiles, which
                                            // see the most rows, go first
  const int q_begin = causal ? k0 : 0;      // rows below k0 see none of these keys
  const int n_q = q_begin < Tq ? (Tq - q_begin + SW - 1) / SW : 0;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;

  if (tid == 0) {
    mbar_init(bar_res);
    mbar_init(bar_q[0]);
    mbar_init(bar_q[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_res, 2 * RT);
    tma_tile_halves<RH>(sK, &tm_k, bar_res, k0, bh);
    tma_tile_halves<RH>(sV, &tm_v, bar_res, k0, bh);
    if (n_q > 0) {
      mbar_expect_tx(bar_q[0], 2 * ST);
      tma_tile_halves<SH>(sQ, &tm_q, bar_q[0], q_begin, bh);
      tma_tile_halves<SH>(sdO, &tm_do, bar_q[0], q_begin, bh);
    }
  }
  // row terms of the first q tile; later tiles' are loaded one tile ahead
  float nextL = 0.f, nextD = 0.f;
  if (tid < SW) {
    rowL[0][tid] = row_L(lb, q_begin + tid, Tq);
    rowD[0][tid] = q_begin + tid < Tq ? db[q_begin + tid] : 0.f;
  }

  const int rr = 16 * warp + (lane >> 2);  // this thread's key rows rr, rr + 8
  const float sl2 = scale * LOG2E;
  float dk_acc[2][32], dv_acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[h][i] = dv_acc[h][i] = 0.f;

  mbar_wait(bar_res, 0);  // also when n_q == 0: no copy may outlive the block
  for (int it = 0; it < n_q; ++it) {
    const int q0 = q_begin + it * SW, b = it & 1;
    const uint32_t qb = sQ + b * ST, ob = sdO + b * ST;
    __syncthreads();  // buffer b ^ 1 and rowL/rowD[b ^ 1] are free; rowL/rowD[b] written
    if (it + 1 < n_q) {
      if (tid == 0) {
        mbar_expect_tx(bar_q[b ^ 1], 2 * ST);
        tma_tile_halves<SH>(sQ + (b ^ 1) * ST, &tm_q, bar_q[b ^ 1], q0 + SW, bh);
        tma_tile_halves<SH>(sdO + (b ^ 1) * ST, &tm_do, bar_q[b ^ 1], q0 + SW, bh);
      }
      if (tid < SW) {  // stored after this tile's products, read next tile
        nextL = row_L(lb, q0 + SW + tid, Tq);
        nextD = q0 + SW + tid < Tq ? db[q0 + SW + tid] : 0.f;
      }
    }
    mbar_wait(bar_q[b], (it >> 1) & 1);

    float st[16], dpt[16];  // S^T and dP^T: rows are keys, columns q rows
    wg_fence();
    mma6_ss(st, sK, qb);
    wg_commit();
    mma6_ss(dpt, sV, ob);
    wg_commit();
    wg_wait<1>();
    reg_fence16(st);

    const bool edge = (k0 + TILE > Tk) || (causal && k0 + TILE - 1 > q0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = acc_col(i) + 2 * (lane & 3);
      float p = exp2f(fmaf(st[i], sl2, -rowL[b][c]));
      if (edge) {
        const int key = k0 + rr + acc_row(i);
        if (key >= Tk || (causal && key > q0 + c)) p = 0.f;
      }
      st[i] = p;
    }
    uint32_t a[3][2][4];  // the planes of P^T, then of dS^T
    split_a(st, a);
    wg_wait<0>();  // dP^T done
    reg_fence16(dpt);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = acc_col(i) + 2 * (lane & 3);
      dpt[i] = st[i] * (dpt[i] - rowD[b][c]);  // ds^T
    }
    reg_fence_a(a);
    add_product(dv_acc, a, ob);  // P^T.dO
    split_a(dpt, a);
    reg_fence_a(a);
    add_product(dk_acc, a, qb);  // dS^T.Q
    if (it + 1 < n_q && tid < SW) {
      rowL[b ^ 1][tid] = nextL;
      rowD[b ^ 1][tid] = nextD;
    }
  }

  store_tile<float, 128>(dk + (size_t)bh * Tk * D, dk_acc, k0, Tk, D, scale);
  store_tile<float, 128>(dv + (size_t)bh * Tk * D, dv_acc, k0, Tk, D, 1.f);
}

// ------------------------------------------------------------------ host side

// The four maps of q, k, v, dout (plane 0 of each operand's planes, the others
// `plane` elements on): boxes of 64 rows for the pass's resident operands and
// SW rows for its swept ones.
cudaError_t make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                      const void* dout, long long plane, int BH, int Tq, int Tk, int D,
                      int q_rows, int kv_rows) {
  cudaError_t e;
  if ((e = make_planes_map(&m[0], q, BH, Tq, D, plane, q_rows)) != cudaSuccess) return e;
  if ((e = make_planes_map(&m[1], k, BH, Tk, D, plane, kv_rows)) != cudaSuccess) return e;
  if ((e = make_planes_map(&m[2], v, BH, Tk, D, plane, kv_rows)) != cudaSuccess) return e;
  return make_planes_map(&m[3], dout, BH, Tq, D, plane, q_rows);
}

}  // namespace

extern "C" {

// Shared memory each pass asks for (bytes).
long long mx_flash_bwd_tc32_d128_smem_bytes() { return (long long)SMEM; }

// q, k, v, dout: plane 0 of each operand's bf16 planes (mx_split_bf16x3),
// the planes `plane` elements apart; lse, delta fp32 (BH, Tq); dq fp32.
int mx_flash_bwd_tc32_d128_dq(const void* q, const void* k, const void* v,
                              const void* dout, long long plane, const void* lse,
                              const void* delta, void* dq, int BH, int Tq, int Tk, int D,
                              float scale, int causal, void* stream) {
  if (bad_dims(BH, Tq, Tk, D, 128) || misaligned({q, k, v, dout, dq}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  cudaError_t e = make_maps(m, q, k, v, dout, plane, BH, Tq, Tk, D, TILE, SW);
  if (e != cudaSuccess) return (int)e;
  // above 48 KB of dynamic shared memory needs the opt-in; set on every
  // launch so that it holds on whichever device is current
  e = cudaFuncSetAttribute(flash_bwd_tc32_d128_dq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((Tq + TILE - 1) / TILE) * BH;
  flash_bwd_tc32_d128_dq_kernel<<<(unsigned)blocks, NT, SMEM,
                                  static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), BH, Tq, Tk, D, scale,
      causal);
  return (int)cudaGetLastError();
}

// As mx_flash_bwd_tc32_d128_dq; dk, dv fp32 (BH, Tk, D).
int mx_flash_bwd_tc32_d128_dkv(const void* q, const void* k, const void* v,
                               const void* dout, long long plane, const void* lse,
                               const void* delta, void* dk, void* dv, int BH, int Tq,
                               int Tk, int D, float scale, int causal, void* stream) {
  if (bad_dims(BH, Tq, Tk, D, 128) || misaligned({q, k, v, dout, dk, dv}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  cudaError_t e = make_maps(m, q, k, v, dout, plane, BH, Tq, Tk, D, SW, TILE);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_tc32_d128_dkv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((Tk + TILE - 1) / TILE) * BH;
  flash_bwd_tc32_d128_dkv_kernel<<<(unsigned)blocks, NT, SMEM,
                                   static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      BH, Tq, Tk, D, scale, causal);
  return (int)cudaGetLastError();
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
