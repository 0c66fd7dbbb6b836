// Flash-attention backward for Hopper (sm_90a) on the tensor cores: fp16 and
// bf16 operands, fp32 accumulation, wgmma products fed by TMA.
//
// Replaces: the two Pallas TPU kernels of `_flash_bwd` in
// mxnet_tpu/ops/pallas_kernels.py:243, with the same two-pass split, so
// neither pass needs atomics and both are deterministic:
//   mx_flash_bwd_tc_dq  (`_bwd_dq_kernel` :170, call :257): one block per
//       (b*h, 64-row q tile), sweeping the K/V tiles:  dq = scale * ds . k;
//       it also computes delta = rowsum(dO * O) for its rows and writes it
//       (fp32, (BH, Tq)) for the dK/dV pass;
//   mx_flash_bwd_tc_dkv (`_bwd_dkv_kernel` :204, call :277): one block per
//       (b*h, 64-key tile), K and V resident, sweeping the q/dO tiles:
//       dv = p^T . dO,  dk = scale * ds^T . q.
// Both recompute p = exp(q.k^T*scale - lse) from the forward's row
// log-sum-exp and ds = p * (dO.v^T - delta). No Tq x Tk matrix reaches
// device memory. fp32 inputs stay on the CUDA-core kernels of flash_bwd.cu:
// they must hold 1e-4 against the plain version, which rules out TF32 and
// fp16 operands.
//
// Bound on an H100 SXM (700 W): the dQ pass does 3 products (S, dP, dQ),
// the dK/dV pass 4 (S, dP, dV, dK), each 2*BH*Tq*Tk*D flops (halved for
// causal). At BERT-base training shapes (B=8, H=12, T=512, D=64) that is
// 9.7 / 12.9 GFLOP against the 989 TFLOP/s fp16/bf16 tensor-core peak:
// 9.8 / 13.0 us of operations, above the ~25 / ~31 MB each pass moves
// (7.5 / 9.4 us at 3.35 TB/s). Beside the products each 64x64 tile needs
// 4096 exp2 on the MUFU (16 a clock per SM), about half as many clocks as
// the tile's wgmma work.
//
// Design against that bound:
// - Every product is a warpgroup `wgmma.mma_async` m64n64k16 with fp32
//   accumulators in registers; one warpgroup (128 threads) per block, one
//   64-row tile. The tiles sit in shared memory row-major ([row][d]) in the
//   128-byte swizzle that TMA writes, one 64-column half (8 KB) after the
//   other, so every operand is read in place without a transposed copy:
//     S = Q.K^T, dP = dO.V^T (dQ pass) and S^T = K.Q^T, dP^T = V.dO^T
//       (dK/dV pass): A and B both K-major from shared memory;
//     dQ += dS.K, dV += P^T.dO, dK += dS^T.Q: A is P or dS, taken from the
//       accumulator registers (the fp32 accumulator layout of a 64x64 tile is
//       the A-fragment layout of the next product once rounded to 16 bits),
//       B MN-major (the wgmma transpose flag) from the swept tile.
// - P and dS are rounded to the input type once, as A operands; the
//   accumulators stay fp32 and the outputs are rounded once when stored.
// - Copies: `cp.async.bulk.tensor` (TMA) of 64x64 boxes of a 3-D map
//   (D, T, B*H) per operand, completion through `mbarrier`s. Thread 0 issues
//   them; the swept operand is double-buffered, so tile i+1 loads while tile
//   i computes. TMA's out-of-bounds zero fill stands in for masking loads
//   past Tq, Tk and D.
// - Overlap inside a tile: S and dP are two wgmma groups; P is computed
//   from S while dP is still in flight (and, in the dK/dV pass, dV's product
//   runs while dS is computed).
// - Masks: rows >= Tq get L = +inf (p = 0), an lse of -inf gives p = 0,
//   keys >= Tk are masked; causal is top-left aligned. The dQ pass skips K
//   tiles past the tile's last row and issues its heaviest q tiles first;
//   the dK/dV pass skips q tiles before the key tile.
// - D <= 128 with D % 8 == 0 (TMA needs 16-byte row strides), specialised
//   for DP in {64, 128}; every pointer 16-byte aligned. The tensor maps are
//   encoded on the host with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__.
#include <cuda.h>

#include <initializer_list>

#include "flash_common.cuh"

namespace {

using namespace mxflash;

constexpr int TILE = 64;                   // rows of a tile (q rows or keys)
constexpr int NT = 128;                    // one warpgroup
constexpr uint32_t HALF_BYTES = 64 * 128;  // a 64-row x 64-column 16-bit block

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of the given parity to complete. A copy that never
// lands (a fault in the kernel, not in the data) traps after 4 s instead of
// hanging the device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

// One 64 x 64 box of a (D, T, BH) map at (column c, row r, head bh).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int r, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r), "r"(bh)
      : "memory");
}

// A whole tile: DP/64 boxes, one per 64-column half.
template <int DP>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int bh) {
#pragma unroll
  for (int h = 0; h < DP / 64; ++h) tma_load(dst + h * HALF_BYTES, map, bar, h * 64, row, bh);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled block: start address,
// leading byte offset 16 (unused by these layouts), stride byte offset 1024
// (from one 8-row group to the next), layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to registers that an asynchronous
// wgmma reads or writes across the fence / wait that guards them.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

#define MX_D32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define MX_ACC32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])

// d (+)= A . B, m64n64k16, A and B K-major in shared memory.
// scale_d == 0 overwrites d.
template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int scale_d);
template <>
__device__ __forceinline__ void mma_ss<__half>(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " MX_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MX_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void mma_ss<__nv_bfloat16>(float (&d)[32], uint64_t da,
                                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MX_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MX_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B, m64n64k16, A from registers (four 16-bit pairs), B MN-major
// in shared memory (transpose flag set).
template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db);
template <>
__device__ __forceinline__ void mma_rs<__half>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " MX_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MX_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs<__nv_bfloat16>(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MX_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MX_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------- 16-bit values

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x);
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// The 64 x 64 fp32 accumulator of one product, rounded to 16 bits, as the
// A fragments of the four k16 steps of the next product: k step kk takes
// columns 16kk..16kk+15, i.e. accumulator entries 8kk..8kk+7.
template <typename T>
__device__ __forceinline__ void to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack2<T>(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Accumulator entry i of a thread: row  16*warp + lane/4 + 8*((i >> 1) & 1),
// column 8*(i >> 2) + 2*(lane % 4) + (i & 1).
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + (i & 1); }

// L = lse * log2(e), +inf past the last row or where lse is -inf (p = 0).
__device__ __forceinline__ float row_L(const float* lse, int row, int T) {
  if (row >= T) return INFINITY;
  const float l = lse[row];
  return l == -INFINITY ? INFINITY : l * LOG2E;
}

// Store rows [r0, r0 + 64) of a (nrows, D) output from a thread's
// accumulators (DP/64 column halves), times mul, dropping rows >= nrows.
template <typename T, int DP>
__device__ __forceinline__ void store_tile(T* out, const float (&acc)[DP / 64][32], int r0,
                                           int nrows, int D, float mul) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < DP / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + 16 * warp + (lane >> 2) + acc_row(i);
      const int col = h * 64 + acc_col(i) + 2 * (lane & 3);
      if (row < nrows && col < D)  // D % 8 == 0, so col + 1 < D too
        *reinterpret_cast<uint32_t*>(out + (size_t)row * D + col) =
            pack2<T>(acc[h][i] * mul, acc[h][i + 1] * mul);
    }
}

// ---------------------------------------------------------------- dQ pass

// q, o, dout, dq: (BH, Tq, D); k, v: (BH, Tk, D); lse, delta: (BH, Tq) fp32.
// Shared memory (each tile DP/64 swizzled halves of 8 KB): Q, dO, O, then
// K[2], V[2].
template <typename T, int DP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse, float* __restrict__ delta,
                       T* __restrict__ dq, int BH, int Tq, int Tk, int D, float scale,
                       int causal) {
  constexpr int HV = DP / 64;
  constexpr uint32_t TB = HV * HALF_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // resident tiles, K/V buffer 0, 1
  __shared__ float rowD[TILE];

  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint8_t* gsm = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t sQ = base, sdO = base + TB, sO = base + 2 * TB, sK = base + 3 * TB,
                 sV = base + 5 * TB;
  const uint32_t bar_res = smem_addr(&bars[0]);
  const uint32_t bar_kv[2] = {smem_addr(&bars[1]), smem_addr(&bars[2])};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (Tq + TILE - 1) / TILE;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * TILE;  // heaviest causal tiles first
  const int kv_end = causal ? min(Tk, q0 + TILE) : Tk;
  const int n_kv = (kv_end + TILE - 1) / TILE;

  if (tid == 0) {
    mbar_init(bar_res);
    mbar_init(bar_kv[0]);
    mbar_init(bar_kv[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_res, 3 * TB);
    tma_tile<DP>(sQ, &tm_q, bar_res, q0, bh);
    tma_tile<DP>(sdO, &tm_do, bar_res, q0, bh);
    tma_tile<DP>(sO, &tm_o, bar_res, q0, bh);
    mbar_expect_tx(bar_kv[0], 2 * TB);
    tma_tile<DP>(sK, &tm_k, bar_kv[0], 0, bh);
    tma_tile<DP>(sV, &tm_v, bar_kv[0], 0, bh);
  }

  // this thread's two rows (tile-relative) and their L
  const int rr = 16 * warp + (lane >> 2);
  const float* lb = lse + (size_t)bh * Tq;
  const float L[2] = {row_L(lb, q0 + rr, Tq), row_L(lb, q0 + rr + 8, Tq)};

  // delta = rowsum(dO * O): two threads per row, each half of the row's 16-byte
  // chunks (dO and O share the swizzle, so chunk c of both holds the same
  // columns; zero-filled columns add nothing)
  mbar_wait(bar_res, 0);
  {
    const int r = tid >> 1, part = tid & 1;
    float acc = 0.f;
#pragma unroll
    for (int h = 0; h < HV; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t off = h * HALF_BYTES + r * 128 + (part * 4 + c) * 16;
        const uint4 a = *reinterpret_cast<const uint4*>(gsm + TB + off);       // dO
        const uint4 b = *reinterpret_cast<const uint4*>(gsm + 2 * TB + off);   // O
        const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = unpack2<T>(av[j]), y = unpack2<T>(bv[j]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      rowD[r] = acc;
      if (q0 + r < Tq) delta[(size_t)bh * Tq + q0 + r] = acc;
    }
  }
  __syncthreads();
  const float Dl[2] = {rowD[rr], rowD[rr + 8]};

  const float sl2 = scale * LOG2E;
  float acc[HV][32];
#pragma unroll
  for (int h = 0; h < HV; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * TILE, b = it & 1;
    const uint32_t kb = sK + b * TB, vb = sV + b * TB;
    if (it + 1 < n_kv) {
      __syncthreads();  // every warp is past its products on buffer b ^ 1
      if (tid == 0) {
        mbar_expect_tx(bar_kv[b ^ 1], 2 * TB);
        tma_tile<DP>(sK + (b ^ 1) * TB, &tm_k, bar_kv[b ^ 1], k0 + TILE, bh);
        tma_tile<DP>(sV + (b ^ 1) * TB, &tm_v, bar_kv[b ^ 1], k0 + TILE, bh);
      }
    }
    mbar_wait(bar_kv[b], (it >> 1) & 1);

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * HV; ++kk) {
      const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      mma_ss<T>(s, desc(sQ + off), desc(kb + off), kk);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * HV; ++kk) {
      const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      mma_ss<T>(dp, desc(sdO + off), desc(vb + off), kk);
    }
    wg_commit();
    wg_wait<1>();
    reg_fence(s);

    const bool edge = (k0 + TILE > Tk) || (causal && k0 + TILE - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], sl2, -L[e]));
      if (edge) {
        const int col = k0 + acc_col(i) + 2 * (lane & 3);
        if (col >= Tk || (causal && col > q0 + rr + 8 * e)) p = 0.f;
      }
      s[i] = p;
    }
    wg_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - Dl[(i >> 1) & 1];  // ds

    uint32_t a[4][4];
    to_a<T>(s, a);
    reg_fence(a);
    wg_fence();
#pragma unroll
    for (int h = 0; h < HV; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T>(acc[h], a[kk], desc(kb + h * HALF_BYTES + kk * 16 * 128));
    wg_commit();
    wg_wait<0>();
    reg_fence(a);
#pragma unroll
    for (int h = 0; h < HV; ++h) reg_fence(acc[h]);
  }

  store_tile<T, DP>(dq + (size_t)bh * Tq * D, acc, q0, Tq, D, scale);
}

// ------------------------------------------------------------- dK/dV pass

// q, dout: (BH, Tq, D); k, v, dk, dv: (BH, Tk, D); lse, delta: (BH, Tq) fp32.
// Shared memory: K, V, then Q[2], dO[2]; the row terms L and delta of the
// current q tile in rowL/rowD[2][64].
template <typename T, int DP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_tc_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, int BH, int Tq, int Tk,
                        int D, float scale, int causal) {
  constexpr int HV = DP / 64;
  constexpr uint32_t TB = HV * HALF_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // K/V, q/dO buffer 0, 1
  __shared__ float rowL[2][TILE], rowD[2][TILE];

  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + TB, sQ = base + 2 * TB, sdO = base + 4 * TB;
  const uint32_t bar_res = smem_addr(&bars[0]);
  const uint32_t bar_q[2] = {smem_addr(&bars[1]), smem_addr(&bars[2])};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * TILE;  // causal: the lowest key tiles, which
                                            // see the most rows, go first
  const int q_begin = causal ? k0 : 0;      // rows below k0 see none of these keys
  const int n_q = q_begin < Tq ? (Tq - q_begin + TILE - 1) / TILE : 0;
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
    mbar_expect_tx(bar_res, 2 * TB);
    tma_tile<DP>(sK, &tm_k, bar_res, k0, bh);
    tma_tile<DP>(sV, &tm_v, bar_res, k0, bh);
    if (n_q > 0) {
      mbar_expect_tx(bar_q[0], 2 * TB);
      tma_tile<DP>(sQ, &tm_q, bar_q[0], q_begin, bh);
      tma_tile<DP>(sdO, &tm_do, bar_q[0], q_begin, bh);
    }
  }
  // row terms of the first q tile; later tiles' are loaded one tile ahead
  float nextL = 0.f, nextD = 0.f;
  if (tid < TILE) {
    rowL[0][tid] = row_L(lb, q_begin + tid, Tq);
    rowD[0][tid] = q_begin + tid < Tq ? db[q_begin + tid] : 0.f;
  }

  const int rr = 16 * warp + (lane >> 2);  // this thread's key rows rr, rr + 8
  const float sl2 = scale * LOG2E;
  float dk_acc[HV][32], dv_acc[HV][32];
#pragma unroll
  for (int h = 0; h < HV; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[h][i] = dv_acc[h][i] = 0.f;

  mbar_wait(bar_res, 0);  // also when n_q == 0: no copy may outlive the block
  for (int it = 0; it < n_q; ++it) {
    const int q0 = q_begin + it * TILE, b = it & 1;
    const uint32_t qb = sQ + b * TB, ob = sdO + b * TB;
    __syncthreads();  // buffer b ^ 1 and rowL/rowD[b ^ 1] are free; rowL/rowD[b] written
    if (it + 1 < n_q) {
      if (tid == 0) {
        mbar_expect_tx(bar_q[b ^ 1], 2 * TB);
        tma_tile<DP>(sQ + (b ^ 1) * TB, &tm_q, bar_q[b ^ 1], q0 + TILE, bh);
        tma_tile<DP>(sdO + (b ^ 1) * TB, &tm_do, bar_q[b ^ 1], q0 + TILE, bh);
      }
      if (tid < TILE) {  // stored after this tile's products, read next tile
        nextL = row_L(lb, q0 + TILE + tid, Tq);
        nextD = q0 + TILE + tid < Tq ? db[q0 + TILE + tid] : 0.f;
      }
    }
    mbar_wait(bar_q[b], (it >> 1) & 1);

    float st[32], dpt[32];  // S^T and dP^T: rows are keys, columns q rows
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * HV; ++kk) {
      const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      mma_ss<T>(st, desc(sK + off), desc(qb + off), kk);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * HV; ++kk) {
      const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      mma_ss<T>(dpt, desc(sV + off), desc(ob + off), kk);
    }
    wg_commit();
    wg_wait<1>();
    reg_fence(st);

    const bool edge = (k0 + TILE > Tk) || (causal && k0 + TILE - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i) + 2 * (lane & 3);
      float p = exp2f(fmaf(st[i], sl2, -rowL[b][c]));
      if (edge) {
        const int key = k0 + rr + acc_row(i);
        if (key >= Tk || (causal && key > q0 + c)) p = 0.f;
      }
      st[i] = p;
    }
    uint32_t pa[4][4];
    to_a<T>(st, pa);
    reg_fence(pa);
    wg_fence();
#pragma unroll
    for (int h = 0; h < HV; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T>(dv_acc[h], pa[kk], desc(ob + h * HALF_BYTES + kk * 16 * 128));
    wg_commit();
    wg_wait<1>();  // dP^T done; dV's product may still run
    reg_fence(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i) + 2 * (lane & 3);
      dpt[i] = st[i] * (dpt[i] - rowD[b][c]);  // ds^T
    }
    uint32_t da[4][4];
    to_a<T>(dpt, da);
    reg_fence(da);
    wg_fence();
#pragma unroll
    for (int h = 0; h < HV; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T>(dk_acc[h], da[kk], desc(qb + h * HALF_BYTES + kk * 16 * 128));
    wg_commit();
    wg_wait<0>();
    reg_fence(pa);
    reg_fence(da);
#pragma unroll
    for (int h = 0; h < HV; ++h) {
      reg_fence(dv_acc[h]);
      reg_fence(dk_acc[h]);
    }
    if (it + 1 < n_q && tid < TILE) {
      rowL[b ^ 1][tid] = nextL;
      rowD[b ^ 1][tid] = nextD;
    }
  }

  store_tile<T, DP>(dk + (size_t)bh * Tk * D, dk_acc, k0, Tk, D, scale);
  store_tile<T, DP>(dv + (size_t)bh * Tk * D, dv_acc, k0, Tk, D, 1.f);
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once through the runtime
// so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (D, T, BH) map of a contiguous (BH, T, D) 16-bit tensor: 64 x 64 boxes,
// 128-byte swizzle, zero fill out of bounds.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int dtype, int BH, int T, int D) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, TILE, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map,
                         dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                         3, const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP>
constexpr size_t smem_bytes(int tiles) {
  return (size_t)tiles * (DP / 64) * HALF_BYTES + 1024;  // + alignment slack
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* delta, void* dq, int BH,
                      int Tq, int Tk, int D, float scale, int causal, int dtype,
                      cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo, mdo;
  cudaError_t e;
  if ((e = make_map(&mq, q, dtype, BH, Tq, D)) != cudaSuccess) return e;
  if ((e = make_map(&mk, k, dtype, BH, Tk, D)) != cudaSuccess) return e;
  if ((e = make_map(&mv, v, dtype, BH, Tk, D)) != cudaSuccess) return e;
  if ((e = make_map(&mo, o, dtype, BH, Tq, D)) != cudaSuccess) return e;
  if ((e = make_map(&mdo, dout, dtype, BH, Tq, D)) != cudaSuccess) return e;
  auto kern = flash_bwd_tc_dq_kernel<T, DP>;
  const size_t smem = smem_bytes<DP>(7);
  // above 48 KB of dynamic shared memory needs the opt-in; set on every
  // launch so that it holds on whichever device is current
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((Tq + TILE - 1) / TILE) * BH;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      mq, mk, mv, mo, mdo, static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), BH, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int BH,
                       int Tq, int Tk, int D, float scale, int causal, int dtype,
                       cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = make_map(&mq, q, dtype, BH, Tq, D)) != cudaSuccess) return e;
  if ((e = make_map(&mk, k, dtype, BH, Tk, D)) != cudaSuccess) return e;
  if ((e = make_map(&mv, v, dtype, BH, Tk, D)) != cudaSuccess) return e;
  if ((e = make_map(&mdo, dout, dtype, BH, Tq, D)) != cudaSuccess) return e;
  auto kern = flash_bwd_tc_dkv_kernel<T, DP>;
  const size_t smem = smem_bytes<DP>(6);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((Tk + TILE - 1) / TILE) * BH;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), BH, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

// The template for (dtype, D rounded to 64 or 128) of one launcher.
#define MX_TC_DISPATCH(LAUNCH, ...)                                          \
  do {                                                                       \
    if (dtype == 1) return D <= 64 ? LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__)  \
                                   : LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__); \
    return D <= 64 ? LAUNCH<__half, 64>(__VA_ARGS__)                         \
                   : LAUNCH<__half, 128>(__VA_ARGS__);                       \
  } while (0)

// What the tensor-core kernels take: 16-bit types, D <= 128 with D % 8 == 0,
// and (checked by the caller) 16-byte-aligned pointers.
bool bad_args(int BH, int Tq, int Tk, int D, int dtype) {
  return BH <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 || D % 8 != 0 ||
         (dtype != 1 && dtype != 2);
}

bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  return false;
}

}  // namespace

extern "C" {

// dtype: 1 = bfloat16, 2 = float16 (q, k, v, o, dout and the gradients);
// lse and delta are fp32. mx_flash_bwd_tc_dq writes dq and delta =
// rowsum(dout * o); mx_flash_bwd_tc_dkv reads that delta. Each returns the
// cudaError_t of its launch (cudaErrorInvalidValue for arguments the
// kernels do not take).
int mx_flash_bwd_tc_dq(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* delta, void* dq, int BH,
                       int Tq, int Tk, int D, float scale, int causal, int dtype,
                       void* stream) {
  if (bad_args(BH, Tq, Tk, D, dtype) || misaligned({q, k, v, o, dout, dq}))
    return (int)cudaErrorInvalidValue;
  MX_TC_DISPATCH(launch_dq, q, k, v, o, dout, lse, delta, dq, BH, Tq, Tk, D, scale,
                 causal, dtype, static_cast<cudaStream_t>(stream));
}

int mx_flash_bwd_tc_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int BH,
                        int Tq, int Tk, int D, float scale, int causal, int dtype,
                        void* stream) {
  if (bad_args(BH, Tq, Tk, D, dtype) || misaligned({q, k, v, dout, dk, dv}))
    return (int)cudaErrorInvalidValue;
  MX_TC_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, D, scale,
                 causal, dtype, static_cast<cudaStream_t>(stream));
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
