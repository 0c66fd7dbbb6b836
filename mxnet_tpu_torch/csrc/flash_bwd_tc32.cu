// Flash-attention backward for Hopper (sm_90a) in fp32 on the tensor cores:
// every product is split into bf16 planes ("bf16x6"), with fp32 accumulation.
//
// Replaces: for fp32 inputs, the two Pallas TPU kernels of `_flash_bwd` in
// mxnet_tpu/ops/pallas_kernels.py:243, with the two-pass split of
// flash_bwd_tc.cu (no atomics, deterministic):
//   mx_flash_bwd_tc32_dq  (`_bwd_dq_kernel` :170, call :257): one block per
//       (b*h, 64-row q tile), sweeping the K/V tiles:  dq = scale * ds . k;
//   mx_flash_bwd_tc32_dkv (`_bwd_dkv_kernel` :204, call :277): one block per
//       (b*h, 64-key tile), K and V resident, sweeping the q/dO tiles:
//       dv = p^T . dO,  dk = scale * ds^T . q.
// Both recompute p = exp(q.k^T*scale - lse) and ds = p * (dO.v^T - delta),
// with delta = rowsum(dO * O) given (fp32, (BH, Tq)), as flash_bwd.cu takes it.
//
// fp32 on bf16 tensor cores (helpers shared with flash_fwd_tc32.cu in
// flash_tc32_common.cuh). mx_split_bf16x3, which the fp32 forward also
// launches, writes each fp32 operand x (q, k, v, dO) once as three bf16
// planes, x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1), whose sum
// is x exactly (each plane takes the next 8 significant bits of the
// remainder; only below bf16's smallest subnormal, 2^-133, or where bf16(x)
// would overflow, is x0 truncated instead). A
// product a.b is then the six plane products ai.bj with i + j <= 2, summed
// in the fp32 accumulator smallest first; the dropped terms are below
// 2^-26 |a||b|, and a product of two bf16 values is exact in fp32, so the
// result is fp32-grade (tests/test_torch_flash_backward_tc32.py holds a model
// of this arithmetic within 2x of plain fp32's error against fp64, where
// one-pass TF32 is some 600 times worse). P and dS are split the same way in
// registers, one k16 slice of the accumulator at a time.
//
// Bound on an H100 SXM (700 W): 3 products (dQ pass) and 4 (dK/dV pass) of
// 2*BH*Tq*Tk*D flops each (halved for causal). At BERT-base training shapes
// (B=8, H=12, T=512, D=64) that is 9.7 / 12.9 GFLOP: 0.144 / 0.192 ms at the
// 67 TFLOP/s FFMA peak of flash_bwd.cu, and 0.059 / 0.078 ms at the bf16
// tensor cores' 989 TFLOP/s over the six products each (165 TFLOP/s),
// against the ~63 / ~75 MB of fp32 inputs and outputs each pass moves (~0.02
// ms at 3.35 TB/s; the kernels read the bf16 planes, 1.5x the inputs).
// Beside the products each 64x64 tile needs 4096 exp2 and the register
// split of P and dS, about a fifth of the tile's tensor-core time.
//
// Design against that bound: flash_bwd_tc.cu's, with three planes per tile.
// - Every product is a warpgroup `wgmma.mma_async` m64n64k16 on bf16 planes
//   (24 per 64x64x64 product); one warpgroup (128 threads) per block. The
//   planes sit in shared memory row-major in TMA's 128-byte swizzle, so S,
//   dP (and their transposes in the dK/dV pass) read A and B K-major, and
//   dQ += dS.K, dV += P^T.dO, dK += dS^T.Q read B MN-major through wgmma's
//   transpose flag (which exists only for 16-bit types: the reason for bf16
//   planes rather than 3xTF32, whose tf32 wgmma would need transposed
//   copies of K, Q and dO); A is the split accumulator, from registers.
// - Copies: TMA boxes of one 64 x 64 plane of a 4-D map (D, T, B*H, plane)
//   per operand; completion through `mbarrier`s; thread 0 issues them. At
//   D <= 64 a tile is 3 x 8 KB and each pass holds two resident operands and
//   two double-buffered ones: 18 planes, 144 KB, one block per SM, tile i+1
//   loading while tile i computes. D > 64 stays on flash_bwd.cu: the ring
//   would need 288 KB, and the dK/dV pass's accumulators would not fit the
//   registers beside the planes of P and dS.
// - Overlap inside a tile: S and dP are two wgmma groups, and P is computed
//   and split while dP is in flight. The products that sum over tiles (dQ,
//   dV, dK) each start a fresh accumulator per tile, added to the running
//   fp32 sum on the CUDA cores (add_tile: the tensor cores' own sums drift
//   over a long chain). One set of A planes (48 registers) serves dV's and
//   dK's products in turn.
// - Masks, causal skipping and heaviest-tiles-first order as flash_bwd_tc.cu;
//   TMA's zero fill stands in for loads past Tq, Tk and D.
// - D <= 64 with D % 8 == 0 (TMA needs 16-byte row strides of the planes);
//   every pointer 16-byte aligned.
#include "flash_tc32_common.cuh"

namespace {

using namespace mxflash;
using namespace mxflash::tc;
using namespace mxflash::tc32;

constexpr size_t SMEM = 6 * TB + 1024;  // six tiles + alignment slack

// ------------------------------------------------------------- the split

// The leading plane of x: bf16(x), or x truncated where bf16(x) would
// overflow (|x| above bf16's largest finite value), so that the planes stay
// finite and sum to x.
__device__ __forceinline__ bf16 lead(float x) {
  bf16 h = __float2bfloat16_rn(x);
  if (isinf(__bfloat162float(h)) && !isinf(x)) h = __float2bfloat16_rz(x);
  return h;
}

// dst: (3, plane) bf16; blockIdx.y picks the segment: s_i, n_i elements (a
// multiple of 4), from element off_i of each plane. The segment's fields are
// picked by selects on scalar arguments: indexing an argument array by a
// run-time value would copy it to local memory in every thread.
__global__ void split_bf16x3_kernel(const float* s0, const float* s1, const float* s2,
                                    const float* s3, long long n0, long long n1,
                                    long long n2, long long n3, bf16* __restrict__ dst,
                                    long long plane) {
  const int y = blockIdx.y;
  const float* from = y == 0 ? s0 : y == 1 ? s1 : y == 2 ? s2 : s3;
  const long long n = y == 0 ? n0 : y == 1 ? n1 : y == 2 ? n2 : n3;
  const long long off = (y > 0 ? n0 : 0) + (y > 1 ? n1 : 0) + (y > 2 ? n2 : 0);
  const long long n4 = n / 4;
  const float4* src = reinterpret_cast<const float4*>(from);
  bf16* out = dst + off;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 x4 = src[i];
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    bf16 h[3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[0][j] = lead(x[j]);
      const float r = x[j] - __bfloat162float(h[0][j]);
      h[1][j] = __float2bfloat16_rn(r);
      h[2][j] = __float2bfloat16_rn(r - __bfloat162float(h[1][j]));
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(out + p * plane + 4 * i) =
          make_uint2(bf2_bits(__halves2bfloat162(h[p][0], h[p][1])),
                     bf2_bits(__halves2bfloat162(h[p][2], h[p][3])));
  }
}

// ---------------------------------------------------------------- dQ pass

// Planes of q, dout: (3, ..., BH, Tq, D); of k, v: (3, ..., BH, Tk, D);
// lse, delta: (BH, Tq) fp32; dq: (BH, Tq, D) fp32.
// Shared memory: Q, dO, then K[2], V[2], three planes each.
__global__ void __launch_bounds__(NT, 1)
flash_bwd_tc32_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int BH, int Tq, int Tk, int D,
                         float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // resident tiles, K/V buffer 0, 1

  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + TB, sK = base + 2 * TB, sV = base + 4 * TB;
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
    mbar_expect_tx(bar_res, 2 * TB);
    tma_planes(sQ, &tm_q, bar_res, q0, bh);
    tma_planes(sdO, &tm_do, bar_res, q0, bh);
    mbar_expect_tx(bar_kv[0], 2 * TB);
    tma_planes(sK, &tm_k, bar_kv[0], 0, bh);
    tma_planes(sV, &tm_v, bar_kv[0], 0, bh);
  }

  // this thread's two rows (tile-relative), their L and delta
  const int rr = 16 * warp + (lane >> 2);
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;
  const float L[2] = {row_L(lb, q0 + rr, Tq), row_L(lb, q0 + rr + 8, Tq)};
  const float Dl[2] = {q0 + rr < Tq ? db[q0 + rr] : 0.f,
                       q0 + rr + 8 < Tq ? db[q0 + rr + 8] : 0.f};

  const float sl2 = scale * LOG2E;
  float acc[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = 0.f;

  mbar_wait(bar_res, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * TILE, b = it & 1;
    const uint32_t kb = sK + b * TB, vb = sV + b * TB;
    if (it + 1 < n_kv) {
      __syncthreads();  // every warp is past its products on buffer b ^ 1
      if (tid == 0) {
        mbar_expect_tx(bar_kv[b ^ 1], 2 * TB);
        tma_planes(sK + (b ^ 1) * TB, &tm_k, bar_kv[b ^ 1], k0 + TILE, bh);
        tma_planes(sV + (b ^ 1) * TB, &tm_v, bar_kv[b ^ 1], k0 + TILE, bh);
      }
    }
    mbar_wait(bar_kv[b], (it >> 1) & 1);

    float s[32], dp[32];
    wg_fence();
    mma6_ss(s, sQ, kb);
    wg_commit();
    mma6_ss(dp, sdO, vb);
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

    uint32_t a[3][4][4];
    split_a(s, a);
    reg_fence3(a);
    wg_fence();
    mma6_rs(s, a, kb);  // this tile's dS.K, into s's registers
    wg_commit();
    wg_wait<0>();
    reg_fence3(a);
    reg_fence(s);
    add_tile(acc[0], s);
  }

  store_tile<float, 64>(dq + (size_t)bh * Tq * D, acc, q0, Tq, D, scale);
}

// ------------------------------------------------------------- dK/dV pass

// As the dQ pass; dk, dv: (BH, Tk, D) fp32. Shared memory: K, V, then Q[2],
// dO[2]; the row terms L and delta of the current q tile in rowL/rowD[2][64].
__global__ void __launch_bounds__(NT, 1)
flash_bwd_tc32_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int BH, int Tq,
                          int Tk, int D, float scale, int causal) {
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
    tma_planes(sK, &tm_k, bar_res, k0, bh);
    tma_planes(sV, &tm_v, bar_res, k0, bh);
    if (n_q > 0) {
      mbar_expect_tx(bar_q[0], 2 * TB);
      tma_planes(sQ, &tm_q, bar_q[0], q_begin, bh);
      tma_planes(sdO, &tm_do, bar_q[0], q_begin, bh);
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
  float dk_acc[1][32], dv_acc[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[0][i] = dv_acc[0][i] = 0.f;

  mbar_wait(bar_res, 0);  // also when n_q == 0: no copy may outlive the block
  for (int it = 0; it < n_q; ++it) {
    const int q0 = q_begin + it * TILE, b = it & 1;
    const uint32_t qb = sQ + b * TB, ob = sdO + b * TB;
    __syncthreads();  // buffer b ^ 1 and rowL/rowD[b ^ 1] are free; rowL/rowD[b] written
    if (it + 1 < n_q) {
      if (tid == 0) {
        mbar_expect_tx(bar_q[b ^ 1], 2 * TB);
        tma_planes(sQ + (b ^ 1) * TB, &tm_q, bar_q[b ^ 1], q0 + TILE, bh);
        tma_planes(sdO + (b ^ 1) * TB, &tm_do, bar_q[b ^ 1], q0 + TILE, bh);
      }
      if (tid < TILE) {  // stored after this tile's products, read next tile
        nextL = row_L(lb, q0 + TILE + tid, Tq);
        nextD = q0 + TILE + tid < Tq ? db[q0 + TILE + tid] : 0.f;
      }
    }
    mbar_wait(bar_q[b], (it >> 1) & 1);

    float st[32], dpt[32];  // S^T and dP^T: rows are keys, columns q rows
    wg_fence();
    mma6_ss(st, sK, qb);
    wg_commit();
    mma6_ss(dpt, sV, ob);
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
    uint32_t a[3][4][4];  // the planes of P^T, then of dS^T
    split_a(st, a);
    wg_wait<0>();  // dP^T done
    reg_fence(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i) + 2 * (lane & 3);
      dpt[i] = st[i] * (dpt[i] - rowD[b][c]);  // ds^T
    }
    reg_fence3(a);
    wg_fence();
    mma6_rs(st, a, ob);  // this tile's P^T.dO, into st's registers
    wg_commit();
    wg_wait<0>();
    reg_fence3(a);
    reg_fence(st);
    add_tile(dv_acc[0], st);
    split_a(dpt, a);
    reg_fence3(a);
    wg_fence();
    mma6_rs(st, a, qb);  // this tile's dS^T.Q
    wg_commit();
    wg_wait<0>();
    reg_fence3(a);
    reg_fence(st);
    add_tile(dk_acc[0], st);
    if (it + 1 < n_q && tid < TILE) {
      rowL[b ^ 1][tid] = nextL;
      rowD[b ^ 1][tid] = nextD;
    }
  }

  store_tile<float, 64>(dk + (size_t)bh * Tk * D, dk_acc, k0, Tk, D, scale);
  store_tile<float, 64>(dv + (size_t)bh * Tk * D, dv_acc, k0, Tk, D, 1.f);
}

// ------------------------------------------------------------------ host side

// q, k, v, dout: plane 0 of each operand's planes (the others `plane`
// elements on); makes the four maps.
cudaError_t make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                      const void* dout, long long plane, int BH, int Tq, int Tk, int D) {
  cudaError_t e;
  if ((e = make_planes_map(&m[0], q, BH, Tq, D, plane)) != cudaSuccess) return e;
  if ((e = make_planes_map(&m[1], k, BH, Tk, D, plane)) != cudaSuccess) return e;
  if ((e = make_planes_map(&m[2], v, BH, Tk, D, plane)) != cudaSuccess) return e;
  return make_planes_map(&m[3], dout, BH, Tq, D, plane);
}

}  // namespace

extern "C" {

// Shared memory each pass asks for (bytes).
long long mx_flash_bwd_tc32_smem_bytes() { return (long long)SMEM; }

// The three bf16 planes of up to four fp32 tensors (src_i, n_i elements, a
// multiple of 4, 16-byte aligned; n_i = 0 for an unused slot) into dst
// (3, sum n_i), the tensors back to back in each plane.
int mx_split_bf16x3(const void* s0, const void* s1, const void* s2, const void* s3,
                    long long n0, long long n1, long long n2, long long n3, void* dst,
                    void* stream) {
  const void* src[4] = {s0, s1, s2, s3};
  const long long n[4] = {n0, n1, n2, n3};
  long long total = 0, most = 0;
  for (int s = 0; s < 4; ++s) {
    if (n[s] < 0 || n[s] % 4 != 0 || (n[s] > 0 && misaligned({src[s]})))
      return (int)cudaErrorInvalidValue;
    total += n[s];
    most = n[s] > most ? n[s] : most;
  }
  if (total == 0) return (int)cudaSuccess;
  if (misaligned({dst})) return (int)cudaErrorInvalidValue;
  const long long blocks = (most / 4 + 255) / 256;
  const dim3 grid((unsigned)(blocks < 2048 ? blocks : 2048), 4);
  split_bf16x3_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), static_cast<const float*>(s1),
      static_cast<const float*>(s2), static_cast<const float*>(s3), n0, n1, n2, n3,
      static_cast<bf16*>(dst), total);
  return (int)cudaGetLastError();
}

// q, k, v, dout: plane 0 of each operand's bf16 planes (mx_split_bf16x3),
// the planes `plane` elements apart; lse, delta fp32 (BH, Tq); dq fp32.
int mx_flash_bwd_tc32_dq(const void* q, const void* k, const void* v, const void* dout,
                         long long plane, const void* lse, const void* delta, void* dq,
                         int BH, int Tq, int Tk, int D, float scale, int causal,
                         void* stream) {
  if (bad_dims(BH, Tq, Tk, D) || misaligned({q, k, v, dout, dq}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  cudaError_t e = make_maps(m, q, k, v, dout, plane, BH, Tq, Tk, D);
  if (e != cudaSuccess) return (int)e;
  // above 48 KB of dynamic shared memory needs the opt-in; set on every
  // launch so that it holds on whichever device is current
  e = cudaFuncSetAttribute(flash_bwd_tc32_dq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((Tq + TILE - 1) / TILE) * BH;
  flash_bwd_tc32_dq_kernel<<<(unsigned)blocks, NT, SMEM,
                             static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), BH, Tq, Tk, D, scale,
      causal);
  return (int)cudaGetLastError();
}

// As mx_flash_bwd_tc32_dq; dk, dv fp32 (BH, Tk, D).
int mx_flash_bwd_tc32_dkv(const void* q, const void* k, const void* v, const void* dout,
                          long long plane, const void* lse, const void* delta, void* dk,
                          void* dv, int BH, int Tq, int Tk, int D, float scale,
                          int causal, void* stream) {
  if (bad_dims(BH, Tq, Tk, D) || misaligned({q, k, v, dout, dk, dv}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  cudaError_t e = make_maps(m, q, k, v, dout, plane, BH, Tq, Tk, D);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_tc32_dkv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((Tk + TILE - 1) / TILE) * BH;
  flash_bwd_tc32_dkv_kernel<<<(unsigned)blocks, NT, SMEM,
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
