// Flash-attention forward for Hopper (sm_90a) on the tensor cores: fp16 and
// bf16 operands, fp32 accumulation and softmax, wgmma products fed by TMA.
//
// Replaces: the Pallas TPU kernel `_flash_fwd` in
// mxnet_tpu/ops/pallas_kernels.py:126 (body `_fwd_kernel` :83, call :137)
// for 16-bit inputs with D % 8 == 0; fp32 inputs and other head dims take
// the CUDA-core kernel of flash_fwd.cu. It computes the same function:
//   out[r] = softmax(q[r] . K^T * scale  (causal / tail masked)) . V
//   lse[r] = log sum_c exp(q[r] . k[c] * scale)          (fp32, natural log)
// with online softmax, so no Tq x Tk matrix reaches device memory. lse means
// exactly what flash_fwd.cu writes: the backward kernels rebuild
// p = exp(s - lse) from it.
//
// Bound on an H100 SXM (700 W): two products of 2*BH*Tq*Tk*D flops each
// (halved for causal) against |q| + |k| + |v| + |o| bytes and 4 bytes of lse
// a row. At BERT-base training shapes (B=8, H=12, T=512, D=64, fp16) that is
// 6.4 GFLOP against the 989 TFLOP/s tensor-core peak (6.5 us) and 25 MB
// against 3.35 TB/s (7.5 us): bytes bound, 7.6 us. Beside the products each
// 64 x 64 tile needs 4096 exp2 on the MUFU (16 a clock per SM), about as many
// clocks as the tile's two products take on the tensor cores.
//
// Design against that bound:
// - One warpgroup (128 threads) per block and one 64-row q tile per block;
//   the Q tile stays resident in shared memory (one TMA load). The
//   sequential K sweep of the Pallas grid is the loop over 64-key K/V tiles
//   inside the block; K and V are double-buffered through TMA behind
//   `mbarrier`s, so tile i+1 loads while tile i computes. Several blocks
//   share an SM (41 KB of shared memory and 91 registers a thread at
//   D <= 64: five), so one block's softmax overlaps another's products.
//   Each head's K and V are read by its Tq/64 q tiles, from L2 after the
//   first.
// - S = Q.K^T: m64n64k16 `wgmma`, A and B both K-major from shared memory,
//   fp32 accumulators. scale*log2(e) multiplies the fp32 accumulator (q is
//   not pre-scaled: rounding q*scale to 16 bits would add an error the plain
//   version does not have).
// - Online softmax in base 2 in registers: each row's 64 entries lie on the
//   four threads of a quad (`acc_row`/`acc_col`), so the row max and the row
//   sum take two shuffles; p = 2^(s*scale*log2(e) - m) is one FFMA and one
//   MUFU `ex2.approx` (relative error ~2^-22, far below the 16-bit rounding
//   of p), the running sum l is taken over the fp32 p, and the output
//   accumulator is rescaled by 2^(m_old - m_new) before each product. A
//   tile's softmax runs more instructions than its products take
//   tensor-core clocks, so the instruction count sets the kernel's time
//   (PERF.md): hence the one-instruction exp2 and the scale folded into
//   the FFMA.
// - O += P.V: P rounded once to the input type, taken from the accumulator
//   registers as the A fragments (`to_a`), V as B MN-major (the transpose
//   flag) from shared memory, exactly as the dQ pass of flash_bwd_tc.cu
//   reads K. At a row's maximum the exponent is the rounding residual of
//   m = s*scale*log2(e) (at most half an ulp of m), so p rounds to exactly
//   1 in 16 bits, and the rounding of P moves an output by at most
//   u * sum_{c != argmax} p_c |v_c| / l (u = 2^-11 for fp16, 2^-8 for bf16),
//   on top of the output's own rounding (chip_smoke.FWD_TOL).
// - Masks: keys >= Tk get s = -inf; rows >= Tq (zero-filled by TMA) are
//   never stored; causal is top-left aligned: K tiles past the tile's last
//   row are never loaded, and the heaviest q tiles go first.
// - D <= 128 with D % 8 == 0 (TMA needs 16-byte row strides), specialised
//   for DP in {64, 128}; TMA's zero fill covers D < DP. Every pointer
//   16-byte aligned.
// - Epilogue: out = acc / max(l, 1e-20), rounded once to the input type;
//   lse = (m + log2 l) * ln 2 in fp32.
#include "flash_tc_common.cuh"

namespace {

using namespace mxflash;
using namespace mxflash::tc;

// q, o: (BH, Tq, D); k, v: (BH, Tk, D); lse: (BH, Tq) fp32.
// Shared memory (each tile DP/64 swizzled halves of 8 KB): Q, K[2], V[2].
template <typename T, int DP>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                    float* __restrict__ lse, int BH, int Tq, int Tk, int D,
                    float scale_log2, int causal) {
  constexpr int HV = DP / 64;
  constexpr uint32_t TB = HV * HALF_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // Q, K/V buffer 0, 1

  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + TB, sV = base + 3 * TB;
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t bar_kv[2] = {smem_addr(&bars[1]), smem_addr(&bars[2])};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (Tq + TILE - 1) / TILE;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * TILE;  // heaviest causal tiles first
  const int kv_end = causal ? min(Tk, q0 + TILE) : Tk;
  const int n_kv = (kv_end + TILE - 1) / TILE;       // >= 1: key 0 is always seen

  if (tid == 0) {
    mbar_init(bar_q);
    mbar_init(bar_kv[0]);
    mbar_init(bar_kv[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, TB);
    tma_tile<DP>(sQ, &tm_q, bar_q, q0, bh);
    mbar_expect_tx(bar_kv[0], 2 * TB);
    tma_tile<DP>(sK, &tm_k, bar_kv[0], 0, bh);
    tma_tile<DP>(sV, &tm_v, bar_kv[0], 0, bh);
  }

  const int rr = 16 * warp + (lane >> 2);  // this thread's rows rr, rr + 8
  float acc[HV][32];
#pragma unroll
  for (int h = 0; h < HV; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  // running max (base 2, scaled) and this thread's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
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

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * HV; ++kk) {
      const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      mma_ss<T>(s, desc(sQ + off), desc(kb + off), kk);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(s);

    // mask, row max over the quad, p = 2^(s*scale*log2(e) - m)
    const bool edge = (k0 + TILE > Tk) || (causal && k0 + TILE - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (edge) {
        const int col = k0 + acc_col(i) + 2 * (lane & 3);
        if (col >= Tk || (causal && col > q0 + rr + acc_row(i))) s[i] = -INFINITY;
      }
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float mu[2], corr[2];
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
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      const float p = ex2(fmaf(s[i], scale_log2, -mu[e]));
      l[e] += p;
      s[i] = p;
    }
#pragma unroll
    for (int h = 0; h < HV; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] *= corr[(i >> 1) & 1];

    // O += P.V, P rounded once to T
    uint32_t a[4][4];
    to_a<T>(s, a);
    reg_fence(a);
    wg_fence();
#pragma unroll
    for (int h = 0; h < HV; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T>(acc[h], a[kk], desc(vb + h * HALF_BYTES + kk * 16 * 128));
    wg_commit();
    wg_wait<0>();
    reg_fence(a);
#pragma unroll
    for (int h = 0; h < HV; ++h) reg_fence(acc[h]);
  }

  // epilogue: out = acc / l, lse = (m + log2 l) * ln 2
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float lt = l[e];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-20f);
    inv[e] = 1.f / lt;
    const int row = q0 + rr + 8 * e;
    if ((lane & 3) == 0 && row < Tq) {
      const float mf = m[e] == -INFINITY ? 0.f : m[e];
      lse[(size_t)bh * Tq + row] = (mf + log2f(lt)) * LN2;
    }
  }
#pragma unroll
  for (int h = 0; h < HV; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] *= inv[(i >> 1) & 1];
  store_tile<T, DP>(o + (size_t)bh * Tq * D, acc, q0, Tq, D, 1.f);
}

template <typename T, int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       int BH, int Tq, int Tk, int D, float scale, int causal, int dtype,
                       cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = make_map(&mq, q, dtype, BH, Tq, D)) != cudaSuccess) return e;
  if ((e = make_map(&mk, k, dtype, BH, Tk, D)) != cudaSuccess) return e;
  if ((e = make_map(&mv, v, dtype, BH, Tk, D)) != cudaSuccess) return e;
  auto kern = flash_fwd_tc_kernel<T, DP>;
  const size_t smem = smem_bytes<DP>(5);
  // above 48 KB of dynamic shared memory (DP = 128) needs the opt-in; set on
  // every launch so that it holds on whichever device is current
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((Tq + TILE - 1) / TILE) * BH;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(mq, mk, mv, static_cast<T*>(o),
                                               static_cast<float*>(lse), BH, Tq, Tk, D,
                                               scale * LOG2E, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 1 = bfloat16, 2 = float16 (q, k, v and o); lse is fp32. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments the kernel
// does not take).
int mx_flash_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                    int BH, int Tq, int Tk, int D, float scale, int causal, int dtype,
                    void* stream) {
  if (bad_args(BH, Tq, Tk, D, dtype) || misaligned({q, k, v, o}))
    return (int)cudaErrorInvalidValue;
  MX_TC_DISPATCH(launch_fwd, q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, dtype,
                 static_cast<cudaStream_t>(stream));
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
