// Flash-attention forward for Hopper (sm_90a) in fp32 on the tensor cores:
// every product is split into bf16 planes ("bf16x6"), with fp32 accumulation.
//
// Replaces: for fp32 inputs with D % 8 == 0 and D <= 64, the Pallas TPU
// kernel `_flash_fwd` in mxnet_tpu/ops/pallas_kernels.py:126 (body
// `_fwd_kernel` :83, call :137); 64 < D <= 128 takes flash_fwd_tc32_d128.cu,
// odd head dims the CUDA-core kernel of flash_fwd.cu. It computes the same
// function:
//   out[r] = softmax(q[r] . K^T * scale  (causal / tail masked)) . V
//   lse[r] = log sum_c exp(q[r] . k[c] * scale)          (fp32, natural log)
// with online softmax, so no Tq x Tk matrix reaches device memory. lse means
// exactly what flash_fwd.cu writes: the backward kernels rebuild
// p = exp(s - lse) from it.
//
// fp32 on bf16 tensor cores, as flash_bwd_tc32.cu does it (helpers shared in
// flash_tc32_common.cuh): one launch of mx_split_bf16x3 writes q, k and v
// once as three bf16 planes each (x0 + x1 + x2 == x); S = Q.K^T and each
// tile's P.V are the six plane products ai.bj with i + j <= 2, each exact in
// fp32, summed smallest first, so the products are fp32-grade
// (tests/test_torch_flash_forward_tc32.py holds a model of this arithmetic
// within 2x of plain fp32's error against fp64). P is split the same way in
// registers.
//
// Bound on an H100 SXM (700 W): two products of 2*BH*Tq*Tk*D flops each
// (halved for causal). At BERT-base shapes (B=8, H=12, T=512, D=64) that is
// 6.4 GFLOP counted once: 0.096 ms at the 67 TFLOP/s FFMA peak of
// flash_fwd.cu, and 0.039 ms at the bf16 tensor cores' 989 TFLOP/s over the
// six products (165 TFLOP/s), against the 50 MB of fp32 q, k, v and out it
// moves (0.015 ms at 3.35 TB/s; the kernel reads the planes, 1.5x the
// inputs). Beside the products each 64 x 64 tile needs 4096 exp2 and the
// register split of P (three conversions and two subtractions a pair).
//
// Design against that bound:
// - Two consumer warpgroups per block (256 threads), each with its own
//   64-row q tile, whose three Q planes stay resident (2 x 24 KB); they share
//   one K/V ring, two stages of K and V planes (4 x 24 KB) double-buffered
//   through TMA (4-D maps (D, T, B*H, plane)) behind `mbarrier`s: 144 KB,
//   one block per SM. Sharing the ring halves the K/V bytes per q row, and
//   the tensor cores run one warpgroup's products while the other computes
//   its softmax: wgmma is asynchronous, so the two warpgroups' products
//   queue one behind the other and their softmaxes fall apart by one product.
//   (mx_flash_fwd_tc32_one_wg launches one warpgroup per block, 120 KB, for
//   chip_smoke.py to time beside it; PERF.md has both.)
// - S = Q.K^T: six plane products (mma6_ss), A and B K-major from shared
//   memory. scale*log2(e) multiplies the fp32 accumulator, never q.
// - Online softmax in base 2 in registers, as flash_fwd_tc.cu: the row max
//   and row sum over a quad (two shuffles), p = 2^(s*scale*log2(e) - m) one
//   FFMA and one MUFU `ex2.approx` (relative error ~2^-22, below fp32's
//   summation error over a row), the running sum l over the fp32 p.
// - O_tile = P.V: P split into three planes in registers (split_a), V read
//   MN-major through wgmma's transpose flag (which 16-bit types have and tf32
//   wgmma lacks: the reason for bf16 planes rather than 3xTF32), six plane
//   products into a fresh accumulator. O = O * corr + O_tile on the CUDA
//   cores (one FFMA an element): a long wgmma chain into one accumulator
//   drifts (add_tile's note), so no tile's sum is left to the tensor cores.
// - Masks, causal skipping and heaviest-tiles-first order follow
//   flash_fwd_tc.cu: keys >= Tk get s = -inf, rows >= Tq (zero-filled by
//   TMA) are never stored, a warpgroup skips the K/V tiles its rows cannot
//   see (causal, top-left aligned) and the block loads none past its last
//   row; TMA's zero fill covers D < 64 and the ragged edges.
// - D <= 64 with D % 8 == 0 (TMA needs 16-byte row strides of the planes),
//   every pointer 16-byte aligned. D = 65-128 has tiles of two 64-column
//   halves, for which this layout would need 288 KB: flash_fwd_tc32_d128.cu
//   sweeps K and V in 32-row tiles instead.
// - Epilogue: out = O / l, lse = m * ln 2 + ln l, both fp32 (store_out).
#include "flash_tc32_common.cuh"

namespace {

using namespace mxflash;
using namespace mxflash::tc;
using namespace mxflash::tc32;

// Shared memory of a block of nwg consumer warpgroups: Q[nwg], K[2], V[2]
// and alignment slack.
constexpr size_t smem_for(int nwg) { return (nwg + 4) * TB + 1024; }

// Planes of q: (3, ..., BH, Tq, D); of k, v: (3, ..., BH, Tk, D); o: (BH, Tq,
// D) fp32; lse: (BH, Tq) fp32. NWG consumer warpgroups, one q tile each (2;
// 1 only to measure what the second one buys). Shared memory: Q[NWG], then
// K[2], V[2], three planes each.
template <int NWG>
__global__ void __launch_bounds__(NWG * NT, 1)
flash_fwd_tc32_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                      float* __restrict__ lse, int BH, int Tq, int Tk, int D,
                      float scale_log2, int causal) {
  constexpr int ROWS = NWG * TILE;  // q rows per block
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // Q, K/V buffer 0, 1

  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base + NWG * TB, sV = base + (NWG + 2) * TB;
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t bar_kv[2] = {smem_addr(&bars[1]), smem_addr(&bars[2])};

  const int tid = threadIdx.x, wg = tid / NT, warp = tid >> 5, lane = tid & 31;
  const int nb = (Tq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x % BH;
  const int r0 = (nb - 1 - blockIdx.x / BH) * ROWS;  // heaviest causal blocks first
  const int q0 = r0 + wg * TILE;                     // this warpgroup's tile
  const uint32_t sQ = base + wg * TB;
  // the second tile may lie wholly past Tq: it is then neither loaded nor
  // computed, and its warpgroup only keeps the block's barriers
  const bool live1 = NWG > 1 && r0 + TILE < Tq;
  const int n0 = kv_tiles(r0, Tq, Tk, causal, TILE);
  const int n1 = live1 ? kv_tiles(r0 + TILE, Tq, Tk, causal, TILE) : 0;
  const int n_kv = max(n0, n1);          // every tile loaded is waited for
  const int my_n = wg == 0 ? n0 : n1;    // the tiles this warpgroup computes

  if (tid == 0) {
    mbar_init(bar_q);
    mbar_init(bar_kv[0]);
    mbar_init(bar_kv[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, live1 ? 2 * TB : TB);
    tma_planes(base, &tm_q, bar_q, r0, bh);
    if (live1) tma_planes(base + TB, &tm_q, bar_q, r0 + TILE, bh);
    mbar_expect_tx(bar_kv[0], 2 * TB);
    tma_planes(sK, &tm_k, bar_kv[0], 0, bh);
    tma_planes(sV, &tm_v, bar_kv[0], 0, bh);
  }

  // this thread's two rows, block-relative: warps 4-7 (the second
  // warpgroup) start at row 64, as store_tile counts them
  const int rr = 16 * warp + (lane >> 2);
  float acc[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = 0.f;
  // running max (base 2, scaled) and this thread's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (my_n > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * TILE, b = it & 1;
    const uint32_t kb = sK + b * TB, vb = sV + b * TB;
    if (it + 1 < n_kv) {
      __syncthreads();  // both warpgroups are past their products on buffer b ^ 1
      if (tid == 0) {
        mbar_expect_tx(bar_kv[b ^ 1], 2 * TB);
        tma_planes(sK + (b ^ 1) * TB, &tm_k, bar_kv[b ^ 1], k0 + TILE, bh);
        tma_planes(sV + (b ^ 1) * TB, &tm_v, bar_kv[b ^ 1], k0 + TILE, bh);
      }
    }
    if (it >= my_n) continue;  // keys this warpgroup's rows cannot see
    mbar_wait(bar_kv[b], (it >> 1) & 1);

    float s[32];
    wg_fence();
    mma6_ss(s, sQ, kb);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);

    float corr[2];
    softmax_tile(s, m, l, corr, k0, q0, r0 + rr, Tk, causal, scale_log2);

    // O = O * corr + P.V, this tile's product in a fresh accumulator
    uint32_t a[3][4][4];
    split_a(s, a);
    reg_fence3(a);
    wg_fence();
    mma6_rs(s, a, vb);  // into s's registers
    wg_commit();
    wg_wait<0>();
    reg_fence3(a);
    reg_fence(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = fmaf(acc[0][i], corr[(i >> 1) & 1], s[i]);
  }
  if (my_n == 0) return;
  store_out(o + (size_t)bh * Tq * D, lse + (size_t)bh * Tq, acc, m, l, r0, r0 + rr, Tq, D);
}

template <int NWG>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, long long plane,
                       void* o, void* lse, int BH, int Tq, int Tk, int D, float scale,
                       int causal, cudaStream_t stream) {
  if (bad_dims(BH, Tq, Tk, D) || misaligned({q, k, v, o})) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = make_planes_map(&mq, q, BH, Tq, D, plane)) != cudaSuccess) return e;
  if ((e = make_planes_map(&mk, k, BH, Tk, D, plane)) != cudaSuccess) return e;
  if ((e = make_planes_map(&mv, v, BH, Tk, D, plane)) != cudaSuccess) return e;
  auto kern = flash_fwd_tc32_kernel<NWG>;
  const size_t smem = smem_for(NWG);
  // above 48 KB of dynamic shared memory needs the opt-in; set on every
  // launch so that it holds on whichever device is current
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((Tq + NWG * TILE - 1) / (NWG * TILE)) * BH;
  kern<<<(unsigned)blocks, NWG * NT, smem, stream>>>(mq, mk, mv, static_cast<float*>(o),
                                                     static_cast<float*>(lse), BH, Tq, Tk,
                                                     D, scale * LOG2E, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for (bytes).
long long mx_flash_fwd_tc32_smem_bytes() { return (long long)smem_for(2); }

// q, k, v: plane 0 of each operand's bf16 planes (mx_split_bf16x3 in
// flash_bwd_tc32.cu), the planes `plane` elements apart; o fp32 (BH, Tq, D),
// lse fp32 (BH, Tq). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
int mx_flash_fwd_tc32(const void* q, const void* k, const void* v, long long plane,
                      void* o, void* lse, int BH, int Tq, int Tk, int D, float scale,
                      int causal, void* stream) {
  return (int)launch_fwd<2>(q, k, v, plane, o, lse, BH, Tq, Tk, D, scale, causal,
                            static_cast<cudaStream_t>(stream));
}

// The same with one consumer warpgroup per block (120 KB of shared memory,
// still one block per SM): not a route of the port, only chip_smoke.py's
// measure of what the second warpgroup buys.
int mx_flash_fwd_tc32_one_wg(const void* q, const void* k, const void* v,
                             long long plane, void* o, void* lse, int BH, int Tq, int Tk,
                             int D, float scale, int causal, void* stream) {
  return (int)launch_fwd<1>(q, k, v, plane, o, lse, BH, Tq, Tk, D, scale, causal,
                            static_cast<cudaStream_t>(stream));
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
