// Flash-attention backward for Hopper (sm_90a), CUDA cores, fp32 accumulation.
//
// Replaces: the two Pallas TPU kernels of `_flash_bwd` in
// mxnet_tpu/ops/pallas_kernels.py, with the same split, so neither needs
// atomics:
//   mx_flash_bwd_dq  (`_bwd_dq_kernel`):  one block per (b*h, 64-row q tile),
//       sweeping the K/V tiles:   dq = scale * sum_k ds . k
//   mx_flash_bwd_dkv (`_bwd_dkv_kernel`): one block per (b*h, 64-key tile),
//       sweeping the q/dO tiles:  dv = p^T . dO,  dk = ds^T . (scale * q)
// where both recompute p = exp(q.k^T*scale - lse) from the forward's row
// log-sum-exp and ds = p * (dO.v^T - delta), delta = rowsum(dO * O) (given,
// fp32). No Tq x Tk matrix reaches device memory.
//
// Bound on an H100 SXM (700 W): FA2's count of 10*BH*Tq*Tk*D flops for the
// pair (6 for dq, 8 for dk/dv, since both recompute S and dP), halved for
// causal, against q, k, v, o, dO, lse, delta read once and dq, dk, dv written
// once. At BERT-base training shapes (B=8, H=12, T=512, D=64) that is
// 16.1 GFLOP over ~51 MB (fp16): against the fp16 tensor-core peak
// (989 TFLOP/s) that is ~16 us of operations beside ~15 us of bytes
// (3.35 TB/s); fp32 without tensor cores (67 TFLOP/s) is compute bound at
// ~240 us.
//
// Design against that bound. This first version, like the forward, does all
// arithmetic on the CUDA cores in fp32 (the fp32 path must hold 1e-4 against
// the plain version); bf16 and fp16 inputs are widened to fp32 in shared
// memory and outputs are rounded once, when stored.
// - Each of the block's 256 threads owns a 4x4 block of the 64x64 S/dP tile
//   and 4 rows x (D/16) columns of its accumulators; every inner-loop operand
//   is one 16-byte shared load, as in the forward. Tiles are staged in both
//   layouts the three products need ([d][row] for S = Q.K^T and dP = dO.V^T,
//   [row][d] for the products that sum over rows or keys).
// - p and ds stay in registers and pass through one transposed shared tile.
// - Masks instead of padding: rows >= Tq get lse = +inf (so p = 0, and they
//   add nothing to dk/dv), keys >= Tk are masked to p = 0 (nothing to dq),
//   and a row whose lse is -inf (every key masked) gives p = 0, not NaN.
//   Loads past Tq, Tk or D are zero-filled and stores past them dropped, so
//   Tq != Tk and any D <= 128 need no padded copies.
// - causal (top-left): dq skips K tiles past the tile's last row and issues
//   its heaviest q tiles first; dk/dv skips q tiles before the key tile.
// mma.sync / wgmma, TMA and a tensor-core fp16/bf16 path are later work;
// PERF.md carries the measured time beside the bound.
#include "flash_common.cuh"

namespace {

using namespace mxflash;

constexpr int BM = 64;        // q rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int LDP = 68;       // row stride of the transposed p / ds tile

// Stage rows [row0, row0 + 64) of a (nrows, D) matrix into shared memory as
// fp32 times mul, transposed: dst[d * 64 + r]. Rows past nrows and columns
// past D are zero. Consecutive threads take consecutive rows, so the
// transposed stores are conflict-free.
template <typename T, int DP, bool VEC>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int row0,
                                        int nrows, int D, float mul) {
  for (int idx = threadIdx.x; idx < 64 * (DP / 4); idx += NT) {
    const int r = idx % 64, d = (idx / 64) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < nrows) load4<VEC>(src + (size_t)(row0 + r) * D, d, D, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(d + i) * 64 + r] = x[i] * mul;
  }
}

// The same rows, row-major: dst[r * DP + d].
template <typename T, int DP, bool VEC>
__device__ __forceinline__ void stage_r(float* dst, const T* src, int row0,
                                        int nrows, int D, float mul) {
  for (int idx = threadIdx.x; idx < 64 * (DP / 4); idx += NT) {
    const int r = idx / (DP / 4), d = (idx % (DP / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < nrows) load4<VEC>(src + (size_t)(row0 + r) * D, d, D, x);
    *reinterpret_cast<float4*>(&dst[r * DP + d]) =
        make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
  }
}

// acc[i][j] += sum_d At[d][a0 + i] * Bt[d][b0 + j] over two transposed tiles.
template <int DP>
__device__ __forceinline__ void mm_tt(float acc[4][4], const float* At, int a0,
                                      const float* Bt, int b0) {
#pragma unroll 16
  for (int d = 0; d < DP; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&At[d * 64 + a0]);
    const float4 b = *reinterpret_cast<const float4*>(&Bt[d * 64 + b0]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][g*4 + j] += sum_c Xt[c][x0 + i] * Y[c][g*64 + y0 + j]: a transposed
// 64-wide tile (stride LDP) times a row-major (64, DP) tile.
template <int DP>
__device__ __forceinline__ void mm_tr(float (*acc)[DP / 16], const float* Xt,
                                      int x0, const float* Y, int y0) {
  constexpr int CG = DP / 64;
#pragma unroll 8
  for (int c = 0; c < 64; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(&Xt[c * LDP + x0]);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float4 b = *reinterpret_cast<const float4*>(&Y[c * DP + g * 64 + y0]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][g * 4 + j] = fmaf(av[i], bv[j], acc[i][g * 4 + j]);
    }
  }
}

// Row terms of rows [row0, row0 + 64): lse * log2(e) (+inf past Tq or where
// lse is -inf, so that p = exp2(s - L) is 0 there) and delta.
__device__ __forceinline__ void stage_rows(float* rowL, float* rowD,
                                           const float* lse, const float* delta,
                                           int row0, int Tq) {
  for (int r = threadIdx.x; r < 64; r += NT) {
    const int row = row0 + r;
    float L = INFINITY, dl = 0.f;
    if (row < Tq) {
      const float l = lse[row];
      L = (l == -INFINITY) ? INFINITY : l * LOG2E;
      dl = delta[row];
    }
    rowL[r] = L;
    rowD[r] = dl;
  }
}

// q, dout, dq: (BH, Tq, D); k, v: (BH, Tk, D); lse, delta: (BH, Tq) fp32.
// At D <= 64 two blocks fit in an SM's shared memory (~98 KB each).
template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int BH, int Tq, int Tk, int D,
                    float scale, int causal) {
  constexpr int CG = DP / 64;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;              // [DP][BM]  q * scale * log2(e)
  float* dOt = Qt + DP * BM;     // [DP][BM]
  float* Kt = dOt + DP * BM;     // [DP][BN]
  float* Vt = Kt + DP * BN;      // [DP][BN]
  float* Ks = Vt + DP * BN;      // [BN][DP]
  float* dSt = Ks + BN * DP;     // [BN][LDP] ds, transposed
  float* rowL = dSt + BN * LDP;  // [BM]
  float* rowD = rowL + BM;       // [BM]

  const int nq = (Tq + BM - 1) / BM;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * BM;  // heaviest causal tiles first
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // key / output-column group
  const int ty = tid >> 4;   // row group
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;

  stage_t<T, DP, VEC>(Qt, q + (size_t)bh * Tq * D, q0, Tq, D, scale * LOG2E);
  stage_t<T, DP, VEC>(dOt, dout + (size_t)bh * Tq * D, q0, Tq, D, 1.f);
  stage_rows(rowL, rowD, lse + (size_t)bh * Tq, delta + (size_t)bh * Tq, q0, Tq);

  float acc[4][CG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CG * 4; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(Tk, q0 + BM) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // previous tile's Kt/Vt/Ks/dSt fully consumed
    stage_t<T, DP, VEC>(Kt, kb, k0, Tk, D, 1.f);
    stage_t<T, DP, VEC>(Vt, vb, k0, Tk, D, 1.f);
    stage_r<T, DP, VEC>(Ks, kb, k0, Tk, D, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_tt<DP>(s, Qt, ty * 4, Kt, tx * 4);    // log2-domain logits
    mm_tt<DP>(dp, dOt, ty * 4, Vt, tx * 4);  // dO . v^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty * 4 + i;
      const int r = q0 + ri;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        const bool keep = c < Tk && !(causal && c > r);
        const float p = keep ? exp2f(s[i][j] - rowL[ri]) : 0.f;
        s[i][j] = p * (dp[i][j] - rowD[ri]);  // ds
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dSt[(tx * 4 + j) * LDP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    mm_tr<DP>(acc, dSt, ty * 4, Ks, tx * 4);  // acc += ds . k
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    T* row = dq + ((size_t)bh * Tq + r) * D;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float x[4] = {acc[i][g * 4] * scale, acc[i][g * 4 + 1] * scale,
                          acc[i][g * 4 + 2] * scale, acc[i][g * 4 + 3] * scale};
      store4<VEC>(row, g * 64 + tx * 4, D, x);
    }
  }
}

// q, dout: (BH, Tq, D); k, v, dk, dv: (BH, Tk, D); lse, delta: (BH, Tq) fp32.
template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int BH, int Tq,
                     int Tk, int D, float scale, int causal) {
  constexpr int CG = DP / 64;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Kt = smem;              // [DP][BN]
  float* Vt = Kt + DP * BN;      // [DP][BN]
  float* Qt = Vt + DP * BN;      // [DP][BM]  q * scale * log2(e)
  float* Qs = Qt + DP * BM;      // [BM][DP]  q * scale
  float* dOt = Qs + BM * DP;     // [DP][BM]
  float* dOs = dOt + DP * BM;    // [BM][DP]
  float* Pt = dOs + BM * DP;     // [BM][LDP] p, then ds, keys contiguous
  float* rowL = Pt + BM * LDP;   // [BM]
  float* rowD = rowL + BM;       // [BM]

  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * BN;  // causal: the lowest tiles, which
                                          // see the most rows, go first
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // row / output-column group
  const int ty = tid >> 4;   // key group
  const T* qb = q + (size_t)bh * Tq * D;
  const T* ob = dout + (size_t)bh * Tq * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;

  stage_t<T, DP, VEC>(Kt, k + (size_t)bh * Tk * D, k0, Tk, D, 1.f);
  stage_t<T, DP, VEC>(Vt, v + (size_t)bh * Tk * D, k0, Tk, D, 1.f);

  float dk_acc[4][CG * 4], dv_acc[4][CG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CG * 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: rows below k0 see none of this tile's keys
  const int q_begin = causal ? (k0 / BM) * BM : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += BM) {
    __syncthreads();  // previous tile's Qt/Qs/dOt/dOs/Pt fully consumed
    stage_t<T, DP, VEC>(Qt, qb, q0, Tq, D, scale * LOG2E);
    stage_r<T, DP, VEC>(Qs, qb, q0, Tq, D, scale);
    stage_t<T, DP, VEC>(dOt, ob, q0, Tq, D, 1.f);
    stage_r<T, DP, VEC>(dOs, ob, q0, Tq, D, 1.f);
    stage_rows(rowL, rowD, lb, db, q0, Tq);
    __syncthreads();

    // transposed tiles: st[i][j] for key ty*4+i and row tx*4+j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    mm_tt<DP>(st, Kt, ty * 4, Qt, tx * 4);
    mm_tt<DP>(dpt, Vt, ty * 4, dOt, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rj = tx * 4 + j;
        const bool keep = c < Tk && !(causal && c > q0 + rj);
        const float p = keep ? exp2f(st[i][j] - rowL[rj]) : 0.f;
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - rowD[rj]);  // ds
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LDP + ty * 4]) =
          make_float4(st[0][j], st[1][j], st[2][j], st[3][j]);
    __syncthreads();
    mm_tr<DP>(dv_acc, Pt, ty * 4, dOs, tx * 4);   // dv += p^T . dO
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LDP + ty * 4]) =
          make_float4(dpt[0][j], dpt[1][j], dpt[2][j], dpt[3][j]);
    __syncthreads();
    mm_tr<DP>(dk_acc, Pt, ty * 4, Qs, tx * 4);    // dk += ds^T . (scale * q)
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= Tk) continue;
    T* krow = dk + ((size_t)bh * Tk + c) * D;
    T* vrow = dv + ((size_t)bh * Tk + c) * D;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float xk[4] = {dk_acc[i][g * 4], dk_acc[i][g * 4 + 1],
                           dk_acc[i][g * 4 + 2], dk_acc[i][g * 4 + 3]};
      const float xv[4] = {dv_acc[i][g * 4], dv_acc[i][g * 4 + 1],
                           dv_acc[i][g * 4 + 2], dv_acc[i][g * 4 + 3]};
      store4<VEC>(krow, g * 64 + tx * 4, D, xk);
      store4<VEC>(vrow, g * 64 + tx * 4, D, xv);
    }
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * DP * BM + 2 * DP * BN + BN * DP + BN * LDP + 2 * BM);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(2 * DP * BN + 4 * DP * BM + BM * LDP + 2 * BM);
}

template <typename Kern>
cudaError_t opt_in(Kern kern, size_t smem) {
  // above 48 KB of dynamic shared memory needs the opt-in; set on every
  // launch (it costs ~1 us) so that it holds on whichever device is current
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP, bool VEC>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int BH, int Tq,
                      int Tk, int D, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, DP, VEC>;
  constexpr size_t smem = dq_smem_bytes<DP>();
  cudaError_t e = opt_in(kern, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((Tq + BM - 1) / BM) * BH;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), BH, Tq, Tk, D, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int DP, bool VEC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int BH,
                       int Tq, int Tk, int D, float scale, int causal,
                       cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, DP, VEC>;
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t e = opt_in(kern, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((Tk + BN - 1) / BN) * BH;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), BH,
      Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

// The template for (dtype, D rounded to 64 or 128, vec) of one launcher.
#define MX_DISPATCH(LAUNCH, ...)                                                  \
  do {                                                                            \
    if (dtype == 0) {                                                             \
      if (D <= 64) return vec ? LAUNCH<float, 64, true>(__VA_ARGS__)              \
                              : LAUNCH<float, 64, false>(__VA_ARGS__);            \
      return vec ? LAUNCH<float, 128, true>(__VA_ARGS__)                          \
                 : LAUNCH<float, 128, false>(__VA_ARGS__);                        \
    }                                                                             \
    if (dtype == 1) {                                                             \
      if (D <= 64) return vec ? LAUNCH<__nv_bfloat16, 64, true>(__VA_ARGS__)      \
                              : LAUNCH<__nv_bfloat16, 64, false>(__VA_ARGS__);    \
      return vec ? LAUNCH<__nv_bfloat16, 128, true>(__VA_ARGS__)                  \
                 : LAUNCH<__nv_bfloat16, 128, false>(__VA_ARGS__);                \
    }                                                                             \
    if (dtype == 2) {                                                             \
      if (D <= 64) return vec ? LAUNCH<__half, 64, true>(__VA_ARGS__)             \
                              : LAUNCH<__half, 64, false>(__VA_ARGS__);           \
      return vec ? LAUNCH<__half, 128, true>(__VA_ARGS__)                         \
                 : LAUNCH<__half, 128, false>(__VA_ARGS__);                       \
    }                                                                             \
    return cudaErrorInvalidValue;                                                 \
  } while (0)

cudaError_t dq_dt(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int BH, int Tq, int Tk,
                  int D, float scale, int causal, int dtype, int vec, cudaStream_t s) {
  MX_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, BH, Tq, Tk, D, scale, causal, s);
}

cudaError_t dkv_dt(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int BH,
                   int Tq, int Tk, int D, float scale, int causal, int dtype, int vec,
                   cudaStream_t s) {
  MX_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, D, scale,
              causal, s);
}

bool bad_shape(int BH, int Tq, int Tk, int D) {
  return BH <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dout and the
// gradients); lse and delta are fp32. vec: 1 when D % 4 == 0 and every
// pointer is 16-byte aligned. Each returns the cudaError_t of its launch.
int mx_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int BH, int Tq,
                    int Tk, int D, float scale, int causal, int dtype, int vec,
                    void* stream) {
  if (bad_shape(BH, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  return (int)dq_dt(q, k, v, dout, lse, delta, dq, BH, Tq, Tk, D, scale, causal, dtype,
                    vec, static_cast<cudaStream_t>(stream));
}

int mx_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int BH,
                     int Tq, int Tk, int D, float scale, int causal, int dtype, int vec,
                     void* stream) {
  if (bad_shape(BH, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  return (int)dkv_dt(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, D, scale, causal,
                     dtype, vec, static_cast<cudaStream_t>(stream));
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
