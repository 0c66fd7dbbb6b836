// Flash-attention forward for Hopper (sm_90a), CUDA cores, fp32 accumulation.
//
// Replaces: the Pallas TPU kernel `_flash_fwd` / `_fwd_kernel` in
// mxnet_tpu/ops/pallas_kernels.py:126 for head dims with D % 8 != 0 (or
// pointers not 16-byte aligned); fp16 and bf16 inputs otherwise take the
// tensor-core kernel of flash_fwd_tc.cu, fp32 inputs that of
// flash_fwd_tc32.cu (D <= 64) or flash_fwd_tc32_d128.cu (64 < D <= 128)
// (ops/flash_attention.py::_fwd_route). It computes the same function:
//   out[r] = softmax(q[r] . K^T * scale  (causal / tail masked)) . V
//   lse[r] = log sum_c exp(q[r] . k[c] * scale)          (fp32, natural log)
// with online softmax, so no Tq x Tk matrix ever reaches device memory.
//
// Bound on an H100 SXM (700 W): the work is 4*BH*Tq*Tk*D flops (halved for
// causal) against (|q|+|k|+|v|+|o|)*itemsize + 4*BH*Tq bytes. At BERT-base
// serving shapes (B=8, H=12, T=512, D=64) that is 6.4 GFLOP over 50 MB:
// fp32 without tensor cores (67 TFLOP/s) it is compute bound at ~96 us;
// bf16 against the tensor-core peak (989 TFLOP/s) the 25 MB it moves
// (3.35 TB/s) bound it at ~7.5 us.
//
// Design against that bound. This kernel does all arithmetic on the CUDA
// cores in fp32 (the fp32 path must hold 1e-4 against the plain version, so
// TF32 tensor cores are not an option there); the 16-bit inputs it serves
// (odd head dims) are widened to fp32 in shared memory and take the same
// path. The FMA rate is kept fed by register blocking:
// - one 256-thread block per (b*h, 64-row q tile); the sequential K sweep of
//   the Pallas grid is the loop over 64-key K/V tiles inside the block;
// - q is staged once, pre-multiplied by scale*log2(e) (softmax in base 2);
//   Q and K tiles are stored transposed ([d][row]) and P transposed
//   ([key][row]) so every inner-loop operand is one 16-byte shared load:
//   each thread owns a 4x4 block of S (rows ty*4.., keys tx*4..) and the
//   matching 4 rows x (D/16) columns of the output, so per 16 FMAs it issues
//   two 128-bit shared loads (both products stay FMA bound);
// - the running max/sum live in registers; row reductions are 16-lane
//   shuffles inside a warp;
// - ragged edges (Tq, Tk not multiples of 64, D < 64 or 64 < D < 128) are
//   zero-filled on load and masked in the kernel: no padded copies;
// - causal: K tiles beyond the tile's last row are never loaded, and q
//   tiles are issued heaviest first so the causal tail balances.
// PERF.md carries the measured time beside the bound.
#include "flash_common.cuh"

namespace {

using namespace mxflash;

constexpr int BM = 64;        // q rows per block
constexpr int BN = 64;        // keys per K/V tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int LDP = BM + 4;   // row stride of the transposed P tile

// q: (BH, Tq, D), k/v: (BH, Tk, D), o: (BH, Tq, D), lse: (BH, Tq) fp32.
// DP: D rounded up to 64 or 128 (the shared tiles' width).
template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int BH, int Tq, int Tk, int D,
                 float scale_log2, int causal) {
  constexpr int CG = DP / 64;  // 4-column groups of the output per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;            // [DP][BM]  q tile, transposed, pre-scaled
  float* Kt = Qt + DP * BM;    // [DP][BN]  k tile, transposed
  float* Vs = Kt + DP * BN;    // [BN][DP]  v tile
  float* Pt = Vs + BN * DP;    // [BN][LDP] probabilities, transposed

  const int nq = (Tq + BM - 1) / BM;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * BM;  // heaviest causal tiles first
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // key / output-column group
  const int ty = tid >> 4;   // row group
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;

  // stage q: consecutive threads take consecutive rows (conflict-free
  // transposed stores), each reading 4 consecutive elements of its row
  for (int idx = tid; idx < BM * (DP / 4); idx += NT) {
    const int r = idx % BM, d = (idx / BM) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Tq) load4<VEC>(qb + (size_t)(q0 + r) * D, d, D, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) Qt[(d + i) * BM + r] = x[i] * scale_log2;
  }

  float acc[4][CG * 4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CG * 4; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(Tk, q0 + BM) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // previous tile's Kt/Vs/Pt fully consumed
    for (int idx = tid; idx < BN * (DP / 4); idx += NT) {
      const int c = idx % BN, d = (idx / BN) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Tk) load4<VEC>(kb + (size_t)(k0 + c) * D, d, D, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) Kt[(d + i) * BN + c] = x[i];
    }
    for (int idx = tid; idx < BN * (DP / 4); idx += NT) {
      const int c = idx / (DP / 4), d = (idx % (DP / 4)) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Tk) load4<VEC>(vb + (size_t)(k0 + c) * D, d, D, x);
      *reinterpret_cast<float4*>(&Vs[c * DP + d]) = make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    // S = (q * scale * log2e) . K^T for this thread's 4x4 block
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * BM + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Kt[d * BN + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, online softmax update (base 2), P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        if (c >= Tk || (causal && c > r)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = exp2f(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;  // per-thread partial; reduced at the end
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CG * 4; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LDP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P . V
#pragma unroll 8
    for (int c = 0; c < BN; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[c * LDP + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(&Vs[c * DP + g * 64 + tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(av[i], bv[j], acc[i][g * 4 + j]);
      }
    }
  }

  // epilogue: out = acc / l, lse = m*ln2 + log(l)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    const float lt = fmaxf(row_sum16(l[i]), 1e-20f);
    if (r >= Tq) continue;
    const float inv = 1.f / lt;
    T* orow = o + ((size_t)bh * Tq + r) * D;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float x[4] = {acc[i][g * 4] * inv, acc[i][g * 4 + 1] * inv,
                          acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv};
      store4<VEC>(orow, g * 64 + tx * 4, D, x);
    }
    if (tx == 0) {
      const float mf = (m[i] == -INFINITY) ? 0.f : m[i];
      lse[(size_t)bh * Tq + r] = mf * LN2 + logf(lt);
    }
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(DP * BM + DP * BN + BN * DP + BN * LDP);
}

template <typename T, int DP, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int Tq, int Tk, int D, float scale,
                   int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DP, VEC>;
  constexpr size_t smem = smem_bytes<DP>();
  // above 48 KB of dynamic shared memory needs the opt-in; set on every
  // launch (it costs ~1 us) so that it holds on whichever device is current
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((Tq + BM - 1) / BM) * BH;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      BH, Tq, Tk, D, scale * LOG2E, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dt(const void* q, const void* k, const void* v, void* o,
                      void* lse, int BH, int Tq, int Tk, int D, float scale,
                      int causal, int vec, cudaStream_t s) {
  if (D <= 64) {
    return vec ? launch<T, 64, true>(q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, s)
               : launch<T, 64, false>(q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, s);
  }
  return vec ? launch<T, 128, true>(q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, s)
             : launch<T, 128, false>(q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. vec: 1 when D % 4 == 0
// and every pointer is 16-byte aligned. Returns the cudaError_t of the launch.
int mx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int BH, int Tq, int Tk, int D, float scale,
                 int causal, int dtype, int vec, void* stream) {
  if (BH <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dt<float>(q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, vec, s);
  if (dtype == 1)
    return (int)launch_dt<__nv_bfloat16>(q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, vec, s);
  if (dtype == 2)
    return (int)launch_dt<__half>(q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, vec, s);
  return (int)cudaErrorInvalidValue;
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
