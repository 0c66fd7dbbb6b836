// Mixed-precision SGD with momentum, one elementwise pass (Hopper, sm_90a).
//
// Replaces: the Pallas TPU kernel `_mp_sgd_call` / `_mp_sgd_kernel` in
// mxnet_tpu/opt/kernels.py. Per element, in fp32:
//   g   = grad * rescale_grad;  g = clip(g, -clip, clip) if clip >= 0
//   g   = g + wd * w32
//   m'  = momentum * m - lr * g
//   w32'= w32 + m';   w' = fp16(w32')
// reading fp16 grad, fp32 mom and fp32 master weight, writing fp16 weight,
// fp32 mom and fp32 master weight: 20 bytes per element, no other traffic.
// Each operation rounds on its own (no contraction into FMAs), in the order
// above, so the result is bit-equal to the plain PyTorch composition.
//
// lr, wd, rescale_grad, momentum and clip are launch arguments: a
// learning-rate schedule changes nothing that is built (the counterpart of the
// Pallas kernel's traced scalars).
//
// Bound on an H100 SXM (700 W): bytes. The largest parameter of BERT-base
// (the 30522 x 768 embedding, 23.4 M elements) moves 469 MB: ~140 us at
// 3.35 TB/s. Design against that bound: a grid-stride loop in which each
// thread moves 4 elements with one 8-byte fp16 load/store and 16-byte fp32
// loads/stores when every pointer is aligned for them, and a scalar loop for
// the tail (any n, no padded copy) or for unaligned pointers. The wrapper
// passes the inputs as the outputs to update in place; each element is read
// before it is written by the same thread, so that is safe.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

struct Hyper {
  float lr, wd, rescale, momentum, clip;
};

__device__ __forceinline__ void step(float g16, float& m, float& w, const Hyper& h) {
  float g = __fmul_rn(g16, h.rescale);
  // comparisons leave a NaN gradient NaN, as clamp does
  if (h.clip >= 0.f) g = g < -h.clip ? -h.clip : (g > h.clip ? h.clip : g);
  g = __fadd_rn(g, __fmul_rn(h.wd, w));
  m = __fsub_rn(__fmul_rn(h.momentum, m), __fmul_rn(h.lr, g));
  w = __fadd_rn(w, m);
}

__global__ void __launch_bounds__(NT)
mp_sgd_mom_kernel(const __half* __restrict__ grad, const float* mom, const float* w32,
                  __half* w_out, float* m_out, float* w32_out, long long n, Hyper h,
                  int vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const uint2 graw = reinterpret_cast<const uint2*>(grad)[i];
      const float2 g01 = __half22float2(*reinterpret_cast<const __half2*>(&graw.x));
      const float2 g23 = __half22float2(*reinterpret_cast<const __half2*>(&graw.y));
      float4 m = reinterpret_cast<const float4*>(mom)[i];
      float4 w = reinterpret_cast<const float4*>(w32)[i];
      step(g01.x, m.x, w.x, h);
      step(g01.y, m.y, w.y, h);
      step(g23.x, m.z, w.z, h);
      step(g23.y, m.w, w.w, h);
      reinterpret_cast<float4*>(m_out)[i] = m;
      reinterpret_cast<float4*>(w32_out)[i] = w;
      __half2 a = __floats2half2_rn(w.x, w.y);
      __half2 b = __floats2half2_rn(w.z, w.w);
      uint2 wraw;
      wraw.x = *reinterpret_cast<uint32_t*>(&a);
      wraw.y = *reinterpret_cast<uint32_t*>(&b);
      reinterpret_cast<uint2*>(w_out)[i] = wraw;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float m = mom[i], w = w32[i];
    step(__half2float(grad[i]), m, w, h);
    m_out[i] = m;
    w32_out[i] = w;
    w_out[i] = __float2half_rn(w);
  }
}

}  // namespace

extern "C" {

// grad, w_out: fp16; mom, w32, m_out, w32_out: fp32; n elements each.
// vec: 1 when the fp16 pointers are 8-byte and the fp32 pointers 16-byte
// aligned. clip < 0 means no clipping. Returns the cudaError_t of the launch.
int mx_mp_sgd_mom_update(const void* grad, const void* mom, const void* w32,
                         void* w_out, void* m_out, void* w32_out, long long n,
                         float lr, float momentum, float wd, float rescale_grad,
                         float clip, int vec, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + NT - 1) / NT;
  // a grid-stride loop: enough blocks to fill 132 SMs several times over
  if (blocks > 132 * 16) blocks = 132 * 16;
  const Hyper h{lr, wd, rescale_grad, momentum, clip};
  mp_sgd_mom_kernel<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __half*>(grad), static_cast<const float*>(mom),
      static_cast<const float*>(w32), static_cast<__half*>(w_out),
      static_cast<float*>(m_out), static_cast<float*>(w32_out), n, h, vec);
  return (int)cudaGetLastError();
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
