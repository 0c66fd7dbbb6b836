// Mixed-precision SGD with momentum over a list of tensors, one launch
// (Hopper, sm_90a).
//
// Replaces: the Pallas TPU kernel `_mp_sgd_call` / `_mp_sgd_kernel` in
// mxnet_tpu/opt/kernels.py, which the JAX package calls once per parameter.
// Per element of every tensor, in fp32:
//   g   = grad * rescale_grad;  g = clip(g, -clip, clip) if clip >= 0
//   g   = g + wd * w32
//   m'  = momentum * m - lr * g
//   w32'= w32 + m';   w' = fp16(w32')
// reading fp16 grad, fp32 mom and fp32 master weight, writing fp16 weight,
// fp32 mom and fp32 master weight: 20 bytes per element, no other traffic.
// Each operation rounds on its own (no contraction into FMAs), in the order
// above, so the result is bit-equal to the plain PyTorch composition.
//
// Bound on an H100 SXM (700 W): bytes, at 3.35 TB/s. A training step updates
// every fp16 parameter: BERT-base's 150 tensors, ResNet-50's 87 (median
// 36,864 values). Launched once per tensor, the small tensors' launches and
// their tails held the step's update below half of its bound, so the design
// is one launch over the whole list:
// - a table of the tensors (six pointers, n, lr, wd, a vector flag) and of
//   each tensor's first block travels as a __grid_constant__ kernel
//   parameter (up to 32,764 bytes from CUDA 12.1 on sm_70+): no copy of its
//   own to the device per step, and the launch can be captured in a CUDA
//   graph; lists of up to SMALL tensors take a small table;
// - every block owns one chunk of CHUNK elements of one tensor, found by a
//   binary search over the first blocks; no grid-stride loop, so a small
//   tensor costs one block, not a launch;
// - each thread updates one quad of 4 elements: an 8-byte load of 4 fp16
//   gradients, a float4 of momentum and one of the master weight, all
//   issued before it computes, and streaming stores. Quad q of a chunk is
//   thread q's, so each load and store of a warp covers one contiguous
//   span. On the card (NVIDIA H100 80GB HBM3, 700 W) this was as fast as
//   two to eight quads a thread on every list and single tensor timed,
//   while 8 contiguous elements a thread (two float4 a thread 32 bytes
//   apart, each touching half of every sector) was slower: see PERF.md;
// - a tensor's last partial quad, and every element of a tensor whose
//   pointers are not 16-byte aligned, take a scalar path.
// lr and wd are per tensor (lr_mult / wd_mult are per parameter); momentum,
// rescale_grad and clip are per launch. All are launch arguments, so a
// learning-rate schedule rebuilds nothing. The wrapper passes the inputs as
// the outputs to update in place; each element is read before it is written
// by the same thread, so that is safe.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                         // threads per block
constexpr long long CHUNK = (long long)NT * 4;  // elements per block
constexpr int CAPACITY = 384;  // tensors per launch (the largest table)
// A launch copies its whole parameter buffer: a 29 KB table costs ~20 us a
// launch (NVIDIA H100 80GB HBM3, 700 W: ResNet-50's 87 fp16 parameters took
// 1.76 ms as 87 list-of-one launches with this table, 0.18 ms as one), so
// short lists, the single-tensor call among them, take SMALL entries.
constexpr int SMALL = 4;

struct Entry {
  const __half* grad;
  const float* mom;
  const float* w32;
  __half* w_out;
  float* m_out;
  float* w32_out;
  long long n;
  float lr, wd;
  int vec;
};

template <int CAP>
struct Table {
  Entry e[CAP];
  int first[CAP + 1];  // first block of each tensor; first[count] = grid
  int count;
  float momentum, rescale, clip;
};
static_assert(sizeof(Table<CAPACITY>) <= 32764, "kernel parameters exceed 32,764 bytes");

__device__ __forceinline__ void step(float g16, float& m, float& w, float lr, float wd,
                                     float rescale, float momentum, float clip) {
  float g = __fmul_rn(g16, rescale);
  // comparisons leave a NaN gradient NaN, as clamp does
  if (clip >= 0.f) g = g < -clip ? -clip : (g > clip ? clip : g);
  g = __fadd_rn(g, __fmul_rn(wd, w));
  m = __fsub_rn(__fmul_rn(momentum, m), __fmul_rn(lr, g));
  w = __fadd_rn(w, m);
}

__device__ __forceinline__ float2 h2f(uint32_t raw) {
  return __half22float2(*reinterpret_cast<const __half2*>(&raw));
}

__device__ __forceinline__ uint32_t f2h(float a, float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int CAP>
__global__ void __launch_bounds__(NT)
mp_sgd_mom_kernel(const __grid_constant__ Table<CAP> t) {
  // the tensor whose blocks hold this one: the last first[] <= blockIdx.x
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const Entry& e = t.e[lo];
  const long long start = (long long)(b - t.first[lo]) * CHUNK;
  const long long end = min(start + CHUNK, e.n);
  const float lr = e.lr, wd = e.wd;
  const float rescale = t.rescale, momentum = t.momentum, clip = t.clip;

  if (e.vec) {
    // this thread's quad, if it lies wholly inside the tensor
    const long long q_end = start + ((end - start) >> 2 << 2);
    const long long at = start + ((long long)threadIdx.x << 2);
    if (at < q_end) {
      const uint2 graw = __ldcs(reinterpret_cast<const uint2*>(e.grad + at));
      float4 m = __ldcs(reinterpret_cast<const float4*>(e.mom + at));
      float4 w = __ldcs(reinterpret_cast<const float4*>(e.w32 + at));
      const float2 g01 = h2f(graw.x), g23 = h2f(graw.y);
      step(g01.x, m.x, w.x, lr, wd, rescale, momentum, clip);
      step(g01.y, m.y, w.y, lr, wd, rescale, momentum, clip);
      step(g23.x, m.z, w.z, lr, wd, rescale, momentum, clip);
      step(g23.y, m.w, w.w, lr, wd, rescale, momentum, clip);
      __stcs(reinterpret_cast<float4*>(e.m_out + at), m);
      __stcs(reinterpret_cast<float4*>(e.w32_out + at), w);
      uint2 wraw;
      wraw.x = f2h(w.x, w.y);
      wraw.y = f2h(w.z, w.w);
      __stcs(reinterpret_cast<uint2*>(e.w_out + at), wraw);
    }
    // the tail of fewer than 4 elements, in the tensor's last chunk
    const long long i = q_end + threadIdx.x;
    if (i < end) {
      float mm = e.mom[i], ww = e.w32[i];
      step(__half2float(e.grad[i]), mm, ww, lr, wd, rescale, momentum, clip);
      e.m_out[i] = mm;
      e.w32_out[i] = ww;
      e.w_out[i] = __float2half_rn(ww);
    }
    return;
  }
  // pointers not aligned for 16-byte accesses: one element at a time
  for (long long i = start + threadIdx.x; i < end; i += NT) {
    float mm = e.mom[i], ww = e.w32[i];
    step(__half2float(e.grad[i]), mm, ww, lr, wd, rescale, momentum, clip);
    e.m_out[i] = mm;
    e.w32_out[i] = ww;
    e.w_out[i] = __float2half_rn(ww);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int CAP>
int launch(int count, const long long* ptrs, const long long* ns, const float* lrs,
           const float* wds, float momentum, float rescale_grad, float clip,
           cudaStream_t stream) {
  Table<CAP> t;  // on the host stack; copied into the launch's parameters
  t.count = count;
  t.momentum = momentum;
  t.rescale = rescale_grad;
  t.clip = clip;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* p = ptrs + 6 * i;
    Entry& e = t.e[i];
    e.grad = reinterpret_cast<const __half*>(p[0]);
    e.mom = reinterpret_cast<const float*>(p[1]);
    e.w32 = reinterpret_cast<const float*>(p[2]);
    e.w_out = reinterpret_cast<__half*>(p[3]);
    e.m_out = reinterpret_cast<float*>(p[4]);
    e.w32_out = reinterpret_cast<float*>(p[5]);
    e.n = ns[i];
    e.lr = lrs[i];
    e.wd = wds[i];
    if (e.n <= 0) return (int)cudaErrorInvalidValue;
    e.vec = aligned16(e.grad) && aligned16(e.mom) && aligned16(e.w32) &&
            aligned16(e.w_out) && aligned16(e.m_out) && aligned16(e.w32_out);
    t.first[i] = (int)blocks;
    blocks += (e.n + CHUNK - 1) / CHUNK;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  t.first[count] = (int)blocks;
  mp_sgd_mom_kernel<CAP><<<(unsigned)blocks, NT, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most tensors one launch takes.
int mx_mp_sgd_capacity() { return CAPACITY; }

// One launch over `count` tensors (1 <= count <= mx_mp_sgd_capacity()).
// ptrs: count x 6 pointers (grad, mom, w32, w_out, m_out, w32_out; the
// first and fourth fp16, the others fp32); ns: elements of each (> 0);
// lrs, wds: per tensor. clip < 0 means no clipping. Returns the
// cudaError_t of the launch.
int mx_mp_sgd_mom_update_multi(int count, const long long* ptrs, const long long* ns,
                               const float* lrs, const float* wds, float momentum,
                               float rescale_grad, float clip, void* stream) {
  if (count < 1 || count > CAPACITY) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count <= SMALL)
    return launch<SMALL>(count, ptrs, ns, lrs, wds, momentum, rescale_grad, clip, s);
  return launch<CAPACITY>(count, ptrs, ns, lrs, wds, momentum, rescale_grad, clip, s);
}

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
