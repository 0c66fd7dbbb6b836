// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// four-element loads and stores between fp32 registers and fp32 / bf16 / fp16
// rows in device memory, and 16-lane row reductions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace mxflash {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Four consecutive elements row[d..d+3] as floats; zero past D.
// VEC: D % 4 == 0 and the row is 16-byte (fp32) / 8-byte (bf16, fp16) aligned.
template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int d, int D, float x[4]) {
  if (VEC) {
    if (d < D) {
      float4 t = *reinterpret_cast<const float4*>(row + d);
      x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = (d + i < D) ? row[d + i] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* row, int d, int D, float x[4]) {
  if (VEC) {
    if (d < D) {
      uint2 t = *reinterpret_cast<const uint2*>(row + d);
      float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
      float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
      x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = (d + i < D) ? __bfloat162float(row[d + i]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load4(const __half* row, int d, int D, float x[4]) {
  if (VEC) {
    if (d < D) {
      uint2 t = *reinterpret_cast<const uint2*>(row + d);
      float2 a = __half22float2(*reinterpret_cast<const __half2*>(&t.x));
      float2 b = __half22float2(*reinterpret_cast<const __half2*>(&t.y));
      x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = (d + i < D) ? __half2float(row[d + i]) : 0.f;
  }
}

// Store x[0..3] to row[d..d+3], dropping columns at or past D.
template <bool VEC>
__device__ __forceinline__ void store4(float* row, int d, int D, const float x[4]) {
  if (VEC) {
    if (d < D) *reinterpret_cast<float4*>(row + d) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) if (d + i < D) row[d + i] = x[i];
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(__nv_bfloat16* row, int d, int D, const float x[4]) {
  if (VEC) {
    if (d < D) {
      __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
      __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
      uint2 t;
      t.x = *reinterpret_cast<uint32_t*>(&a);
      t.y = *reinterpret_cast<uint32_t*>(&b);
      *reinterpret_cast<uint2*>(row + d) = t;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) if (d + i < D) row[d + i] = __float2bfloat16_rn(x[i]);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(__half* row, int d, int D, const float x[4]) {
  if (VEC) {
    if (d < D) {
      __half2 a = __floats2half2_rn(x[0], x[1]);
      __half2 b = __floats2half2_rn(x[2], x[3]);
      uint2 t;
      t.x = *reinterpret_cast<uint32_t*>(&a);
      t.y = *reinterpret_cast<uint32_t*>(&b);
      *reinterpret_cast<uint2*>(row + d) = t;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) if (d + i < D) row[d + i] = __float2half_rn(x[i]);
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace mxflash
