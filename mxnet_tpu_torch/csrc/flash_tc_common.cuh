// What the tensor-core flash-attention kernels (flash_fwd_tc.cu,
// flash_bwd_tc.cu, flash_fwd_tc32.cu, flash_bwd_tc32.cu) share: PTX wrappers for TMA, mbarriers
// and the m64n64k16 wgmma (A and B from shared memory, or A from registers
// with B transposed), 16-bit packing, the fp32 accumulator layout of a
// 64 x 64 tile and its stores, and on the host the 3-D tensor maps and
// argument checks. Tiles are
// 64 rows (q rows or keys) of DP = 64 or 128 16-bit columns, held in shared
// memory in the 128-byte swizzle TMA writes, one 64-column half (8 KB)
// after the other.
#pragma once

#include <cuda.h>

#include <initializer_list>

#include "flash_common.cuh"

namespace mxflash {
namespace tc {

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

// 2^x on the MUFU in one instruction (relative error ~2^-22; 0 for -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// d (+)= A . B, m64n64k16, A from registers (four 16-bit pairs), B MN-major
// in shared memory (transpose flag set). scale_d == 0 overwrites d.
template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int scale_d = 1);
template <>
__device__ __forceinline__ void mma_rs<__half>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " MX_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MX_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void mma_rs<__nv_bfloat16>(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MX_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MX_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
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

// Two adjacent elements of an output, rounded to its type T (fp16, bf16 or
// fp32).
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
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
        store2<T>(out + (size_t)row * D + col, acc[h][i] * mul, acc[h][i + 1] * mul);
    }
}

// L = lse * log2(e) of a backward pass's row, +inf past the last row or where
// lse is -inf (p = 0).
__device__ __forceinline__ float row_L(const float* lse, int row, int T) {
  if (row >= T) return INFINITY;
  const float l = lse[row];
  return l == -INFINITY ? INFINITY : l * LOG2E;
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query so that the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
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

// Make current the context of the device that holds ptr. The tensor maps
// are made by a driver call, which needs a current context, and a thread
// that has made no CUDA runtime call yet has none: autograd's backward
// thread, when a kernel's backward is the first work it does, got
// "invalid argument" from the map's encoding. The runtime calls here bind
// the primary context of ptr's device (and make the launch go there).
inline cudaError_t bind_device(const void* ptr) {
  cudaPointerAttributes a;
  cudaError_t e = cudaPointerGetAttributes(&a, ptr);
  if (e != cudaSuccess) return e;
  return cudaSetDevice(a.device);
}

// The (D, T, BH) map of a contiguous (BH, T, D) 16-bit tensor: 64 x 64 boxes,
// 128-byte swizzle, zero fill out of bounds.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int dtype, int BH, int T, int D) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cudaError_t bound = bind_device(ptr);
  if (bound != cudaSuccess) return bound;
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
inline bool bad_args(int BH, int Tq, int Tk, int D, int dtype) {
  return BH <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 || D % 8 != 0 ||
         (dtype != 1 && dtype != 2);
}

inline bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  return false;
}

}  // namespace tc
}  // namespace mxflash
