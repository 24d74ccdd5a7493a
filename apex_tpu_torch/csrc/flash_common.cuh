// What the flash-attention kernels share: the Hopper kernels K2 / K17,
// K4 / K18, K13 and K14 (through flash_sm90.cuh), the prologue
// (flash_bwd_prologue.cu) and the generic kernels (flash_simt.cu): the
// NEG_INF of an empty row, the element conversions of the storage types,
// the lane rotation `rot1`; and two host helpers K3 and K16 use too, the
// shared-memory opt-in and the SM count.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace apex_fa {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct Strides {  // in elements; the last dimension has stride 1
  long long b, l, h;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The storage types and fp32: to fp32 exactly, from fp32 to nearest even.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to the storage type T and back (the identity for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float rot1(float x, float xr, float c, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(xr, s));
}

// Set the dynamic shared memory of `kernel` to `bytes` once per device (the
// opt-in above 48 KB); `configured` is the caller's per-kernel bit set.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, size_t bytes,
                               unsigned* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && (*configured & (1u << dev))) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 32) *configured |= 1u << dev;
  return e;
}

// The current device's SM count, read once a device (132 if it cannot be
// read).
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
    counts[dev] = n;
  }
  return counts[dev];
}

}  // namespace apex_fa
