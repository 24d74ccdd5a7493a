// What the layer-norm kernels share, K1 (layer_norm_fwd.cu) and K3
// (layer_norm_bwd.cu): the element conversions, rows moved in groups of
// 16 bytes (8 bf16 / fp16 or 4 fp32 elements) with element accesses for a
// misaligned view or a ragged width, and the warp's shuffle sum.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <string.h>

namespace apex_ln {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);  // round to nearest even
}

// 16 bytes as fp32 values: 4 fp32, or 8 bf16 / fp16
__device__ __forceinline__ void unpack16(uint4 r, float* o, float*) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}
template <typename H>
__device__ __forceinline__ void unpack16(uint4 r, float* o, H*) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    H lo, hi;
    const uint16_t a = (uint16_t)(w[q] & 0xffffu);
    const uint16_t b = (uint16_t)(w[q] >> 16);
    memcpy(&lo, &a, 2);
    memcpy(&hi, &b, 2);
    o[2 * q] = to_f(lo);
    o[2 * q + 1] = to_f(hi);
  }
}

// G consecutive elements of type E from p as fp32: 16-byte loads when VEC
// (p 16-byte aligned, all G in range), else element loads masked at
// `valid` (elements past it read as 0).
template <typename E, int G, bool VEC>
__device__ __forceinline__ void load_group(const E* __restrict__ p, int valid,
                                           float (&o)[G]) {
  if constexpr (VEC) {
    constexpr int kPer = 16 / (int)sizeof(E);
    static_assert(G % kPer == 0, "a group is whole 16-byte words");
#pragma unroll
    for (int q = 0; q < G / kPer; ++q)
      unpack16(__ldg(reinterpret_cast<const uint4*>(p) + q), o + q * kPer,
               (E*)nullptr);
  } else {
#pragma unroll
    for (int k = 0; k < G; ++k) o[k] = k < valid ? to_f(p[k]) : 0.f;
  }
}

template <typename T, int G, bool VEC>
__device__ __forceinline__ void store_group(T* __restrict__ p, int valid,
                                            const float (&v)[G]) {
  if constexpr (VEC) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int q = 0; q < G / kPer; ++q) {
      uint4 r;
      T h[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) h[k] = from_f<T>(v[q * kPer + k]);
      memcpy(&r, h, 16);
      reinterpret_cast<uint4*>(p)[q] = r;
    }
  } else {
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (k < valid) p[k] = from_f<T>(v[k]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace apex_ln
