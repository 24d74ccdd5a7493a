// Tile helpers of the fused flash-attention backward for Hopper (sm_90a),
// K4 (flash_attn_bwd.cu, one block per key tile); the Hopper kernels K2 /
// K17, K13 and K14 (flash_sm90.cuh) and the generic kernels
// (flash_simt.cu) share its constants, the element conversions, `rot1` and
// `opt_in_smem`.
//
// K4 stages 64-row tiles of (B, L, H, D) bf16 or fp16 tensors in shared
// memory,
// read through the caller's strides (unit stride over D), rows past L
// zero-filled; q is pre-scaled in its storage dtype on load and q / k are
// rotated on load by the full-width rope tables, exactly as the forward
// kernel does; gradients w.r.t. rotated tensors are inverse-rotated (the
// same lane rotation with the sine negated) in an fp32 staging tile before
// they are written.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace apex_fa {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPadH = 8;  // bf16 row padding (keeps WMMA ldm a multiple of 8)
constexpr int kPadF = 4;  // fp32 row padding (a multiple of 4)

struct Strides {  // in elements; the last dimension has stride 1
  long long b, l, h;
};

// Row pitches of a staged (64, D) tile: bf16 operand rows and fp32 staging
// rows.
template <int D>
struct TileLd {
  static constexpr int h = D + kPadH;
  static constexpr int f = D + kPadF;
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

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Copy a (64, D) tile of a strided bf16 / fp16 tensor into shared memory
// (row pitch TileLd<D>::h), zero past L.  With `do_scale`, each value is
// multiplied by `scale` and rounded back to T (the wrapper's q pre-scale);
// with tables (cos_b / sin_b, this batch's (L, D)), the row is then
// rotated in fp32 and rounded to T.
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride_l, int row0, int L,
                                          bool do_scale, float scale,
                                          const T* cos_b, const T* sin_b) {
  constexpr int kVec = 8;
  constexpr int kHalf = D / 2;
  constexpr int kPerRow = kHalf / kVec;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (row0 + r < L) {
      const long long row = row0 + r;
      lo = *reinterpret_cast<const uint4*>(src + row * stride_l + c);
      hi = *reinterpret_cast<const uint4*>(src + row * stride_l + c + kHalf);
      T* el = reinterpret_cast<T*>(&lo);
      T* eh = reinterpret_cast<T*>(&hi);
      if (do_scale) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          el[j] = from_f32<T>(to_f32(el[j]) * scale);
          eh[j] = from_f32<T>(to_f32(eh[j]) * scale);
        }
      }
      if (cos_b != nullptr) {
        const uint4 cl = *reinterpret_cast<const uint4*>(cos_b + row * D + c);
        const uint4 ch =
            *reinterpret_cast<const uint4*>(cos_b + row * D + c + kHalf);
        const uint4 sl = *reinterpret_cast<const uint4*>(sin_b + row * D + c);
        const uint4 sh =
            *reinterpret_cast<const uint4*>(sin_b + row * D + c + kHalf);
        const T* ecl = reinterpret_cast<const T*>(&cl);
        const T* ech = reinterpret_cast<const T*>(&ch);
        const T* esl = reinterpret_cast<const T*>(&sl);
        const T* esh = reinterpret_cast<const T*>(&sh);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xl = to_f32(el[j]);
          const float xh = to_f32(eh[j]);
          el[j] = from_f32<T>(rot1(xl, xh, to_f32(ecl[j]), to_f32(esl[j])));
          eh[j] = from_f32<T>(rot1(xh, xl, to_f32(ech[j]), to_f32(esh[j])));
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * TileLd<D>::h + c) = lo;
    *reinterpret_cast<uint4*>(dst + r * TileLd<D>::h + c + kHalf) = hi;
  }
}

// Inverse-rotate this warp's 16 fp32 staging rows (row pitch TileLd<D>::f)
// in place (the rows' tables; the same lane rotation with the sine
// negated).  Rows at or past L are left as they are.
template <int D, typename T>
__device__ __forceinline__ void unrotate_rows(float* stage, int wrow,
                                              int row0, int L,
                                              const T* cos_b,
                                              const T* sin_b) {
  constexpr int kHalf = D / 2;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < 16; ++r) {
    const int pos = row0 + wrow + r;
    if (pos >= L) break;
    float* row = stage + (wrow + r) * TileLd<D>::f;
    const T* cr = cos_b + (long long)pos * D;
    const T* sr = sin_b + (long long)pos * D;
    for (int c = lane; c < kHalf; c += 32) {
      const float lo = row[c], hi = row[c + kHalf];
      row[c] = rot1(lo, hi, to_f32(cr[c]), -to_f32(sr[c]));
      row[c + kHalf] =
          rot1(hi, lo, to_f32(cr[c + kHalf]), -to_f32(sr[c + kHalf]));
    }
  }
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

}  // namespace apex_fa
