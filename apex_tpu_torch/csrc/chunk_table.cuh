// The chunk table shared by the multi-tensor kernels (K7 lamb_stage1, K8
// lamb_stage2, K9 multi_tensor_sumsq), for Hopper (sm_90a).
//
// A tree of leaves (tensors of any size) is cut into chunks of at most
// `chunk` elements; every chunk lies inside one leaf.  The table lives in
// device memory (apex_tpu_torch/ops/multi_tensor.py builds it once per
// optimizer): per chunk its leaf and its first element in that leaf, per
// leaf its element count and its first chunk.  A list of tensors (the
// parameters, the gradients, m, v, ...) is one int64 row of leaf base
// pointers.  One block takes one chunk, so a kernel is one launch over
// the whole tree, with no packing copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace apex_mt {

constexpr int kThreads = 256;

struct ChunkTable {
  const int* chunk_leaf;         // leaf of each chunk
  const long long* chunk_start;  // first element of each chunk in its leaf
  const long long* leaf_numel;   // elements of each leaf
  int chunk;                     // elements of a full chunk
};

// elements [start, start + len) of leaf `leaf`
struct ChunkSpan {
  int leaf;
  long long start;
  int len;
};

__device__ __forceinline__ ChunkSpan span_of(const ChunkTable& t, int c) {
  ChunkSpan s;
  s.leaf = t.chunk_leaf[c];
  s.start = t.chunk_start[c];
  const long long left = t.leaf_numel[s.leaf] - s.start;
  s.len = (int)(left < t.chunk ? left : t.chunk);
  return s;
}

template <typename T>
__device__ __forceinline__ T* leaf_ptr(const long long* row,
                                       const ChunkSpan& s) {
  return reinterpret_cast<T*>(row[s.leaf]) + s.start;
}

// whether four elements from p on can be moved by one vector access
template <typename T>
__device__ __forceinline__ bool aligned4(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive elements as fp32: one 16-byte (fp32) or 8-byte (bf16)
// access
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &r.x, 4);
  memcpy(&hi, &r.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 r;
  memcpy(&r.x, &lo, 4);
  memcpy(&r.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = r;
}

// Two sums over the block in one fixed order (a shuffle tree in each warp,
// then warp 0 over the warp sums), so two runs give equal bits.  The
// result is valid in thread 0.  `smem` holds kThreads / 32 entries.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* smem) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane] : make_float2(0.f, 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_down_sync(0xffffffffu, v.x, o);
      v.y += __shfl_down_sync(0xffffffffu, v.y, o);
    }
  }
  __syncthreads();
  return v;
}

}  // namespace apex_mt
