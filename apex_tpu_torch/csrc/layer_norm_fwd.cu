// Layer-norm forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/layer_norm_kernels.py, `_forward` and its
// kernel `_fwd_kernel` (the Pallas forward of FusedLayerNorm).
//
// Computes, per row of x (n1, n2): fp32 mean, the centred two-pass
// variance, inv = rsqrt(var + eps), y = (x - mean) * inv * w + b in fp32,
// stored in x's dtype; also stores mean and inv (n1,) fp32 for a backward,
// unless the caller passes no stats buffer (a forward nobody
// differentiates), which skips only those two stores.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once and costs about ten flops, far below the ~295 flops per byte where the
// tensor cores would become the limit, so the floor is (2 * n1 * n2 * itemsize
// + 8 * n1) bytes over 3.35 TB/s.  At decode (a few rows) nothing is
// bound by the card: the call's host path and one trip to device memory are
// the whole cost.
//
// Design.  The TPU kernel streamed large row blocks through VMEM; here a
// row lives in registers as groups of V = 16 / sizeof(T) consecutive
// elements (8 bf16 / fp16, 4 fp32), each group one 16-byte load and one
// 16-byte store where the row and n2 allow it (`VEC`), else V element
// accesses masked at n2 (a view at an odd offset, a ragged width).  x is
// read from device memory once.  Python picks one of three routes
// (`ln_fwd_route` in ops/cuda/layer_norm.py):
//   warp   training's many rows: one warp a row, four rows a block, the
//          lane's groups lane + 32 i, both sums warp shuffles;
//   block  decode's and prefill's few rows: one row a block of up to 1024
//          threads, one or two groups a thread, the sums through shared
//          memory, so every SM that can take a row gets one;
//   loop   rows too wide for the warp's registers: one warp a row, three
//          passes, the later two from L1 / L2.
// Every sum runs in one fixed order (per thread in group order, then a
// shuffle tree, then the warps in index order), so two runs give equal bits.
// Rows are independent, so nothing of the TPU's sequential grid carries over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "layer_norm_common.cuh"

namespace {

using namespace apex_ln;

constexpr int kWarps = 4;          // warp route: rows a block
constexpr int kMaxGroupsWarp = 8;  // warp route: groups a lane
constexpr int kMaxThreads = 1024;  // block route
constexpr int kMaxGroupsBlock = 2; // block route: groups a thread

// The sum over the block, in every thread: each warp's shuffle tree, then
// the warp sums in warp order.  `red` holds 32 floats and is used by one
// sum only (two sums take two buffers, so one barrier each suffices).
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int nw = (int)(blockDim.x >> 5);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nw; ++i) s += red[i];
  return s;
}

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  float* mean;  // null: no stats stores (inv is null too)
  float* inv;
  int n1;
  int n2;
  float eps;
};

// y for one group from its centred values
template <typename W, int V, bool VEC>
__device__ __forceinline__ void affine(const W* w, const W* b, int c,
                                       int valid, float mean, float inv,
                                       float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = (v[k] - mean) * inv;
  if (w != nullptr) {
    float wv[V], bv[V];
    load_group<W, V, VEC>(w + c, valid, wv);
    load_group<W, V, VEC>(b + c, valid, bv);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = v[k] * wv[k] + bv[k];
  }
}

// Warp route: one warp a row, the row's groups in the lane's registers.
template <typename T, typename W, int NG, bool VEC>
__global__ void __launch_bounds__(32 * kWarps) ln_fwd_warp(Args a) {
  constexpr int V = 16 / (int)sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.n1) return;
  const int n2 = a.n2;
  const T* xr = static_cast<const T*>(a.x) + (size_t)row * n2;
  float v[NG][V];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = (lane + 32 * i) * V;
    if (c < n2) {
      load_group<T, V, VEC>(xr + c, n2 - c, v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[i][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) s += v[i][k];
  }
  const float mean = warp_sum(s) / (float)n2;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = (lane + 32 * i) * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = c + k < n2 ? v[i][k] - mean : 0.f;
      ss += d * d;
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)n2 + a.eps);
  const W* w = static_cast<const W*>(a.w);
  const W* b = static_cast<const W*>(a.b);
  T* yr = static_cast<T*>(a.y) + (size_t)row * n2;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = (lane + 32 * i) * V;
    if (c < n2) {
      affine<W, V, VEC>(w, b, c, n2 - c, mean, inv, v[i]);
      store_group<T, V, VEC>(yr + c, n2 - c, v[i]);
    }
  }
  if (lane == 0 && a.mean != nullptr) {
    a.mean[row] = mean;
    a.inv[row] = inv;
  }
}

// Block route: one row a block, NG groups a thread (group t + blockDim i).
template <typename T, typename W, int NG, bool VEC>
__global__ void __launch_bounds__(kMaxThreads) ln_fwd_block(Args a) {
  constexpr int V = 16 / (int)sizeof(T);
  __shared__ float red[2][32];
  const int row = blockIdx.x;
  const int n2 = a.n2;
  const T* xr = static_cast<const T*>(a.x) + (size_t)row * n2;
  float v[NG][V];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = (threadIdx.x + blockDim.x * i) * V;
    if (c < n2) {
      load_group<T, V, VEC>(xr + c, n2 - c, v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[i][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) s += v[i][k];
  }
  const float mean = block_sum(s, red[0]) / (float)n2;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = (threadIdx.x + blockDim.x * i) * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = c + k < n2 ? v[i][k] - mean : 0.f;
      ss += d * d;
    }
  }
  const float inv = rsqrtf(block_sum(ss, red[1]) / (float)n2 + a.eps);
  const W* w = static_cast<const W*>(a.w);
  const W* b = static_cast<const W*>(a.b);
  T* yr = static_cast<T*>(a.y) + (size_t)row * n2;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = (threadIdx.x + blockDim.x * i) * V;
    if (c < n2) {
      affine<W, V, VEC>(w, b, c, n2 - c, mean, inv, v[i]);
      store_group<T, V, VEC>(yr + c, n2 - c, v[i]);
    }
  }
  if (threadIdx.x == 0 && a.mean != nullptr) {
    a.mean[row] = mean;
    a.inv[row] = inv;
  }
}

// Loop route: any width, one warp a row, three passes over the row (the
// later two from cache), the same group layout as the warp route.
template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(32 * kWarps) ln_fwd_loop(Args a) {
  constexpr int V = 16 / (int)sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.n1) return;
  const int n2 = a.n2;
  const T* xr = static_cast<const T*>(a.x) + (size_t)row * n2;
  float s = 0.f;
  for (int c = lane * V; c < n2; c += 32 * V) {
    float v[V];
    load_group<T, V, VEC>(xr + c, n2 - c, v);
#pragma unroll
    for (int k = 0; k < V; ++k) s += v[k];
  }
  const float mean = warp_sum(s) / (float)n2;
  float ss = 0.f;
  for (int c = lane * V; c < n2; c += 32 * V) {
    float v[V];
    load_group<T, V, VEC>(xr + c, n2 - c, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = c + k < n2 ? v[k] - mean : 0.f;
      ss += d * d;
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)n2 + a.eps);
  const W* w = static_cast<const W*>(a.w);
  const W* b = static_cast<const W*>(a.b);
  T* yr = static_cast<T*>(a.y) + (size_t)row * n2;
  for (int c = lane * V; c < n2; c += 32 * V) {
    float v[V];
    load_group<T, V, VEC>(xr + c, n2 - c, v);
    affine<W, V, VEC>(w, b, c, n2 - c, mean, inv, v);
    store_group<T, V, VEC>(yr + c, n2 - c, v);
  }
  if (lane == 0 && a.mean != nullptr) {
    a.mean[row] = mean;
    a.inv[row] = inv;
  }
}

// route codes, as ops/cuda/layer_norm.py numbers them
constexpr int kRouteWarp = 0, kRouteBlock = 1, kRouteLoop = 2;

// cudaLaunchKernel itself, not <<< >>> and cudaGetLastError: the
// decode call is host-bound, and this is its cheapest launch
int go(const void* kernel, dim3 grid, dim3 block, const Args& a,
       cudaStream_t stream) {
  void* args[] = {const_cast<Args*>(&a)};
  return (int)cudaLaunchKernel(kernel, grid, block, args, 0, stream);
}

template <typename T, typename W, bool VEC>
int launch(const Args& a, int route, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  const int groups = (a.n2 + V - 1) / V;
  if (route == kRouteBlock) {
    if (groups > kMaxThreads * kMaxGroupsBlock)
      return (int)cudaErrorInvalidValue;
    const int ng = groups <= kMaxThreads ? 1 : 2;
    const int threads = ((groups + ng - 1) / ng + 31) / 32 * 32;
    return go(ng == 1 ? (const void*)ln_fwd_block<T, W, 1, VEC>
                      : (const void*)ln_fwd_block<T, W, 2, VEC>,
              dim3(a.n1), dim3(threads), a, stream);
  }
  const dim3 grid((a.n1 + kWarps - 1) / kWarps), block(32 * kWarps);
  if (route == kRouteLoop)
    return go((const void*)ln_fwd_loop<T, W, VEC>, grid, block, a, stream);
  if (route != kRouteWarp || groups > 32 * kMaxGroupsWarp)
    return (int)cudaErrorInvalidValue;
  const int per_lane = (groups + 31) / 32;
  const void* k =
      per_lane <= 1   ? (const void*)ln_fwd_warp<T, W, 1, VEC>
      : per_lane <= 2 ? (const void*)ln_fwd_warp<T, W, 2, VEC>
      : per_lane <= 3 ? (const void*)ln_fwd_warp<T, W, 3, VEC>
      : per_lane <= 4 ? (const void*)ln_fwd_warp<T, W, 4, VEC>
      : per_lane <= 6 ? (const void*)ln_fwd_warp<T, W, 6, VEC>
                      : (const void*)ln_fwd_warp<T, W, 8, VEC>;
  return go(k, grid, block, a, stream);
}

template <typename T, typename W>
int launch_vec(const Args& a, int route, bool vec, cudaStream_t stream) {
  return vec ? launch<T, W, true>(a, route, stream)
             : launch<T, W, false>(a, route, stream);
}

}  // namespace

// mode, one int: x's dtype (bits 0-1: 0 = float32, 1 = bfloat16,
// 2 = float16), w's (bits 2-3: float32 or x's), the route (bits 4-5: 0 warp,
// 1 block, 2 loop) and bit 6: 16-byte accesses (the caller checked that
// x, w, b are 16-byte aligned and n2 a multiple of 16 / itemsize).  w and b
// may be null (no affine).  mean and inv: n1 floats each, or both null (no
// statistics stored).  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a route the row does not fit).
extern "C" int apex_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* y, void* mean,
                                   void* inv, int n1, int n2, float eps,
                                   int mode, void* stream) {
  if (n1 <= 0 || n2 <= 0 || (mean == nullptr) != (inv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, w, b, y, static_cast<float*>(mean),
               static_cast<float*>(inv), n1, n2, eps};
  const int x_dtype = mode & 3, w_dtype = (mode >> 2) & 3;
  const int route = (mode >> 4) & 3;
  const bool vec = (mode >> 6) & 1;
  if (x_dtype == 0 && w_dtype == 0)
    return launch_vec<float, float>(a, route, vec, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(a, route, vec, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(a, route, vec, s);
  if (x_dtype == 2 && w_dtype == 2)
    return launch_vec<__half, __half>(a, route, vec, s);
  if (x_dtype == 2 && w_dtype == 0)
    return launch_vec<__half, float>(a, route, vec, s);
  return (int)cudaErrorInvalidValue;
}
