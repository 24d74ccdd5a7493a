// Layer-norm forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/layer_norm_kernels.py, `_forward` and its
// kernel `_fwd_kernel` (the Pallas forward of FusedLayerNorm).
//
// Computes, per row of x (n1, n2): fp32 mean, the centred two-pass
// variance, inv = rsqrt(var + eps), y = (x - mean) * inv * w + b in fp32,
// stored in x's dtype; also stores mean and inv (n1,) fp32 for a backward.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once and costs about ten flops, far below the ~295 flops per byte where the
// tensor cores would become the limit, so the floor is (2 * n1 * n2 * itemsize
// + 8 * n1) bytes over 3.35 TB/s.
//
// Design: one warp per row, four rows per 128-thread block.  The TPU kernel
// streamed large row blocks through VMEM; here the row lives in registers
// (VPL values per lane, column lane + 32 * i so that a warp's loads are
// coalesced), the two reductions are warp shuffles, and x is read from
// device memory exactly once.  Rows wider than 32 * 32 take the loop
// variant, which re-reads the row from L1/L2 for its second and third pass.
// Every width works: the ragged tail of a row is masked per element.  Rows
// are independent, so nothing of the TPU's sequential grid carries over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row held in registers: n2 <= 32 * VPL.
template <typename T, typename W, int VPL>
__global__ void __launch_bounds__(32 * kWarps)
ln_fwd_reg(const T* __restrict__ x, const W* __restrict__ w,
           const W* __restrict__ b, T* __restrict__ y,
           float* __restrict__ mean_out, float* __restrict__ inv_out,
           int n1, int n2, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n1) return;
  const T* xr = x + (size_t)row * n2;
  float v[VPL];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < n2 ? to_f(xr[c]) : 0.f;
    s += v[i];
  }
  const float mean = warp_sum(s) / (float)n2;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const float d = c < n2 ? v[i] - mean : 0.f;
    ss += d * d;
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)n2 + eps);
  T* yr = y + (size_t)row * n2;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < n2) {
      float o = (v[i] - mean) * inv;
      if (w != nullptr) o *= to_f(w[c]);
      if (b != nullptr) o += to_f(b[c]);
      yr[c] = from_f<T>(o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }
}

// Any width: three passes over the row, the later two from cache.
template <typename T, typename W>
__global__ void __launch_bounds__(32 * kWarps)
ln_fwd_loop(const T* __restrict__ x, const W* __restrict__ w,
            const W* __restrict__ b, T* __restrict__ y,
            float* __restrict__ mean_out, float* __restrict__ inv_out,
            int n1, int n2, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n1) return;
  const T* xr = x + (size_t)row * n2;
  float s = 0.f;
  for (int c = lane; c < n2; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / (float)n2;
  float ss = 0.f;
  for (int c = lane; c < n2; c += 32) {
    const float d = to_f(xr[c]) - mean;
    ss += d * d;
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)n2 + eps);
  T* yr = y + (size_t)row * n2;
  for (int c = lane; c < n2; c += 32) {
    float o = (to_f(xr[c]) - mean) * inv;
    if (w != nullptr) o *= to_f(w[c]);
    if (b != nullptr) o += to_f(b[c]);
    yr[c] = from_f<T>(o);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, const void* b, void* y,
            float* mean, float* inv, int n1, int n2, float eps,
            cudaStream_t stream) {
  const dim3 grid((n1 + kWarps - 1) / kWarps), block(32 * kWarps);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* yp = static_cast<T*>(y);
  const int vpl = (n2 + 31) / 32;
#define APEX_LN_REG(N)                                                  \
  ln_fwd_reg<T, W, N><<<grid, block, 0, stream>>>(xp, wp, bp, yp, mean, \
                                                   inv, n1, n2, eps)
  if (vpl <= 2) APEX_LN_REG(2);
  else if (vpl <= 4) APEX_LN_REG(4);
  else if (vpl <= 8) APEX_LN_REG(8);
  else if (vpl <= 16) APEX_LN_REG(16);
  else if (vpl <= 24) APEX_LN_REG(24);
  else if (vpl <= 32) APEX_LN_REG(32);
  else
    ln_fwd_loop<T, W><<<grid, block, 0, stream>>>(xp, wp, bp, yp, mean, inv,
                                                  n1, n2, eps);
#undef APEX_LN_REG
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  w and b may be null
// (no affine); when given they are float32 or x's dtype (w_dtype).  Returns
// the
// cudaError_t of the launch.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* y, void* mean,
                                   void* inv, int n1, int n2, float eps,
                                   int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* iv = static_cast<float*>(inv);
  if (n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0) {
    launch<float, float>(x, w, b, y, m, iv, n1, n2, eps, s);
  } else if (x_dtype == 1 && w_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, m, iv, n1, n2, eps, s);
  } else if (x_dtype == 1 && w_dtype == 0) {
    launch<__nv_bfloat16, float>(x, w, b, y, m, iv, n1, n2, eps, s);
  } else if (x_dtype == 2 && w_dtype == 2) {
    launch<__half, __half>(x, w, b, y, m, iv, n1, n2, eps, s);
  } else if (x_dtype == 2 && w_dtype == 0) {
    launch<__half, float>(x, w, b, y, m, iv, n1, n2, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
