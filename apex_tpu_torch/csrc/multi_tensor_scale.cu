// Scale with a non-finite check, for Hopper (sm_90a), with a plain C
// interface: the amp unscale.
//
// Replaces: apex_tpu/ops/pallas/multi_tensor_kernels.py, `packed_scale` and
// its kernel `_scale_kernel` (the Pallas form of
// csrc/multi_tensor_scale_kernel.cu).
//
// Computes out = (float(x) * scale) cast to out's dtype, over one flat leaf,
// and stores 1 into a shared int32 device flag if any input value is not
// finite (the check reads the input, so a gradient that overflowed to inf
// in bf16 is always seen).  `scale` is read from device memory, so a moving
// loss scale needs no host sync; the flag is a plain store of 1 (every
// writer writes the same value, so there is no read-modify-write race), and
// many leaves can share one flag.  out may be x itself (in place, same
// dtype): every element is read and then written by the same thread.
//
// What bounds it on the H100: bytes (2 B in and 4 B out per element for the
// bf16 gradients of the train step), one flop per element.
//
// Design: a grid-stride loop (neighbouring threads on neighbouring
// elements), a per-thread "saw a non-finite value" bit, and one warp vote
// before the single store.  One launch per leaf into the same flag.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

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
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);  // round to nearest even
}

template <typename In, typename Out>
__global__ void __launch_bounds__(256)
scale_kernel(const In* x, Out* out,  // may alias: in place
             const float* __restrict__ scale, int* __restrict__ flag,
             long long n) {
  const float s = *scale;
  const long long stride = (long long)gridDim.x * blockDim.x;
  bool bad = false;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = to_f(x[i]);
    bad |= !isfinite(v);
    out[i] = from_f<Out>(__fmul_rn(v, s));
  }
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0) *flag = 1;
}

template <typename In, typename Out>
void launch(const void* x, void* out, const float* scale, int* flag,
            long long n, cudaStream_t stream) {
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  scale_kernel<In, Out><<<blocks, threads, 0, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), scale, flag, n);
}

}  // namespace

// x: n elements of in_dtype; out: n elements of out_dtype (0 = float32,
// 1 = bfloat16, 2 = float16).  scale: one float32 and flag: one int32, both
// in device memory.  Returns the cudaError_t of the launch.
extern "C" int apex_multi_tensor_scale(const void* x, void* out,
                                       const void* scale, void* flag,
                                       long long n, int in_dtype,
                                       int out_dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  int* fl = static_cast<int*>(flag);
  if (in_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(x, out, sc, fl, n, s);
  else if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(x, out, sc, fl, n, s);
  else if (in_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, out, sc, fl, n, s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(x, out, sc, fl, n, s);
  else if (in_dtype == 2 && out_dtype == 0)
    launch<__half, float>(x, out, sc, fl, n, s);
  else if (in_dtype == 2 && out_dtype == 2)
    launch<__half, __half>(x, out, sc, fl, n, s);
  else if (in_dtype == 0 && out_dtype == 2)
    launch<float, __half>(x, out, sc, fl, n, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
