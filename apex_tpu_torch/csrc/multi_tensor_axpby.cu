// out = a * x + b * y over a tree of tensors, for Hopper (sm_90a), with a
// plain C interface: gradient accumulation and the unscale onto stashed
// gradients.
//
// Replaces: apex_tpu/ops/pallas/multi_tensor_kernels.py, `packed_axpby` and
// its kernel `_axpby_kernel` (the Pallas form of
// csrc/multi_tensor_axpby_kernel.cu).
//
// Computes, per element of every leaf of the chunk table in
// chunk_table.cuh, out = float(x) * a + float(y) * b in fp32 and cast to
// out's dtype; x, y and out are each float32 or bfloat16, and out may be
// the very storage of x or of y (in place: every element is read and then
// written by the same thread).  a and b are fp32 scalars in device memory,
// so a moving loss scale needs no host sync.  Each product and the sum are
// rounded on their own (no fused multiply-add), so the kernel equals the
// plain PyTorch version and the JAX jnp path bit for bit.  The int32 flag
// is set to 1 when a value of x (arg_to_check 0), of y (1) or of either
// (-1) is not finite: the policy of the reference's kernel.
//
// What bounds it on the H100: bytes.  For the accumulation (bf16 x, fp32 y
// and out) 10 B an element against 3 flops.
//
// Design: one block (256 threads) per chunk of the table, so one launch
// covers the whole tree with no packing copy; 16-byte loads (8-byte for
// bf16) where a leaf's three pointers allow it, a scalar tail otherwise.
// Each thread keeps a "saw a non-finite value" bit; one warp vote comes
// before one plain store of 1 to the flag (every writer writes the same
// value, so there is no read-modify-write race), as the amp unscale does.

#include "chunk_table.cuh"

namespace {

using namespace apex_mt;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float axpby_one(float x, float y, float a,
                                           float b) {
  return __fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

template <typename X, typename Y, typename O>
__global__ void __launch_bounds__(kThreads)
axpby_kernel(ChunkTable t, const long long* __restrict__ x_row,
             const long long* __restrict__ y_row,
             const long long* __restrict__ out_row,
             const float* __restrict__ a_ptr,
             const float* __restrict__ b_ptr, int* __restrict__ flag,
             int check_x, int check_y) {
  const ChunkSpan s = span_of(t, blockIdx.x);
  // no __restrict__: out may alias x or y
  const X* x = leaf_ptr<const X>(x_row, s);
  const Y* y = leaf_ptr<const Y>(y_row, s);
  O* out = leaf_ptr<O>(out_row, s);
  const float a = *a_ptr, b = *b_ptr;
  bool bad = false;
  int done = 0;
  if (aligned4(x) && aligned4(y) && aligned4(out)) {
    const int n4 = s.len / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 xx = load4(x + 4 * i), yy = load4(y + 4 * i);
      if (check_x)
        bad |= !(isfinite(xx.x) && isfinite(xx.y) && isfinite(xx.z) &&
                 isfinite(xx.w));
      if (check_y)
        bad |= !(isfinite(yy.x) && isfinite(yy.y) && isfinite(yy.z) &&
                 isfinite(yy.w));
      store4(out + 4 * i,
             make_float4(axpby_one(xx.x, yy.x, a, b),
                         axpby_one(xx.y, yy.y, a, b),
                         axpby_one(xx.z, yy.z, a, b),
                         axpby_one(xx.w, yy.w, a, b)));
    }
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < s.len; i += blockDim.x) {
    const float xx = to_f32(x[i]), yy = to_f32(y[i]);
    if (check_x) bad |= !isfinite(xx);
    if (check_y) bad |= !isfinite(yy);
    out[i] = from_f32<O>(axpby_one(xx, yy, a, b));
  }
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0) *flag = 1;
}

template <typename X, typename Y>
int launch_out(int out_dtype, dim3 grid, cudaStream_t st, const ChunkTable& t,
               const long long* xr, const long long* yr,
               const long long* outr, const float* a, const float* b,
               int* flag, int cx, int cy) {
  if (out_dtype == 0)
    axpby_kernel<X, Y, float><<<grid, kThreads, 0, st>>>(t, xr, yr, outr, a,
                                                         b, flag, cx, cy);
  else if (out_dtype == 1)
    axpby_kernel<X, Y, bf16><<<grid, kThreads, 0, st>>>(t, xr, yr, outr, a,
                                                        b, flag, cx, cy);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename X>
int launch_y(int y_dtype, int out_dtype, dim3 grid, cudaStream_t st,
             const ChunkTable& t, const long long* xr, const long long* yr,
             const long long* outr, const float* a, const float* b,
             int* flag, int cx, int cy) {
  if (y_dtype == 0)
    return launch_out<X, float>(out_dtype, grid, st, t, xr, yr, outr, a, b,
                                flag, cx, cy);
  if (y_dtype == 1)
    return launch_out<X, bf16>(out_dtype, grid, st, t, xr, yr, outr, a, b,
                               flag, cx, cy);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The chunk table (chunk_leaf int32, chunk_start int64, leaf_numel int64;
// n_chunks chunks of at most `chunk` elements).  Rows of int64 leaf base
// pointers: x (x_dtype 0 = float32, 1 = bfloat16), y (y_dtype), out
// (out_dtype; may equal x's or y's row).  a, b: one float32 each and flag:
// one int32, in device memory.  arg_to_check: 0 = x, 1 = y, -1 = both.
// Returns the cudaError_t of the launch.
extern "C" int apex_multi_tensor_axpby(
    const void* chunk_leaf, const void* chunk_start, const void* leaf_numel,
    int n_chunks, int chunk, const void* x_row, const void* y_row,
    const void* out_row, const void* a, const void* b, void* flag,
    int arg_to_check, int x_dtype, int y_dtype, int out_dtype,
    void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (arg_to_check < -1 || arg_to_check > 1) return (int)cudaErrorInvalidValue;
  const ChunkTable t{static_cast<const int*>(chunk_leaf),
                     static_cast<const long long*>(chunk_start),
                     static_cast<const long long*>(leaf_numel), chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using LL = const long long*;
  const LL xr = static_cast<LL>(x_row), yr = static_cast<LL>(y_row),
           outr = static_cast<LL>(out_row);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  int* fl = static_cast<int*>(flag);
  const int cx = arg_to_check != 1, cy = arg_to_check != 0;
  const dim3 grid(n_chunks);
  int err;
  if (x_dtype == 0)
    err = launch_y<float>(y_dtype, out_dtype, grid, st, t, xr, yr, outr, ap,
                          bp, fl, cx, cy);
  else if (x_dtype == 1)
    err = launch_y<bf16>(y_dtype, out_dtype, grid, st, t, xr, yr, outr, ap,
                         bp, fl, cx, cy);
  else
    err = (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
