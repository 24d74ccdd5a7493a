// K6, scale with a non-finite check over a tree of tensors, for Hopper
// (sm_90a), with a plain C interface: the amp unscale.
//
// Replaces: apex_tpu/ops/pallas/multi_tensor_kernels.py, `packed_scale` and
// its kernel `_scale_kernel` (the Pallas form of
// csrc/multi_tensor_scale_kernel.cu).
//
// Computes, for every leaf i, out[i] = (float(x[i]) * scale) cast to
// out[i]'s dtype (one __fmul_rn, so the bits are the plain version's), and
// stores 1 into one int32 device flag if any input value is not finite (the
// check reads the input, so a gradient that overflowed to inf in bf16 is
// always seen).  `scale` is read from device memory, so a moving loss scale
// needs no host sync; the flag is a plain store of 1 (every writer writes
// the same value, so there is no read-modify-write race).  out[i] may be
// x[i] itself (in place): every element is read and then written by the
// same thread.
//
// What bounds it on the H100: bytes (2 B in and 4 B out per element for the
// bf16 gradients of an O2 step, 4 B and 4 B in place in fp32), one flop per
// element.
//
// Design: the TPU version packs each dtype group into one flat buffer and
// walks it; here the chunk table of chunk_table.cuh says where every chunk of
// every leaf lies, so ONE launch reads and writes the leaves in place
// through two pointer rows (inputs, outputs), one 256-thread block a chunk.
// Each leaf carries its own in / out dtype code, so a list that mixes bf16
// and fp32 leaves (ResNet's O2 gradients) is still one launch.  Groups of 4
// elements move as one vector access a side (16 bytes of fp32, 8 of bf16 /
// fp16: a warp's access is one contiguous 256- or 512-byte span) where the
// chunk's input and output start on a group boundary, eight groups a thread
// in flight; element accesses take the rest and each leaf's ragged tail.
// (8-element groups, one 16-byte access of bf16 but two of fp32 a thread,
// ran slower on the card: each fp32 access a half-filled 1 KB span.)  Each
// warp votes once; a warp that saw a non-finite value stores 1 into the
// flag.

#include "chunk_table.cuh"

namespace {

using namespace apex_mt;

constexpr int kBatch = 8;  // 4-element groups a thread loads before it stores

// one chunk of one leaf, In -> Out; returns whether a value was not finite
template <typename In, typename Out>
__device__ __forceinline__ bool scale_chunk(const In* x, Out* out, int len,
                                            float s) {
  bool bad = false;
  int done = 0;
  if (aligned4(x) && aligned4(out)) {
    const int groups = len / 4;
    // kBatch groups a thread in flight: all loads, then all stores (each
    // thread's groups are its own, so this holds in place too)
    for (int g0 = threadIdx.x; g0 < groups; g0 += kBatch * kThreads) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u * kThreads;
        if (g < groups) v[u] = load4(x + 4 * g);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u * kThreads;
        if (g < groups) {
          float4 a = v[u];
          bad |= !isfinite(a.x) | !isfinite(a.y) | !isfinite(a.z) |
                 !isfinite(a.w);
          a.x = __fmul_rn(a.x, s);
          a.y = __fmul_rn(a.y, s);
          a.z = __fmul_rn(a.z, s);
          a.w = __fmul_rn(a.w, s);
          store4(out + 4 * g, a);
        }
      }
    }
    done = groups * 4;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    const float v = to_f32(x[i]);
    bad |= !isfinite(v);
    out[i] = from_f32<Out>(__fmul_rn(v, s));
  }
  return bad;
}

template <typename In>
__device__ __forceinline__ bool scale_to(const unsigned char* x,
                                         unsigned char* out, int out_code,
                                         int len, float s) {
  const In* xi = reinterpret_cast<const In*>(x);
  if (out_code == 0)
    return scale_chunk(xi, reinterpret_cast<float*>(out), len, s);
  if (out_code == 1)
    return scale_chunk(xi, reinterpret_cast<__nv_bfloat16*>(out), len, s);
  return scale_chunk(xi, reinterpret_cast<__half*>(out), len, s);
}

__device__ __forceinline__ int elem_size(int code) {
  return code == 0 ? 4 : 2;
}

// leaf_codes: per leaf, in dtype + 3 * out dtype (0 = float32,
// 1 = bfloat16, 2 = float16)
__global__ void __launch_bounds__(kThreads)
scale_kernel(ChunkTable t, const long long* __restrict__ in_row,
             const long long* __restrict__ out_row,
             const int* __restrict__ leaf_codes,
             const float* __restrict__ scale, int* __restrict__ flag) {
  const ChunkSpan sp = span_of(t, blockIdx.x);
  const int code = leaf_codes[sp.leaf];
  const int in_code = code % 3, out_code = code / 3;
  // in place is allowed: no __restrict__ between x and out
  const unsigned char* x = reinterpret_cast<const unsigned char*>(
      in_row[sp.leaf]) + sp.start * elem_size(in_code);
  unsigned char* out = reinterpret_cast<unsigned char*>(out_row[sp.leaf]) +
                       sp.start * elem_size(out_code);
  const float s = *scale;
  bool bad;
  if (in_code == 0)
    bad = scale_to<float>(x, out, out_code, sp.len, s);
  else if (in_code == 1)
    bad = scale_to<__nv_bfloat16>(x, out, out_code, sp.len, s);
  else
    bad = scale_to<__half>(x, out, out_code, sp.len, s);
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0) *flag = 1;
}

}  // namespace

// The chunk table (chunk_leaf int32, chunk_start int64, leaf_numel int64,
// n_chunks chunks of at most `chunk` elements); in_row / out_row: int64
// base pointers of the inputs and the outputs (a leaf's output may be its
// input); leaf_codes: int32 per leaf, in dtype + 3 * out dtype (0 =
// float32, 1 = bfloat16, 2 = float16).  scale: one float32 and flag: one
// int32, both in device memory; the flag is set to 1 when an input value is
// not finite and otherwise left as it was.  Returns the cudaError_t of the
// launch.
extern "C" int apex_multi_tensor_scale(const void* chunk_leaf,
                                       const void* chunk_start,
                                       const void* leaf_numel, int n_chunks,
                                       int chunk, const void* in_row,
                                       const void* out_row,
                                       const void* leaf_codes,
                                       const void* scale, void* flag,
                                       void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const ChunkTable t{static_cast<const int*>(chunk_leaf),
                     static_cast<const long long*>(chunk_start),
                     static_cast<const long long*>(leaf_numel), chunk};
  scale_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const long long*>(in_row),
      static_cast<const long long*>(out_row),
      static_cast<const int*>(leaf_codes), static_cast<const float*>(scale),
      static_cast<int*>(flag));
  return (int)cudaGetLastError();
}
