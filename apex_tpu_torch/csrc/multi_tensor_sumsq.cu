// Total sum of squares over a tree of tensors, for Hopper (sm_90a), with a
// plain C interface: the global gradient norm of the LAMB clip.
//
// Replaces: apex_tpu/ops/pallas/multi_tensor_kernels.py, `packed_sumsq`
// and its kernel `_sumsq_kernel` (the Pallas form of
// csrc/multi_tensor_l2norm_kernel.cu).
//
// Computes out[0] = sum over every element x of every leaf of float(x)^2,
// in fp32, over the chunk table of chunk_table.cuh (leaves read in place
// through a row of base pointers; no packed buffer).
//
// What bounds it on the H100: bytes (4 B an fp32 element read, 2 B a bf16
// one; two flops an element).
//
// Design: the TPU sums in grid order with an SMEM accumulator; Hopper's
// blocks run in no order, and float atomics would make the sum change from
// run to run.  So two stages in one launch: each block (one chunk) sums
// its elements with 16-byte loads and a fixed-order block reduction and
// writes one fp32 partial; the block that finishes last (told by an
// integer ticket, never by a float atomic) sums the partials in a fixed
// order and resets the ticket.  Two runs give equal bits, and the result
// stays on the device.

#include "chunk_table.cuh"

namespace {

using namespace apex_mt;

template <typename T>
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(ChunkTable t, const long long* __restrict__ row, int n_chunks,
             float* __restrict__ partials, unsigned* __restrict__ ticket,
             float* __restrict__ out) {
  __shared__ float2 red[kThreads / 32];
  __shared__ bool last;
  const ChunkSpan s = span_of(t, blockIdx.x);
  const T* x = leaf_ptr<const T>(row, s);
  float acc = 0.f;
  int done = 0;
  if (aligned4(x)) {
    const int n4 = s.len / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 a = load4(x + 4 * i);
      acc += a.x * a.x;
      acc += a.y * a.y;
      acc += a.z * a.z;
      acc += a.w * a.w;
    }
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < s.len; i += blockDim.x) {
    const float a = to_f32(x[i]);
    acc += a * a;
  }
  const float mine = block_sum2(make_float2(acc, 0.f), red).x;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = mine;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float tot = 0.f;
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x)
    tot += __ldcg(partials + c);
  tot = block_sum2(make_float2(tot, 0.f), red).x;
  if (threadIdx.x == 0) {
    *out = tot;
    *ticket = 0u;
  }
}

}  // namespace

// The chunk table (chunk_leaf int32, chunk_start int64, leaf_numel int64,
// n_chunks chunks of at most `chunk` elements), `row`: int64 base pointers
// of the leaves, all of dtype 0 = float32 or 1 = bfloat16.  partials:
// n_chunks float32 scratch; ticket: one uint32, zero on entry and left
// zero; out: one float32.  Returns the cudaError_t of the launch.
extern "C" int apex_multi_tensor_sumsq(const void* chunk_leaf,
                                       const void* chunk_start,
                                       const void* leaf_numel, int n_chunks,
                                       int chunk, const void* row, int dtype,
                                       void* partials, void* ticket,
                                       void* out, void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const ChunkTable t{static_cast<const int*>(chunk_leaf),
                     static_cast<const long long*>(chunk_start),
                     static_cast<const long long*>(leaf_numel), chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* r = static_cast<const long long*>(row);
  float* pa = static_cast<float*>(partials);
  unsigned* tk = static_cast<unsigned*>(ticket);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    sumsq_kernel<float><<<n_chunks, kThreads, 0, st>>>(t, r, n_chunks, pa,
                                                        tk, o);
  else if (dtype == 1)
    sumsq_kernel<__nv_bfloat16><<<n_chunks, kThreads, 0, st>>>(
        t, r, n_chunks, pa, tk, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
