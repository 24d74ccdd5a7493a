// Sums of squares over a tree of tensors, for Hopper (sm_90a), with a
// plain C interface: K9, the total (the global gradient norm of the LAMB
// clip and of FP16Optimizer), and K12, one sum per leaf (the per-tensor
// norms of multi_tensor_l2norm).
//
// Replaces: apex_tpu/ops/pallas/multi_tensor_kernels.py, `packed_sumsq`
// and its kernel `_sumsq_kernel` (K9), and `packed_sumsq_per_chunk`
// (`_sumsq_per_chunk_kernel`) together with the segment add of
// apex_tpu/ops/multi_tensor.py `per_tensor_sumsq_from_packed` (K12): the
// Pallas forms of csrc/multi_tensor_l2norm_kernel.cu.
//
// Computes, over the chunk table of chunk_table.cuh (leaves read in place
// through a row of base pointers; no packed buffer), the sum over every
// element x of float(x)^2 in fp32: of all leaves (K9, out[0]) or of each
// leaf (K12, out[leaf]).
//
// What bounds them on the H100: bytes (4 B an fp32 element read, 2 B a
// bf16 one; two flops an element).
//
// Design: the TPU sums in grid order with an SMEM accumulator; Hopper's
// blocks run in no order, and float atomics would make the sum change from
// run to run.  So two stages in one launch: each block (one chunk) sums
// its elements with 16-byte loads and a fixed-order block reduction and
// writes one fp32 partial (the same code for K9 and K12); the block that
// finishes last (told by an integer ticket, never by a float atomic) sums
// the partials in a fixed order -- all of them (K9), or each leaf's own
// in chunk order, one warp per leaf (K12) -- and resets the ticket.  Two
// runs give equal bits, and the result stays on the device.

#include "chunk_table.cuh"

namespace {

using namespace apex_mt;

// The sum of squares of chunk `c`, valid in thread 0.
template <typename T>
__device__ __forceinline__ float chunk_sumsq(const ChunkTable& t,
                                             const long long* row, int c,
                                             float2* red) {
  const ChunkSpan s = span_of(t, c);
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
  return block_sum2(make_float2(acc, 0.f), red).x;
}

// Stage one of both kernels: this block's chunk partial into
// partials[blockIdx.x]; true in every thread of the block that finished
// last, which then sees every partial.
template <typename T>
__device__ __forceinline__ bool partial_then_ticket(
    const ChunkTable& t, const long long* row, float* partials,
    unsigned* ticket, float2* red) {
  __shared__ bool last;
  const float mine = chunk_sumsq<T>(t, row, blockIdx.x, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = mine;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(ChunkTable t, const long long* __restrict__ row, int n_chunks,
             float* __restrict__ partials, unsigned* __restrict__ ticket,
             float* __restrict__ out) {
  __shared__ float2 red[kThreads / 32];
  if (!partial_then_ticket<T>(t, row, partials, ticket, red)) return;
  float tot = 0.f;
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x)
    tot += __ldcg(partials + c);
  tot = block_sum2(make_float2(tot, 0.f), red).x;
  if (threadIdx.x == 0) {
    *out = tot;
    *ticket = 0u;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sumsq_per_leaf_kernel(ChunkTable t, const long long* __restrict__ row,
                      const int* __restrict__ leaf_first_chunk, int n_leaves,
                      float* __restrict__ partials,
                      unsigned* __restrict__ ticket,
                      float* __restrict__ out) {
  __shared__ float2 red[kThreads / 32];
  if (!partial_then_ticket<T>(t, row, partials, ticket, red)) return;
  // one warp per leaf: lane-strided sums over the leaf's chunks in chunk
  // order, then a shuffle tree; a leaf of no elements gets 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int leaf = warp; leaf < n_leaves; leaf += kThreads / 32) {
    const int c0 = leaf_first_chunk[leaf], c1 = leaf_first_chunk[leaf + 1];
    float acc = 0.f;
    for (int c = c0 + lane; c < c1; c += 32) acc += __ldcg(partials + c);
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) out[leaf] = acc;
  }
  if (threadIdx.x == 0) *ticket = 0u;
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

// K12: as apex_multi_tensor_sumsq, plus leaf_first_chunk (int32, n_leaves
// + 1) of the table; out: n_leaves float32, one sum of squares per leaf.
// Returns the cudaError_t of the launch.
extern "C" int apex_multi_tensor_sumsq_per_tensor(
    const void* chunk_leaf, const void* chunk_start, const void* leaf_numel,
    const void* leaf_first_chunk, int n_chunks, int n_leaves, int chunk,
    const void* row, int dtype, void* partials, void* ticket, void* out,
    void* stream) {
  if (n_chunks <= 0 || n_leaves <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const ChunkTable t{static_cast<const int*>(chunk_leaf),
                     static_cast<const long long*>(chunk_start),
                     static_cast<const long long*>(leaf_numel), chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* r = static_cast<const long long*>(row);
  const int* first = static_cast<const int*>(leaf_first_chunk);
  float* pa = static_cast<float*>(partials);
  unsigned* tk = static_cast<unsigned*>(ticket);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    sumsq_per_leaf_kernel<float><<<n_chunks, kThreads, 0, st>>>(
        t, r, first, n_leaves, pa, tk, o);
  else if (dtype == 1)
    sumsq_per_leaf_kernel<__nv_bfloat16><<<n_chunks, kThreads, 0, st>>>(
        t, r, first, n_leaves, pa, tk, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
