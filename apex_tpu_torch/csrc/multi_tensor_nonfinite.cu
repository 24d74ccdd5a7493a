// K15, a read-only non-finite flag over a tree of tensors, for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/experimental/finite_pack.py,
// `packed_nonfinite` and its kernel `_nonfinite_kernel` (the read-only half
// of K6's in-pass overflow flag), behind `all_finite_packed`.
//
// Computes one int32: 1 if any element of any leaf is an inf or a nan, else
// left as the caller zeroed it.  The leaves may mix float32, bfloat16 and
// float16 (a per-leaf dtype code); each is tested in its own format, by its
// exponent bits, with no upcast.
//
// What bounds it on the H100: bytes (each element read once, 4 B in fp32,
// 2 B in bf16 / fp16; one compare each).
//
// Design: the TPU version packs the leaves into one flat buffer per dtype
// (a concatenate, padded to the chunk) and walks it; here the chunk table
// of chunk_table.cuh says where every chunk of every leaf lies, so the one
// launch reads the leaves in place: a block a chunk, 16-byte loads where
// the chunk starts on a 16-byte boundary, element loads for the rest and
// for the ragged tail of a leaf (the hazard finite_pack.py names: an
// unchecked tail).  A block that sees a non-finite value stores the
// constant 1 to the flag: a plain store, no float atomics, so the result
// repeats bit for bit.

#include "chunk_table.cuh"

namespace {

using namespace apex_mt;

// exponent masks: a value is not finite when all its exponent bits are set
constexpr uint32_t kExpF32 = 0x7f800000u;
constexpr uint32_t kExpBf16 = 0x7f80u;
constexpr uint32_t kExpF16 = 0x7c00u;

__device__ __forceinline__ bool bad32(uint32_t w, int code) {
  if (code == 0) return (w & kExpF32) == kExpF32;
  const uint32_t m = code == 1 ? kExpBf16 : kExpF16;
  return ((w & m) == m) || (((w >> 16) & m) == m);
}

__device__ __forceinline__ bool bad_elem(const unsigned char* p, int code) {
  if (code == 0) return (*reinterpret_cast<const uint32_t*>(p) & kExpF32) ==
                        kExpF32;
  const uint32_t m = code == 1 ? kExpBf16 : kExpF16;
  return (*reinterpret_cast<const uint16_t*>(p) & m) == m;
}

__global__ void __launch_bounds__(kThreads)
nonfinite_kernel(ChunkTable t, const long long* __restrict__ row,
                 const int* __restrict__ leaf_dtype, int* __restrict__ flag) {
  const ChunkSpan s = span_of(t, blockIdx.x);
  const int code = leaf_dtype[s.leaf];
  const int es = code == 0 ? 4 : 2;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(
                                  row[s.leaf]) + s.start * es;
  const long long nbytes = (long long)s.len * es;
  bool bad = false;
  long long done = 0;
  if (reinterpret_cast<uintptr_t>(base) % 16 == 0) {
    const long long n16 = nbytes / 16;
    const uint4* v = reinterpret_cast<const uint4*>(base);
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) {
      const uint4 w = __ldcs(v + i);
      bad |= bad32(w.x, code) | bad32(w.y, code) | bad32(w.z, code) |
             bad32(w.w, code);
    }
    done = n16 * 16;
  }
  for (long long b = done + (long long)threadIdx.x * es; b < nbytes;
       b += (long long)blockDim.x * es)
    bad |= bad_elem(base + b, code);
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1;
}

}  // namespace

// The chunk table (chunk_leaf int32, chunk_start int64, leaf_numel int64,
// n_chunks chunks of at most `chunk` elements); `row`: int64 base pointers
// of the leaves; leaf_dtype: int32 per leaf, 0 = float32, 1 = bfloat16,
// 2 = float16.  flag: one int32, set to 1 when a value is not finite and
// otherwise left as it was (zero it first).  Returns the cudaError_t of the
// launch.
extern "C" int apex_packed_nonfinite(const void* chunk_leaf,
                                     const void* chunk_start,
                                     const void* leaf_numel, int n_chunks,
                                     int chunk, const void* row,
                                     const void* leaf_dtype, void* flag,
                                     void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const ChunkTable t{static_cast<const int*>(chunk_leaf),
                     static_cast<const long long*>(chunk_start),
                     static_cast<const long long*>(leaf_numel), chunk};
  nonfinite_kernel<<<n_chunks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const long long*>(row),
      static_cast<const int*>(leaf_dtype), static_cast<int*>(flag));
  return (int)cudaGetLastError();
}
