// Fused Adam steps for Hopper (sm_90a), with a plain C interface: K5 over
// one flat leaf, and K11 over a whole tree of leaves in one launch.
//
// Replaces: apex_tpu/ops/pallas/adam_kernel.py, `packed_adam` and its kernel
// `_adam_kernel` (K5; the Pallas form of csrc/fused_adam_cuda_kernel.cu),
// and `packed_adam_tree` and its kernel `_adam_tree_kernel` (K11).
//
// Computes, per element of one flat leaf, in fp32 and in the op order of the
// JAX package's `adam_step`: g = g / scale; g = g + wd * p (only when wd is
// not 0); m = b1 * m + (1 - b1) * g; v = b2 * v + (1 - b2) * g * g;
// denom = sqrt(v) + eps (or sqrt(v + eps)); p = p - step_size * m / denom;
// and, optionally, a bf16 or fp16 copy of the new p (the fused half
// write-back that refreshes the model's compute weights).  p, m, v are updated in place.
// Every product and sum is rounded on its own (no fused multiply-add), so
// the kernel equals the plain PyTorch version bit for bit.
//
// `step_size` and `scale` are read from device memory, as the TPU kernel
// reads them from SMEM: a changing loss scale or bias correction needs no
// host sync.  When the device `noop` flag is set (an overflow found by the
// unscale), the kernel writes nothing: the skipped step stays on the card.
//
// g is read in its own dtype, fp32 or p's, and widened to fp32, as the JAX
// `adam_step` widens it: under O3 (no master weights) the optimizer steps
// the bf16 model parameters with bf16 gradients.
//
// What bounds it on the H100: bytes.  Four fp32 reads and three fp32
// writes per element (28 B; 30 B with the bf16 copy) against ~15 flops.
//
// K5's design: a grid-stride loop, four elements per thread per trip with
// 16-byte loads where the leaf's pointers allow it, a scalar tail
// otherwise; one launch per leaf (FP16Optimizer's one flat buffer, the
// one-leaf `adam_step`).
//
// K11 (`adam_tree`): the same element math (it calls K5's `adam_one`) over
// the chunk table of chunk_table.cuh, one block (256 threads) per chunk,
// so a parameter group of any number of leaves is one launch with no
// packing copy.  Each leaf's step size (its own bias correction) is read
// from a device vector indexed by the chunk's leaf: the TPU kernel's
// per-chunk step table.  Rows of leaf base pointers carry p, m, v, g and
// the optional half copy; 16-byte loads (8-byte for bf16) where a leaf's
// pointers allow it, a scalar tail otherwise.  It reads the noop flag on
// the card and writes nothing when it is set.  Bound: 28 B an element
// (fp32 p, m, v, g), 30 B with the bf16 copy, 26 B with bf16 p and g;
// against ~15 flops.

#include "chunk_table.cuh"

namespace {

using namespace apex_mt;

struct Hyper {
  float beta1, beta2, om_beta1, om_beta2, eps, weight_decay;
  int eps_inside;
};

__device__ __forceinline__ void adam_one(float& p, float& m, float& v,
                                         float g, float step_size,
                                         float scale, const Hyper& hp) {
  g = __fdiv_rn(g, scale);
  if (hp.weight_decay != 0.f)
    g = __fadd_rn(g, __fmul_rn(hp.weight_decay, p));
  m = __fadd_rn(__fmul_rn(hp.beta1, m), __fmul_rn(hp.om_beta1, g));
  v = __fadd_rn(__fmul_rn(hp.beta2, v),
                __fmul_rn(__fmul_rn(hp.om_beta2, g), g));
  const float denom = hp.eps_inside ? __fsqrt_rn(__fadd_rn(v, hp.eps))
                                    : __fadd_rn(__fsqrt_rn(v), hp.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(step_size, m), denom));
}

template <typename P, typename G, typename C>
__global__ void __launch_bounds__(256)
adam_kernel(P* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
            const G* __restrict__ g, C* __restrict__ p_copy,
            const float* __restrict__ step_size,
            const float* __restrict__ scale, const int* __restrict__ noop,
            long long n, Hyper hp, int vec) {
  if (noop != nullptr && *noop != 0) return;
  const float ss = *step_size;
  const float sc = *scale;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  // the 16-byte path: fp32 p and g, every pointer 16-byte aligned
  if constexpr (sizeof(P) == 4 && sizeof(G) == 4) if (vec) {
    const long long n4 = n / 4;
    for (long long i = i0; i < n4; i += stride) {
      float4 pp = reinterpret_cast<const float4*>(p)[i];
      float4 mm = reinterpret_cast<const float4*>(m)[i];
      float4 vv = reinterpret_cast<const float4*>(v)[i];
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      adam_one(pp.x, mm.x, vv.x, gg.x, ss, sc, hp);
      adam_one(pp.y, mm.y, vv.y, gg.y, ss, sc, hp);
      adam_one(pp.z, mm.z, vv.z, gg.z, ss, sc, hp);
      adam_one(pp.w, mm.w, vv.w, gg.w, ss, sc, hp);
      reinterpret_cast<float4*>(p)[i] = pp;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
      if (p_copy != nullptr) {
        C* pc = p_copy + 4 * i;
        pc[0] = from_f32<C>(pp.x);
        pc[1] = from_f32<C>(pp.y);
        pc[2] = from_f32<C>(pp.z);
        pc[3] = from_f32<C>(pp.w);
      }
    }
    done = n4 * 4;
  }
  for (long long i = done + i0; i < n; i += stride) {
    float pp = to_f32(p[i]);
    float mm = m[i], vv = v[i];
    adam_one(pp, mm, vv, to_f32(g[i]), ss, sc, hp);
    p[i] = from_f32<P>(pp);
    m[i] = mm;
    v[i] = vv;
    if (p_copy != nullptr) p_copy[i] = from_f32<C>(pp);
  }
}

template <typename P, typename G, typename C>
void launch(void* p, void* m, void* v, const void* g, void* pc,
            const float* ssp, const float* scp, const int* np, long long n,
            const Hyper& hp, int blocks, int threads, int vec,
            cudaStream_t s) {
  adam_kernel<P, G, C><<<blocks, threads, 0, s>>>(
      static_cast<P*>(p), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const G*>(g), static_cast<C*>(pc), ssp, scp, np, n, hp,
      vec);
}

// The half type of dtype code 1 (bf16) or 2 (fp16): one call of `f` with a
// value of that type (its type is what counts).
template <typename F>
void with_half(int code, F&& f) {
  if (code == 2)
    f(__half());
  else
    f(__nv_bfloat16());
}

template <typename P, typename G, typename C>
__global__ void __launch_bounds__(kThreads)
adam_tree_kernel(ChunkTable t, const long long* __restrict__ p_row,
                 const long long* __restrict__ m_row,
                 const long long* __restrict__ v_row,
                 const long long* __restrict__ g_row,
                 const long long* __restrict__ copy_row,
                 const float* __restrict__ step_sizes,
                 const float* __restrict__ scale,
                 const int* __restrict__ noop, Hyper hp) {
  if (noop != nullptr && *noop != 0) return;
  const ChunkSpan s = span_of(t, blockIdx.x);
  P* p = leaf_ptr<P>(p_row, s);
  float* m = leaf_ptr<float>(m_row, s);
  float* v = leaf_ptr<float>(v_row, s);
  const G* g = leaf_ptr<const G>(g_row, s);
  C* cp = copy_row != nullptr ? leaf_ptr<C>(copy_row, s) : nullptr;
  const float ss = step_sizes[s.leaf];
  const float sc = *scale;
  int done = 0;
  if (aligned4(p) && aligned4(m) && aligned4(v) && aligned4(g) &&
      (cp == nullptr || aligned4(cp))) {
    const int n4 = s.len / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      float4 pp = load4(p + 4 * i), mm = load4(m + 4 * i),
             vv = load4(v + 4 * i);
      const float4 gg = load4(g + 4 * i);
      adam_one(pp.x, mm.x, vv.x, gg.x, ss, sc, hp);
      adam_one(pp.y, mm.y, vv.y, gg.y, ss, sc, hp);
      adam_one(pp.z, mm.z, vv.z, gg.z, ss, sc, hp);
      adam_one(pp.w, mm.w, vv.w, gg.w, ss, sc, hp);
      store4(p + 4 * i, pp);
      store4(m + 4 * i, mm);
      store4(v + 4 * i, vv);
      if (cp != nullptr) store4(cp + 4 * i, pp);
    }
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < s.len; i += blockDim.x) {
    float pp = to_f32(p[i]);
    float mm = m[i], vv = v[i];
    adam_one(pp, mm, vv, to_f32(g[i]), ss, sc, hp);
    p[i] = from_f32<P>(pp);
    m[i] = mm;
    v[i] = vv;
    if (cp != nullptr) cp[i] = from_f32<C>(pp);
  }
}

}  // namespace

// p: n elements, float32 (p_dtype 0), bfloat16 (1) or float16 (2); m, v: n
// float32; g: n float32 (g_dtype 0) or, with half p, p's dtype.  p_copy: n
// elements of c_dtype (1 bfloat16, 2 float16) or null.  step_size, scale:
// one float32 each, in device memory.
// noop: one int32 in device memory (nonzero = write nothing) or null.
// Returns the cudaError_t of the launch.
extern "C" int apex_adam(void* p, void* m, void* v, const void* g,
                         void* p_copy, const void* step_size,
                         const void* scale, const void* noop, long long n,
                         float beta1, float beta2, float om_beta1,
                         float om_beta2, float eps, float weight_decay,
                         int eps_inside, int p_dtype, int g_dtype,
                         int c_dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (p_dtype < 0 || p_dtype > 2 || (g_dtype != 0 && g_dtype != p_dtype) ||
      (c_dtype != 1 && c_dtype != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper hp{beta1, beta2, om_beta1, om_beta2, eps, weight_decay,
                 eps_inside};
  // the 16-byte path takes fp32 p (and so fp32 g) only
  const bool f32 = p_dtype == 0;
  const long long per = f32 ? (n + 3) / 4 : n;
  const int threads = 256;
  const long long want = (per + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  const float* ssp = static_cast<const float*>(step_size);
  const float* scp = static_cast<const float*>(scale);
  const int* np = static_cast<const int*>(noop);
  void* pc = p_copy;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(g);
  // the half copy is written 4 elements at a time too: 8-byte alignment
  const int vec = f32 && (bits % 16 == 0) &&
                  (pc == nullptr || reinterpret_cast<uintptr_t>(pc) % 8 == 0);
  with_half(c_dtype, [&](auto c) {
    using C = decltype(c);
    if (p_dtype == 0) {
      launch<float, float, C>(p, m, v, g, pc, ssp, scp, np, n, hp, blocks,
                              threads, vec, s);
      return;
    }
    with_half(p_dtype, [&](auto x) {
      using P = decltype(x);
      if (g_dtype == 0)
        launch<P, float, C>(p, m, v, g, pc, ssp, scp, np, n, hp, blocks,
                            threads, 0, s);
      else
        launch<P, P, C>(p, m, v, g, pc, ssp, scp, np, n, hp, blocks, threads,
                        0, s);
    });
  });
  return (int)cudaGetLastError();
}

// K11 over the chunk table (chunk_leaf int32, chunk_start int64,
// leaf_numel int64; n_chunks chunks of at most `chunk` elements).  Rows of
// int64 leaf base pointers: p (p_dtype 0 = float32, 1 = bfloat16, 2 =
// float16), m, v (float32), g (g_dtype 0, or p's dtype), copy (c_dtype 1 =
// bfloat16 or 2 = float16, or a null row).
// step_sizes: one float32 per leaf; scale: one float32; noop: one int32
// (nonzero = write nothing) or null.  Returns the cudaError_t of the
// launch.
extern "C" int apex_adam_tree(const void* chunk_leaf, const void* chunk_start,
                              const void* leaf_numel, int n_chunks, int chunk,
                              const void* p_row, const void* m_row,
                              const void* v_row, const void* g_row,
                              const void* copy_row, const void* step_sizes,
                              const void* scale, const void* noop,
                              float beta1, float beta2, float om_beta1,
                              float om_beta2, float eps, float weight_decay,
                              int eps_inside, int p_dtype, int g_dtype,
                              int c_dtype, void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (p_dtype < 0 || p_dtype > 2 || (g_dtype != 0 && g_dtype != p_dtype) ||
      (c_dtype != 1 && c_dtype != 2))
    return (int)cudaErrorInvalidValue;
  const ChunkTable t{static_cast<const int*>(chunk_leaf),
                     static_cast<const long long*>(chunk_start),
                     static_cast<const long long*>(leaf_numel), chunk};
  const Hyper hp{beta1, beta2, om_beta1, om_beta2, eps, weight_decay,
                 eps_inside};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using LL = const long long*;
  const auto args = [&](auto kernel) {
    kernel<<<n_chunks, kThreads, 0, st>>>(
        t, static_cast<LL>(p_row), static_cast<LL>(m_row),
        static_cast<LL>(v_row), static_cast<LL>(g_row),
        static_cast<LL>(copy_row), static_cast<const float*>(step_sizes),
        static_cast<const float*>(scale), static_cast<const int*>(noop), hp);
  };
  with_half(c_dtype, [&](auto c) {
    using C = decltype(c);
    if (p_dtype == 0) {
      args(adam_tree_kernel<float, float, C>);
      return;
    }
    with_half(p_dtype, [&](auto x) {
      using P = decltype(x);
      if (g_dtype == 0)
        args(adam_tree_kernel<P, float, C>);
      else
        args(adam_tree_kernel<P, P, C>);
    });
  });
  return (int)cudaGetLastError();
}
