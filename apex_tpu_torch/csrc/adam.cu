// Fused Adam step for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/adam_kernel.py, `packed_adam` and its kernel
// `_adam_kernel` (the Pallas form of csrc/fused_adam_cuda_kernel.cu).
//
// Computes, per element of one flat leaf, in fp32 and in the op order of the
// JAX package's `adam_step`: g = g / scale; g = g + wd * p (only when wd is
// not 0); m = b1 * m + (1 - b1) * g; v = b2 * v + (1 - b2) * g * g;
// denom = sqrt(v) + eps (or sqrt(v + eps)); p = p - step_size * m / denom;
// and, optionally, a bf16 copy of the new p (the fused half write-back that
// refreshes the model's compute weights).  p, m, v are updated in place.
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
// Design: a grid-stride loop, four elements per thread per trip with 16-byte
// loads where the leaf's pointers allow it, a scalar tail otherwise.  One
// launch per leaf; the multi-tensor one-launch form (the TPU's
// `packed_adam_tree`) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename P, typename G>
__global__ void __launch_bounds__(256)
adam_kernel(P* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
            const G* __restrict__ g, __nv_bfloat16* __restrict__ p_copy,
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
        __nv_bfloat16* pc = p_copy + 4 * i;
        pc[0] = __float2bfloat16(pp.x);
        pc[1] = __float2bfloat16(pp.y);
        pc[2] = __float2bfloat16(pp.z);
        pc[3] = __float2bfloat16(pp.w);
      }
    }
    done = n4 * 4;
  }
  for (long long i = done + i0; i < n; i += stride) {
    float pp = to_f32(p[i]);
    float mm = m[i], vv = v[i];
    adam_one(pp, mm, vv, to_f32(g[i]), ss, sc, hp);
    if constexpr (sizeof(P) == 2) p[i] = __float2bfloat16(pp);
    else p[i] = pp;
    m[i] = mm;
    v[i] = vv;
    if (p_copy != nullptr) p_copy[i] = __float2bfloat16(pp);
  }
}

template <typename P, typename G>
void launch(void* p, void* m, void* v, const void* g, __nv_bfloat16* pc,
            const float* ssp, const float* scp, const int* np, long long n,
            const Hyper& hp, int blocks, int threads, int vec,
            cudaStream_t s) {
  adam_kernel<P, G><<<blocks, threads, 0, s>>>(
      static_cast<P*>(p), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const G*>(g), pc, ssp, scp, np, n, hp, vec);
}

}  // namespace

// p: n elements, float32 (p_dtype 0) or bfloat16 (1); m, v: n float32;
// g: n float32 (g_dtype 0) or, with bfloat16 p, bfloat16 (1).  p_copy: n
// bfloat16 or null.  step_size, scale: one float32 each, in device memory.
// noop: one int32 in device memory (nonzero = write nothing) or null.
// Returns the cudaError_t of the launch.
extern "C" int apex_adam(void* p, void* m, void* v, const void* g,
                         void* p_copy, const void* step_size,
                         const void* scale, const void* noop, long long n,
                         float beta1, float beta2, float om_beta1,
                         float om_beta2, float eps, float weight_decay,
                         int eps_inside, int p_dtype, int g_dtype,
                         void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if ((p_dtype != 0 && p_dtype != 1) || (g_dtype != 0 && g_dtype != p_dtype))
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
  __nv_bfloat16* pc = static_cast<__nv_bfloat16*>(p_copy);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(g);
  // the bf16 copy is written 4 elements at a time too: 8-byte alignment
  const int vec = f32 && (bits % 16 == 0) &&
                  (pc == nullptr || reinterpret_cast<uintptr_t>(pc) % 8 == 0);
  using bf16 = __nv_bfloat16;
  if (p_dtype == 0)
    launch<float, float>(p, m, v, g, pc, ssp, scp, np, n, hp, blocks,
                         threads, vec, s);
  else if (g_dtype == 0)
    launch<bf16, float>(p, m, v, g, pc, ssp, scp, np, n, hp, blocks,
                        threads, 0, s);
  else
    launch<bf16, bf16>(p, m, v, g, pc, ssp, scp, np, n, hp, blocks, threads,
                       0, s);
  return (int)cudaGetLastError();
}
