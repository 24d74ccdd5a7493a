// The two LAMB stages for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/lamb_kernels.py, `packed_lamb_stage1`
// (`_stage1_kernel`, with_norms=True) and `packed_lamb_stage2`
// (`_stage2_kernel`) -- the Pallas forms of
// csrc/multi_tensor_lamb_stage_{1,2}.cu.
//
// Stage 1 (K7), per element of every leaf, in fp32 and in the op order of
// the JAX package's fused_lamb: g = g * inv_clip, where inv_clip =
// 1 / max(sqrt(sumsq) / max_grad_norm, 1) is formed here from the device
// sum of squares of K9 (1 without one); m = b1 * m + (1 - b1) * g;
// v = b2 * v + (1 - b2) * g * g; u = (m / bc1) / (sqrt(v / bc2) + eps) +
// weight_decay * p, with bc1 / bc2 per leaf from its own step count.  It
// writes u (fp32 scratch), m and v, and one fp32 ||p||^2 and ||u||^2
// partial per chunk.
//
// Stage 2 (K8): each block sums its leaf's chunk partials in a fixed order
// (every block of a leaf gets the same bits), forms ratio = lr *
// (||p|| / ||u||), or lr when either norm is 0, and applies p = p -
// ratio * u in fp32 -- the same rounding as the JAX optimizer's delta
// -(lr * ratio) * u added to the master -- writing the bf16 compute copy in
// the same pass.  A bf16 p (no master weights) takes the delta rounded to
// bf16 first, as the JAX optimizer casts the update to p's dtype.
//
// Every product and sum of the elementwise math is rounded on its own (no
// fused multiply-add), so u, m, v and p equal the plain PyTorch version's
// on the card bit for bit, given the same norms.  Both kernels read the
// amp overflow flag (`noop`) on the device and write nothing when it is
// set: a skipped step needs no host sync.
//
// What bounds them on the H100: bytes.  Stage 1 reads g, p, m, v and
// writes u, m, v: 28 B an fp32 element (26 with bf16 g) against ~20 flops;
// stage 2 reads p and u and writes p and the bf16 copy: 14 B.
//
// Design: one block (256 threads) per chunk of the table in
// chunk_table.cuh, so each stage is one launch over the whole tree; 16-byte
// loads and stores (8-byte for bf16) where a leaf's pointers allow it, a
// scalar tail otherwise.  The per-chunk norm partials are fixed-order block
// sums (no atomics), and stage 2 reduces them per leaf inside its blocks,
// so nothing between the stages runs on the host or in another kernel.

#include "chunk_table.cuh"

namespace {

using namespace apex_mt;
using bf16 = __nv_bfloat16;

struct Stage1 {
  float beta1, beta2, om_beta1, om_beta2, eps, weight_decay, max_grad_norm;
};

__device__ __forceinline__ void stage1_one(float p, float g, float& m,
                                           float& v, float& u, float bc1,
                                           float bc2, float inv_clip,
                                           const Stage1& h) {
  g = __fmul_rn(g, inv_clip);
  m = __fadd_rn(__fmul_rn(h.beta1, m), __fmul_rn(h.om_beta1, g));
  v = __fadd_rn(__fmul_rn(h.beta2, v),
                __fmul_rn(__fmul_rn(h.om_beta2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
  u = __fadd_rn(__fdiv_rn(__fdiv_rn(m, bc1), denom),
                __fmul_rn(h.weight_decay, p));
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
lamb_stage1_kernel(ChunkTable t, const long long* __restrict__ p_row,
                   const long long* __restrict__ g_row,
                   const long long* __restrict__ m_row,
                   const long long* __restrict__ v_row,
                   const long long* __restrict__ u_row,
                   const float* __restrict__ bc1s,
                   const float* __restrict__ bc2s,
                   const float* __restrict__ sumsq,
                   const int* __restrict__ noop, float* __restrict__ p_sq,
                   float* __restrict__ u_sq, Stage1 h) {
  if (noop != nullptr && *noop != 0) return;
  __shared__ float2 red[kThreads / 32];
  const ChunkSpan s = span_of(t, blockIdx.x);
  const P* p = leaf_ptr<const P>(p_row, s);
  const G* g = leaf_ptr<const G>(g_row, s);
  float* m = leaf_ptr<float>(m_row, s);
  float* v = leaf_ptr<float>(v_row, s);
  float* u = leaf_ptr<float>(u_row, s);
  const float bc1 = bc1s[s.leaf], bc2 = bc2s[s.leaf];
  float inv_clip = 1.f;
  if (sumsq != nullptr) {
    const float clip =
        fmaxf(__fdiv_rn(__fsqrt_rn(*sumsq), h.max_grad_norm), 1.f);
    inv_clip = __fdiv_rn(1.f, clip);
  }
  float2 acc = make_float2(0.f, 0.f);
  int done = 0;
  if (aligned4(p) && aligned4(g) && aligned4(m) && aligned4(v) &&
      aligned4(u)) {
    const int n4 = s.len / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 pp = load4(p + 4 * i), gg = load4(g + 4 * i);
      float4 mm = load4(m + 4 * i), vv = load4(v + 4 * i), uu;
      stage1_one(pp.x, gg.x, mm.x, vv.x, uu.x, bc1, bc2, inv_clip, h);
      stage1_one(pp.y, gg.y, mm.y, vv.y, uu.y, bc1, bc2, inv_clip, h);
      stage1_one(pp.z, gg.z, mm.z, vv.z, uu.z, bc1, bc2, inv_clip, h);
      stage1_one(pp.w, gg.w, mm.w, vv.w, uu.w, bc1, bc2, inv_clip, h);
      store4(m + 4 * i, mm);
      store4(v + 4 * i, vv);
      store4(u + 4 * i, uu);
      acc.x += pp.x * pp.x + pp.y * pp.y + pp.z * pp.z + pp.w * pp.w;
      acc.y += uu.x * uu.x + uu.y * uu.y + uu.z * uu.z + uu.w * uu.w;
    }
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < s.len; i += blockDim.x) {
    const float pp = to_f32(p[i]);
    float mm = m[i], vv = v[i], uu;
    stage1_one(pp, to_f32(g[i]), mm, vv, uu, bc1, bc2, inv_clip, h);
    m[i] = mm;
    v[i] = vv;
    u[i] = uu;
    acc.x += pp * pp;
    acc.y += uu * uu;
  }
  acc = block_sum2(acc, red);
  if (threadIdx.x == 0) {
    p_sq[blockIdx.x] = acc.x;
    u_sq[blockIdx.x] = acc.y;
  }
}

// p - ratio * u, in p's storage dtype
__device__ __forceinline__ float stage2_one(float p, float u, float ratio,
                                            float) {
  return __fsub_rn(p, __fmul_rn(ratio, u));
}
__device__ __forceinline__ float stage2_one(float p, float u, float ratio,
                                            bf16) {
  // the delta rounded to bf16 first, then the bf16 sum
  const float d = __bfloat162float(__float2bfloat16(__fmul_rn(ratio, u)));
  return __bfloat162float(__float2bfloat16(__fsub_rn(p, d)));
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
lamb_stage2_kernel(ChunkTable t, const int* __restrict__ leaf_first_chunk,
                   const long long* __restrict__ p_row,
                   const long long* __restrict__ u_row,
                   const long long* __restrict__ copy_row,
                   const float* __restrict__ p_sq,
                   const float* __restrict__ u_sq,
                   const int* __restrict__ noop, float lr) {
  if (noop != nullptr && *noop != 0) return;
  __shared__ float2 red[kThreads / 32];
  __shared__ float ratio_s;
  const ChunkSpan s = span_of(t, blockIdx.x);
  const int c0 = leaf_first_chunk[s.leaf], c1 = leaf_first_chunk[s.leaf + 1];
  float2 acc = make_float2(0.f, 0.f);
  for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    acc.x += p_sq[c];
    acc.y += u_sq[c];
  }
  acc = block_sum2(acc, red);
  if (threadIdx.x == 0) {
    const float pn = __fsqrt_rn(acc.x), un = __fsqrt_rn(acc.y);
    const float trust = (pn > 0.f && un > 0.f)
                            ? __fdiv_rn(pn, fmaxf(un, 1e-38f)) : 1.f;
    ratio_s = __fmul_rn(lr, trust);
  }
  __syncthreads();
  const float ratio = ratio_s;
  P* p = leaf_ptr<P>(p_row, s);
  const float* u = leaf_ptr<const float>(u_row, s);
  bf16* cp = copy_row != nullptr ? leaf_ptr<bf16>(copy_row, s) : nullptr;
  int done = 0;
  if (aligned4(p) && aligned4(u) && (cp == nullptr || aligned4(cp))) {
    const int n4 = s.len / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      float4 pp = load4(p + 4 * i);
      const float4 uu = load4(u + 4 * i);
      pp.x = stage2_one(pp.x, uu.x, ratio, P());
      pp.y = stage2_one(pp.y, uu.y, ratio, P());
      pp.z = stage2_one(pp.z, uu.z, ratio, P());
      pp.w = stage2_one(pp.w, uu.w, ratio, P());
      store4(p + 4 * i, pp);
      if (cp != nullptr) store4(cp + 4 * i, pp);
    }
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < s.len; i += blockDim.x) {
    const float pp = stage2_one(to_f32(p[i]), u[i], ratio, P());
    p[i] = from_f32<P>(pp);
    if (cp != nullptr) cp[i] = __float2bfloat16(pp);
  }
}

ChunkTable table_of(const void* chunk_leaf, const void* chunk_start,
                    const void* leaf_numel, int chunk) {
  return ChunkTable{static_cast<const int*>(chunk_leaf),
                    static_cast<const long long*>(chunk_start),
                    static_cast<const long long*>(leaf_numel), chunk};
}

}  // namespace

// Stage 1 over the chunk table (chunk_leaf int32, chunk_start int64,
// leaf_numel int64; n_chunks chunks of at most `chunk` elements).  Rows of
// int64 leaf base pointers: p (p_dtype 0 = float32, 1 = bfloat16), g
// (g_dtype 0, or p's dtype), m, v, u (float32).  bc1, bc2: one float32 per
// leaf; sumsq: one float32 (K9's result) or null for no clip; noop: one
// int32 (nonzero = write nothing) or null; p_sq, u_sq: n_chunks float32
// out.  Returns the cudaError_t of the launch.
extern "C" int apex_lamb_stage1(
    const void* chunk_leaf, const void* chunk_start, const void* leaf_numel,
    int n_chunks, int chunk, const void* p_row, const void* g_row,
    const void* m_row, const void* v_row, const void* u_row, const void* bc1,
    const void* bc2, const void* sumsq, const void* noop, void* p_sq,
    void* u_sq, float beta1, float beta2, float om_beta1, float om_beta2,
    float eps, float weight_decay, float max_grad_norm, int p_dtype,
    int g_dtype, void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if ((p_dtype != 0 && p_dtype != 1) || (g_dtype != 0 && g_dtype != p_dtype))
    return (int)cudaErrorInvalidValue;
  const ChunkTable t = table_of(chunk_leaf, chunk_start, leaf_numel, chunk);
  const Stage1 h{beta1, beta2, om_beta1, om_beta2, eps, weight_decay,
                 max_grad_norm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using LL = const long long*;
  const auto args = [&](auto kernel) {
    kernel<<<n_chunks, kThreads, 0, st>>>(
        t, static_cast<LL>(p_row), static_cast<LL>(g_row),
        static_cast<LL>(m_row), static_cast<LL>(v_row),
        static_cast<LL>(u_row), static_cast<const float*>(bc1),
        static_cast<const float*>(bc2), static_cast<const float*>(sumsq),
        static_cast<const int*>(noop), static_cast<float*>(p_sq),
        static_cast<float*>(u_sq), h);
  };
  if (p_dtype == 0)
    args(lamb_stage1_kernel<float, float>);
  else if (g_dtype == 0)
    args(lamb_stage1_kernel<bf16, float>);
  else
    args(lamb_stage1_kernel<bf16, bf16>);
  return (int)cudaGetLastError();
}

// Stage 2 over the same table plus leaf_first_chunk (int32, n_leaves + 1).
// Rows: p (p_dtype), u (float32), copy (bfloat16 compute copies, or null).
// p_sq, u_sq: stage 1's partials; noop as in stage 1.  Returns the
// cudaError_t of the launch.
extern "C" int apex_lamb_stage2(const void* chunk_leaf,
                                const void* chunk_start,
                                const void* leaf_numel,
                                const void* leaf_first_chunk, int n_chunks,
                                int chunk, const void* p_row,
                                const void* u_row, const void* copy_row,
                                const void* p_sq, const void* u_sq,
                                const void* noop, float lr, int p_dtype,
                                void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const ChunkTable t = table_of(chunk_leaf, chunk_start, leaf_numel, chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using LL = const long long*;
  const auto args = [&](auto kernel) {
    kernel<<<n_chunks, kThreads, 0, st>>>(
        t, static_cast<const int*>(leaf_first_chunk), static_cast<LL>(p_row),
        static_cast<LL>(u_row), static_cast<LL>(copy_row),
        static_cast<const float*>(p_sq), static_cast<const float*>(u_sq),
        static_cast<const int*>(noop), lr);
  };
  if (p_dtype == 0)
    args(lamb_stage2_kernel<float>);
  else if (p_dtype == 1)
    args(lamb_stage2_kernel<bf16>);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
