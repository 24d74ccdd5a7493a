// The generic flash-attention kernels for Hopper (sm_90a), with a plain C
// interface: forward, and the backward's two passes (dk / dv, then dq), on
// CUDA cores, for the cases the tensor-core kernels do not take.
//
// Replaces, for those cases: apex_tpu/ops/pallas/flash_attention.py,
// `_flash_fwd` (`_fwd_kernel`) and `_flash_bwd_fused`
// (`_bwd_fused_kernel`), and apex_tpu/ops/pallas/experimental/flash_mh.py,
// `_mh_fwd` and `_mh_bwd_fused` (the same functions, q pre-scaled by the
// wrapper): fp32 at any head width D that is a multiple of 8 up to the
// widest whose rows fit, and bf16 / fp16 where D is above the tensor-core
// kernels' 128.  The route (ops/cuda/flash_attention.py, `fwd_route` / `bwd_route`)
// picks them; every other case takes the Hopper kernels.
//
// Semantics as the tensor-core kernels', in fp32 arithmetic on storage type
// T: q pre-scaled in T (the scale rounded to T, the product rounded), q and
// k rotated by the full-width tables in fp32 and rounded to T; the forward's
// online softmax in fp32; the backward recomputes P = exp(S - lse), rounds
// P to T for dV and dS = P (dP - delta) to T for dK and dQ, inverse-rotates
// dK and dQ in fp32, writes dK and dV in T and dQ in fp32 (the wrapper
// casts it and applies the one deferred scale).  A row that sees no key
// gives zeros and lse = NEG_INF.
//
// What bounds it on the H100: nothing of the card's tensor cores; a warp a
// row walks every visible key, so operations at 67 TFLOP/s fp32 and, far
// above that, the latency of its two warp reductions a key.  These are the
// simple, right kernels of rare cases (fp32 references, wide heads).
//
// Layout: one warp per query (forward, dq) or key (dk / dv) row; lane l
// holds the column pairs (c, c + D / 2) for c = l + 32 j < D / 2, j < P, so
// that a rotation pairs values of one lane.  Up to D 512 the pairs live in
// registers (P = ceil(D / 64) rounded up to 1, 2, 4 or 8; lanes past D / 2
// hold zeros and write nothing).  Above, each row a warp holds (4 in the
// forward, 6 in dk / dv, 5 in dq, each of 64 ceil(D / 64) floats) lives in
// the warp's slice of dynamic shared memory, every lane touching only its
// own columns, and a block takes as many warps (up to 4) as 227 KB hold:
// D up to 9664, where one warp's six rows of dk / dv fill them (a launch
// refuses a wider D).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace apex_fa;

// One block's dynamic shared memory on the H100.
constexpr size_t kMaxSmem = 232448;

// Where a warp's rows live: its slice of dynamic shared memory (only the
// shared-memory rows use it) and the pair chunks of a row, ceil(D / 64).
struct Slab {
  float* next;
  int chunks;
};

// A row's lane-held pairs in registers: lo(j) = x[c], hi(j) = x[c + D / 2]
// for c = lane + 32 j.
template <int P>
struct RegRow {
  float lo_[P], hi_[P];
  __device__ explicit RegRow(Slab&) {}
  __device__ __forceinline__ int pairs() const { return P; }
  __device__ __forceinline__ float& lo(int j) { return lo_[j]; }
  __device__ __forceinline__ float& hi(int j) { return hi_[j]; }
};

// The same pairs in the warp's shared memory: chunk j is 32 lo then 32 hi
// floats, so a warp's access hits 32 banks once.
struct SmemRow {
  float* p;
  int n;
  __device__ explicit SmemRow(Slab& s)
      : p(s.next + (threadIdx.x & 31)), n(s.chunks) {
    s.next += 64 * s.chunks;
  }
  __device__ __forceinline__ int pairs() const { return n; }
  __device__ __forceinline__ float& lo(int j) { return p[64 * j]; }
  __device__ __forceinline__ float& hi(int j) { return p[64 * j + 32]; }
};

// This warp's slab: `rows` rows of `chunks` pair chunks each.
__device__ __forceinline__ Slab warp_slab(int rows, int chunks) {
  extern __shared__ float slab_smem[];
  return Slab{slab_smem + (threadIdx.x >> 5) * rows * 64 * chunks, chunks};
}

// Load row `src` (unit stride over D) into the lane's pairs, times `scale`
// rounded to T when `scaled` (the pre-scale), then rotated by the row's
// tables (cr / sr, or null) and rounded to T.
template <class R, typename T>
__device__ __forceinline__ void load_row(R& x, const T* src, int D,
                                         bool scaled, float scale,
                                         const T* cr, const T* sr) {
  const int lane = threadIdx.x & 31, hd = D / 2;
#pragma unroll
  for (int j = 0; j < x.pairs(); ++j) {
    const int c = lane + 32 * j;
    float lo = 0.f, hi = 0.f;
    if (c < hd) {
      lo = to_f32(src[c]);
      hi = to_f32(src[c + hd]);
      if (scaled) {
        lo = round_to<T>(lo * scale);
        hi = round_to<T>(hi * scale);
      }
      if (cr != nullptr) {
        const float l2 = round_to<T>(rot1(lo, hi, to_f32(cr[c]), to_f32(sr[c])));
        hi = round_to<T>(rot1(hi, lo, to_f32(cr[c + hd]), to_f32(sr[c + hd])));
        lo = l2;
      }
    }
    x.lo(j) = lo;
    x.hi(j) = hi;
  }
}

template <class R>
__device__ __forceinline__ void zero_row(R& x) {
#pragma unroll
  for (int j = 0; j < x.pairs(); ++j) x.lo(j) = x.hi(j) = 0.f;
}

template <class R>
__device__ __forceinline__ float dot(R& a, R& b) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < a.pairs(); ++j)
    s += a.lo(j) * b.lo(j) + a.hi(j) * b.hi(j);
  return warp_sum(s);
}

// acc = acc * keep + w * x, pair by pair.
template <class R>
__device__ __forceinline__ void axpy(R& acc, float keep, float w, R& x) {
#pragma unroll
  for (int j = 0; j < acc.pairs(); ++j) {
    acc.lo(j) = acc.lo(j) * keep + w * x.lo(j);
    acc.hi(j) = acc.hi(j) * keep + w * x.hi(j);
  }
}

// Inverse-rotate a row of fp32 sums (the lane rotation with the sine
// negated), in fp32.
template <class R, typename T>
__device__ __forceinline__ void unrotate(R& x, int D, const T* cr,
                                         const T* sr) {
  const int lane = threadIdx.x & 31, hd = D / 2;
#pragma unroll
  for (int j = 0; j < x.pairs(); ++j) {
    const int c = lane + 32 * j;
    if (c >= hd) continue;
    const float lo = x.lo(j), hi = x.hi(j);
    x.lo(j) = rot1(lo, hi, to_f32(cr[c]), -to_f32(sr[c]));
    x.hi(j) = rot1(hi, lo, to_f32(cr[c + hd]), -to_f32(sr[c + hd]));
  }
}

template <class R, typename O>
__device__ __forceinline__ void store_row(O* dst, R& x, int D, float mul) {
  const int lane = threadIdx.x & 31, hd = D / 2;
#pragma unroll
  for (int j = 0; j < x.pairs(); ++j) {
    const int c = lane + 32 * j;
    if (c >= hd) continue;
    dst[c] = from_f32<O>(x.lo(j) * mul);
    dst[c + hd] = from_f32<O>(x.hi(j) * mul);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const uint8_t* kv_mask;
  const void *cos_t, *sin_t;
  Strides sq, sk, sv, sd;
  int H, L, D;
  float scale;
  int causal;
  int chunks;  // ceil(D / 64): the pair chunks of a shared-memory row
};

// Rows a warp holds in each kernel (the shared-memory rows' slab).
constexpr int kFwdRows = 4, kDkvRows = 6, kDqRows = 5;

// Forward: one warp per (query row, batch * head).
template <class R, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(Args a, T* __restrict__ o, float* __restrict__ lse) {
  const int qpos = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  if (qpos >= a.L) return;
  const int L = a.L, D = a.D;
  const T* cb = static_cast<const T*>(a.cos_t);
  const T* sb = static_cast<const T*>(a.sin_t);
  const bool rope = cb != nullptr;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const long long tb = (long long)b * L * D;
  Slab slab = warp_slab(kFwdRows, a.chunks);
  R qr(slab), acc(slab), kr(slab), vr(slab);
  load_row<R, T>(qr, q + qpos * a.sq.l, D, true, a.scale,
                 rope ? cb + tb + (long long)qpos * D : nullptr,
                 rope ? sb + tb + (long long)qpos * D : nullptr);
  zero_row(acc);
  float m = kNegInf, l = 0.f;
  const int end = a.causal ? qpos + 1 : L;
  for (int kpos = 0; kpos < end; ++kpos) {
    if (a.kv_mask != nullptr && a.kv_mask[(long long)b * L + kpos] == 0)
      continue;
    load_row<R, T>(kr, k + kpos * a.sk.l, D, false, 1.f,
                   rope ? cb + tb + (long long)kpos * D : nullptr,
                   rope ? sb + tb + (long long)kpos * D : nullptr);
    load_row<R, T>(vr, v + kpos * a.sv.l, D, false, 1.f, nullptr, nullptr);
    const float s = dot(qr, kr);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    axpy(acc, corr, p, vr);
    m = m_new;
  }
  const long long at = ((long long)b * L + qpos) * a.H + h;
  store_row<R, T>(o + at * D, acc, D, l == 0.f ? 0.f : 1.f / l);
  if (lse != nullptr && (threadIdx.x & 31) == 0)
    lse[at] = l == 0.f ? kNegInf : m + logf(l);
}

// dK, dV: one warp per (key row, batch * head).
template <class R, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_simt(Args a, T* __restrict__ dk, T* __restrict__ dv) {
  const int kpos = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  if (kpos >= a.L) return;
  const int L = a.L, D = a.D;
  const T* cb = static_cast<const T*>(a.cos_t);
  const T* sb = static_cast<const T*>(a.sin_t);
  const bool rope = cb != nullptr;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sd.b + h * a.sd.h;
  const long long tb = (long long)b * L * D;
  const T* ck = rope ? cb + tb + (long long)kpos * D : nullptr;
  const T* sk = rope ? sb + tb + (long long)kpos * D : nullptr;
  Slab slab = warp_slab(kDkvRows, a.chunks);
  R kr(slab), vr(slab), dka(slab), dva(slab), qr(slab), dor(slab);
  load_row<R, T>(kr, k + kpos * a.sk.l, D, false, 1.f, ck, sk);
  load_row<R, T>(vr, v + kpos * a.sv.l, D, false, 1.f, nullptr, nullptr);
  zero_row(dka);
  zero_row(dva);
  const bool key_ok =
      a.kv_mask == nullptr || a.kv_mask[(long long)b * L + kpos] != 0;
  for (int qpos = a.causal ? kpos : 0; key_ok && qpos < L; ++qpos) {
    const long long at = ((long long)b * L + qpos) * a.H + h;
    const float l_q = a.lse[at];
    if (!(l_q > 0.5f * kNegInf)) continue;  // the row saw no key
    load_row<R, T>(qr, q + qpos * a.sq.l, D, true, a.scale,
                   rope ? cb + tb + (long long)qpos * D : nullptr,
                   rope ? sb + tb + (long long)qpos * D : nullptr);
    load_row<R, T>(dor, dout + qpos * a.sd.l, D, false, 1.f, nullptr,
                   nullptr);
    const float p = expf(dot(qr, kr) - l_q);
    const float ds = round_to<T>(p * (dot(dor, vr) - a.delta[at]));
    const float pt = round_to<T>(p);
    axpy(dva, 1.f, pt, dor);
    axpy(dka, 1.f, ds, qr);
  }
  if (rope) unrotate<R, T>(dka, D, ck, sk);
  const long long o = (((long long)b * L + kpos) * a.H + h) * D;
  store_row<R, T>(dk + o, dka, D, 1.f);
  store_row<R, T>(dv + o, dva, D, 1.f);
}

// dQ in fp32, before the deferred scale: one warp per (query row,
// batch * head).
template <class R, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_simt(Args a, float* __restrict__ dq) {
  const int qpos = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  if (qpos >= a.L) return;
  const int L = a.L, D = a.D;
  const T* cb = static_cast<const T*>(a.cos_t);
  const T* sb = static_cast<const T*>(a.sin_t);
  const bool rope = cb != nullptr;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sd.b + h * a.sd.h;
  const long long tb = (long long)b * L * D;
  const long long at = ((long long)b * L + qpos) * a.H + h;
  const float l_q = a.lse[at];
  const float d_q = a.delta[at];
  const T* cq = rope ? cb + tb + (long long)qpos * D : nullptr;
  const T* sq = rope ? sb + tb + (long long)qpos * D : nullptr;
  Slab slab = warp_slab(kDqRows, a.chunks);
  R qr(slab), dor(slab), acc(slab), kr(slab), vr(slab);
  load_row<R, T>(qr, q + qpos * a.sq.l, D, true, a.scale, cq, sq);
  load_row<R, T>(dor, dout + qpos * a.sd.l, D, false, 1.f, nullptr,
                 nullptr);
  zero_row(acc);
  const int end = (l_q > 0.5f * kNegInf) ? (a.causal ? qpos + 1 : L) : 0;
  for (int kpos = 0; kpos < end; ++kpos) {
    if (a.kv_mask != nullptr && a.kv_mask[(long long)b * L + kpos] == 0)
      continue;
    load_row<R, T>(kr, k + kpos * a.sk.l, D, false, 1.f,
                   rope ? cb + tb + (long long)kpos * D : nullptr,
                   rope ? sb + tb + (long long)kpos * D : nullptr);
    load_row<R, T>(vr, v + kpos * a.sv.l, D, false, 1.f, nullptr, nullptr);
    const float p = expf(dot(qr, kr) - l_q);
    const float ds = round_to<T>(p * (dot(dor, vr) - d_q));
    axpy(acc, 1.f, ds, kr);
  }
  if (rope) unrotate<R, T>(acc, D, cq, sq);
  store_row<R, float>(dq + at * D, acc, D, 1.f);
}

// Launch `kernel` over the L rows of every (batch, head): kWarps warps a
// block for register rows; for shared-memory rows (kRows of them a warp)
// as many warps as kMaxSmem holds, up to kWarps.
template <class R, int kRows, typename Kernel, typename... Out>
int launch_rows(Kernel kernel, const Args& a, int B, cudaStream_t s,
                Out... out) {
  int warps = kWarps;
  size_t smem = 0;
  if constexpr (std::is_same<R, SmemRow>::value) {
    const size_t per_warp = (size_t)kRows * 64 * a.chunks * sizeof(float);
    warps = (int)(kMaxSmem / per_warp);
    if (warps < 1) return (int)cudaErrorInvalidValue;
    if (warps > kWarps) warps = kWarps;
    smem = warps * per_warp;
    // the block's own size each launch (a rare path: one attribute call)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.L + warps - 1) / warps, B * a.H);
  kernel<<<grid, 32 * warps, smem, s>>>(a, out...);
  return (int)cudaGetLastError();
}

template <class R, typename T>
int launch_fwd(const Args& a, int B, void* o, float* lse, cudaStream_t s) {
  return launch_rows<R, kFwdRows>(flash_fwd_simt<R, T>, a, B, s,
                                  static_cast<T*>(o), lse);
}

template <class R, typename T>
int launch_bwd(const Args& a, int B, float* dq, void* dk, void* dv,
               cudaStream_t s) {
  const int e = launch_rows<R, kDkvRows>(flash_bwd_dkdv_simt<R, T>, a, B, s,
                                         static_cast<T*>(dk),
                                         static_cast<T*>(dv));
  if (e != 0) return e;
  return launch_rows<R, kDqRows>(flash_bwd_dq_simt<R, T>, a, B, s, dq);
}

// Pairs a lane holds for head width D: ceil(D / 64), rounded up to 1, 2, 4
// or 8; 0 above D 512 (the shared-memory rows).
int pairs_of(int D) {
  const int p = (D / 2 + 31) / 32;
  return p <= 1 ? 1 : p <= 2 ? 2 : p <= 4 ? 4 : p <= 8 ? 8 : 0;
}

template <typename T>
int fwd_type(const Args& a, int B, void* o, float* lse, cudaStream_t s) {
  switch (pairs_of(a.D)) {
    case 1: return launch_fwd<RegRow<1>, T>(a, B, o, lse, s);
    case 2: return launch_fwd<RegRow<2>, T>(a, B, o, lse, s);
    case 4: return launch_fwd<RegRow<4>, T>(a, B, o, lse, s);
    case 8: return launch_fwd<RegRow<8>, T>(a, B, o, lse, s);
    default: return launch_fwd<SmemRow, T>(a, B, o, lse, s);
  }
}

template <typename T>
int bwd_type(const Args& a, int B, float* dq, void* dk, void* dv,
             cudaStream_t s) {
  switch (pairs_of(a.D)) {
    case 1: return launch_bwd<RegRow<1>, T>(a, B, dq, dk, dv, s);
    case 2: return launch_bwd<RegRow<2>, T>(a, B, dq, dk, dv, s);
    case 4: return launch_bwd<RegRow<4>, T>(a, B, dq, dk, dv, s);
    case 8: return launch_bwd<RegRow<8>, T>(a, B, dq, dk, dv, s);
    default: return launch_bwd<SmemRow, T>(a, B, dq, dk, dv, s);
  }
}

bool valid(int B, int L, int H, int D, int dtype) {
  return B > 0 && L > 0 && H > 0 && D > 0 && D % 8 == 0 && dtype >= 0 &&
         dtype <= 2;
}

}  // namespace

// q, k, v: (B, L, H, D) of type dtype (0 fp32, 1 bf16, 2 fp16), element
// strides (b, l, h), unit stride over D; D a multiple of 8 whose rows fit
// a block's shared memory.  kv_mask: (B, L) uint8 or null.  cos_t / sin_t: contiguous
// (B, L, D) tables of that type, or both null.  o: contiguous (B, L, H, D)
// of that type.  lse: contiguous (B, L, H) fp32 or null.  scale: the
// softmax scale rounded to the type.  Returns the cudaError_t of the
// launch.
extern "C" int apex_flash_fwd_simt(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* cos_t, const void* sin_t, void* o, void* lse, long long sqb,
    long long sql, long long sqh, long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh, int B, int L, int H, int D,
    float scale, int causal, int dtype, void* stream) {
  if (!valid(B, L, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, nullptr, nullptr, nullptr,
               static_cast<const uint8_t*>(kv_mask), cos_t, sin_t,
               Strides{sqb, sql, sqh}, Strides{skb, skl, skh},
               Strides{svb, svl, svh}, Strides{0, 0, 0}, H, L, D, scale,
               causal, (D + 63) / 64};
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_type<float>(a, B, o, lp, s);
  if (dtype == 1) return fwd_type<__nv_bfloat16>(a, B, o, lp, s);
  return fwd_type<__half>(a, B, o, lp, s);
}

// The forward's operands and do (strides sd), lse and delta = rowsum(o *
// do) - dlse (contiguous (B, L, H) fp32).  dq: contiguous (B, L, H, D)
// fp32, before the deferred scale; dk, dv: contiguous (B, L, H, D) of the
// operands' type.  Two launches (dk / dv, then dq).  Returns the
// cudaError_t of the launches.
extern "C" int apex_flash_bwd_simt(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask,
    const void* cos_t, const void* sin_t, void* dq, void* dk, void* dv,
    long long sqb, long long sql, long long sqh, long long skb,
    long long skl, long long skh, long long svb, long long svl,
    long long svh, long long sdb, long long sdl, long long sdh, int B, int L,
    int H, int D, float scale, int causal, int dtype, void* stream) {
  if (!valid(B, L, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const uint8_t*>(kv_mask), cos_t, sin_t,
               Strides{sqb, sql, sqh}, Strides{skb, skl, skh},
               Strides{svb, svl, svh}, Strides{sdb, sdl, sdh}, H, L, D,
               scale, causal, (D + 63) / 64};
  float* dqp = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_type<float>(a, B, dqp, dk, dv, s);
  if (dtype == 1) return bwd_type<__nv_bfloat16>(a, B, dqp, dk, dv, s);
  return bwd_type<__half>(a, B, dqp, dk, dv, s);
}
