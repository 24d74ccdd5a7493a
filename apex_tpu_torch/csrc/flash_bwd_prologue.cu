// The prologue of the Hopper flash kernels (sm_90a): of the two-pass
// backward (K13, K14: q^ and k^) and of the forward (K2: k^ alone, q being
// rotated in the forward's own shared memory), once per call, with a plain
// C interface.
//
// TMA copies bytes and cannot rotate, so those kernels read operands that
// are already what their score product sees: q^ = q pre-scaled in its
// storage type T, bf16 or fp16 (the scale rounded to T, the product
// rounded) and then, with rope tables, rotated in fp32 and rounded to T;
// k^ = k rotated likewise.  This is the arithmetic the TPU kernels
// (`_fwd_kernel`, `_dq_kernel`, `_dkv_kernel`) apply to every tile they
// load, done once for the call instead of once per tile pair:
// element (c, c + D / 2) pairs rotate as
//   lo' = lo * cos[c] + hi * sin[c],  hi' = hi * cos[c + D/2] + lo * sin[..]
// with `sin` the signed full-width table, each product and the sum rounded
// on their own (__fmul_rn / __fadd_rn), as the plain version
// (`_scaled_rotated`) computes it.  Without tables only q is written (k^ is
// k), and the wrapper launches nothing when the scale is also 1; without
// a q^ buffer only k^ is written.
//
// What bounds it on the H100: bytes (read q, k and the tables, write q^ and
// k^; a few operations an element).  Each thread moves V-element chunks of
// the two halves of a row with 8- or 16-byte accesses.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using apex_fa::from_f32;
using apex_fa::rot1;
using apex_fa::Strides;
using apex_fa::to_f32;

template <int V, typename T>
struct alignas(2 * V) Chunk {
  T x[V];
};

template <int V, typename T>
__device__ __forceinline__ void rotate(Chunk<V, T>& lo, Chunk<V, T>& hi,
                                       const Chunk<V, T>& cl,
                                       const Chunk<V, T>& ch,
                                       const Chunk<V, T>& sl,
                                       const Chunk<V, T>& sh) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xl = to_f32(lo.x[j]);
    const float xh = to_f32(hi.x[j]);
    lo.x[j] = from_f32<T>(rot1(xl, xh, to_f32(cl.x[j]), to_f32(sl.x[j])));
    hi.x[j] = from_f32<T>(rot1(xh, xl, to_f32(ch.x[j]), to_f32(sh.x[j])));
  }
}

// One thread per (row (b, l, h), chunk of V columns of the first half).
template <int V, typename T>
__global__ void __launch_bounds__(256)
flash_bwd_prologue(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                   T* __restrict__ qh, T* __restrict__ kh, Strides sq,
                   Strides sk, int L, int H, int D, float scale,
                   long long items) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= items) return;
  const int hd = D / 2;
  const int per_row = hd / V;
  const long long row = i / per_row;
  const int c = (int)(i % per_row) * V;
  const int h = (int)(row % H);
  const long long bl = row / H;
  const int l = (int)(bl % L);
  const int b = (int)(bl / L);
  using C = Chunk<V, T>;
  C cl, ch, sl, sh;
  if (cos_t != nullptr) {
    const long long t = bl * D;  // (b, l) row of the (B, L, D) tables
    cl = *reinterpret_cast<const C*>(cos_t + t + c);
    ch = *reinterpret_cast<const C*>(cos_t + t + c + hd);
    sl = *reinterpret_cast<const C*>(sin_t + t + c);
    sh = *reinterpret_cast<const C*>(sin_t + t + c + hd);
  }
  const long long out = row * D + c;
  C lo, hi;
  if (qh != nullptr) {
    const T* qr = q + b * sq.b + l * sq.l + h * sq.h + c;
    lo = *reinterpret_cast<const C*>(qr);
    hi = *reinterpret_cast<const C*>(qr + hd);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      lo.x[j] = from_f32<T>(to_f32(lo.x[j]) * scale);
      hi.x[j] = from_f32<T>(to_f32(hi.x[j]) * scale);
    }
    if (cos_t != nullptr) rotate(lo, hi, cl, ch, sl, sh);
    *reinterpret_cast<C*>(qh + out) = lo;
    *reinterpret_cast<C*>(qh + out + hd) = hi;
  }
  if (kh == nullptr) return;
  const T* kr = k + b * sk.b + l * sk.l + h * sk.h + c;
  lo = *reinterpret_cast<const C*>(kr);
  hi = *reinterpret_cast<const C*>(kr + hd);
  rotate(lo, hi, cl, ch, sl, sh);
  *reinterpret_cast<C*>(kh + out) = lo;
  *reinterpret_cast<C*>(kh + out + hd) = hi;
}

template <int V, typename T>
int launch(const void* q, const void* k, const void* cos_t,
           const void* sin_t, void* qh, void* kh, Strides sq, Strides sk,
           int B, int L, int H, int D, float scale, cudaStream_t stream) {
  const long long items = (long long)B * L * H * (D / 2 / V);
  const int threads = 256;
  const long long blocks = (items + threads - 1) / threads;
  flash_bwd_prologue<V, T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(cos_t), static_cast<const T*>(sin_t),
      static_cast<T*>(qh), static_cast<T*>(kh), sq, sk, L, H, D, scale,
      items);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_type(const void* q, const void* k, const void* cos_t,
                const void* sin_t, void* qh, void* kh, Strides sq, Strides sk,
                int B, int L, int H, int D, float scale, cudaStream_t s) {
  if ((D / 2) % 8 == 0)
    return launch<8, T>(q, k, cos_t, sin_t, qh, kh, sq, sk, B, L, H, D, scale,
                        s);
  return launch<4, T>(q, k, cos_t, sin_t, qh, kh, sq, sk, B, L, H, D, scale,
                      s);
}

}  // namespace

// q, k: (B, L, H, D) of type dtype (1 bf16, 2 fp16), element strides
// (b, l, h), unit stride over D, rows on 16-byte boundaries; D a multiple
// of 8 up to 128.  cos_t / sin_t: contiguous (B, L, D) tables of that type,
// or both null.  qh: contiguous (B, L, H, D), written with q^, or null (q
// is not read).  kh: contiguous (B, L, H, D), written with k^ when tables
// are given (else null and k is not read).  scale: the softmax scale
// rounded to the type.  Returns the cudaError_t of the launch.
extern "C" int apex_flash_bwd_prologue(
    const void* q, const void* k, const void* cos_t, const void* sin_t,
    void* qh, void* kh, long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh, int B, int L, int H, int D,
    float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D % 8 != 0 || D <= 0 || D > 128 ||
      (cos_t == nullptr) != (kh == nullptr) ||
      (qh == nullptr && kh == nullptr) || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return launch_type<__half>(q, k, cos_t, sin_t, qh, kh, sq, sk, B, L, H, D,
                               scale, s);
  return launch_type<__nv_bfloat16>(q, k, cos_t, sin_t, qh, kh, sq, sk, B, L,
                                    H, D, scale, s);
}
