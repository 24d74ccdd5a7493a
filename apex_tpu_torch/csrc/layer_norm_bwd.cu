// Layer-norm backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/layer_norm_kernels.py, `_backward` and its
// kernel `_bwd_kernel` (the Pallas backward of FusedLayerNorm).
//
// Computes, per row of x (n1, n2) with the forward's fp32 mean and inv:
// xhat = (x - mean) * inv, wdy = dy * w (dy without affine),
// dx = inv * (wdy - mean(wdy) - xhat * mean(wdy * xhat)) in fp32, stored in
// x's dtype; and, with an affine, dw = sum over rows of dy * xhat and
// db = sum over rows of dy in fp32, stored in w's dtype.
//
// What bounds it on the H100: bytes.  It reads dy and x and writes dx
// (3 * n1 * n2 * itemsize) plus the (n1,) statistics, at a few tens of
// flops per element, far under the ~295 flops per byte ridge.
//
// Design: the TPU kernel sums dw / db across its sequential grid into one
// output tile; blocks on Hopper run in no order, so the sums take the
// reference's two-stage split instead (cuComputePartGradGammaBeta /
// cuComputeGradGammaBeta).  Stage 1: each 128-thread block takes 32
// consecutive rows, one warp per row as in the forward (the row in
// registers, two shuffle reductions, dx written), while each lane adds its
// columns' dy * xhat and dy over the warp's 8 rows in registers; the four
// warps' sums then meet in shared memory in a fixed order and the block
// writes one fp32 partial row.  Stage 2 sums the partial rows of each
// column in a fixed order (eight strided chains, then a fixed tree) and
// casts to w's dtype.  No atomics: two runs give equal bits.  Rows wider
// than 32 * 32 take a loop variant: one warp per block, its partial row
// accumulated in place in device memory (no other warp touches it).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);  // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row held in registers: n2 <= 32 * VPL.
template <typename T, typename W, int VPL>
__global__ void __launch_bounds__(32 * kWarps)
ln_bwd_reg(const T* __restrict__ dy, const T* __restrict__ x,
           const W* __restrict__ w, const float* __restrict__ mean,
           const float* __restrict__ inv, T* __restrict__ dx,
           float* __restrict__ part_w, float* __restrict__ part_b, int n1,
           int n2) {
  __shared__ float red[kWarps][2][32 * VPL];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool affine = part_w != nullptr;
  float acc_w[VPL], acc_b[VPL], wv[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    acc_w[i] = acc_b[i] = 0.f;
    wv[i] = (w != nullptr && c < n2) ? to_f(w[c]) : 1.f;
  }
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + rr;
    if (row >= n1) break;
    const T* dyr = dy + (size_t)row * n2;
    const T* xr = x + (size_t)row * n2;
    const float mu = mean[row], iv = inv[row];
    float g[VPL], xh[VPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      const float d = c < n2 ? to_f(dyr[c]) : 0.f;
      xh[i] = c < n2 ? (to_f(xr[c]) - mu) * iv : 0.f;
      g[i] = d * wv[i];
      s1 += g[i];
      s2 += g[i] * xh[i];
      if (affine) {
        acc_w[i] += d * xh[i];
        acc_b[i] += d;
      }
    }
    const float m1 = warp_sum(s1) / (float)n2;
    const float m2 = warp_sum(s2) / (float)n2;
    T* dxr = dx + (size_t)row * n2;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < n2) dxr[c] = from_f<T>(iv * (g[i] - m1 - xh[i] * m2));
    }
  }
  if (!affine) return;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    red[warp][0][lane + 32 * i] = acc_w[i];
    red[warp][1][lane + 32 * i] = acc_b[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n2; c += 32 * kWarps) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) {  // fixed order
      sw += red[wp][0][c];
      sb += red[wp][1][c];
    }
    part_w[(size_t)blockIdx.x * n2 + c] = sw;
    part_b[(size_t)blockIdx.x * n2 + c] = sb;
  }
}

// Any width: one warp per block over kRowsPerWarp rows, three passes over
// each row (the later two from cache), the block's partial row kept in
// device memory.
template <typename T, typename W>
__global__ void __launch_bounds__(32)
ln_bwd_loop(const T* __restrict__ dy, const T* __restrict__ x,
            const W* __restrict__ w, const float* __restrict__ mean,
            const float* __restrict__ inv, T* __restrict__ dx,
            float* __restrict__ part_w, float* __restrict__ part_b, int n1,
            int n2) {
  const int lane = threadIdx.x;
  const bool affine = part_w != nullptr;
  float* pw = affine ? part_w + (size_t)blockIdx.x * n2 : nullptr;
  float* pb = affine ? part_b + (size_t)blockIdx.x * n2 : nullptr;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = blockIdx.x * kRowsPerWarp + rr;
    if (row >= n1) break;
    const T* dyr = dy + (size_t)row * n2;
    const T* xr = x + (size_t)row * n2;
    const float mu = mean[row], iv = inv[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < n2; c += 32) {
      const float d = to_f(dyr[c]);
      const float xh = (to_f(xr[c]) - mu) * iv;
      const float g = d * (w != nullptr ? to_f(w[c]) : 1.f);
      s1 += g;
      s2 += g * xh;
      if (affine) {
        pw[c] = (rr == 0 ? 0.f : pw[c]) + d * xh;
        pb[c] = (rr == 0 ? 0.f : pb[c]) + d;
      }
    }
    const float m1 = warp_sum(s1) / (float)n2;
    const float m2 = warp_sum(s2) / (float)n2;
    T* dxr = dx + (size_t)row * n2;
    for (int c = lane; c < n2; c += 32) {
      const float xh = (to_f(xr[c]) - mu) * iv;
      const float g = to_f(dyr[c]) * (w != nullptr ? to_f(w[c]) : 1.f);
      dxr[c] = from_f<T>(iv * (g - m1 - xh * m2));
    }
  }
}

// Stage 2: dw, db (n2,) in W from `parts` partial rows.  Block: 32 columns
// x 8 chains; chain t sums rows t, t + 8, ...; the chains then add in a
// fixed order.
template <typename W>
__global__ void __launch_bounds__(256)
ln_bwd_final(const float* __restrict__ part_w,
             const float* __restrict__ part_b, W* __restrict__ dw,
             W* __restrict__ db, int parts, int n2) {
  __shared__ float sw[8][33], sb[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float aw = 0.f, ab = 0.f;
  if (c < n2) {
    for (int r = ty; r < parts; r += 8) {
      aw += part_w[(size_t)r * n2 + c];
      ab += part_b[(size_t)r * n2 + c];
    }
  }
  sw[ty][tx] = aw;
  sb[ty][tx] = ab;
  __syncthreads();
  if (ty == 0 && c < n2) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      tw += sw[t][tx];
      tb += sb[t][tx];
    }
    dw[c] = from_f<W>(tw);
    db[c] = from_f<W>(tb);
  }
}

template <typename T, typename W>
int launch(const void* dy, const void* x, const void* w, const float* mean,
           const float* inv, void* dx, void* dw, void* db, float* part_w,
           float* part_b, int n1, int n2, cudaStream_t stream) {
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* dxp = static_cast<T*>(dx);
  const int vpl = (n2 + 31) / 32;
  int parts;
  if (vpl <= 32) {
    parts = (n1 + kRowsPerBlock - 1) / kRowsPerBlock;
    const dim3 grid(parts), block(32 * kWarps);
#define APEX_LN_BWD(N)                                                     \
  ln_bwd_reg<T, W, N><<<grid, block, 0, stream>>>(dyp, xp, wp, mean, inv, \
                                                   dxp, part_w, part_b, n1, \
                                                   n2)
    if (vpl <= 2) APEX_LN_BWD(2);
    else if (vpl <= 4) APEX_LN_BWD(4);
    else if (vpl <= 8) APEX_LN_BWD(8);
    else if (vpl <= 16) APEX_LN_BWD(16);
    else if (vpl <= 24) APEX_LN_BWD(24);
    else APEX_LN_BWD(32);
#undef APEX_LN_BWD
  } else {
    parts = (n1 + kRowsPerWarp - 1) / kRowsPerWarp;
    ln_bwd_loop<T, W><<<parts, 32, 0, stream>>>(dyp, xp, wp, mean, inv, dxp,
                                                part_w, part_b, n1, n2);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part_w == nullptr) return (int)e;
  ln_bwd_final<W><<<(n2 + 31) / 32, 256, 0, stream>>>(
      part_w, part_b, static_cast<W*>(dw), static_cast<W*>(db), parts, n2);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of fp32 partials stage 1 writes for (n1, n2): the caller allocates
// two (rows, n2) fp32 scratch buffers.
extern "C" int apex_layer_norm_bwd_parts(int n1, int n2) {
  if ((n2 + 31) / 32 <= 32) return (n1 + kRowsPerBlock - 1) / kRowsPerBlock;
  return (n1 + kRowsPerWarp - 1) / kRowsPerWarp;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  dy, x, dx:
// contiguous (n1, n2) in x_dtype; mean, inv: (n1,) fp32.  w null = no affine (dw, db, part_w,
// part_b null too); otherwise w, dw, db are (n2,) in w_dtype (float32 or
// x's) and part_w / part_b are the scratch of apex_layer_norm_bwd_parts.
// Returns the cudaError_t of the launches.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* w, const void* mean,
                                   const void* inv, void* dx, void* dw,
                                   void* db, void* part_w, void* part_b,
                                   int n1, int n2, int x_dtype, int w_dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  float* pw = static_cast<float*>(part_w);
  float* pb = static_cast<float*>(part_b);
  if (n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  if ((w == nullptr) != (pw == nullptr)) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(dy, x, w, m, iv, dx, dw, db, pw, pb, n1, n2,
                                s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(dy, x, w, m, iv, dx, dw, db,
                                                 pw, pb, n1, n2, s);
  if (x_dtype == 2 && w_dtype == 2)
    return launch<__half, __half>(dy, x, w, m, iv, dx, dw, db, pw, pb, n1,
                                  n2, s);
  if (x_dtype == 2 && w_dtype == 0)
    return launch<__half, float>(dy, x, w, m, iv, dx, dw, db, pw, pb, n1, n2,
                                 s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(dy, x, w, m, iv, dx, dw, db, pw, pb,
                                        n1, n2, s);
  return (int)cudaErrorInvalidValue;
}
