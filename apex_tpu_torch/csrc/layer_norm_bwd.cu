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
// Design.  The TPU kernel sums dw / db across its sequential grid into one
// output tile; blocks on Hopper run in no order, so the sums take two
// stages.  Stage 1 writes dx and one fp32 partial row pair per block;
// stage 2 adds the partial rows of each column in a fixed order and casts
// to w's dtype.  No atomics: two runs give equal bits.  Rows move as
// groups of V = 16 / sizeof(T) consecutive elements (8 bf16 / fp16, 4
// fp32), each one 16-byte access where the pointers and n2 allow it (`VEC`),
// else V element accesses masked at n2 (K1's layout, layer_norm_common.cuh).
// A thread keeps its groups of dy and x as raw 16-byte words between the
// two passes over a row (the row sums, then dx), and adds its columns'
// terms dy * xhat and dy in fp32 over all of its rows.  Python picks one of
// three routes (`ln_bwd_route` in ops/cuda/layer_norm.py):
//   warp   rows of up to 1024 16-bit or 768 fp32 elements: one warp a row
//          (the lane's groups lane + 32 i), eight warps a block,
//          three blocks an SM, each warp walking rows in a fixed stride, so
//          396 partial rows on 132 SMs whatever n1 (2.4 MB at 768
//          columns).  A warp's column sums live in its own two rows of
//          shared memory, not in registers: that is what lets three blocks
//          (24 warps, 24 rows in flight) share an SM, where sums held in
//          registers allowed two.  The block adds its warps' rows in warp
//          order;
//   block  few rows (n1 <= 64) or rows of up to 8192 elements: one row a
//          block of up to 512 threads (groups t + blockDim i), the row
//          sums through shared memory, a block per SM walking rows in a
//          fixed stride; each thread writes its own columns' partials;
//   loop   wider rows: one warp a block over 8 rows, three passes a row,
//          the partial row summed in place in device memory.
// Stage 2 spreads the columns over blocks of 16: 32 chains a column (a
// chain takes every 32nd partial row, in order, 16-byte loads where n2
// allows), then a fixed tree over the chains.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "layer_norm_common.cuh"

namespace {

using namespace apex_ln;

constexpr int kWarps = 8;              // warp route: rows in flight a block
constexpr int kMaxElems = 32;          // elements a thread holds (NG * V)
constexpr int kBlockThreadsMax = 512;  // block route
constexpr int kRowsPerWarpLoop = 8;    // loop route
constexpr int kWarpBlocksPerSm = 3;
// the warp route's column sums, kWarps x 2 rows of up to 1024 floats
constexpr size_t kWarpSmemMax = (size_t)kWarps * 2 * kMaxElems * 32 * 4;
constexpr int kFinalCols = 16;         // stage 2: columns a block
constexpr int kChains = 32;            // stage 2: chains a column

struct Args {
  const void* dy;
  const void* x;
  const void* w;  // null: no affine (part_w, part_b null too)
  const float* mean;
  const float* inv;
  void* dx;
  float* part_w;
  float* part_b;
  int n1;
  int n2;
};

// A group of V elements of T at p as one raw 16-byte word: one load when
// VEC, else element loads masked at `valid` (the rest zero).
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ p, int valid) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    constexpr int V = 16 / (int)sizeof(T);
    T e[V];
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = k < valid ? p[k] : from_f<T>(0.f);
    uint4 r;
    memcpy(&r, e, 16);
    return r;
  }
}

// V fp32 values at p: 16-byte stores when VEC, else masked at `valid`.
template <int V, bool VEC>
__device__ __forceinline__ void store_f32(float* p, int valid,
                                          const float (&v)[V]) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < valid) p[k] = v[k];
  }
}

// V fp32 values from p: 16-byte loads when VEC, else masked at `valid`.
template <int V, bool VEC>
__device__ __forceinline__ void load_f32(const float* p, int valid,
                                         float (&v)[V]) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = k < valid ? p[k] : 0.f;
  }
}

// One group's share of a row's two sums (s1 = sum wdy, s2 = sum wdy xhat)
// and its terms of the columns' sums (tw = dy xhat, tb = dy).  Elements
// past n2 read as zero and add nothing.
template <typename T, typename W, int V, bool VEC>
__device__ __forceinline__ void group_sums(uint4 rd, uint4 rx, const W* w,
                                          int c, int valid, float mu,
                                          float iv, float& s1, float& s2,
                                          float (&tw)[V], float (&tb)[V]) {
  float d[V], xh[V], wv[V];
  unpack16(rd, d, (T*)nullptr);
  unpack16(rx, xh, (T*)nullptr);
  if (w != nullptr) {
    load_group<W, V, VEC>(w + c, valid, wv);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) wv[k] = 1.f;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    xh[k] = (xh[k] - mu) * iv;
    const float g = d[k] * wv[k];
    s1 += g;
    s2 += g * xh[k];
    tw[k] = d[k] * xh[k];
    tb[k] = d[k];
  }
}

// One group of dx from its raw words and the row's two means.
template <typename T, typename W, int V, bool VEC>
__device__ __forceinline__ void group_dx(uint4 rd, uint4 rx, const W* w,
                                        int c, int valid, float mu, float iv,
                                        float m1, float m2, T* dxr) {
  float d[V], xh[V], wv[V];
  unpack16(rd, d, (T*)nullptr);
  unpack16(rx, xh, (T*)nullptr);
  if (w != nullptr) {
    load_group<W, V, VEC>(w + c, valid, wv);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) wv[k] = 1.f;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float xhat = (xh[k] - mu) * iv;
    d[k] = iv * (d[k] * wv[k] - m1 - xhat * m2);
  }
  store_group<T, V, VEC>(dxr + c, valid, d);
}

// Warp route: one warp a row, NG groups a lane.  With an affine each warp
// keeps its columns' sums in its own two rows of shared memory (`sums`,
// kWarps x 2 x n2 floats; a lane's columns are its own), not in
// registers, so that kWarpBlocksPerSm blocks fit an SM; at the end the
// block adds its warps' rows in warp order, column by column.
template <typename T, typename W, int NG, bool VEC>
__global__ void __launch_bounds__(32 * kWarps, kWarpBlocksPerSm)
ln_bwd_warp(Args a) {
  constexpr int V = 16 / (int)sizeof(T);
  static_assert(NG * V <= kMaxElems, "a lane holds at most 32 elements");
  extern __shared__ __align__(16) float sums[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n2 = a.n2;
  const T* dy = static_cast<const T*>(a.dy);
  const T* x = static_cast<const T*>(a.x);
  const W* w = static_cast<const W*>(a.w);
  float* sw = sums + (size_t)warp * 2 * n2;
  float* sb = sw + n2;
  if (w != nullptr)
    for (int c = lane; c < n2; c += 32) sw[c] = sb[c] = 0.f;
  __syncwarp();
  for (int row = blockIdx.x * kWarps + warp; row < a.n1;
       row += gridDim.x * kWarps) {
    const T* dyr = dy + (size_t)row * n2;
    const T* xr = x + (size_t)row * n2;
    uint4 rd[NG], rx[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = (lane + 32 * i) * V;
      rd[i] = rx[i] = make_uint4(0u, 0u, 0u, 0u);
      if (c < n2) {
        rd[i] = load_raw<T, VEC>(dyr + c, n2 - c);
        rx[i] = load_raw<T, VEC>(xr + c, n2 - c);
      }
    }
    const float mu = a.mean[row], iv = a.inv[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = (lane + 32 * i) * V;
      if (c < n2) {
        float tw[V], tb[V], aw[V], ab[V];
        group_sums<T, W, V, VEC>(rd[i], rx[i], w, c, n2 - c, mu, iv, s1, s2,
                                 tw, tb);
        if (w != nullptr) {
          load_f32<V, VEC>(sw + c, n2 - c, aw);
          load_f32<V, VEC>(sb + c, n2 - c, ab);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            aw[k] += tw[k];
            ab[k] += tb[k];
          }
          store_f32<V, VEC>(sw + c, n2 - c, aw);
          store_f32<V, VEC>(sb + c, n2 - c, ab);
        }
      }
    }
    const float m1 = warp_sum(s1) / (float)n2;
    const float m2 = warp_sum(s2) / (float)n2;
    T* dxr = static_cast<T*>(a.dx) + (size_t)row * n2;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = (lane + 32 * i) * V;
      if (c < n2)
        group_dx<T, W, V, VEC>(rd[i], rx[i], w, c, n2 - c, mu, iv, m1, m2,
                               dxr);
    }
  }
  if (w == nullptr) return;
  __syncthreads();
  float* pw = a.part_w + (size_t)blockIdx.x * n2;
  float* pb = a.part_b + (size_t)blockIdx.x * n2;
  for (int c = threadIdx.x; c < n2; c += 32 * kWarps) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {  // the warps in order
      tw += sums[(size_t)k * 2 * n2 + c];
      tb += sums[(size_t)k * 2 * n2 + n2 + c];
    }
    pw[c] = tw;
    pb[c] = tb;
  }
}

// Block route: one row a block, NG groups a thread (group t + blockDim i);
// each thread's columns are its own, so its sums are the block's.
template <typename T, typename W, int NG, bool VEC>
__global__ void __launch_bounds__(kBlockThreadsMax)
ln_bwd_block(Args a) {
  constexpr int V = 16 / (int)sizeof(T);
  static_assert(NG * V <= kMaxElems, "a thread holds at most 32 elements");
  __shared__ float red[2][2][32];  // by row parity: s1, s2 of each warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (int)(blockDim.x >> 5);
  const int n2 = a.n2;
  const T* dy = static_cast<const T*>(a.dy);
  const T* x = static_cast<const T*>(a.x);
  const W* w = static_cast<const W*>(a.w);
  float aw[NG][V], ab[NG][V];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k) aw[i][k] = ab[i][k] = 0.f;
  int par = 0;
  for (int row = blockIdx.x; row < a.n1; row += gridDim.x, par ^= 1) {
    const T* dyr = dy + (size_t)row * n2;
    const T* xr = x + (size_t)row * n2;
    uint4 rd[NG], rx[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = (threadIdx.x + blockDim.x * i) * V;
      rd[i] = rx[i] = make_uint4(0u, 0u, 0u, 0u);
      if (c < n2) {
        rd[i] = load_raw<T, VEC>(dyr + c, n2 - c);
        rx[i] = load_raw<T, VEC>(xr + c, n2 - c);
      }
    }
    const float mu = a.mean[row], iv = a.inv[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = (threadIdx.x + blockDim.x * i) * V;
      if (c < n2) {
        float tw[V], tb[V];
        group_sums<T, W, V, VEC>(rd[i], rx[i], w, c, n2 - c, mu, iv, s1, s2,
                                 tw, tb);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          aw[i][k] += tw[k];
          ab[i][k] += tb[k];
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[par][0][warp] = s1;
      red[par][1][warp] = s2;
    }
    __syncthreads();
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < nw; ++i) {  // the warps in order
      t1 += red[par][0][i];
      t2 += red[par][1][i];
    }
    const float m1 = t1 / (float)n2, m2 = t2 / (float)n2;
    T* dxr = static_cast<T*>(a.dx) + (size_t)row * n2;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = (threadIdx.x + blockDim.x * i) * V;
      if (c < n2)
        group_dx<T, W, V, VEC>(rd[i], rx[i], w, c, n2 - c, mu, iv, m1, m2,
                               dxr);
    }
  }
  if (w == nullptr) return;
  float* pw = a.part_w + (size_t)blockIdx.x * n2;
  float* pb = a.part_b + (size_t)blockIdx.x * n2;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = (threadIdx.x + blockDim.x * i) * V;
    if (c < n2) {
      store_f32<V, VEC>(pw + c, n2 - c, aw[i]);
      store_f32<V, VEC>(pb + c, n2 - c, ab[i]);
    }
  }
}

// Loop route, any width: one warp a block over kRowsPerWarpLoop rows,
// three passes over each row (the later two from cache), the block's
// partial row summed in device memory (no other warp touches it).
template <typename T, typename W>
__global__ void __launch_bounds__(32)
ln_bwd_loop(Args a) {
  const int lane = threadIdx.x;
  const int n2 = a.n2;
  const T* dy = static_cast<const T*>(a.dy);
  const T* x = static_cast<const T*>(a.x);
  const W* w = static_cast<const W*>(a.w);
  const bool affine = w != nullptr;
  float* pw = affine ? a.part_w + (size_t)blockIdx.x * n2 : nullptr;
  float* pb = affine ? a.part_b + (size_t)blockIdx.x * n2 : nullptr;
  for (int rr = 0; rr < kRowsPerWarpLoop; ++rr) {
    const int row = blockIdx.x * kRowsPerWarpLoop + rr;
    if (row >= a.n1) break;
    const T* dyr = dy + (size_t)row * n2;
    const T* xr = x + (size_t)row * n2;
    const float mu = a.mean[row], iv = a.inv[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < n2; c += 32) {
      const float d = to_f(dyr[c]);
      const float xh = (to_f(xr[c]) - mu) * iv;
      const float g = d * (affine ? to_f(w[c]) : 1.f);
      s1 += g;
      s2 += g * xh;
      if (affine) {
        pw[c] = (rr == 0 ? 0.f : pw[c]) + d * xh;
        pb[c] = (rr == 0 ? 0.f : pb[c]) + d;
      }
    }
    const float m1 = warp_sum(s1) / (float)n2;
    const float m2 = warp_sum(s2) / (float)n2;
    T* dxr = static_cast<T*>(a.dx) + (size_t)row * n2;
    for (int c = lane; c < n2; c += 32) {
      const float xh = (to_f(xr[c]) - mu) * iv;
      const float g = to_f(dyr[c]) * (affine ? to_f(w[c]) : 1.f);
      dxr[c] = from_f<T>(iv * (g - m1 - xh * m2));
    }
  }
}

// Stage 2: dw, db (n2,) in W from `parts` partial rows.  A block of 128
// threads takes kFinalCols columns: thread (chain, group) sums rows chain,
// chain + kChains, ... of the group's 4 columns (16-byte loads when n2 is a
// multiple of 4), then the chains meet in a fixed tree: shuffles over the
// warp's 8 chains, then the 4 warps in order.
template <typename W>
__global__ void __launch_bounds__(128)
ln_bwd_final(const float* __restrict__ part_w,
             const float* __restrict__ part_b, W* __restrict__ dw,
             W* __restrict__ db, int parts, int n2) {
  __shared__ float sm[2][4][kFinalCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane & 3, chain = warp * 8 + (lane >> 2);
  const int c0 = blockIdx.x * kFinalCols + 4 * g;
  float aw[4] = {0.f, 0.f, 0.f, 0.f}, ab[4] = {0.f, 0.f, 0.f, 0.f};
  if (n2 % 4 == 0 && c0 < n2) {
#pragma unroll 4
    for (int r = chain; r < parts; r += kChains) {
      const float4 vw =
          __ldcg(reinterpret_cast<const float4*>(part_w + (size_t)r * n2 + c0));
      const float4 vb =
          __ldcg(reinterpret_cast<const float4*>(part_b + (size_t)r * n2 + c0));
      aw[0] += vw.x;
      aw[1] += vw.y;
      aw[2] += vw.z;
      aw[3] += vw.w;
      ab[0] += vb.x;
      ab[1] += vb.y;
      ab[2] += vb.z;
      ab[3] += vb.w;
    }
  } else {
    for (int r = chain; r < parts; r += kChains)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < n2) {
          aw[k] += __ldcg(part_w + (size_t)r * n2 + c0 + k);
          ab[k] += __ldcg(part_b + (size_t)r * n2 + c0 + k);
        }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      aw[k] += __shfl_xor_sync(0xffffffffu, aw[k], o);
      ab[k] += __shfl_xor_sync(0xffffffffu, ab[k], o);
    }
  if (lane < 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sm[0][warp][4 * g + k] = aw[k];
      sm[1][warp][4 * g + k] = ab[k];
    }
  }
  __syncthreads();
  const int c = blockIdx.x * kFinalCols + threadIdx.x;
  if (threadIdx.x < kFinalCols && c < n2) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      tw += sm[0][q][threadIdx.x];
      tb += sm[1][q][threadIdx.x];
    }
    dw[c] = from_f<W>(tw);
    db[c] = from_f<W>(tb);
  }
}

// route codes, as ops/cuda/layer_norm.py numbers them
constexpr int kRouteWarp = 0, kRouteBlock = 1, kRouteLoop = 2;

// Groups a thread holds on the block route and its threads (a warp's
// multiple), for groups of 16 bytes over n2.
void block_shape(int groups, int* ng, int* threads) {
  *ng = groups <= kBlockThreadsMax ? 1 : groups <= 2 * kBlockThreadsMax ? 2 : 4;
  *threads = ((groups + *ng - 1) / *ng + 31) / 32 * 32;
}

// Stage 1's blocks, which is the number of partial rows.
int stage1_blocks(int n1, int route) {
  if (route == kRouteLoop)
    return (n1 + kRowsPerWarpLoop - 1) / kRowsPerWarpLoop;
  const int sms = apex_fa::sm_count();
  if (route == kRouteBlock) return n1 < sms ? n1 : sms;
  const int want = (n1 + kWarps - 1) / kWarps;
  const int cap = kWarpBlocksPerSm * sms;
  return want < cap ? want : cap;
}

template <typename T, typename W, bool VEC>
int launch(const Args& a, int route, void* dw, void* db, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int kMaxNg = kMaxElems / V;
  const int groups = (a.n2 + V - 1) / V;
  const int blocks = stage1_blocks(a.n1, route);
  if (route == kRouteWarp) {
    // at most 32 16-bit or 24 fp32 elements a lane: 8 fp32 groups spilled
    // at the register budget of three blocks an SM
    constexpr int kWarpNg = V == 4 ? 6 : kMaxNg;
    const int per_lane = (groups + 31) / 32;
    if (per_lane > kWarpNg) return (int)cudaErrorInvalidValue;
    void (*k)(Args) =
        per_lane <= 1   ? ln_bwd_warp<T, W, 1, VEC>
        : per_lane <= 2 ? ln_bwd_warp<T, W, 2, VEC>
        : per_lane <= 3 ? ln_bwd_warp<T, W, 3, VEC>
                        : ln_bwd_warp<T, W, kWarpNg, VEC>;
    const size_t smem =
        a.w != nullptr ? (size_t)kWarps * 2 * a.n2 * sizeof(float) : 0;
    if (smem > 48 * 1024) {
      // once a device and instantiation: the call's host path is short
      static unsigned configured[4] = {0, 0, 0, 0};
      const cudaError_t e = apex_fa::opt_in_smem(
          k, kWarpSmemMax,
          &configured[per_lane <= 1 ? 0 : per_lane <= 2 ? 1
                      : per_lane <= 3 ? 2 : 3]);
      if (e != cudaSuccess) return (int)e;
    }
    k<<<blocks, 32 * kWarps, smem, stream>>>(a);
  } else if (route == kRouteBlock) {
    int ng, threads;
    block_shape(groups, &ng, &threads);
    if (threads > kBlockThreadsMax || ng > kMaxNg)
      return (int)cudaErrorInvalidValue;
    const dim3 grid(blocks), block(threads);
    if (ng == 1) {
      ln_bwd_block<T, W, 1, VEC><<<grid, block, 0, stream>>>(a);
    } else if (ng == 2) {
      ln_bwd_block<T, W, 2, VEC><<<grid, block, 0, stream>>>(a);
    } else if constexpr (V == 4) {  // fp32: at most 8192 elements a row
      ln_bwd_block<T, W, 4, VEC><<<grid, block, 0, stream>>>(a);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else if (route == kRouteLoop) {
    ln_bwd_loop<T, W><<<blocks, 32, 0, stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.part_w == nullptr) return (int)e;
  ln_bwd_final<W><<<(a.n2 + kFinalCols - 1) / kFinalCols, 128, 0, stream>>>(
      a.part_w, a.part_b, static_cast<W*>(dw), static_cast<W*>(db), blocks,
      a.n2);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch_vec(const Args& a, int route, bool vec, void* dw, void* db,
               cudaStream_t stream) {
  return vec ? launch<T, W, true>(a, route, dw, db, stream)
             : launch<T, W, false>(a, route, dw, db, stream);
}

}  // namespace

// Partial rows stage 1 writes for (n1, n2) on `mode`'s route (the mode
// word below): the caller allocates two (rows, n2) fp32 scratch buffers.
extern "C" int apex_layer_norm_bwd_parts(int n1, int n2, int mode) {
  if (n1 <= 0 || n2 <= 0) return 0;
  return stage1_blocks(n1, (mode >> 4) & 3);
}

// mode, one int: x's dtype (bits 0-1: 0 = float32, 1 = bfloat16,
// 2 = float16), w's (bits 2-3: float32 or x's), the route (bits 4-5: 0 warp,
// 1 block, 2 loop) and bit 6: 16-byte accesses (the caller checked that
// dy, x, dx and w are 16-byte aligned and n2 a multiple of 16 / itemsize).
// dy, x, dx: contiguous (n1, n2) in x's dtype; mean, inv: (n1,) fp32.
// w null = no affine (dw, db, part_w, part_b null too); otherwise w, dw, db
// are (n2,) in w's dtype and part_w / part_b the scratch of
// apex_layer_norm_bwd_parts.  Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for a route the row does not fit).
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* w, const void* mean,
                                   const void* inv, void* dx, void* dw,
                                   void* db, void* part_w, void* part_b,
                                   int n1, int n2, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  if ((w == nullptr) != (part_w == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{dy, x, w, static_cast<const float*>(mean),
               static_cast<const float*>(inv), dx,
               static_cast<float*>(part_w), static_cast<float*>(part_b), n1,
               n2};
  const int x_dtype = mode & 3, w_dtype = (mode >> 2) & 3;
  const int route = (mode >> 4) & 3;
  const bool vec = (mode >> 6) & 1;
  if (x_dtype == 0 && w_dtype == 0)
    return launch_vec<float, float>(a, route, vec, dw, db, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(a, route, vec, dw, db, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(a, route, vec, dw, db, s);
  if (x_dtype == 2 && w_dtype == 2)
    return launch_vec<__half, __half>(a, route, vec, dw, db, s);
  if (x_dtype == 2 && w_dtype == 0)
    return launch_vec<__half, float>(a, route, vec, dw, db, s);
  return (int)cudaErrorInvalidValue;
}
