// K18, the fused multi-head flash-attention backward for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/experimental/flash_mh.py, `_mh_bwd_fused`
// and its kernel `_bwd_fused_kernel` (the backward of `flash_attention_mh`
// while its dq partial planes fit the budget; above it the wrapper takes the
// two-pass kernels K13 / K14 on strided views, as `_mh_bwd_rule` does).
//
// Computes, for (B, L, H, D) bf16 or fp16 (the same code instantiated on
// __half; "bf16" below stands for the storage type) q, k, v, do read as
// (B, L, H * D) through the caller's strides, the forward's lse (B, L, H) fp32 and delta =
// rowsum(o * do) - dlse (B, L, H) fp32 (computed outside, as the TPU path
// leaves it to XLA), with q pre-scaled by `scale` in bf16:
//   P = exp(S - lse) (zero where causality, the key mask, a ragged L or an
//   empty row hides the pair), dV = P^T dO, dP = dO V^T,
//   dS = P * (dP - delta), dK = dS^T Q, dQ = dS K.
// dK and dV are written in bf16; dQ leaves as fp32 partial planes, one per
// 64-key tile, which the caller sums in a fixed order before the one
// deferred `* scale`.  D is any multiple of 8 up to 128.
//
// What bounds it on the H100: five products a visible (q, k) pair (S
// recomputed, dP, dV, dK, dQ), 10 * D flops, against reading q, k, v, do,
// lse, delta once and writing dq's planes, dk and dv.
//
// Design.  The TPU block holds all heads of a key tile with dk / dv in VMEM
// scratch; on Hopper a block takes one 64-key tile of a group of heads that
// share one 128-lane plane (the TPU kernel's 64-lane head slices, paired)
// and walks them one after another.  Per head it is the K4 design: the head's K and V tiles
// stay in shared memory, the q tiles stream past (from the diagonal down
// when causal), warp w owns keys 16w..16w+15 and computes S^T and dP^T for
// them with WMMA (bf16 operands, fp32 accumulators), P^T and dS^T
// elementwise in fp32, and accumulates dV += P^T dO and dK += dS^T Q in
// register fragments across the q walk (the TPU's scratch); each key tile
// writes its fp32 dQ contribution for every q tile into its own partial
// plane.  No atomics anywhere: two runs give equal bits.  Head widths that
// are not a multiple of 16 are zero-padded to DP in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

#include "flash_attn_bwd_tiles.cuh"

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPadH = 8;
constexpr int kPadF = 4;
constexpr int kPlane = 128;

struct Strides {  // in elements; the last dimension has stride 1
  long long b, l, h;
};

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ constexpr int heads_per_block(int dp) {
  return dp >= kPlane ? 1 : kPlane / dp;
}

template <int DP>
struct Smem {
  static constexpr int ldh = DP + kPadH;    // K, V, Q, dO rows (bf16)
  static constexpr int lds = kBQ + kPadF;   // S^T, dP^T (fp32)
  static constexpr int ldp = kBQ + kPadH;   // P^T, dS^T (bf16)
  static constexpr int ldo = DP + kPadF;    // fp32 staging rows
  static constexpr size_t k = 0;
  static constexpr size_t v = align128(k + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t q = align128(v + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t dout =
      align128(q + sizeof(__nv_bfloat16) * kBQ * ldh);
  static constexpr size_t pt =
      align128(dout + sizeof(__nv_bfloat16) * kBQ * ldh);
  static constexpr size_t dst =
      align128(pt + sizeof(__nv_bfloat16) * kBK * ldp);
  static constexpr size_t stats =
      align128(dst + sizeof(__nv_bfloat16) * kBK * ldp);  // lse, delta
  static constexpr size_t st = align128(stats + sizeof(float) * 2 * kBQ);
  static constexpr size_t dpt = align128(st + sizeof(float) * kBK * lds);
  static constexpr size_t end_scores =
      align128(dpt + sizeof(float) * kBK * lds);
  // the fp32 staging tile reuses the S^T / dP^T region once consumed
  static constexpr size_t stage = st;
  static constexpr size_t end_stage =
      align128(stage + sizeof(float) * 64 * ldo);
  static constexpr size_t bytes = end_scores > end_stage ? end_scores
                                                         : end_stage;
};

// A (64, D) tile of one head into shared memory as (64, DP),
// zero past L and past D, optionally pre-scaled in bf16.
template <int DP, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride_l, int row0,
                                          int L, int D, bool do_scale,
                                          float scale) {
  constexpr int kVec = 8;
  constexpr int kPerRow = DP / kVec;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && c < D) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_l + c);
      if (do_scale) {
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          e[j] = apex_fa::from_f32<T>(apex_fa::to_f32(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<DP>::ldh + c) = val;
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_mh_bwd_wmma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const uint8_t* __restrict__ kv_mask,
                  float* __restrict__ dq_part, T* __restrict__ dk,
                  T* __restrict__ dv, Strides sq, Strides sk,
                  Strides sv, Strides sd, int B, int H, int L, int D,
                  float scale, int causal) {
  using S = Smem<DP>;
  constexpr int G = heads_per_block(DP);
  constexpr int kFr = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + S::k);
  T* Vs = reinterpret_cast<T*>(smem + S::v);
  T* Qs = reinterpret_cast<T*>(smem + S::q);
  T* Ds = reinterpret_cast<T*>(smem + S::dout);
  T* Pt = reinterpret_cast<T*>(smem + S::pt);
  T* dSt = reinterpret_cast<T*>(smem + S::dst);
  float* lse_s = reinterpret_cast<float*>(smem + S::stats);
  float* delta_s = lse_s + kBQ;
  float* St = reinterpret_cast<float*>(smem + S::st);
  float* dPt = reinterpret_cast<float*>(smem + S::dpt);
  float* stage = reinterpret_cast<float*>(smem + S::stage);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ik = blockIdx.x;
  const int groups = (H + G - 1) / G;
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y % groups) * G;
  const int k0 = ik * kBK;
  const int wrow = warp * 16;  // this warp's first key (and q) row
  const uint8_t* mb = kv_mask ? kv_mask + (long long)b * L : nullptr;
  const int n_q = (L + kBQ - 1) / kBQ;
  const int first = causal ? k0 / kBQ : 0;
  float* pbase = dq_part + ik * ((long long)B * L * H * D);

  for (int h = h0; h < min(h0 + G, H); ++h) {
    __syncthreads();  // the previous head's K / V / staging are consumed
    load_tile<DP, T>(Ks, k + b * sk.b + h * sk.h, sk.l, k0, L, D, false, 1.f);
    load_tile<DP, T>(Vs, v + b * sv.b + h * sv.h, sv.l, k0, L, D, false, 1.f);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[kFr],
        dv_acc[kFr];
#pragma unroll
    for (int f = 0; f < kFr; ++f) {
      wmma::fill_fragment(dk_acc[f], 0.f);
      wmma::fill_fragment(dv_acc[f], 0.f);
    }

    for (int iq = first; iq < n_q; ++iq) {
      const int q0 = iq * kBQ;
      __syncthreads();  // the previous tile's Q / dO / P / dS / staging done
      load_tile<DP, T>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, L, D, true,
                    scale);
      load_tile<DP, T>(Ds, dout + b * sd.b + h * sd.h, sd.l, q0, L, D, false,
                    1.f);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const bool ok = q0 + i < L;
        const long long at = ((long long)b * L + q0 + i) * H + h;
        lse_s[i] = ok ? lse[at] : kNegInf;
        delta_s[i] = ok ? delta[at] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
#pragma unroll
      for (int nf = 0; nf < kBQ / 16; ++nf) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf, pf;
        wmma::fill_fragment(sf, 0.f);
        wmma::fill_fragment(pf, 0.f);
#pragma unroll
        for (int kk = 0; kk < kFr; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T,
                         wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(af, Ks + wrow * S::ldh + kk * 16, S::ldh);
          wmma::load_matrix_sync(bf, Qs + nf * 16 * S::ldh + kk * 16,
                                 S::ldh);
          wmma::mma_sync(sf, af, bf, sf);
          wmma::load_matrix_sync(af, Vs + wrow * S::ldh + kk * 16, S::ldh);
          wmma::load_matrix_sync(bf, Ds + nf * 16 * S::ldh + kk * 16,
                                 S::ldh);
          wmma::mma_sync(pf, af, bf, pf);
        }
        wmma::store_matrix_sync(St + wrow * S::lds + nf * 16, sf, S::lds,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(dPt + wrow * S::lds + nf * 16, pf, S::lds,
                                wmma::mem_row_major);
      }
      __syncwarp();

      // P^T and dS^T, a key row at a time; lanes hold queries lane, lane+32
      for (int r = 0; r < 16; ++r) {
        const int kpos = k0 + wrow + r;
        bool key_ok = kpos < L;
        if (mb != nullptr && key_ok) key_ok = mb[kpos] != 0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          const int qpos = q0 + c;
          const float l_q = lse_s[c];
          bool ok = key_ok && qpos < L && l_q > 0.5f * kNegInf;
          if (causal) ok = ok && kpos <= qpos;
          const float p = ok ? expf(St[(wrow + r) * S::lds + c] - l_q) : 0.f;
          const float ds = p * (dPt[(wrow + r) * S::lds + c] - delta_s[c]);
          Pt[(wrow + r) * S::ldp + c] = apex_fa::from_f32<T>(p);
          dSt[(wrow + r) * S::ldp + c] = apex_fa::from_f32<T>(ds);
        }
      }
      __syncwarp();

      // dV += P^T dO, dK += dS^T Q for this warp's keys
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T,
                       wmma::row_major> pa, sa;
        wmma::load_matrix_sync(pa, Pt + wrow * S::ldp + kk * 16, S::ldp);
        wmma::load_matrix_sync(sa, dSt + wrow * S::ldp + kk * 16, S::ldp);
#pragma unroll
        for (int df = 0; df < kFr; ++df) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, Ds + kk * 16 * S::ldh + df * 16,
                                 S::ldh);
          wmma::mma_sync(dv_acc[df], pa, bf, dv_acc[df]);
          wmma::load_matrix_sync(bf, Qs + kk * 16 * S::ldh + df * 16,
                                 S::ldh);
          wmma::mma_sync(dk_acc[df], sa, bf, dk_acc[df]);
        }
      }
      __syncthreads();  // every warp's dS^T rows are in; S^T / dP^T free

      // dQ partial = dS K for this warp's 16 queries (dS read through dS^T
      // as a column-major A), staged in fp32, written to this key tile's
      // plane
#pragma unroll
      for (int df = 0; df < kFr; ++df) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> qf;
        wmma::fill_fragment(qf, 0.f);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T,
                         wmma::col_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(af, dSt + kk * 16 * S::ldp + wrow, S::ldp);
          wmma::load_matrix_sync(bf, Ks + kk * 16 * S::ldh + df * 16,
                                 S::ldh);
          wmma::mma_sync(qf, af, bf, qf);
        }
        wmma::store_matrix_sync(stage + wrow * S::ldo + df * 16, qf, S::ldo,
                                wmma::mem_row_major);
      }
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        const int qpos = q0 + wrow + r;
        if (qpos >= L) break;
        float* dst_row = pbase + (((long long)b * L + qpos) * H + h) * D;
        for (int c = lane; c < D; c += 32)
          dst_row[c] = stage[(wrow + r) * S::ldo + c];
      }
    }

    // emit dK and dV of this head in bf16
    __syncthreads();  // the last tile's staging is done
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int df = 0; df < kFr; ++df)
        wmma::store_matrix_sync(stage + wrow * S::ldo + df * 16,
                                pass == 0 ? dk_acc[df] : dv_acc[df], S::ldo,
                                wmma::mem_row_major);
      __syncwarp();
      T* out = pass == 0 ? dk : dv;
      for (int r = 0; r < 16; ++r) {
        const int kpos = k0 + wrow + r;
        if (kpos >= L) break;
        T* row = out + (((long long)b * L + kpos) * H + h) * D;
        for (int c = lane; c < D; c += 32)
          row[c] = apex_fa::from_f32<T>(stage[(wrow + r) * S::ldo + c]);
      }
      __syncwarp();
    }
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const uint8_t* mask,
           float* dq, void* dk, void* dv, Strides sq, Strides sk, Strides sv,
           Strides sd, int B, int H, int L, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = Smem<DP>::bytes;
  static unsigned configured = 0;  // the >48 KB opt-in, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(flash_mh_bwd_wmma<DP, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) configured |= 1u << dev;
  }
  constexpr int G = heads_per_block(DP);
  const dim3 grid((L + kBK - 1) / kBK, B * ((H + G - 1) / G));
  flash_mh_bwd_wmma<DP, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      dq, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, sv, sd, B, H, L,
      D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout: (B, L, H, D) of type dtype (1 bf16, 2 fp16), element
// strides (b, l, h), unit stride over D, rows starting on 16-byte
// boundaries.  lse, delta: contiguous
// (B, L, H) fp32.  kv_mask: (B, L) uint8 or null.  dq: ceil(L / 64)
// zero-filled fp32 partial planes of (B, L, H, D) (key tile t writes plane
// t; dead causal tiles leave zeros).  dk, dv: contiguous (B, L, H, D) of
// that type.
// D: a multiple of 8 up to 128.  Returns the cudaError_t of the launch.
extern "C" int apex_flash_mh_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask, void* dq,
    void* dk, void* dv, long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh, long long svb,
    long long svl, long long svh, long long sdb, long long sdl,
    long long sdh, int B, int L, int H, int D, float scale, int causal,
    int dtype, void* stream) {
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh},
      sd{sdb, sdl, sdh};
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqp = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || D < 8 || D > 128 || D % 8 ||
      (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
#define APEX_MH_CASE(n)                                                      \
  case n:                                                                    \
    return dtype == 2                                                        \
               ? launch<16 * n, __half>(q, k, v, dout, lp, dl, mask, dqp, dk, \
                                        dv, sq, sk, sv, sd, B, H, L, D,      \
                                        scale, causal, s)                    \
               : launch<16 * n, __nv_bfloat16>(q, k, v, dout, lp, dl, mask,   \
                                               dqp, dk, dv, sq, sk, sv, sd,   \
                                               B, H, L, D, scale, causal, s);
    APEX_MH_CASE(1)
    APEX_MH_CASE(2)
    APEX_MH_CASE(3)
    APEX_MH_CASE(4)
    APEX_MH_CASE(5)
    APEX_MH_CASE(6)
    APEX_MH_CASE(7)
    APEX_MH_CASE(8)
#undef APEX_MH_CASE
  }
  return (int)cudaErrorInvalidValue;
}
