// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py, `_flash_bwd_fused` and
// its kernel `_bwd_fused_kernel` (K4: the one-pass backward the TPU picks
// while the dq-partials buffer fits its budget; above it the two-pass
// backward, K13 in flash_attn_bwd_dq.cu and K14 in flash_attn_bwd_dkv.cu).
//
// Computes, for (B, L, H, D) q, k, v, do and the forward's lse (B, L, H)
// fp32 and delta = rowsum(o * do) - dlse (B, L, H) fp32 (computed outside,
// as the TPU path leaves it to XLA): with q pre-scaled by `scale` in its
// storage dtype and q, k rotated by the optional rope tables (exactly as the
// forward kernel rotates them, on the tile after it is loaded),
//   P = exp(S - lse) (zero where causality, the key mask or an empty row
//   hides the pair), dV = P^T dO, dP = dO V^T, dS = P * (dP - delta),
//   dK = dS^T Q, dQ = dS K,
// then the inverse rotation (the same lane rotation with the sine negated)
// of dK and dQ.  dK and dV are written in the input dtype; dQ leaves as fp32
// (the caller casts it and applies the one deferred `* scale`).
//
// What bounds it on the H100: the five products of each visible (q, k)
// pair (S recomputed, dP, dV, dK, dQ), 10 * D flops a pair, against reading
// q, k, v, do, lse once and writing dq, dk, dv: at B8 L2048 H12 D64 causal
// about 0.13 TFLOP against 0.2 GB, so operations (~0.13 ms at 989 TFLOP/s)
// bound it; this simple version is far from that bound (see PERF.md).
//
// Design (bf16; "bf16" below stands for the storage type): one 128-thread
// block per (64-key tile, batch * head), looping over the 64-row q tiles from the diagonal down (causal) or over
// all of them.  The key tile's rotated K and its V stay in shared memory;
// each q tile brings rotated, pre-scaled Q, dO, lse and delta.  Warp w owns
// keys 16w..16w+15: it computes S^T and dP^T for them with WMMA (bf16
// operands, fp32 accumulators), the probabilities and dS^T elementwise in
// fp32, and accumulates dV += P^T dO and dK += dS^T Q in register fragments
// that live across the whole q loop (the TPU's VMEM scratch).  dQ cannot
// accumulate on chip (it is indexed by the q tile), so, as on the TPU, each
// key tile writes its fp32 dQ contribution, already inverse-rotated, into
// its own partial plane; the caller sums the planes in a fixed order.  No
// atomics anywhere: two runs give equal bits.  The planes are
// ceil(L / 64) * B * L * H * D * 4 bytes, growing with L^2, which is why the
// wrapper gates K4 on their size.
//
// fp16 is the same code instantiated on __half (WMMA has fp16 fragments of
// the same shape).  fp32, and head widths other than 64 and 128, take the
// generic kernels (flash_simt.cu) or the two-pass route.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

#include "flash_attn_bwd_tiles.cuh"

namespace {

using namespace nvcuda;
using namespace apex_fa;

template <int D>
struct Smem {
  static constexpr int ldh = D + kPadH;     // K, V, Q, dO rows (bf16)
  static constexpr int lds = kBQ + kPadF;   // S^T, dP^T (fp32), keys x queries
  static constexpr int ldp = kBQ + kPadH;   // P^T, dS^T (bf16)
  static constexpr int ldo = D + kPadF;     // fp32 staging rows
  static constexpr size_t k = 0;
  static constexpr size_t v = align128(k + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t q = align128(v + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t dout =
      align128(q + sizeof(__nv_bfloat16) * kBQ * ldh);
  static constexpr size_t pt =
      align128(dout + sizeof(__nv_bfloat16) * kBQ * ldh);
  static constexpr size_t dst = align128(pt + sizeof(__nv_bfloat16) * kBK * ldp);
  static constexpr size_t stats =
      align128(dst + sizeof(__nv_bfloat16) * kBK * ldp);  // lse, delta
  static constexpr size_t st = align128(stats + sizeof(float) * 2 * kBQ);
  static constexpr size_t dpt = align128(st + sizeof(float) * kBK * lds);
  static constexpr size_t end_scores = align128(dpt + sizeof(float) * kBK * lds);
  // the fp32 staging tile (64 x D) reuses the S^T / dP^T region once they
  // are consumed
  static constexpr size_t stage = st;
  static constexpr size_t end_stage = align128(stage + sizeof(float) * 64 * ldo);
  static constexpr size_t bytes = end_scores > end_stage ? end_scores
                                                         : end_stage;
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_wmma(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const uint8_t* __restrict__ kv_mask,
               const T* __restrict__ cos_t, const T* __restrict__ sin_t,
               float* __restrict__ dq_part, T* __restrict__ dk,
               T* __restrict__ dv, Strides sq, Strides sk,
               Strides sv, Strides sd, int B, int H, int L, float scale,
               int causal) {
  using S = Smem<D>;
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
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = ik * kBK;
  const int wrow = warp * 16;  // this warp's first key (and q) row
  const uint8_t* mb = kv_mask ? kv_mask + (long long)b * L : nullptr;
  const T* cb = cos_t ? cos_t + (long long)b * L * D : nullptr;
  const T* sb = sin_t ? sin_t + (long long)b * L * D : nullptr;

  load_tile<D>(Ks, k + b * sk.b + h * sk.h, sk.l, k0, L, false, 1.f, cb, sb);
  load_tile<D, T>(Vs, v + b * sv.b + h * sv.h, sv.l, k0, L, false, 1.f,
                  nullptr, nullptr);

  constexpr int kFr = D / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[kFr], dv_acc[kFr];
#pragma unroll
  for (int f = 0; f < kFr; ++f) {
    wmma::fill_fragment(dk_acc[f], 0.f);
    wmma::fill_fragment(dv_acc[f], 0.f);
  }

  const int n_q = (L + kBQ - 1) / kBQ;
  const int first = causal ? k0 / kBQ : 0;

  for (int iq = first; iq < n_q; ++iq) {
    const int q0 = iq * kBQ;
    __syncthreads();  // the previous tile's Q / dO / P / dS / staging done
    load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, L, true, scale, cb,
                 sb);
    load_tile<D, T>(Ds, dout + b * sd.b + h * sd.h, sd.l, q0, L, false, 1.f,
                    nullptr, nullptr);
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      const bool ok = q0 + i < L;
      const long long at = ((long long)b * L + q0 + i) * H + h;
      lse_s[i] = ok ? lse[at] : kNegInf;
      delta_s[i] = ok ? delta[at] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries.
#pragma unroll
    for (int nf = 0; nf < kBQ / 16; ++nf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf, pf;
      wmma::fill_fragment(sf, 0.f);
      wmma::fill_fragment(pf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T,
                       wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(af, Ks + wrow * S::ldh + kk * 16, S::ldh);
        wmma::load_matrix_sync(bf, Qs + nf * 16 * S::ldh + kk * 16, S::ldh);
        wmma::mma_sync(sf, af, bf, sf);
        wmma::load_matrix_sync(af, Vs + wrow * S::ldh + kk * 16, S::ldh);
        wmma::load_matrix_sync(bf, Ds + nf * 16 * S::ldh + kk * 16, S::ldh);
        wmma::mma_sync(pf, af, bf, pf);
      }
      wmma::store_matrix_sync(St + wrow * S::lds + nf * 16, sf, S::lds,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dPt + wrow * S::lds + nf * 16, pf, S::lds,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // P^T and dS^T, one key row at a time; lanes hold queries lane, lane+32.
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
        Pt[(wrow + r) * S::ldp + c] = from_f32<T>(p);
        dSt[(wrow + r) * S::ldp + c] = from_f32<T>(ds);
      }
    }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q for this warp's keys.
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
        wmma::load_matrix_sync(bf, Ds + kk * 16 * S::ldh + df * 16, S::ldh);
        wmma::mma_sync(dv_acc[df], pa, bf, dv_acc[df]);
        wmma::load_matrix_sync(bf, Qs + kk * 16 * S::ldh + df * 16, S::ldh);
        wmma::mma_sync(dk_acc[df], sa, bf, dk_acc[df]);
      }
    }
    {  // dQ: this key tile's contribution, into its partial plane
      __syncthreads();  // every warp's dS^T rows are in; S^T / dP^T are free

      // dQ partial = dS K for this warp's 16 queries (dS read through dS^T
      // as a column-major A), staged in fp32, inverse-rotated, written to
      // this key tile's plane.
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
          wmma::load_matrix_sync(bf, Ks + kk * 16 * S::ldh + df * 16, S::ldh);
          wmma::mma_sync(qf, af, bf, qf);
        }
        wmma::store_matrix_sync(stage + wrow * S::ldo + df * 16, qf, S::ldo,
                                wmma::mem_row_major);
      }
      __syncwarp();
      if (cb != nullptr) {
        unrotate_rows<D>(stage, wrow, q0, L, cb, sb);
        __syncwarp();
      }
      // this key tile's partial plane of (B, L, H, D)
      float* pbase = dq_part + ik * ((long long)B * L * H * D);
      for (int r = 0; r < 16; ++r) {
        const int qpos = q0 + wrow + r;
        if (qpos >= L) break;
        float* dst_row = pbase + (((long long)b * L + qpos) * H + h) * D;
        for (int c = lane; c < D; c += 32)
          dst_row[c] = stage[(wrow + r) * S::ldo + c];
      }
    }
  }

  // Emit dK (inverse-rotated) and dV in the input dtype.
  __syncthreads();  // the last tile's staging is done
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int df = 0; df < kFr; ++df)
      wmma::store_matrix_sync(stage + wrow * S::ldo + df * 16,
                              pass == 0 ? dk_acc[df] : dv_acc[df], S::ldo,
                              wmma::mem_row_major);
    __syncwarp();
    if (pass == 0 && cb != nullptr) {
      unrotate_rows<D>(stage, wrow, k0, L, cb, sb);
      __syncwarp();
    }
    T* out = pass == 0 ? dk : dv;
    for (int r = 0; r < 16; ++r) {
      const int kpos = k0 + wrow + r;
      if (kpos >= L) break;
      T* row = out + (((long long)b * L + kpos) * H + h) * D;
      for (int c = lane; c < D; c += 32)
        row[c] = from_f32<T>(stage[(wrow + r) * S::ldo + c]);
    }
    __syncwarp();
  }
}

template <int D, typename T>
int launch_wmma(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const uint8_t* mask, const void* cos_t, const void* sin_t,
                float* dq_part, void* dk, void* dv, Strides sq, Strides sk,
                Strides sv, Strides sd, int B, int H, int L, float scale,
                int causal, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  static unsigned configured = 0;
  cudaError_t e = opt_in_smem(flash_bwd_wmma<D, T>, bytes, &configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((L + kBK - 1) / kBK, B * H);
  flash_bwd_wmma<D, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      static_cast<const T*>(cos_t), static_cast<const T*>(sin_t), dq_part,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, sv, sd, B, H, L,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the backward at head dim D (0: unsupported).
extern "C" int apex_flash_attn_bwd_smem_bytes(int D) {
  if (D == 64) return (int)Smem<64>::bytes;
  if (D == 128) return (int)Smem<128>::bytes;
  return 0;
}

// q, k, v, dout: (B, L, H, D) of type dtype (1 bf16, 2 fp16), D 64 or 128,
// element strides (b, l, h), unit stride over D, rows on 16-byte
// boundaries.  lse, delta: contiguous (B, L, H) fp32.  kv_mask: (B, L)
// uint8 or null.  cos_t / sin_t: contiguous (B, L, D) tables of that type,
// or both null.  dq: ceil(L / 64) zero-filled fp32 partial planes of (B, L,
// H, D) (key tile t writes plane t; dead causal tiles leave zeros).  dk, dv:
// contiguous (B, L, H, D) of that type.  Returns the cudaError_t of the
// launch.
extern "C" int apex_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask,
    const void* cos_t, const void* sin_t, void* dq, void* dk, void* dv,
    long long sqb, long long sql, long long sqh, long long skb,
    long long skl, long long skh, long long svb, long long svl,
    long long svh, long long sdb, long long sdl, long long sdh, int B, int L,
    int H, int D, float scale, int causal, int dtype, void* stream) {
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh},
      sd{sdb, sdl, sdh};
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqp = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || (D != 64 && D != 128) ||
      (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  if (dtype == 2)
    return D == 64
               ? launch_wmma<64, __half>(q, k, v, dout, lp, dl, mask, cos_t,
                                         sin_t, dqp, dk, dv, sq, sk, sv, sd,
                                         B, H, L, scale, causal, s)
               : launch_wmma<128, __half>(q, k, v, dout, lp, dl, mask, cos_t,
                                          sin_t, dqp, dk, dv, sq, sk, sv, sd,
                                          B, H, L, scale, causal, s);
  return D == 64
             ? launch_wmma<64, __nv_bfloat16>(q, k, v, dout, lp, dl, mask,
                                              cos_t, sin_t, dqp, dk, dv, sq,
                                              sk, sv, sd, B, H, L, scale,
                                              causal, s)
             : launch_wmma<128, __nv_bfloat16>(q, k, v, dout, lp, dl, mask,
                                               cos_t, sin_t, dqp, dk, dv, sq,
                                               sk, sv, sd, B, H, L, scale,
                                               causal, s);
}
