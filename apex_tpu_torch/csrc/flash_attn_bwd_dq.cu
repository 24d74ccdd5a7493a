// Flash-attention backward, dq pass (K13), for Hopper (sm_90a), with a plain
// C interface.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py, `_flash_bwd`'s dq
// kernel `_dq_kernel` (the first pass of the two-pass backward the TPU
// takes when the fused kernel's fp32 dq partials would exceed their
// budget; flash_attn_bwd.cu's K14 is the second, dk / dv).
//
// Computes, for bf16 (B, L, H, D) q, k, v, do, the forward's lse (B, L, H)
// fp32 and delta = rowsum(o * do) - dlse (B, L, H) fp32: with q pre-scaled
// by `scale` in bf16 and q, k rotated by the optional rope tables on load
// (as the forward and K4 do),
//   P = exp(S - lse) (zero where causality, the key mask or an empty row
//   hides the pair), dP = dO V^T, dS = P * (dP - delta), dQ = dS K,
// then dQ's inverse rotation, its rounding to bf16 and the one deferred
// `* scale` in bf16 (the scale rounded to bf16, the product rounded again:
// what `dq.astype(q.dtype) * scale` gives on the TPU path).  A row that sees
// no key (lse = NEG_INF) gets dq = 0.
//
// What bounds it on the H100: the three products of each visible (q, k)
// pair (S recomputed, dP, dQ), 6 * D flops a pair, against reading q, k, v,
// do, lse, delta once and writing dq: at B1 L16384 H12 D64 causal 0.62
// TFLOP against 0.1 GB, so operations (~0.63 ms at 989 TFLOP/s) bound it.
// This simple version is far from that bound (see PERF.md).
//
// Design: one 128-thread block per (64-row q tile, batch * head), looping
// over the 64-key tiles up to the diagonal (causal) or over all of them;
// the TPU's sequential k grid axis with its fp32 dq scratch becomes that
// loop, and dQ accumulates in WMMA fp32 fragments that stay in registers
// for the whole loop.  The q tile (pre-scaled, rotated), its dO, lse and
// delta are loaded once.  Per key tile, rotated K and V are staged in
// shared memory; warp w owns queries 16w..16w+15 and computes S and dP for
// them with WMMA (bf16 operands, fp32 accumulators), P and dS elementwise
// in fp32 (the straddling causal tile and the ragged last tile masked per
// element, tiles past the diagonal never visited), then dQ += dS K with dS
// rounded to bf16, as the TPU kernel feeds its MXU.  Nothing is written
// but dq itself: no partial planes, no atomics; two runs give equal bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "flash_attn_bwd_tiles.cuh"

namespace {

using namespace nvcuda;
using namespace apex_fa;

template <int D>
struct DqSmem {
  static constexpr int ldh = TileLd<D>::h;  // Q, dO, K, V rows (bf16)
  static constexpr int lds = kBK + kPadF;   // S, dP (fp32), queries x keys
  static constexpr int ldp = kBK + kPadH;   // dS (bf16)
  static constexpr int ldo = TileLd<D>::f;  // fp32 staging rows
  static constexpr size_t q = 0;
  static constexpr size_t dout =
      align128(q + sizeof(__nv_bfloat16) * kBQ * ldh);
  static constexpr size_t k =
      align128(dout + sizeof(__nv_bfloat16) * kBQ * ldh);
  static constexpr size_t v = align128(k + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t ds = align128(v + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t stats =
      align128(ds + sizeof(__nv_bfloat16) * kBQ * ldp);  // lse, delta
  static constexpr size_t s = align128(stats + sizeof(float) * 2 * kBQ);
  static constexpr size_t dp = align128(s + sizeof(float) * kBQ * lds);
  static constexpr size_t end_scores = align128(dp + sizeof(float) * kBQ * lds);
  // the fp32 staging tile (64 x D) reuses the S / dP region after the loop
  static constexpr size_t stage = s;
  static constexpr size_t end_stage = align128(stage + sizeof(float) * 64 * ldo);
  static constexpr size_t bytes = end_scores > end_stage ? end_scores
                                                         : end_stage;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const uint8_t* __restrict__ kv_mask,
                  const __nv_bfloat16* __restrict__ cos_t,
                  const __nv_bfloat16* __restrict__ sin_t,
                  __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk,
                  Strides sv, Strides sd, int H, int L, float scale,
                  int causal) {
  using S = DqSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q);
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem + S::dout);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::v);
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(smem + S::ds);
  float* lse_s = reinterpret_cast<float*>(smem + S::stats);
  float* delta_s = lse_s + kBQ;
  float* Ss = reinterpret_cast<float*>(smem + S::s);
  float* dPs = reinterpret_cast<float*>(smem + S::dp);
  float* stage = reinterpret_cast<float*>(smem + S::stage);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int iq = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = iq * kBQ;
  const int wrow = warp * 16;  // this warp's first query row
  const uint8_t* mb = kv_mask ? kv_mask + (long long)b * L : nullptr;
  const __nv_bfloat16* cb = cos_t ? cos_t + (long long)b * L * D : nullptr;
  const __nv_bfloat16* sb = sin_t ? sin_t + (long long)b * L * D : nullptr;

  load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, L, true, scale, cb, sb);
  load_tile<D>(Ds, dout + b * sd.b + h * sd.h, sd.l, q0, L, false, 1.f,
               nullptr, nullptr);
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const bool ok = q0 + i < L;
    const long long at = ((long long)b * L + q0 + i) * H + h;
    lse_s[i] = ok ? lse[at] : kNegInf;
    delta_s[i] = ok ? delta[at] : 0.f;
  }

  constexpr int kFr = D / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[kFr];
#pragma unroll
  for (int f = 0; f < kFr; ++f) wmma::fill_fragment(dq_acc[f], 0.f);

  // kBQ == kBK: key tile ik holds a key at or before the q tile's last row
  // exactly when ik <= iq
  const int n_k = (L + kBK - 1) / kBK;
  const int last = causal ? min(iq, n_k - 1) : n_k - 1;

  for (int ik = 0; ik <= last; ++ik) {
    const int k0 = ik * kBK;
    __syncthreads();  // the previous key tile's K / V are consumed
    load_tile<D>(Ks, k + b * sk.b + h * sk.h, sk.l, k0, L, false, 1.f, cb,
                 sb);
    load_tile<D>(Vs, v + b * sv.b + h * sv.h, sv.l, k0, L, false, 1.f,
                 nullptr, nullptr);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x 64 keys.
#pragma unroll
    for (int nf = 0; nf < kBK / 16; ++nf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf, pf;
      wmma::fill_fragment(sf, 0.f);
      wmma::fill_fragment(pf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(af, Qs + wrow * S::ldh + kk * 16, S::ldh);
        wmma::load_matrix_sync(bf, Ks + nf * 16 * S::ldh + kk * 16, S::ldh);
        wmma::mma_sync(sf, af, bf, sf);
        wmma::load_matrix_sync(af, Ds + wrow * S::ldh + kk * 16, S::ldh);
        wmma::load_matrix_sync(bf, Vs + nf * 16 * S::ldh + kk * 16, S::ldh);
        wmma::mma_sync(pf, af, bf, pf);
      }
      wmma::store_matrix_sync(Ss + wrow * S::lds + nf * 16, sf, S::lds,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dPs + wrow * S::lds + nf * 16, pf, S::lds,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // dS, one query row at a time; lanes hold keys lane, lane + 32.
    bool key_ok[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kpos = k0 + lane + 32 * j;
      key_ok[j] = kpos < L && (mb == nullptr || mb[kpos] != 0);
    }
    for (int r = 0; r < 16; ++r) {
      const int row = wrow + r;
      const int qpos = q0 + row;
      const float l_q = lse_s[row];
      const float d_q = delta_s[row];
      const bool row_ok = qpos < L && l_q > 0.5f * kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        bool ok = row_ok && key_ok[j];
        if (causal) ok = ok && k0 + c <= qpos;
        const float p = ok ? expf(Ss[row * S::lds + c] - l_q) : 0.f;
        const float ds = p * (dPs[row * S::lds + c] - d_q);
        dSs[row * S::ldp + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dQ += dS K for this warp's queries.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::load_matrix_sync(af, dSs + wrow * S::ldp + kk * 16, S::ldp);
#pragma unroll
      for (int df = 0; df < kFr; ++df) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, Ks + kk * 16 * S::ldh + df * 16, S::ldh);
        wmma::mma_sync(dq_acc[df], af, bf, dq_acc[df]);
      }
    }
  }

  // Emit dQ: inverse-rotated, rounded to bf16, times the scale in bf16.
  __syncthreads();  // every warp is done with S / dP, which staging reuses
#pragma unroll
  for (int df = 0; df < kFr; ++df)
    wmma::store_matrix_sync(stage + wrow * S::ldo + df * 16, dq_acc[df],
                            S::ldo, wmma::mem_row_major);
  __syncwarp();
  if (cb != nullptr) {
    unrotate_rows<D>(stage, wrow, q0, L, cb, sb);
    __syncwarp();
  }
  for (int r = 0; r < 16; ++r) {
    const int qpos = q0 + wrow + r;
    if (qpos >= L) break;
    __nv_bfloat16* row = dq + (((long long)b * L + qpos) * H + h) * D;
    for (int c = lane; c < D; c += 32) {
      const float x =
          __bfloat162float(__float2bfloat16(stage[(wrow + r) * S::ldo + c]));
      row[c] = __float2bfloat16(__fmul_rn(x, scale));
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const uint8_t* mask,
              const void* cos_t, const void* sin_t, void* dq, Strides sq,
              Strides sk, Strides sv, Strides sd, int B, int H, int L,
              float scale, int causal, cudaStream_t stream) {
  const size_t bytes = DqSmem<D>::bytes;
  static unsigned configured = 0;
  cudaError_t e = opt_in_smem(flash_bwd_dq_bf16<D>, bytes, &configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((L + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq_bf16<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, mask,
      static_cast<const __nv_bfloat16*>(cos_t),
      static_cast<const __nv_bfloat16*>(sin_t),
      static_cast<__nv_bfloat16*>(dq), sq, sk, sv, sd, H, L, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the dq pass at head dim D (0: unsupported).
extern "C" int apex_flash_attn_bwd_dq_smem_bytes(int D) {
  if (D == 64) return (int)DqSmem<64>::bytes;
  if (D == 128) return (int)DqSmem<128>::bytes;
  return 0;
}

// q, k, v, dout: bf16 (B, L, H, D), element strides (b, l, h), unit stride
// over D, rows on 16-byte boundaries.  lse, delta: contiguous (B, L, H)
// fp32.  kv_mask: (B, L) uint8 or null.  cos_t / sin_t: contiguous
// (B, L, D) bf16 tables, or both null.  dq: contiguous (B, L, H, D) bf16,
// every element written.  scale: the softmax scale, already rounded to
// bf16: q's pre-scale and the deferred scale of dq.  Returns the
// cudaError_t of the launch.
extern "C" int apex_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask,
    const void* cos_t, const void* sin_t, void* dq, long long sqb,
    long long sql, long long sqh, long long skb, long long skl,
    long long skh, long long svb, long long svl, long long svh,
    long long sdb, long long sdl, long long sdh, int B, int L, int H, int D,
    float scale, int causal, void* stream) {
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh},
      sd{sdb, sdl, sdh};
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lp, dl, mask, cos_t, sin_t, dq, sq,
                         sk, sv, sd, B, H, L, scale, causal, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lp, dl, mask, cos_t, sin_t, dq, sq,
                          sk, sv, sd, B, H, L, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
