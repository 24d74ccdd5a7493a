// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py, `_flash_bwd_fused` and
// its kernel `_bwd_fused_kernel` (the one-pass backward the TPU picks while
// the dq-partials buffer fits its budget).
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
// Design (bf16): one 128-thread block per (64-key tile, batch * head),
// looping over the 64-row q tiles from the diagonal down (causal) or over
// all of them.  The key tile's rotated K and its V stay in shared memory;
// each q tile brings rotated, pre-scaled Q, dO, lse and delta.  Warp w owns
// keys 16w..16w+15: it computes S^T and dP^T for them with WMMA (bf16
// operands, fp32 accumulators), the probabilities and dS^T elementwise in
// fp32, and accumulates dV += P^T dO and dK += dS^T Q in register fragments
// that live across the whole q loop (the TPU's VMEM scratch).  dQ cannot
// accumulate on chip (it is indexed by the q tile), so, as on the TPU, each
// key tile writes its fp32 dQ contribution, already inverse-rotated, into
// its own partial plane; the caller sums the planes in a fixed order.  No
// atomics anywhere: two runs give equal bits.
//
// fp32 inputs (tests, the fp32 reference) take two SIMT kernels: one warp
// per key row for dK / dV (looping over the queries that see it) and one
// warp per query row for dQ (looping over its keys), lanes across D.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPadH = 8;
constexpr int kPadF = 4;

struct Strides {  // in elements; the last dimension has stride 1
  long long b, l, h;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float rot1(float x, float xr, float c, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(xr, s));
}

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

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

// Copy a (64, D) tile of a strided bf16 tensor into shared memory, zero past
// L.  With `do_scale`, each value is multiplied by `scale` and rounded back
// to bf16 (the wrapper's q pre-scale); with tables (cos_b / sin_b, this
// batch's (L, D)), the row is then rotated in fp32 and rounded to bf16.
template <int D>
__device__ __forceinline__ void load_tile(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long stride_l,
    int row0, int L, bool do_scale, float scale,
    const __nv_bfloat16* cos_b, const __nv_bfloat16* sin_b) {
  constexpr int kVec = 8;
  constexpr int kHalf = D / 2;
  constexpr int kPerRow = kHalf / kVec;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (row0 + r < L) {
      const long long row = row0 + r;
      lo = *reinterpret_cast<const uint4*>(src + row * stride_l + c);
      hi = *reinterpret_cast<const uint4*>(src + row * stride_l + c + kHalf);
      __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&lo);
      __nv_bfloat16* eh = reinterpret_cast<__nv_bfloat16*>(&hi);
      if (do_scale) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          el[j] = __float2bfloat16(__bfloat162float(el[j]) * scale);
          eh[j] = __float2bfloat16(__bfloat162float(eh[j]) * scale);
        }
      }
      if (cos_b != nullptr) {
        const uint4 cl = *reinterpret_cast<const uint4*>(cos_b + row * D + c);
        const uint4 ch =
            *reinterpret_cast<const uint4*>(cos_b + row * D + c + kHalf);
        const uint4 sl = *reinterpret_cast<const uint4*>(sin_b + row * D + c);
        const uint4 sh =
            *reinterpret_cast<const uint4*>(sin_b + row * D + c + kHalf);
        const __nv_bfloat16* ecl = reinterpret_cast<const __nv_bfloat16*>(&cl);
        const __nv_bfloat16* ech = reinterpret_cast<const __nv_bfloat16*>(&ch);
        const __nv_bfloat16* esl = reinterpret_cast<const __nv_bfloat16*>(&sl);
        const __nv_bfloat16* esh = reinterpret_cast<const __nv_bfloat16*>(&sh);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xl = __bfloat162float(el[j]);
          const float xh = __bfloat162float(eh[j]);
          el[j] = __float2bfloat16(rot1(xl, xh, __bfloat162float(ecl[j]),
                                        __bfloat162float(esl[j])));
          eh[j] = __float2bfloat16(rot1(xh, xl, __bfloat162float(ech[j]),
                                        __bfloat162float(esh[j])));
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::ldh + c) = lo;
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::ldh + c + kHalf) = hi;
  }
}

// Inverse-rotate this warp's 16 fp32 staging rows in place (the rows'
// tables; the same lane rotation with the sine negated).  Rows at or past
// L are left as they are.
template <int D>
__device__ __forceinline__ void unrotate_rows(float* stage, int wrow,
                                              int row0, int L,
                                              const __nv_bfloat16* cos_b,
                                              const __nv_bfloat16* sin_b) {
  constexpr int kHalf = D / 2;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < 16; ++r) {
    const int pos = row0 + wrow + r;
    if (pos >= L) break;
    float* row = stage + (wrow + r) * Smem<D>::ldo;
    const __nv_bfloat16* cr = cos_b + (long long)pos * D;
    const __nv_bfloat16* sr = sin_b + (long long)pos * D;
    for (int c = lane; c < kHalf; c += 32) {
      const float lo = row[c], hi = row[c + kHalf];
      row[c] = rot1(lo, hi, __bfloat162float(cr[c]),
                    -__bfloat162float(sr[c]));
      row[c + kHalf] = rot1(hi, lo, __bfloat162float(cr[c + kHalf]),
                            -__bfloat162float(sr[c + kHalf]));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const uint8_t* __restrict__ kv_mask,
               const __nv_bfloat16* __restrict__ cos_t,
               const __nv_bfloat16* __restrict__ sin_t,
               float* __restrict__ dq_part, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk,
               Strides sv, Strides sd, int B, int H, int L, float scale,
               int causal) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::v);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q);
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem + S::dout);
  __nv_bfloat16* Pt = reinterpret_cast<__nv_bfloat16*>(smem + S::pt);
  __nv_bfloat16* dSt = reinterpret_cast<__nv_bfloat16*>(smem + S::dst);
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
  const __nv_bfloat16* cb = cos_t ? cos_t + (long long)b * L * D : nullptr;
  const __nv_bfloat16* sb = sin_t ? sin_t + (long long)b * L * D : nullptr;

  load_tile<D>(Ks, k + b * sk.b + h * sk.h, sk.l, k0, L, false, 1.f, cb, sb);
  load_tile<D>(Vs, v + b * sv.b + h * sv.h, sv.l, k0, L, false, 1.f,
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
  const long long plane = (long long)B * L * H * D;  // one dq partial plane

  for (int iq = first; iq < n_q; ++iq) {
    const int q0 = iq * kBQ;
    __syncthreads();  // the previous tile's Q / dO / P / dS / staging done
    load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, L, true, scale, cb,
                 sb);
    load_tile<D>(Ds, dout + b * sd.b + h * sd.h, sd.l, q0, L, false, 1.f,
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
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
        Pt[(wrow + r) * S::ldp + c] = __float2bfloat16(p);
        dSt[(wrow + r) * S::ldp + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q for this warp's keys.
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> pa, sa;
      wmma::load_matrix_sync(pa, Pt + wrow * S::ldp + kk * 16, S::ldp);
      wmma::load_matrix_sync(sa, dSt + wrow * S::ldp + kk * 16, S::ldp);
#pragma unroll
      for (int df = 0; df < kFr; ++df) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, Ds + kk * 16 * S::ldh + df * 16, S::ldh);
        wmma::mma_sync(dv_acc[df], pa, bf, dv_acc[df]);
        wmma::load_matrix_sync(bf, Qs + kk * 16 * S::ldh + df * 16, S::ldh);
        wmma::mma_sync(dk_acc[df], sa, bf, dk_acc[df]);
      }
    }
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
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
    float* pbase = dq_part + ik * plane;
    for (int r = 0; r < 16; ++r) {
      const int qpos = q0 + wrow + r;
      if (qpos >= L) break;
      float* dst_row = pbase + (((long long)b * L + qpos) * H + h) * D;
      for (int c = lane; c < D; c += 32)
        dst_row[c] = stage[(wrow + r) * S::ldo + c];
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
    __nv_bfloat16* out = pass == 0 ? dk : dv;
    for (int r = 0; r < 16; ++r) {
      const int kpos = k0 + wrow + r;
      if (kpos >= L) break;
      __nv_bfloat16* row = out + (((long long)b * L + kpos) * H + h) * D;
      for (int c = lane; c < D; c += 32)
        row[c] = __float2bfloat16(stage[(wrow + r) * S::ldo + c]);
    }
    __syncwarp();
  }
}

// -- fp32: SIMT, lanes across D ---------------------------------------------

// Rotate (sign = 1) or inverse-rotate (sign = -1) the lane's columns of one
// row in registers: column lane + 32 j pairs with j + kCols / 2.
template <int D>
__device__ __forceinline__ void rot_regs(float* x, const float* cr,
                                         const float* sr, float sign) {
  constexpr int kCols = D / 32, kHalf = kCols / 2;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float lo = x[j], hi = x[j + kHalf];
    const int c = lane + 32 * j, c2 = c + 32 * kHalf;
    x[j] = rot1(lo, hi, cr[c], sign * sr[c]);
    x[j + kHalf] = rot1(hi, lo, cr[c2], sign * sr[c2]);
  }
}

template <int D>
__device__ __forceinline__ void load_row(float* x, const float* src,
                                         float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < D / 32; ++j) x[j] = src[lane + 32 * j] * scale;
}

// dK, dV: one warp per key row.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const uint8_t* __restrict__ kv_mask,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, float* __restrict__ dk,
                   float* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                   Strides sd, int H, int L, float scale, int causal) {
  constexpr int kCols = D / 32;
  const int lane = threadIdx.x & 31;
  const int kpos = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  if (kpos >= L) return;
  const float* cb = cos_t ? cos_t + (long long)b * L * D : nullptr;
  const float* sb = sin_t ? sin_t + (long long)b * L * D : nullptr;
  float kr[kCols], vr[kCols], dka[kCols], dva[kCols];
  load_row<D>(kr, k + b * sk.b + h * sk.h + kpos * sk.l, 1.f);
  load_row<D>(vr, v + b * sv.b + h * sv.h + kpos * sv.l, 1.f);
  if (cb != nullptr) rot_regs<D>(kr, cb + (long long)kpos * D,
                                 sb + (long long)kpos * D, 1.f);
#pragma unroll
  for (int j = 0; j < kCols; ++j) dka[j] = dva[j] = 0.f;
  const bool key_ok = kv_mask == nullptr || kv_mask[(long long)b * L + kpos];
  for (int qpos = causal ? kpos : 0; key_ok && qpos < L; ++qpos) {
    const long long at = ((long long)b * L + qpos) * H + h;
    const float l_q = lse[at];
    if (!(l_q > 0.5f * kNegInf)) continue;  // the row saw no key
    float qr[kCols], dor[kCols];
    load_row<D>(qr, q + b * sq.b + h * sq.h + qpos * sq.l, scale);
    if (cb != nullptr) rot_regs<D>(qr, cb + (long long)qpos * D,
                                   sb + (long long)qpos * D, 1.f);
    load_row<D>(dor, dout + b * sd.b + h * sd.h + qpos * sd.l, 1.f);
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s += qr[j] * kr[j];
      dp += dor[j] * vr[j];
    }
    const float p = expf(warp_sum(s) - l_q);
    const float ds = p * (warp_sum(dp) - delta[at]);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dva[j] += p * dor[j];
      dka[j] += ds * qr[j];
    }
  }
  if (cb != nullptr) rot_regs<D>(dka, cb + (long long)kpos * D,
                                 sb + (long long)kpos * D, -1.f);
  const long long o = (((long long)b * L + kpos) * H + h) * D;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    dk[o + lane + 32 * j] = dka[j];
    dv[o + lane + 32 * j] = dva[j];
  }
}

// dQ (fp32, before the deferred scale): one warp per query row.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const uint8_t* __restrict__ kv_mask,
                 const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, float* __restrict__ dq,
                 Strides sq, Strides sk, Strides sv, Strides sd, int H, int L,
                 float scale, int causal) {
  constexpr int kCols = D / 32;
  const int lane = threadIdx.x & 31;
  const int qpos = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  if (qpos >= L) return;
  const float* cb = cos_t ? cos_t + (long long)b * L * D : nullptr;
  const float* sb = sin_t ? sin_t + (long long)b * L * D : nullptr;
  const long long at = ((long long)b * L + qpos) * H + h;
  const float l_q = lse[at];
  const float d_q = delta[at];
  float qr[kCols], dor[kCols], acc[kCols];
  load_row<D>(qr, q + b * sq.b + h * sq.h + qpos * sq.l, scale);
  if (cb != nullptr) rot_regs<D>(qr, cb + (long long)qpos * D,
                                 sb + (long long)qpos * D, 1.f);
  load_row<D>(dor, dout + b * sd.b + h * sd.h + qpos * sd.l, 1.f);
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  const int end = (l_q > 0.5f * kNegInf) ? (causal ? qpos + 1 : L) : 0;
  for (int kpos = 0; kpos < end; ++kpos) {
    if (kv_mask != nullptr && kv_mask[(long long)b * L + kpos] == 0) continue;
    float kr[kCols], vr[kCols];
    load_row<D>(kr, k + b * sk.b + h * sk.h + kpos * sk.l, 1.f);
    if (cb != nullptr) rot_regs<D>(kr, cb + (long long)kpos * D,
                                   sb + (long long)kpos * D, 1.f);
    load_row<D>(vr, v + b * sv.b + h * sv.h + kpos * sv.l, 1.f);
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s += qr[j] * kr[j];
      dp += dor[j] * vr[j];
    }
    const float p = expf(warp_sum(s) - l_q);
    const float ds = p * (warp_sum(dp) - d_q);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] += ds * kr[j];
  }
  if (cb != nullptr) rot_regs<D>(acc, cb + (long long)qpos * D,
                                 sb + (long long)qpos * D, -1.f);
#pragma unroll
  for (int j = 0; j < kCols; ++j) dq[at * D + lane + 32 * j] = acc[j];
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const uint8_t* mask, const void* cos_t, const void* sin_t,
                float* dq_part, void* dk, void* dv, Strides sq, Strides sk,
                Strides sv, Strides sd, int B, int H, int L, float scale,
                int causal, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(flash_bwd_bf16<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) configured |= 1u << dev;
  }
  const dim3 grid((L + kBK - 1) / kBK, B * H);
  flash_bwd_bf16<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, mask,
      static_cast<const __nv_bfloat16*>(cos_t),
      static_cast<const __nv_bfloat16*>(sin_t), dq_part,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq,
      sk, sv, sd, B, H, L, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const uint8_t* mask,
               const void* cos_t, const void* sin_t, float* dq, void* dk,
               void* dv, Strides sq, Strides sk, Strides sv, Strides sd,
               int B, int H, int L, float scale, int causal,
               cudaStream_t stream) {
  const dim3 grid((L + kWarps - 1) / kWarps, B * H);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dp = static_cast<const float*>(dout);
  const float* cp = static_cast<const float*>(cos_t);
  const float* spp = static_cast<const float*>(sin_t);
  flash_bwd_dkdv_f32<D><<<grid, kThreads, 0, stream>>>(
      qp, kp, vp, dp, lse, delta, mask, cp, spp, static_cast<float*>(dk),
      static_cast<float*>(dv), sq, sk, sv, sd, H, L, scale, causal);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_f32<D><<<grid, kThreads, 0, stream>>>(
      qp, kp, vp, dp, lse, delta, mask, cp, spp, dq, sq, sk, sv, sd, H, L,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the bf16 backward at head dim D (0: unsupported).
extern "C" int apex_flash_attn_bwd_smem_bytes(int D) {
  if (D == 64) return (int)Smem<64>::bytes;
  if (D == 128) return (int)Smem<128>::bytes;
  return 0;
}

// q, k, v, dout: (B, L, H, D), element strides (b, l, h), unit stride over
// D; bf16 rows start on 16-byte boundaries.  lse, delta: contiguous
// (B, L, H) fp32.  kv_mask: (B, L) uint8 or null.  cos_t / sin_t: contiguous
// (B, L, D) tables in the input dtype, or both null.  dq: fp32; for bf16 it
// is ceil(L / 64) zero-filled partial planes of (B, L, H, D) (key tile t
// writes plane t; dead causal tiles leave zeros), for fp32 one (B, L, H, D)
// tensor.  dk, dv: contiguous (B, L, H, D) in the input dtype.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
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
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 64)
      return launch_bf16<64>(q, k, v, dout, lp, dl, mask, cos_t, sin_t, dqp,
                             dk, dv, sq, sk, sv, sd, B, H, L, scale, causal,
                             s);
    if (D == 128)
      return launch_bf16<128>(q, k, v, dout, lp, dl, mask, cos_t, sin_t,
                              dqp, dk, dv, sq, sk, sv, sd, B, H, L, scale,
                              causal, s);
  } else if (dtype == 0) {
    if (D == 64)
      return launch_f32<64>(q, k, v, dout, lp, dl, mask, cos_t, sin_t, dqp,
                            dk, dv, sq, sk, sv, sd, B, H, L, scale, causal,
                            s);
    if (D == 128)
      return launch_f32<128>(q, k, v, dout, lp, dl, mask, cos_t, sin_t, dqp,
                             dk, dv, sq, sk, sv, sd, B, H, L, scale, causal,
                             s);
  }
  return (int)cudaErrorInvalidValue;
}
