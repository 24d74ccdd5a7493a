// Flash-attention backward, dq pass (K13), for Hopper (sm_90a), with a plain
// C interface.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py, `_flash_bwd`'s dq
// kernel `_dq_kernel` (the first pass of the two-pass backward the TPU
// takes when the fused kernel's fp32 dq partials would exceed their
// budget; flash_attn_bwd_dkv.cu's K14 is the second, dk / dv).
//
// Computes (in bf16, or in fp16 by the same code instantiated on __half,
// "bf16" below then reading fp16), for (B, L, H, D) q^ (q pre-scaled in
// bf16 and rotated: flash_bwd_prologue.cu), k^ (k rotated), v, do, the forward's lse and
// delta = rowsum(o * do) - dlse ((B, L, H) fp32):
//   P = exp(S - lse) with S = q^ k^T (zero where causality, the key mask or
//   an empty row hides the pair), dP = dO V^T, dS = P * (dP - delta),
//   dQ = dS k^ with dS rounded to bf16,
// then dQ's inverse rotation in fp32, its rounding to bf16 and the one
// deferred `* scale` in bf16 (the scale rounded to bf16, the product
// rounded again: what `dq.astype(q.dtype) * scale` gives on the TPU path).
// A row that sees no key (lse = NEG_INF) gets dq = 0.
//
// What bounds it on the H100: the three products of each visible (q, k)
// pair (S recomputed, dP, dQ), 6 * D flops a pair, against reading q, k, v,
// do, lse, delta once and writing dq: at B1 L16384 H12 D64 causal 0.62
// TFLOP against 0.1 GB, so operations (~0.63 ms at 989 TFLOP/s) bound it.
//
// Design: one block of three warpgroups per (128-row q tile, batch * head),
// tiles scheduled longest-first under causality.  The producer warpgroup
// gives its registers to the two consumer warpgroups (setmaxnreg: 56 and
// 224 a thread) and one of its threads issues TMA: the q^ and dO tiles
// once, then the k^ / V tiles of 64 keys through a ring of shared-memory
// stages (3 at DP 64, 2 at DP 128) under full / empty mbarriers, up to the
// diagonal; with a key mask, its second warp gathers each tile's 64 mask
// bytes into the stage and arrives on the same barrier.  Each consumer
// warpgroup owns 64 of the q rows: S = q^ k^T and dP = dO V^T are wgmma
// with both operands in shared memory and fp32 accumulators in registers,
// committed as two groups so that P = exp(S - lse) (one fma and one ex2 an
// element) is formed in the accumulator layout while dP still runs; dS,
// packed to bf16, is the register A operand of dQ += dS k^, whose B is the
// same k^ tile read MN-major, and which runs on into the next tile's
// scores, the stage released once it retires.  The causal, ragged and mask
// tests run only on tiles that need them.  dQ stays in registers for the
// whole loop (the TPU's fp32 VMEM scratch); the epilogue stages it in
// shared memory for the inverse rotation.  A tile wholly above a
// warpgroup's rows is released unread.  No atomics, a fixed summation
// order: two runs give equal bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

using namespace apex_sm90;

template <int DP>
struct DqSmem {
  static constexpr int kStages = DP == 64 ? 3 : 2;
  static constexpr size_t q_tile = 128 * DP * 2;   // q^ or dO, 128 rows
  static constexpr size_t kv_tile = 64 * DP * 2;   // k^ or V, 64 rows
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + q_tile;
  static constexpr size_t ring = dout + q_tile;    // k^, V per stage
  static constexpr size_t stage = ring + kStages * 2 * kv_tile;  // fp32 dQ
  static constexpr size_t mask = stage + 128 * (DP + 8) * 4;     // 64 B each
  static constexpr size_t bars = mask + kStages * 64;
  // q_full, then full[kStages], empty[kStages]
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kStages);
  static constexpr size_t alloc = bytes + 1024;    // room to align the base
};

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const uint8_t* __restrict__ kv_mask,
                  const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                  T* __restrict__ dq, int H, int L, int D,
                  float scale, int causal) {
  using S = DqSmem<DP>;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_q = base + S::bars;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int n_qt = gridDim.y;
  const int iq = causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = iq * 128;
  const int n_k = (L + kBox - 1) / kBox;
  const int last = causal ? min((q0 + 127) / kBox, n_k - 1) : n_k - 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      // TMA's thread, and with a key mask the mask warp
      mbar_init(bar_full + 8 * s, kv_mask != nullptr ? 1 + 32 : 1);
      mbar_init(bar_empty + 8 * s, 4 * kConsumers);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // -- producer ---------------------------------------------------------
    regs_dec<kProducerRegs>();
    const int pt = threadIdx.x - 128 * kConsumers;  // 0 .. 127
    if (pt == 0) {
      mbar_expect(bar_q, 2 * S::q_tile);
      tma_tile<DP>(base + S::q, &tm_q, bar_q, 128, h, q0, b);
      tma_tile<DP>(base + S::dout, &tm_do, bar_q, 128, h, q0, b);
      for (int it = 0; it <= last; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(bar_empty + 8 * s, (it / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t kt = base + S::ring + s * 2 * S::kv_tile;
        mbar_expect(full, 2 * S::kv_tile);
        tma_tile<DP>(kt, &tm_k, full, 64, h, it * kBox, b);
        tma_tile<DP>(kt + S::kv_tile, &tm_v, full, 64, h, it * kBox, b);
      }
    } else if (pt / 32 == 1 && kv_mask != nullptr) {
      // the mask warp: lane i takes keys i and i + 32 of each tile (0 past
      // L); each lane's arrive releases its own stores
      const int lane = pt % 32;
      for (int it = 0; it <= last; ++it) {
        const int s = it % kStages;
        const int k0 = it * kBox;
        if (it >= kStages) mbar_wait(bar_empty + 8 * s, (it / kStages - 1) & 1);
        uint8_t* mk = smem + S::mask + 64 * s;
        for (int i = lane; i < 64; i += 32)
          mk[i] = k0 + i < L ? kv_mask[(long long)b * L + k0 + i] : 0;
        mbar_arrive(bar_full + 8 * s);
      }
    }
  } else {
    // -- consumers: warpgroup cw owns q rows q0 + 64 cw .. + 63 --------------
    regs_inc<kConsumerRegs>();
    const int cw = wg;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int t2 = 2 * (lane % 4);
    const int first_row = q0 + 64 * cw;
    const int my_row = first_row + (tid / 32) * 16 + lane / 4;  // and + 8
    float lse2[2], del_r[2];  // lse2: lse log2 e
    bool row_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = my_row + 8 * i;
      const long long at = ((long long)b * L + pos) * H + h;
      const float l = pos < L ? lse[at] : kNegInf;
      lse2[i] = l * kLog2e;
      del_r[i] = pos < L ? delta[at] : 0.f;
      row_ok[i] = l > 0.5f * kNegInf;
    }

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float s_acc[32], p_acc[32];
    uint32_t a_ds[16] = {};
    // The stage whose dQ product may still be running (its k^ is read until
    // that product retires), or -1.
    int pending = -1;

    mbar_wait(bar_q, 0);
    for (int it = 0; it <= last; ++it) {
      const int s = it % kStages;
      const int k0 = it * kBox;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      if (causal && k0 > first_row + 63) {  // wholly above these rows
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
        continue;
      }
      const uint32_t kt = base + S::ring + s * 2 * S::kv_tile;
      // S = q^ k^T and dP = dO V^T, two groups behind the last tile's dQ
      wgmma_fence();
      scores<DP, 64, T>(s_acc, base + S::q, 128, 64 * cw, kt, 64, 0);
      wgmma_commit();
      scores<DP, 64, T>(p_acc, base + S::dout, 128, 64 * cw, kt + S::kv_tile, 64,
                     0);
      wgmma_commit();
      wgmma_wait<1>();  // the last dQ and S have retired; dP may run on
      pin<32>(s_acc);
      pin<DP / 2>(acc);
      pin<16>(a_ds);
      if (pending >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * pending);
      }
      // P = exp(S - lse) in place of S, while dP runs; the tests only where
      // causality, the ragged end or the key mask reach into the tile
      const bool edge = (causal && k0 + kBox - 1 > first_row) ||
                        k0 + kBox > L || kv_mask != nullptr;
      const uint8_t* mk = smem + S::mask + 64 * s;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int col = 8 * (i >> 2) + t2 + (i & 1);
        bool ok = row_ok[r];
        if (edge) {
          const int kpos = k0 + col;
          ok = ok && kpos < L && (kv_mask == nullptr || mk[col] != 0) &&
               (!causal || kpos <= my_row + 8 * r);
        }
        s_acc[i] = ok ? exp2_approx(fmaf(s_acc[i], kLog2e, -lse2[r])) : 0.f;
      }
      wgmma_wait<0>();
      pin<32>(p_acc);
      // dS = P (dP - delta), packed to bf16: the A operand of dQ += dS k^
      // (k^ read MN-major: its rows are the reduction)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s_acc[i] = s_acc[i] * (p_acc[i] - del_r[(i >> 1) & 1]);
      to_a_operand<64, T>(s_acc, a_ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DP, T>(acc, a_ds + 4 * kk, mnmajor(kt, 64, kk));
      wgmma_commit();
      pending = s;
    }
    wgmma_wait<0>();
    pin<DP / 2>(acc);
    pin<16>(a_ds);
    if (pending >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * pending);
    }

    // Emit dQ: staged, inverse-rotated, rounded to bf16, times the scale.
    float* stage =
        reinterpret_cast<float*>(smem + S::stage) + 64 * cw * (DP + 8);
    stage_acc<DP>(stage, acc, tid);
    warpgroup_sync(1 + cw);
    write_rows<DP, T>(dq, stage, tid, b, h, first_row, L, H, D, cos_t, sin_t, true,
                   scale);
  }
}

template <int DP, typename T>
int launch(const CUtensorMap* maps, const float* lse, const float* delta,
           const uint8_t* kv_mask, const void* cos_t, const void* sin_t,
           void* dq, int B, int H, int L, int D, float scale,
           int causal, cudaStream_t stream) {
  static unsigned configured = 0;
  cudaError_t e = apex_fa::opt_in_smem(flash_bwd_dq_sm90<DP, T>,
                                       DqSmem<DP>::alloc, &configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (L + 127) / 128);
  flash_bwd_dq_sm90<DP, T><<<grid, kThreads, DqSmem<DP>::alloc, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, kv_mask,
      static_cast<const T*>(cos_t), static_cast<const T*>(sin_t),
      static_cast<T*>(dq), H, L, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the dq pass at padded head width DP (64 or 128;
// 0: unsupported).
extern "C" int apex_flash_attn_bwd_dq_smem_bytes(int DP) {
  if (DP == 64) return (int)DqSmem<64>::alloc;
  if (DP == 128) return (int)DqSmem<128>::alloc;
  return 0;
}

// qh, kh, v, dout: bf16 or fp16 (dtype 1 / 2) (B, L, H, D) operands, each
// described by 7 words of `geo` (dims D, H, L, B and the byte strides of
// H, L, B; the wrapper checked them for TMA).  lse, delta: contiguous (B, L, H) fp32.  kv_mask:
// (B, L) uint8 or null.  cos_t / sin_t: contiguous (B, L, D) tables of the
// operands' type, or both null.  dq: contiguous (B, L, H, D) of that type,
// every element written.  scale: the softmax scale rounded to that type
// (dq's deferred scale).  Returns
// 0, a cudaError_t, or an encoder error (kMapErrorBase - CUresult).
extern "C" int apex_flash_attn_bwd_dq(
    const void* qh, const void* kh, const void* v, const void* dout,
    const long long* geo, const void* lse, const void* delta,
    const void* kv_mask, const void* cos_t, const void* sin_t, void* dq,
    int B, int L, int H, int D, float scale, int causal, int dtype,
    void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D % 8 != 0 || D <= 0 || D > 128 ||
      (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  const bool half = dtype == 2;
  CUtensorMap maps[4];
  const void* ptrs[4] = {qh, kh, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int e = encode_map(&maps[i], ptrs[i], geo + kGeoWords * i, half);
    if (e != 0) return e;
  }
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const uint8_t* mp = static_cast<const uint8_t*>(kv_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half)
    return D <= 64 ? launch<64, __half>(maps, lp, dl, mp, cos_t, sin_t, dq, B,
                                        H, L, D, scale, causal, s)
                   : launch<128, __half>(maps, lp, dl, mp, cos_t, sin_t, dq,
                                         B, H, L, D, scale, causal, s);
  return D <= 64 ? launch<64, __nv_bfloat16>(maps, lp, dl, mp, cos_t, sin_t,
                                             dq, B, H, L, D, scale, causal, s)
                 : launch<128, __nv_bfloat16>(maps, lp, dl, mp, cos_t, sin_t,
                                              dq, B, H, L, D, scale, causal,
                                              s);
}
