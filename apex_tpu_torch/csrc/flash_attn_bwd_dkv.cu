// Flash-attention backward, dk / dv pass (K14), for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py, `_flash_bwd`'s dk / dv
// kernel `_dkv_kernel` (the second pass of the two-pass backward the TPU
// takes above the fused kernel's partials budget; K13 in
// flash_attn_bwd_dq.cu is the first).
//
// Computes (in bf16, or in fp16 by the same code instantiated on __half,
// "bf16" below then reading fp16), for (B, L, H, D) q^ (q pre-scaled in
// bf16 and rotated: flash_bwd_prologue.cu), k^ (k rotated), v, do and the forward's lse and
// delta ((B, L, H) fp32): with S^T = k^ q^T,
//   P^T = exp(S^T - lse) (zero where causality, the key mask or an empty
//   row hides the pair), dV = P^T dO with P rounded to bf16,
//   dP^T = V dO^T, dS^T = P^T * (dP^T - delta), dK = dS^T q^ with dS
//   rounded to bf16 (exact: the scale lives in q^),
// then dK's inverse rotation in fp32; dK and dV are written in bf16.
//
// What bounds it on the H100: the four products of each visible pair (S
// recomputed, dP, dV, dK), 8 * D flops a pair, against reading q, k, v, do,
// lse, delta once and writing dk, dv: at B1 L16384 H12 D64 causal 0.82
// TFLOP against 0.1 GB, so operations (~0.83 ms at 989 TFLOP/s) bound it.
//
// Design: one block of three warpgroups per (128-key tile, batch * head),
// tiles scheduled longest-first under causality.  The producer warpgroup
// gives its registers to the two consumer warpgroups (setmaxnreg: 56 and
// 224 a thread) and one of its threads issues TMA: the k^ and V tiles once,
// then the q^ / dO tiles of 64 queries through a ring of shared-memory
// stages (3 at DP 64, 2 at DP 128) under full / empty mbarriers, from the
// diagonal on (causal) or over all, while its second warp gathers each
// tile's 64 lse and delta values (H apart in device memory) into the
// stage and arrives on the same barrier.  Each
// consumer warpgroup owns 64 of the keys: S^T = k^ q^T and dP^T = V dO^T
// are wgmma with both operands in shared memory, committed as two groups so
// that P^T = exp(S^T - lse) (one fma and one ex2 an element) is formed in
// the accumulator layout while dP^T still runs; packed to bf16, P^T is the
// register A operand of dV += P^T dO, issued before dS^T is formed, and
// dS^T that of dK += dS^T q^ (the B tiles read MN-major), which runs on
// into the next tile's scores, the stage released once it retires.  At DP
// 128, where dK and dV take 128 registers a thread, a q tile is taken in
// two parts of 32 queries.  The causal and ragged tests run only on tiles
// that need them.  dK and dV stay in registers for the whole loop (the
// TPU's fp32 VMEM scratch); the epilogue stages them in shared memory, dK
// for its inverse rotation.  A tile wholly before a warpgroup's keys is
// released unread.  No atomics, a fixed summation order: two runs give
// equal bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

using namespace apex_sm90;

template <int DP>
struct DkvSmem {
  static constexpr int kStages = DP == 64 ? 3 : 2;
  static constexpr size_t k_tile = 128 * DP * 2;   // k^ or V, 128 rows
  static constexpr size_t q_tile = 64 * DP * 2;    // q^ or dO, 64 rows
  static constexpr size_t k = 0;
  static constexpr size_t v = k + k_tile;
  static constexpr size_t ring = v + k_tile;       // q^, dO per stage
  static constexpr size_t stage = ring + kStages * 2 * q_tile;  // fp32 dK/dV
  static constexpr size_t stats = stage + 128 * (DP + 8) * 4;   // lse, delta
  static constexpr size_t bars = stats + kStages * 2 * 64 * 4;
  // kv_full, then full[kStages], empty[kStages]
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kStages);
  static constexpr size_t alloc = bytes + 1024;    // room to align the base
};

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const uint8_t* __restrict__ kv_mask,
                   const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                   T* __restrict__ dk, T* __restrict__ dv, int H, int L, int D,
                   int causal) {
  using S = DkvSmem<DP>;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_kv = base + S::bars;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * 128;
  const int n_q = (L + kBox - 1) / kBox;
  const int first = causal ? k0 / kBox : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1 + 32);  // TMA's thread + the stats warp
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
      mbar_expect(bar_kv, 2 * S::k_tile);
      tma_tile<DP>(base + S::k, &tm_k, bar_kv, 128, h, k0, b);
      tma_tile<DP>(base + S::v, &tm_v, bar_kv, 128, h, k0, b);
      for (int it = 0; first + it < n_q; ++it) {
        const int s = it % kStages;
        const int q0 = (first + it) * kBox;
        if (it >= kStages) mbar_wait(bar_empty + 8 * s, (it / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t qt = base + S::ring + s * 2 * S::q_tile;
        mbar_expect(full, 2 * S::q_tile);
        tma_tile<DP>(qt, &tm_q, full, 64, h, q0, b);
        tma_tile<DP>(qt + S::q_tile, &tm_do, full, 64, h, q0, b);
      }
    } else if (pt / 32 == 1) {
      // the stats warp: lane i takes queries i and i + 32 of each tile (past
      // L, NEG_INF: the row sees no key); each lane's arrive releases its
      // own stores
      const int lane = pt % 32;
      for (int it = 0; first + it < n_q; ++it) {
        const int s = it % kStages;
        const int q0 = (first + it) * kBox;
        if (it >= kStages) mbar_wait(bar_empty + 8 * s, (it / kStages - 1) & 1);
        float* st = reinterpret_cast<float*>(smem + S::stats) + s * 2 * 64;
        for (int i = lane; i < 64; i += 32) {
          const long long at = ((long long)b * L + q0 + i) * H + h;
          st[i] = q0 + i < L ? lse[at] : kNegInf;
          st[64 + i] = q0 + i < L ? delta[at] : 0.f;
        }
        mbar_arrive(bar_full + 8 * s);
      }
    }
  } else {
    // -- consumers: warpgroup cw owns keys k0 + 64 cw .. + 63 ----------------
    regs_inc<kConsumerRegs>();
    const int cw = wg;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int t2 = 2 * (lane % 4);
    const int first_key = k0 + 64 * cw;
    const int my_key = first_key + (tid / 32) * 16 + lane / 4;  // and + 8
    bool key_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kpos = my_key + 8 * i;
      key_ok[i] = kpos < L &&
                  (kv_mask == nullptr || kv_mask[(long long)b * L + kpos] != 0);
    }

    float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    // A q tile's 64 queries in parts of kN (32 at DP 128, where dK and dV
    // already take 128 registers a thread)
    constexpr int kN = DP == 64 ? 64 : 32;
    float s_acc[kN / 2], p_acc[kN / 2];
    uint32_t a_p[kN / 4] = {}, a_ds[kN / 4] = {};
    // The stage whose dV / dK products may still be running, or -1.
    int pending = -1;

    mbar_wait(bar_kv, 0);
    for (int it = 0; first + it < n_q; ++it) {
      const int s = it % kStages;
      const int q0 = (first + it) * kBox;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      if (causal && q0 + kBox - 1 < first_key) {  // wholly before these keys
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
        continue;
      }
      const uint32_t qt = base + S::ring + s * 2 * S::q_tile;
      const float* lse_s =
          reinterpret_cast<const float*>(smem + S::stats) + s * 2 * 64;
      const float* delta_s = lse_s + 64;
      // the tests only where causality or the ragged end reach into the tile
      const bool edge = (causal && q0 < first_key + kBox - 1) || q0 + kBox > L;
#pragma unroll
      for (int part = 0; part < 64 / kN; ++part) {
        const int c0 = part * kN;  // this part's first query of the tile
        // S^T = k^ q^T and dP^T = V dO^T, two groups behind the last dV / dK
        wgmma_fence();
        scores<DP, kN, T>(s_acc, base + S::k, 128, 64 * cw, qt, 64, c0);
        wgmma_commit();
        scores<DP, kN, T>(p_acc, base + S::v, 128, 64 * cw, qt + S::q_tile, 64,
                       c0);
        wgmma_commit();
        wgmma_wait<1>();  // the last dV / dK and S^T have retired
        pin<kN / 2>(s_acc);
        pin<DP / 2>(acc_k);
        pin<kN / 4>(a_ds);
        if (pending >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * pending);
          pending = -1;
        }
        // P^T = exp(S^T - lse) in place of S^T, while dP^T runs
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int col = c0 + 8 * (i >> 2) + t2 + (i & 1);
          const float l_q = lse_s[col];
          bool ok = key_ok[r] && l_q > 0.5f * kNegInf;
          if (edge) {
            const int qpos = q0 + col;
            ok = ok && qpos < L && (!causal || my_key + 8 * r <= qpos);
          }
          s_acc[i] = ok ? exp2_approx(fmaf(s_acc[i], kLog2e, -l_q * kLog2e))
                        : 0.f;
        }
        // dV += P^T dO (dO read MN-major)
        to_a_operand<kN, T>(s_acc, a_p);
        wgmma_fence();
        pin<DP / 2>(acc_v);
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_rs<DP, T>(acc_v, a_p + 4 * kk,
                       mnmajor(qt + S::q_tile, 64, c0 / 16 + kk));
        wgmma_commit();
        wgmma_wait<1>();  // dP^T has retired; dV may run on
        pin<kN / 2>(p_acc);
        // dS^T = P^T (dP^T - delta); dK += dS^T q^ (q^ read MN-major)
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int col = c0 + 8 * (i >> 2) + t2 + (i & 1);
          p_acc[i] = s_acc[i] * (p_acc[i] - delta_s[col]);
        }
        to_a_operand<kN, T>(p_acc, a_ds);
        wgmma_fence();
        pin<DP / 2>(acc_k);
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          wgmma_rs<DP, T>(acc_k, a_ds + 4 * kk, mnmajor(qt, 64, c0 / 16 + kk));
        wgmma_commit();
        wgmma_wait<1>();  // dV has retired; dK may run on
        pin<DP / 2>(acc_v);
        pin<kN / 4>(a_p);
      }
      pending = s;
    }
    wgmma_wait<0>();
    pin<DP / 2>(acc_k);
    pin<kN / 4>(a_ds);
    if (pending >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * pending);
    }

    // Emit dK (inverse-rotated) and dV, through this warpgroup's staging rows.
    float* stage =
        reinterpret_cast<float*>(smem + S::stage) + 64 * cw * (DP + 8);
    stage_acc<DP>(stage, acc_k, tid);
    warpgroup_sync(1 + cw);
    write_rows<DP, T>(dk, stage, tid, b, h, first_key, L, H, D, cos_t, sin_t,
                   false, 1.f);
    warpgroup_sync(1 + cw);
    stage_acc<DP>(stage, acc_v, tid);
    warpgroup_sync(1 + cw);
    write_rows<DP, T>(dv, stage, tid, b, h, first_key, L, H, D, nullptr, nullptr,
                   false, 1.f);
  }
}

template <int DP, typename T>
int launch(const CUtensorMap* maps, const float* lse, const float* delta,
           const uint8_t* kv_mask, const void* cos_t, const void* sin_t,
           void* dk, void* dv, int B, int H, int L, int D, int causal,
           cudaStream_t stream) {
  static unsigned configured = 0;
  cudaError_t e = apex_fa::opt_in_smem(flash_bwd_dkv_sm90<DP, T>,
                                       DkvSmem<DP>::alloc, &configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (L + 127) / 128);
  flash_bwd_dkv_sm90<DP, T><<<grid, kThreads, DkvSmem<DP>::alloc, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, kv_mask,
      static_cast<const T*>(cos_t), static_cast<const T*>(sin_t),
      static_cast<T*>(dk), static_cast<T*>(dv), H, L, D, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the dk / dv pass at padded head width DP (64 or
// 128; 0: unsupported).
extern "C" int apex_flash_attn_bwd_dkv_smem_bytes(int DP) {
  if (DP == 64) return (int)DkvSmem<64>::alloc;
  if (DP == 128) return (int)DkvSmem<128>::alloc;
  return 0;
}

// The operands as apex_flash_attn_bwd_dq's; dk, dv: contiguous (B, L, H, D)
// of the operands' type, every element written.  Returns 0, a cudaError_t, or an encoder
// error (kMapErrorBase - CUresult).
extern "C" int apex_flash_attn_bwd_dkv(
    const void* qh, const void* kh, const void* v, const void* dout,
    const long long* geo, const void* lse, const void* delta,
    const void* kv_mask, const void* cos_t, const void* sin_t, void* dk,
    void* dv, int B, int L, int H, int D, int causal, int dtype,
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
    return D <= 64 ? launch<64, __half>(maps, lp, dl, mp, cos_t, sin_t, dk,
                                        dv, B, H, L, D, causal, s)
                   : launch<128, __half>(maps, lp, dl, mp, cos_t, sin_t, dk,
                                         dv, B, H, L, D, causal, s);
  return D <= 64 ? launch<64, __nv_bfloat16>(maps, lp, dl, mp, cos_t, sin_t,
                                             dk, dv, B, H, L, D, causal, s)
                 : launch<128, __nv_bfloat16>(maps, lp, dl, mp, cos_t, sin_t,
                                              dk, dv, B, H, L, D, causal, s);
}
