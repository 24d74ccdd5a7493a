// The fused flash-attention backward (K4, and K18 behind flash_attention_mh)
// for Hopper (sm_90a), and its finish pass, with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py, `_flash_bwd_fused`
// (:477, pallas_call :487) and its kernel `_bwd_fused_kernel` (:362): the
// one-pass backward the TPU takes while the dq partial planes fit their
// budget (`_flash_bwd_rule`), the planes summed at :519; and
// apex_tpu/ops/pallas/experimental/flash_mh.py, `_mh_bwd_fused` (:240,
// pallas_call :246, kernel `_bwd_fused_kernel` :129, the sum at :276): the
// same function for flash_attention_mh, whose (B, L, H * D) operands reach
// this kernel as (B, L, H, D) views, read through their strides.
//
// Computes (in bf16, or in fp16 by the same code instantiated on __half,
// "bf16" below then reading fp16), for (B, L, H, D) q^ (q pre-scaled in
// bf16 and rotated: flash_bwd_prologue.cu), k^ (k rotated), v, do and the
// forward's lse and delta = rowsum(o * do) - dlse ((B, L, H) fp32):
//   P = exp(S - lse), S = q^ k^T (zero where causality, the key mask, a
//   ragged L or an empty row hides the pair), dV = P^T dO with P rounded
//   to bf16, dP = dO V^T, dS = P (dP - delta) rounded to bf16,
//   dK = dS^T q^ (exact: the scale lives in q^), dQ = dS k^.
// dK is inverse-rotated in fp32 and written with dV in bf16.  dQ leaves as
// fp32 partial planes (nk, B, L, H, D), plane j holding the contribution
// of the 64 keys 64 j ..; under causality the rows before a plane's keys
// are neither written nor read.  The finish pass (flash_bwd_finish) sums
// each row's planes in ascending j in fp32, inverse-rotates the sum in fp32
// (rotation is linear, as the JAX kernel notes: the same as rotating each
// plane), rounds it to bf16 and multiplies by the scale in bf16: the one
// deferred scale of `_flash_bwd_rule` and `_mh_bwd_rule`.
//
// What bounds it on the H100: the five products of each visible pair (S
// recomputed, dP, dV, dK, dQ), 10 * D flops at 989 TFLOP/s, against the
// bytes: q^, k^, v, do, lse, delta read once, dk, dv written once, and the
// planes written once here and read once by the finish pass.  At BERT's
// (32, 512, 16, 64) the 537 MB of planes, moved twice at 3.35 TB/s (0.32
// ms), bound it above its 86 GFLOP (0.087 ms).
//
// Design: K14's (flash_attn_bwd_dkv.cu) with the fifth product.  One block
// of three warpgroups per (128-key tile, batch * head), tiles scheduled
// longest-first under causality.  The producer warpgroup gives its
// registers to the two consumer warpgroups (setmaxnreg: 56 and 224 a
// thread) and one of its threads issues TMA: the k^ and V tiles once, then
// the q^ / dO tiles of 64 queries through a ring of shared-memory stages (3
// at DP 64, 2 at DP 128) under full / empty mbarriers, while its second
// warp gathers each tile's 64 lse and delta values into the stage.  Each
// consumer warpgroup owns 64 of the keys and forms S^T, P^T, dP^T and dS^T
// in its accumulators, with dV += P^T dO and dK += dS^T q^ in registers
// for the whole loop, exactly as K14 does (a q tile in two parts of 32
// queries at DP 128).  New: each consumer stores its dS^T, packed to bf16,
// into its 64 rows of a shared-memory tile in the 128-byte swizzled layout
// TMA gives a box; after a barrier of its own warps, dQ of the q tile (64
// x DP) = dS (64 x its 64 keys) k^ is one wgmma chain a 64-column slice of
// D (32 accumulator registers a thread), both operands in shared memory
// and read MN-major (dS from its dS^T rows, k^ from its rows of the
// resident key tile).  It retires before the next tile's scores, and each
// thread writes its fp32 pairs straight into the warpgroup's plane with
// 8-byte stores.  The two consumers share nothing but the k^ / V tiles:
// no barrier between them.  (One plane a 128-key block, the two
// consumers' dS^T exchanged through shared memory, halves the planes but
// made the whole call at (8, 2048, 12, 64) slower than the two-pass
// route's on an H100 (PERF.md); with one plane a 64-key warpgroup the gate
// keeps that shape on the two-pass route.)  No atomics, a fixed summation
// order everywhere: two runs give equal bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

using namespace apex_sm90;

// Keys of one block's tile, and of one dq partial plane (one consumer
// warpgroup's keys).
constexpr int kKeyTile = 128;
constexpr int kPlaneKeys = 64;

template <int DP>
struct FusedSmem {
  static constexpr int kStages = DP == 64 ? 3 : 2;
  static constexpr size_t k_tile = kKeyTile * DP * 2;  // k^ or V
  static constexpr size_t q_tile = 64 * DP * 2;        // q^ or dO, 64 rows
  static constexpr size_t ds_tile = kKeyTile * 64 * 2;  // dS^T: keys x queries
  static constexpr size_t k = 0;
  static constexpr size_t v = k + k_tile;
  static constexpr size_t ring = v + k_tile;           // q^, dO per stage
  static constexpr size_t ds = ring + kStages * 2 * q_tile;
  static constexpr size_t stage = ds + ds_tile;        // fp32 dK / dV
  static constexpr size_t stats = stage + kKeyTile * (DP + 8) * 4;
  static constexpr size_t bars = stats + kStages * 2 * 64 * 4;
  // kv_full, then full[kStages], empty[kStages]
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kStages);
  static constexpr size_t alloc = bytes + 1024;        // room to align the base
};

// Store this thread's packed dS^T words of one part (queries c0 .. c0 + kN
// - 1 of the q tile) into the dS^T tile: row = key (this warpgroup's 64 at
// 64 cw), 64 queries a 128-byte row, its 16-byte chunks permuted by the
// swizzle (chunk ^ (row % 8)), as a TMA box lands.  Word j holds the
// accumulator's (row + 8 (j % 2), columns 8 (j / 2) + t2, + 1).
template <int kN>
__device__ __forceinline__ void store_ds(unsigned char* tile,
                                         const uint32_t* a, int cw, int tid,
                                         int c0) {
  const int lane = tid % 32;
  const int r0 = 64 * cw + (tid / 32) * 16 + lane / 4;
  const int t2 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kN / 4; ++j) {
    const int r = r0 + 8 * (j & 1);
    const int c = c0 + 8 * (j >> 1);
    *reinterpret_cast<uint32_t*>(tile + r * kRowBytes +
                                 (((c >> 3) ^ (r & 7)) << 4) + 2 * t2) = a[j];
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_fused_sm90(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const uint8_t* __restrict__ kv_mask,
                     const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ planes, int H, int L, int D,
                     int causal) {
  using S = FusedSmem<DP>;
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
  const int k0 = blockIdx.y * kKeyTile;
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
    // -- producer (K14's) -------------------------------------------------
    regs_dec<kProducerRegs>();
    const int pt = threadIdx.x - 128 * kConsumers;  // 0 .. 127
    if (pt == 0) {
      mbar_expect(bar_kv, 2 * S::k_tile);
      tma_tile<DP>(base + S::k, &tm_k, bar_kv, kKeyTile, h, k0, b);
      tma_tile<DP>(base + S::v, &tm_v, bar_kv, kKeyTile, h, k0, b);
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
    // This warpgroup's rows of the dS^T tile and of the k^ tile (its keys:
    // the reduction of its dQ product), and its dq partial plane (none when
    // its keys start at or past L: ceil(L / 64) planes).
    const uint32_t ds_rows = base + S::ds + 64 * cw * kRowBytes;
    const uint32_t k_rows = base + S::k + 64 * cw * kRowBytes;
    const bool has_plane = first_key < L;
    float* plane =
        planes + (long long)(2 * blockIdx.y + cw) * gridDim.x * L * D;

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
        // S^T = k^ q^T and dP^T = V dO^T, two groups behind the last dK
        wgmma_fence();
        scores<DP, kN, T>(s_acc, base + S::k, kKeyTile, 64 * cw, qt, 64, c0);
        wgmma_commit();
        scores<DP, kN, T>(p_acc, base + S::v, kKeyTile, 64 * cw,
                          qt + S::q_tile, 64, c0);
        wgmma_commit();
        wgmma_wait<1>();  // the last dK and S^T have retired
        pin<kN / 2>(s_acc);
        pin<DP / 2>(acc_k);
        pin<kN / 4>(a_ds);
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
        // dS^T = P^T (dP^T - delta): the A operand of dK += dS^T q^ (q^
        // read MN-major), and this part's columns of the dS^T tile
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int col = c0 + 8 * (i >> 2) + t2 + (i & 1);
          p_acc[i] = s_acc[i] * (p_acc[i] - delta_s[col]);
        }
        to_a_operand<kN, T>(p_acc, a_ds);
        store_ds<kN>(smem + S::ds, a_ds, cw, tid, c0);
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
      // dQ (64 queries x DP) over this warpgroup's 64 keys = dS k^: A its
      // rows of the dS^T tile, B its rows of the k^ tile, both read
      // MN-major, 64 columns of D at a time; it retires (with the last dK)
      // before the next tile's scores.
      fence_proxy_async();        // the dS^T stores, before wgmma reads them
      warpgroup_sync(1 + cw);     // every warp's rows are in place
#pragma unroll
      for (int nh = 0; nh < DP / 64; ++nh) {
        float dq[32];
        const uint32_t kb = k_rows + nh * kKeyTile * kRowBytes;
        wgmma_fence();
        wgmma_ss_mn<false, T>(dq, mnmajor(ds_rows, 64, 0),
                              mnmajor(kb, kKeyTile, 0));
#pragma unroll
        for (int kk = 1; kk < 4; ++kk)
          wgmma_ss_mn<true, T>(dq, mnmajor(ds_rows, 64, kk),
                               mnmajor(kb, kKeyTile, kk));
        wgmma_commit();
        wgmma_wait<0>();  // dQ (and, first, the last dK) has retired
        pin<32>(dq);
        pin<DP / 2>(acc_k);
        pin<kN / 4>(a_ds);
        if (nh == 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * s);
        }
        if (!has_plane) continue;
        // rows 16 w + lane / 4 (+ 8), columns 8 n + t2 (+ 1) of the product
        const int row = q0 + (tid / 32) * 16 + lane / 4;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 64 * nh + 8 * n + t2;
          if (col >= D) continue;  // D is even: col + 1 < D too
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = row + 8 * i;
            if (q < L)
              *reinterpret_cast<float2*>(
                  plane + (((long long)b * L + q) * H + h) * D + col) =
                  make_float2(dq[4 * n + 2 * i], dq[4 * n + 2 * i + 1]);
          }
        }
      }
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
    write_rows<DP, T>(dv, stage, tid, b, h, first_key, L, H, D, nullptr,
                      nullptr, false, 1.f);
  }
}

// The finish pass: one thread per (row (b, l, h), chunk of kV columns of
// the first half and the same of the second).  Sums the planes that reach the
// row (all of them; under causality j <= l / 64) in ascending j in fp32,
// inverse-rotates with the full-width tables (the lane rotation with the
// sine negated, each product and the sum rounded on their own), rounds to
// T, multiplies by `scale` (the scale rounded to T) and rounds again.
// What bounds it: bytes (each plane row read once, dq written once).
constexpr int kV = 4;

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_finish(const float* __restrict__ planes,
                 const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                 T* __restrict__ dq, int L, int H, int D, int n_planes,
                 long long plane_elems, float scale, int causal,
                 long long items) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= items) return;
  const int hd = D / 2;
  const int per_row = hd / kV;
  const long long row = i / per_row;
  const int c = (int)(i % per_row) * kV;
  const long long bl = row / H;
  const int l = (int)(bl % L);
  const int last = causal ? min(l / kPlaneKeys, n_planes - 1) : n_planes - 1;
  float lo[kV], hi[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) lo[e] = hi[e] = 0.f;
  const float* p = planes + row * D + c;
  for (int j = 0; j <= last; ++j, p += plane_elems) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 z = *reinterpret_cast<const float4*>(p + hd);
    lo[0] = __fadd_rn(lo[0], a.x);
    lo[1] = __fadd_rn(lo[1], a.y);
    lo[2] = __fadd_rn(lo[2], a.z);
    lo[3] = __fadd_rn(lo[3], a.w);
    hi[0] = __fadd_rn(hi[0], z.x);
    hi[1] = __fadd_rn(hi[1], z.y);
    hi[2] = __fadd_rn(hi[2], z.z);
    hi[3] = __fadd_rn(hi[3], z.w);
  }
  if (cos_t != nullptr) {
    const long long t = bl * D + c;  // (b, l) row of the (B, L, D) tables
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float l2 =
          rot1(lo[e], hi[e], to_f32(cos_t[t + e]), -to_f32(sin_t[t + e]));
      hi[e] = rot1(hi[e], lo[e], to_f32(cos_t[t + hd + e]),
                   -to_f32(sin_t[t + hd + e]));
      lo[e] = l2;
    }
  }
  T* out = dq + row * D + c;
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    out[e] = from_f32<T>(__fmul_rn(to_f32(from_f32<T>(lo[e])), scale));
    out[e + hd] = from_f32<T>(__fmul_rn(to_f32(from_f32<T>(hi[e])), scale));
  }
}

template <int DP, typename T>
int launch(const CUtensorMap* maps, const float* lse, const float* delta,
           const uint8_t* kv_mask, const void* cos_t, const void* sin_t,
           float* planes, void* dk, void* dv, int B, int H, int L, int D,
           int causal, cudaStream_t stream) {
  static unsigned configured = 0;
  cudaError_t e = apex_fa::opt_in_smem(flash_bwd_fused_sm90<DP, T>,
                                       FusedSmem<DP>::alloc, &configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (L + kKeyTile - 1) / kKeyTile);
  flash_bwd_fused_sm90<DP, T><<<grid, kThreads, FusedSmem<DP>::alloc,
                                stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, kv_mask,
      static_cast<const T*>(cos_t), static_cast<const T*>(sin_t),
      static_cast<T*>(dk), static_cast<T*>(dv), planes, H, L, D, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finish(const float* planes, const void* cos_t, const void* sin_t,
                  void* dq, int B, int L, int H, int D, int n_planes,
                  float scale, int causal, cudaStream_t stream) {
  const long long items = (long long)B * L * H * (D / 2 / kV);
  const int threads = 256;
  const long long blocks = (items + threads - 1) / threads;
  flash_bwd_finish<T><<<(unsigned)blocks, threads, 0, stream>>>(
      planes, static_cast<const T*>(cos_t), static_cast<const T*>(sin_t),
      static_cast<T*>(dq), L, H, D, n_planes, (long long)B * L * H * D,
      scale, causal, items);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the fused backward at padded head width DP (64
// or 128; 0: unsupported).
extern "C" int apex_flash_bwd_fused_smem_bytes(int DP) {
  if (DP == 64) return (int)FusedSmem<64>::alloc;
  if (DP == 128) return (int)FusedSmem<128>::alloc;
  return 0;
}

// qh, kh, v, dout, geo, lse, delta, kv_mask, cos_t, sin_t: as
// apex_flash_attn_bwd_dq's (the tables, or null, inverse-rotate dk).
// planes: ceil(L / 64) fp32 (B, L, H, D) planes, contiguous, plane j
// written by the 64 keys 64 j .. (under causality from row 64 j on; the
// other rows are left as they are).  dk, dv: contiguous (B, L, H, D) of
// the operands' type, every element written.  Returns 0, a cudaError_t, or an encoder
// error (kMapErrorBase - CUresult).
extern "C" int apex_flash_bwd_fused(
    const void* qh, const void* kh, const void* v, const void* dout,
    const long long* geo, const void* lse, const void* delta,
    const void* kv_mask, const void* cos_t, const void* sin_t, void* planes,
    void* dk, void* dv, int B, int L, int H, int D, int causal, int dtype,
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
  float* pp = static_cast<float*>(planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half)
    return D <= 64 ? launch<64, __half>(maps, lp, dl, mp, cos_t, sin_t, pp,
                                        dk, dv, B, H, L, D, causal, s)
                   : launch<128, __half>(maps, lp, dl, mp, cos_t, sin_t, pp,
                                         dk, dv, B, H, L, D, causal, s);
  return D <= 64 ? launch<64, __nv_bfloat16>(maps, lp, dl, mp, cos_t, sin_t,
                                             pp, dk, dv, B, H, L, D, causal,
                                             s)
                 : launch<128, __nv_bfloat16>(maps, lp, dl, mp, cos_t, sin_t,
                                              pp, dk, dv, B, H, L, D, causal,
                                              s);
}

// planes: n_planes contiguous fp32 (B, L, H, D) planes as
// apex_flash_bwd_fused wrote them.  cos_t / sin_t: contiguous (B, L, D)
// tables of the type, or both null.  dq: contiguous (B, L, H, D) of the
// type (1 bf16, 2 fp16), every element written.  scale: the softmax scale
// rounded to the type.  D a multiple of 8.  Returns the cudaError_t of the
// launch.
extern "C" int apex_flash_bwd_finish(const void* planes, const void* cos_t,
                                     const void* sin_t, void* dq, int B,
                                     int L, int H, int D, int n_planes,
                                     float scale, int causal, int dtype,
                                     void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D % 8 != 0 || D <= 0 || n_planes <= 0 ||
      (cos_t == nullptr) != (sin_t == nullptr) || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  const float* pp = static_cast<const float*>(planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return launch_finish<__half>(pp, cos_t, sin_t, dq, B, L, H, D, n_planes,
                                 scale, causal, s);
  return launch_finish<__nv_bfloat16>(pp, cos_t, sin_t, dq, B, L, H, D,
                                      n_planes, scale, causal, s);
}
