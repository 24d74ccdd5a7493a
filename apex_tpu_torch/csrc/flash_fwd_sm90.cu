// Flash-attention forward for Hopper (sm_90a), with a plain C interface:
// one kernel design behind two entry points, K2 and K17.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py, `_flash_fwd` and its
// kernel `_fwd_kernel` (K2: wrapper semantics `flash_attention`,
// `_flash_core`, with the optional key mask and in-kernel rope), and
// apex_tpu/ops/pallas/experimental/flash_mh.py, `_mh_fwd` and its kernel
// `_fwd_kernel` (K17: the same function on (B, L, H * D) tensors, q
// pre-scaled by the wrapper, no rope).
//
// Computes exact attention over (B, L, H, D) bf16 or fp16 tensors read
// through the caller's strides (q / k / v split out of a fused projection,
// or K17's (B, L, H * D) layout, need no copy), any D that is a multiple of
// 8 up to 128: q pre-scaled in its storage type (the scale rounded to it,
// the product rounded), then, with full-width rope tables (cos_full,
// sin_signed), q and k rotated in fp32 and rounded back, each product and
// the sum rounded on their own; scores, the online softmax and lse in fp32;
// P cast to v's type for P V; an optional (B, L) uint8 key mask; a ragged
// L masked in the kernel; a row that sees no key gives zeros and lse =
// NEG_INF.  Outputs: o (B, L, H, D) in q's type, contiguous, and lse
// (B, L, H) fp32 (optional).
//
// What bounds it on the H100: two products a visible (q, k) pair, 4 * D
// flops, against reading q, k, v once and writing o: (L + 1) / 4 flops a
// byte when causal, so operations above L ~ 1200 (989 TFLOP/s) and bytes
// below (3.35 TB/s).
//
// Design: one block per (q tile, batch * head), one head a block for K17
// too, q tiles launched longest-first under causality: three consumer
// warpgroups of 64 q rows and a producer at DP 64, two consumers at DP
// 128 (FwdCfg below).  The producer warpgroup gives its registers to the
// consumers (setmaxnreg); one of its threads issues TMA through 4-D maps
// (D, H, L, B) with the true D: the q tile once, then the K / V tiles of
// 128 keys into a ring of shared-memory stages (3 at DP 64, 2 at DP 128)
// under full / empty mbarriers, up to the diagonal; TMA zero-fills
// columns past D and rows past L.  With a key mask its second warp packs
// each tile's 128 mask bytes into four words of bits (ballots) in the
// stage.  Rope and the pre-scale are done once a call, never per tile
// pair: k^ (k rotated) comes from the prologue kernel
// (flash_bwd_prologue.cu), and each warpgroup pre-scales and rotates its
// own 64 q rows once in shared memory (fence.proxy.async before wgmma
// reads them), bitwise the prologue's arithmetic.  S = q^ k^T is wgmma
// with both operands in shared memory, K-major, fp32 accumulators in
// registers; the row max and sum are taken on the accumulator registers
// (four independent partials a row) across the four threads of a quad;
// p = exp2(s log2 e - m log2 e) is one fma and one ex2.approx an
// element; P, packed to T in registers, is the register A operand of O +=
// P V, V read MN-major through the transpose bit.  Each tile's P V is
// issued behind the next tile's scores, so that tile's softmax runs while
// P V does, and the consumer warpgroups take turns to issue (named
// barriers, round robin), so that one's softmax runs while another's
// products do; under causality a warpgroup skips the last tiles wholly
// above its rows.  O stays in registers for the whole key walk and leaves
// through a shared-memory stage with 16-byte stores.  The causal, ragged
// and mask tests run only on tiles that need them.  No atomics, a fixed
// summation order: two runs give equal bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

using namespace apex_sm90;

// The block's shape by padded head width.  At DP 64 the softmax, not the
// products, dominates a tile, so three consumer warpgroups (192 q rows,
// 160 registers a thread; the producer keeps 32) keep more independent
// S -> softmax -> P V chains in flight than two (-8 to -10% at the main
// shapes); at DP 128 two consumer warpgroups of 224 registers hold the
// wider O.  Both take 128-key tiles.
template <int DP>
struct FwdCfg {
  static constexpr int kC = DP == 64 ? 3 : 2;       // consumer warpgroups
  static constexpr int kBN = 128;                   // keys a tile
  static constexpr int kStages = DP == 64 ? 3 : 2;
  static constexpr int kProducerRegs = DP == 64 ? 32 : 56;
  static constexpr int kConsumerRegs = DP == 64 ? 160 : 224;
  static constexpr int kThreads = 128 * (kC + 1);
  static constexpr int kQ = 64 * kC;                // q rows a block
};

template <int DP>
struct FwdSmem {
  using C = FwdCfg<DP>;
  static constexpr int kBN = C::kBN;
  static constexpr int kStages = C::kStages;
  static constexpr size_t q_tile = C::kQ * DP * 2;  // q, kQ rows
  static constexpr size_t kv_tile = kBN * DP * 2;   // k^ or V, kBN rows
  static constexpr size_t q = 0;
  static constexpr size_t ring = q + q_tile;        // k^, V per stage
  static constexpr size_t stage = ring + kStages * 2 * kv_tile;  // o in T
  static constexpr int kPitch = DP + 8;             // staged o row, elements
  // the key mask of a stage: kBN bits, one 32-bit word per 32 keys
  static constexpr size_t mask = stage + C::kQ * kPitch * 2;
  static constexpr size_t bars = mask + kStages * kBN / 8;
  // q_full, then full[kStages], empty[kStages]
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kStages);
  static constexpr size_t alloc = bytes + 1024;     // room to align the base
};

// The consumer warpgroups take turns to issue their products, round
// robin (named barriers 4 .. 4 + kC - 1, each of two warpgroups' 256
// threads: the waiting one and its predecessor; 1 .. kC are each
// warpgroup's own): warpgroup w waits for its turn, issues, and hands the
// turn on, so one's softmax runs while another's products do.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + cw) : "memory");
}

template <int kC>
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 + (cw + 1) % kC) : "memory");
}

// Byte offset of element (r, c) of a swizzled tile of `rows` rows (the
// layout of flash_sm90.cuh).
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int c) {
  return (c / 64) * rows * kRowBytes + r * kRowBytes +
         ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
}

// The rope tables of this warpgroup's 64 q rows, as prepare_q walks them:
// pass j of thread tid takes group i = tid + 128 j, row i / (D / 8) and
// columns c .. c + 3 of the first half (c = 4 (i % (D / 8))) with their
// partners c + D / 2; tab[j] holds cos[c], cos[c + D/2], sin[c], sin[c +
// D/2] (four elements each, one 8-byte load).  Issued before the q tile
// lands, so their latency hides behind the TMA.
template <int DP, typename T>
__device__ __forceinline__ void load_tables(uint2 (&tab)[DP / 16][4], int tid,
                                            int b, int first_row, int L,
                                            int D, const T* cos_t,
                                            const T* sin_t) {
  const int hd = D / 2, per_row = hd / 4;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    const int i = tid + 128 * j;
    const int r = i / per_row, c = (i % per_row) * 4;
    const int pos = first_row + r;
    if (r < 64 && pos < L) {
      const long long t = ((long long)b * L + pos) * D + c;
      tab[j][0] = *reinterpret_cast<const uint2*>(cos_t + t);
      tab[j][1] = *reinterpret_cast<const uint2*>(cos_t + t + hd);
      tab[j][2] = *reinterpret_cast<const uint2*>(sin_t + t);
      tab[j][3] = *reinterpret_cast<const uint2*>(sin_t + t + hd);
    }
  }
}

// Pre-scale, and with tables rotate, this warpgroup's 64 rows of the q
// tile in place: x = T(x * scale), then (x[c], x[c + D/2]) -> T(x[c] cos[c]
// + x[c + D/2] sin[c]), T(x[c + D/2] cos[c + D/2] + x[c] sin[c + D/2]),
// each product and the sum rounded on their own (the prologue's
// arithmetic).  The groups of load_tables; rows past L (zeros) are left
// alone.
template <int DP, typename T>
__device__ __forceinline__ void prepare_q(unsigned char* qt, int q_rows,
                                          int cw, int tid, int first_row,
                                          int L, int D, bool rope,
                                          const uint2 (&tab)[DP / 16][4],
                                          float scale) {
  const int hd = D / 2, per_row = hd / 4;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    const int i = tid + 128 * j;
    const int r = i / per_row, c = (i % per_row) * 4;
    if (r >= 64 || first_row + r >= L) continue;
    const int tr = 64 * cw + r;
    uint2* plo = reinterpret_cast<uint2*>(qt + tile_offset(q_rows, tr, c));
    uint2* phi =
        reinterpret_cast<uint2*>(qt + tile_offset(q_rows, tr, c + hd));
    uint2 vlo = *plo, vhi = *phi;
    T* el = reinterpret_cast<T*>(&vlo);
    T* eh = reinterpret_cast<T*>(&vhi);
    float xl[4], xh[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      el[e] = from_f32<T>(to_f32(el[e]) * scale);
      eh[e] = from_f32<T>(to_f32(eh[e]) * scale);
      xl[e] = to_f32(el[e]);
      xh[e] = to_f32(eh[e]);
    }
    if (rope) {
      const T* cl = reinterpret_cast<const T*>(&tab[j][0]);
      const T* ch = reinterpret_cast<const T*>(&tab[j][1]);
      const T* sl = reinterpret_cast<const T*>(&tab[j][2]);
      const T* sh = reinterpret_cast<const T*>(&tab[j][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        el[e] = from_f32<T>(rot1(xl[e], xh[e], to_f32(cl[e]), to_f32(sl[e])));
        eh[e] = from_f32<T>(rot1(xh[e], xl[e], to_f32(ch[e]), to_f32(sh[e])));
      }
    }
    *plo = vlo;
    *phi = vhi;
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(FwdCfg<DP>::kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const uint8_t* __restrict__ kv_mask,
               const T* __restrict__ cos_t, const T* __restrict__ sin_t,
               T* __restrict__ o, float* __restrict__ lse, int H, int L,
               int D, float scale, int prep_q, int causal) {
  using S = FwdSmem<DP>;
  using C = FwdCfg<DP>;
  constexpr int kStages = S::kStages;
  constexpr int kBN = S::kBN;
  constexpr int kC = C::kC;
  constexpr int kQ = C::kQ;
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
  const int q0 = iq * kQ;
  const int n_k = (L + kBN - 1) / kBN;
  const int last = causal ? min((q0 + kQ - 1) / kBN, n_k - 1) : n_k - 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      // TMA's thread, and with a key mask the mask warp's lane 0
      mbar_init(bar_full + 8 * s, kv_mask != nullptr ? 2 : 1);
      mbar_init(bar_empty + 8 * s, 4 * kC);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kC) {
    // -- producer ---------------------------------------------------------
    regs_dec<C::kProducerRegs>();
    const int pt = threadIdx.x - 128 * kC;  // 0 .. 127
    if (pt == 0) {
      mbar_expect(bar_q, S::q_tile);
      tma_tile<DP>(base + S::q, &tm_q, bar_q, kQ, h, q0, b);
      for (int it = 0; it <= last; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(bar_empty + 8 * s, (it / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t kt = base + S::ring + s * 2 * S::kv_tile;
        mbar_expect(full, 2 * S::kv_tile);
        tma_tile<DP>(kt, &tm_k, full, kBN, h, it * kBN, b);
        tma_tile<DP>(kt + S::kv_tile, &tm_v, full, kBN, h, it * kBN, b);
      }
    } else if (pt / 32 == 1 && kv_mask != nullptr) {
      // the mask warp: lane i reads keys i, i + 32, ... of each tile; a
      // ballot packs each 32 into one word (0 past L), which lane 0 stores
      // and releases with its arrive
      const int lane = pt % 32;
      for (int it = 0; it <= last; ++it) {
        const int s = it % kStages;
        const int k0 = it * kBN;
        if (it >= kStages) mbar_wait(bar_empty + 8 * s, (it / kStages - 1) & 1);
        uint32_t* mw = reinterpret_cast<uint32_t*>(smem + S::mask) +
                       s * (kBN / 32);
#pragma unroll
        for (int j = 0; j < kBN / 32; ++j) {
          const int kpos = k0 + 32 * j + lane;
          const uint32_t w = __ballot_sync(
              0xffffffffu,
              kpos < L && kv_mask[(long long)b * L + kpos] != 0);
          if (lane == 0) mw[j] = w;
        }
        if (lane == 0) mbar_arrive(bar_full + 8 * s);
      }
    }
  } else {
    // -- consumers: warpgroup cw owns q rows q0 + 64 cw .. + 63 --------------
    regs_inc<C::kConsumerRegs>();
    const int cw = wg;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int t2 = 2 * (lane % 4);
    const int first_row = q0 + 64 * cw;
    const int my_row = first_row + (tid / 32) * 16 + lane / 4;  // and + 8

    uint2 tab[DP / 16][4];
    if (cos_t != nullptr)
      load_tables<DP, T>(tab, tid, b, first_row, L, D, cos_t, sin_t);
    mbar_wait(bar_q, 0);
    if (prep_q) {
      prepare_q<DP, T>(smem + S::q, kQ, cw, tid, first_row, L, D,
                       cos_t != nullptr, tab, scale);
      fence_proxy_async();
      warpgroup_sync(1 + cw);
    }

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float s_acc[kBN / 2];
    uint32_t a_p[kBN / 4] = {};
    float m_r[2] = {kNegInf, kNegInf};  // row max (natural units)
    float l_r[2] = {0.f, 0.f};          // this thread's share of the row sum
    // the stage of the last tile whose P V is still to come, or -1
    int prev = -1;

    if (cw == kC - 1) turn_pass<kC>(cw);  // warpgroup 0 issues first
    for (int it = 0; it <= last; ++it) {
      const int s = it % kStages;
      const int k0 = it * kBN;
      // under causality a tile wholly above these rows is not computed
      // (the walk's last tiles, for the first warpgroups)
      const bool valid = !causal || k0 <= first_row + 63;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      const uint32_t kt = base + S::ring + s * 2 * S::kv_tile;
      // S = q^ k^T, then the last tile's O += P V behind it: the softmax
      // below runs while P V does
      turn_wait(cw);
      wgmma_fence();
      if (valid) {
        scores<DP, kBN, T>(s_acc, base + S::q, kQ, 64 * cw, kt, kBN, 0);
        wgmma_commit();
      }
      if (prev >= 0) {
        const uint32_t vt = base + S::ring + prev * 2 * S::kv_tile +
                            S::kv_tile;
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs<DP, T>(acc, a_p + 4 * kk, mnmajor(vt, kBN, kk));
        wgmma_commit();
      }
      // hand the turn on (the last warpgroup's last pass has no taker:
      // each barrier completes as often as it is waited on)
      if (cw < kC - 1 || it < last) turn_pass<kC>(cw);
      float corr[2] = {1.f, 1.f}, rs[2] = {0.f, 0.f};
      if (valid) {
        if (prev >= 0)
          wgmma_wait<1>();  // S has retired; P V may run on
        else
          wgmma_wait<0>();
        pin<kBN / 2>(s_acc);
        // hidden pairs to NEG_INF: the key mask's bits (this thread's
        // columns shifted down), then causality and the ragged end where
        // they reach into the tile
        if (kv_mask != nullptr) {
          const uint32_t* mw = reinterpret_cast<const uint32_t*>(
                                   smem + S::mask) + s * (kBN / 32);
          uint32_t w[kBN / 32];
#pragma unroll
          for (int j = 0; j < kBN / 32; ++j) w[j] = mw[j] >> t2;
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i)
            if (!((w[i >> 4] >> ((8 * (i >> 2)) % 32 + (i & 1))) & 1u))
              s_acc[i] = kNegInf;
        }
        if ((causal && k0 + kBN - 1 > first_row) || k0 + kBN > L) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            const int kpos = k0 + 8 * (i >> 2) + t2 + (i & 1);
            if (kpos >= L || (causal && kpos > my_row + 8 * ((i >> 1) & 1)))
              s_acc[i] = kNegInf;
          }
        }
        // the row max: four partial maxima a row (independent chains),
        // then over the quad
        float mp[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) mp[r][c] = m_r[r];
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
          mp[(i >> 1) & 1][(i >> 2) & 3] =
              fmaxf(mp[(i >> 1) & 1][(i >> 2) & 3], s_acc[i]);
        float ml[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx =
              fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          corr[r] = exp2_approx((m_r[r] - mx) * kLog2e);
          m_r[r] = mx;
          // a row that has seen no key yet subtracts 0, so that its hidden
          // scores (NEG_INF) still give exp2(-1.4e30) = 0
          ml[r] = mx > 0.5f * kNegInf ? mx * kLog2e : 0.f;
        }
        // P = exp(S - m) in place of S (0 where hidden: no test needed),
        // its row sums in four partial sums a row
        float sp[2][4] = {};
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const float p =
              exp2_approx(fmaf(s_acc[i], kLog2e, -ml[(i >> 1) & 1]));
          s_acc[i] = p;
          sp[(i >> 1) & 1][(i >> 2) & 3] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          rs[r] = (sp[r][0] + sp[r][1]) + (sp[r][2] + sp[r][3]);
      }
      if (prev >= 0) {
        wgmma_wait<0>();  // the last tile's P V has retired: its stage is free
        pin<DP / 2>(acc);
        pin<kBN / 4>(a_p);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
      }
      if (valid) {
#pragma unroll
        for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + rs[r];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        // P packed to T: the A operand of this tile's P V (V read MN-major)
        to_a_operand<kBN, T>(s_acc, a_p);
        prev = s;
      } else {
        __syncwarp();  // a stage this warpgroup never reads
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
        prev = -1;
      }
    }
    if (prev >= 0) {  // the last tile's O += P V
      const uint32_t vt = base + S::ring + prev * 2 * S::kv_tile + S::kv_tile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<DP, T>(acc, a_p + 4 * kk, mnmajor(vt, kBN, kk));
      wgmma_commit();
      wgmma_wait<0>();
      pin<DP / 2>(acc);
      pin<kBN / 4>(a_p);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
    }

    // Emit: o = acc / l (zeros where no key was visible), lse = m + log l.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = l == 0.f ? 0.f : 1.f / l;
      const int pos = my_row + 8 * r;
      if (lse != nullptr && lane % 4 == 0 && pos < L)
        lse[((long long)b * L + pos) * H + h] =
            l == 0.f ? kNegInf : m_r[r] + logf(l);
    }
    constexpr int kPitch = S::kPitch;
    T* stage = reinterpret_cast<T*>(smem + S::stage) + 64 * cw * kPitch;
    const int sr = (tid / 32) * 16 + lane / 4;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(stage + (sr + 8 * i) * kPitch + 8 * n +
                                     t2) =
            pack2<T>(acc[4 * n + 2 * i] * inv[i],
                     acc[4 * n + 2 * i + 1] * inv[i]);
    warpgroup_sync(1 + cw);
    const int per_row = D / 8;  // 16-byte chunks of a row
    for (int i = tid; i < 64 * per_row; i += 128) {
      const int r = i / per_row, c = (i % per_row) * 8;
      const int pos = first_row + r;
      if (pos >= L) break;  // rows run in order: the rest are past L too
      *reinterpret_cast<uint4*>(o + (((long long)b * L + pos) * H + h) * D +
                                c) =
          *reinterpret_cast<const uint4*>(stage + r * kPitch + c);
    }
  }
}

template <int DP, typename T>
int launch(const CUtensorMap* maps, const uint8_t* kv_mask, const void* cos_t,
           const void* sin_t, void* o, float* lse, int B, int H, int L, int D,
           float scale, int prep_q, int causal, cudaStream_t stream) {
  static unsigned configured = 0;
  cudaError_t e = apex_fa::opt_in_smem(flash_fwd_sm90<DP, T>,
                                       FwdSmem<DP>::alloc, &configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (L + FwdCfg<DP>::kQ - 1) / FwdCfg<DP>::kQ);
  flash_fwd_sm90<DP, T>
      <<<grid, FwdCfg<DP>::kThreads, FwdSmem<DP>::alloc, stream>>>(
      maps[0], maps[1], maps[2], kv_mask, static_cast<const T*>(cos_t),
      static_cast<const T*>(sin_t), static_cast<T*>(o), lse, H, L, D, scale,
      prep_q, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_type(const CUtensorMap* maps, const uint8_t* kv_mask,
                const void* cos_t, const void* sin_t, void* o, float* lse,
                int B, int H, int L, int D, float scale, int prep_q,
                int causal, cudaStream_t s) {
  if (D <= 64)
    return launch<64, T>(maps, kv_mask, cos_t, sin_t, o, lse, B, H, L, D,
                         scale, prep_q, causal, s);
  return launch<128, T>(maps, kv_mask, cos_t, sin_t, o, lse, B, H, L, D,
                        scale, prep_q, causal, s);
}

}  // namespace

// Dynamic shared memory of the forward at padded head width DP (64 or 128;
// 0: unsupported).
extern "C" int apex_flash_fwd_sm90_smem_bytes(int DP) {
  if (DP == 64) return (int)FwdSmem<64>::alloc;
  if (DP == 128) return (int)FwdSmem<128>::alloc;
  return 0;
}

// q, k, v: (B, L, H, D) of type dtype (1 bf16, 2 fp16), each described by 7
// words of `geo` (dims D, H, L, B and the byte strides of H, L, B; the
// wrapper checked them for TMA); k is k^ when rope is on.  kv_mask: (B, L)
// uint8 or null.  cos_t / sin_t: contiguous (B, L, D) tables of that type
// (q is rotated with them), or both null.  o: contiguous (B, L, H, D) of
// that type, every element written.  lse: contiguous (B, L, H) fp32 or
// null.  scale: the softmax scale rounded to the type.  prep_q: pre-scale
// (and with tables rotate) q in the kernel; 0 when q is already q^.
// Returns 0, a cudaError_t, or an encoder error (kMapErrorBase - CUresult).
extern "C" int apex_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                   const long long* geo, const void* kv_mask,
                                   const void* cos_t, const void* sin_t,
                                   void* o, void* lse, int B, int L, int H,
                                   int D, float scale, int prep_q, int causal,
                                   int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D % 8 != 0 || D <= 0 || D > 128 ||
      (dtype != 1 && dtype != 2) || (cos_t != nullptr && !prep_q))
    return (int)cudaErrorInvalidValue;
  const bool half = dtype == 2;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int e = encode_map(&maps[i], ptrs[i], geo + kGeoWords * i, half);
    if (e != 0) return e;
  }
  const uint8_t* mp = static_cast<const uint8_t*>(kv_mask);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half)
    return launch_type<__half>(maps, mp, cos_t, sin_t, o, lp, B, H, L, D,
                               scale, prep_q, causal, s);
  return launch_type<__nv_bfloat16>(maps, mp, cos_t, sin_t, o, lp, B, H, L, D,
                                    scale, prep_q, causal, s);
}
