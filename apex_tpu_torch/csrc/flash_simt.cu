// The generic flash-attention kernels for Hopper (sm_90a), with a plain C
// interface: forward, and the backward's two passes (dk / dv, then dq), on
// CUDA cores in fp32, for the cases the tensor-core kernels do not take.
//
// Replaces, for those cases: apex_tpu/ops/pallas/flash_attention.py,
// `_flash_fwd` (`_fwd_kernel`) and `_flash_bwd_fused`
// (`_bwd_fused_kernel`), and apex_tpu/ops/pallas/experimental/flash_mh.py,
// `_mh_fwd` and `_mh_bwd_fused` (the same functions, q pre-scaled by the
// wrapper): fp32 at any head width D that is a multiple of 8 up to the
// widest whose rows fit, and bf16 / fp16 where D is above the tensor-core
// kernels' 128.  The route (ops/cuda/flash_attention.py, `fwd_route` /
// `bwd_route`) picks them; every other case takes the Hopper kernels.
//
// Semantics as the tensor-core kernels', in fp32 arithmetic on storage type
// T: q pre-scaled in T (the scale rounded to T, the product rounded), q and
// k rotated by the full-width tables in fp32 and rounded to T; the forward's
// online softmax in fp32 (P not rounded before P V); the backward recomputes
// P = exp(S - lse), rounds P to T for dV and dS = P (dP - delta) to T for dK
// and dQ, inverse-rotates dK and dQ in fp32, writes dK and dV in T and dQ
// in fp32 (the wrapper casts it and applies the one deferred scale).  A row
// that sees no key gives zeros and lse = NEG_INF; the backward skips rows
// whose lse is at or below NEG_INF / 2.  No atomics: two runs give equal
// bits.
//
// Two layouts, chosen in Python (`simt_layout`) and passed as a mode word:
//
// "tiled", every D up to 256 (kTiledMaxD).  A block of 256 threads, a 16 x
// 16 grid, takes a tile of BR query rows (forward, dq) or BC keys (dk / dv)
// of one (batch, head) and walks the other side's tiles: 64 rows and 64
// keys up to D 128 (128 keys in the forward at D 64), 32 and 32 above
// (`FwdCfg`, `DkvCfg`, `DqCfg`).  Each loaded tile is widened to fp32 in
// shared memory (rows padded by 4 floats, so that a thread's 16-byte reads
// hit distinct banks), pre-scaled, rotated and rounded as it is loaded:
// four column pairs a thread by 16-byte (fp32) or 8-byte accesses where
// every row is 4-element aligned, else one pair by element accesses.  A
// score tile S = Q K^T (and dP = dO V^T) is a register micro-tile of
// BR / 16 rows by BC / 16 keys a thread (keys tc, tc + 16, ..: the 16
// threads of a row group read 16 consecutive key rows), FFMA over D in
// order; the causal, key-mask, tail and empty-row predicates are applied
// explicitly (a hidden pair is excluded from the row max and gives p = 0).
// The forward's online softmax reduces each row's max once a tile over the
// 16 threads that share the row (xor shuffles, exact) and keeps each
// thread's share of the row sum, summed once at the end in a fixed order.
// P (or dS) goes to shared memory, and O += P V (dQ += dS K) accumulates a
// register micro-tile of the thread's rows by 4-column groups every 64
// columns; dV += P^T dO and dK += dS^T Q accumulate BC / 16 keys a thread
// likewise.  Tiles wholly above the diagonal are skipped; the q tiles
// (forward, dq) are issued longest first.  dK and dQ leave through shared
// memory, inverse-rotated a column pair a thread.
//
// "rows", D above 256, up to 9664: one warp per query (forward, dq) or key
// (dk / dv) row walks every visible key; lane l holds the column pairs (c,
// c + D / 2) for c = l + 32 j.  Up to D 512 the pairs live in registers
// (8 a lane); above, each row a warp holds (4 in the forward, 6 in dk /
// dv, 5 in dq, each of 64 ceil(D / 64) floats) lives in the warp's slice of
// dynamic shared memory, and a block takes as many warps (up to 4) as 227 KB
// hold: D up to 9664, where one warp's six rows of dk / dv fill them.
//
// What bounds them on the H100: operations on the CUDA cores at 67 TFLOP/s
// fp32 (no tensor cores: TF32 would round the products).  The forward does
// 4 D flops a visible pair, dk / dv 8 D and dq 6 D.  In the tiled layout a
// thread's 4 x 4 micro-tile reads eight 16-byte shared-memory vectors for
// 64 FFMAs, so shared-memory bandwidth sits close behind the FFMA rate;
// the tile loads are synchronous (the other block on the SM computes
// meanwhile).  The rows layout is bound instead by the latency of its
// warp reductions a key; it is kept for the widths a register micro-tile
// of the output cannot hold.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace apex_fa;

// One block's dynamic shared memory on the H100.
constexpr size_t kMaxSmem = 232448;

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const uint8_t* kv_mask;
  const void *cos_t, *sin_t;
  Strides sq, sk, sv, sd;
  int H, L, D;
  float scale;
  int causal;
  int chunks;  // ceil(D / 64): the pair chunks of a shared-memory row
  int vec;     // every operand and table row aligned to four elements
};

// ---------------------------------------------------------------------------
// The tiled layout (D up to kTiledMaxD).

constexpr int kTiledMaxD = 256;

// A tile configuration: DP the padded head width (64, 128, 192 or 256), BR
// query rows and BC keys a tile, NT threads a block as a (NT / 16) x 16
// grid (16 threads share a row group), MINB the blocks an SM is to hold
// (the register budget).
template <int DP_, int BR_, int BC_, int NT_, int MINB_>
struct Cfg {
  static constexpr int DP = DP_, BR = BR_, BC = BC_, NT = NT_, MINB = MINB_;
  static constexpr int TR = NT / 16;  // thread rows of the grid
  static constexpr int RM = BR / TR;  // query rows of a thread (S, O, dQ)
  static constexpr int CN = BC / 16;  // keys of a thread (S, dP)
  static constexpr int KM = BC / TR;  // keys of a thread (dK, dV)
  static constexpr int NCH = DP / 64;  // its 4-column groups, 64 apart
  static constexpr int SD = DP + 4;  // floats between rows of a Q/K/V/dO tile
  static constexpr int SP = BC + 4;  // floats between rows of a P / dS tile
  static_assert(BR % TR == 0 && BC % TR == 0 && BC % 16 == 0, "tile shape");
  // P (forward) or dS (dq) over the K / V tile once it is read
  static constexpr bool kOver = BR * SP <= BC * SD;
  static constexpr size_t kFwdSmem =
      ((size_t)(BR + 2 * BC) * SD + (kOver ? 0 : BR * SP)) * 4;
  static constexpr size_t kDkvSmem =
      ((size_t)(2 * BC + 2 * BR) * SD + 2 * BR * SP) * 4;
  static constexpr size_t kDqSmem =
      ((size_t)(2 * BR + 2 * BC) * SD + (kOver ? 0 : BR * SP)) * 4;
};

// The configuration of each kernel by padded width: of the tiles tried on
// the H100 (64 or 128 rows or keys, 128 or 256 threads), the fastest; the
// forward alone gains from 128-key tiles, at D 64.  The forward at DP 128
// and both backward passes at DP 64 keep two blocks an SM at the 128
// registers that leaves a thread, and spill a few words (fp32 at most 76
// bytes stored, 92 loaded): one block an SM, with no spills, ran them about
// 35% slower on the H100.
template <int DP>
using FwdCfg = std::conditional_t<
    DP == 64, Cfg<64, 64, 128, 256, 2>,
    std::conditional_t<DP == 128, Cfg<128, 64, 64, 256, 2>,
                       Cfg<DP, 32, 32, 256, 2>>>;
template <int DP>
using DkvCfg = std::conditional_t<
    DP == 64, Cfg<64, 64, 64, 256, 2>,
    std::conditional_t<DP == 128, Cfg<128, 64, 64, 256, 1>,
                       Cfg<DP, 32, 32, 256, 1>>>;
template <int DP>
using DqCfg = std::conditional_t<
    DP == 64, Cfg<64, 64, 64, 256, 2>,
    std::conditional_t<DP == 128, Cfg<128, 64, 64, 256, 1>,
                       Cfg<DP, 32, 32, 256, 1>>>;

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

__device__ __forceinline__ void sts4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Four consecutive elements of type T from a 4-element-aligned address, as
// fp32.
template <typename T>
struct alignas(4 * sizeof(T)) Four {
  T x[4];
};

template <typename T>
__device__ __forceinline__ void ldg4(const T* p, float (&v)[4]) {
  const Four<T> f = *reinterpret_cast<const Four<T>*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = to_f32(f.x[e]);
}

// The pre-scale and rotation of one column pair (lo = x[c], hi = x[c + D /
// 2]) as the plain version computes them: times `scale` rounded to T when
// `scaled`, then rotated by the row's tables (cl / ch / sl / sh: cos and sin
// at c and c + D / 2) in fp32 and rounded to T.
template <typename T>
__device__ __forceinline__ void prep_pair(float& lo, float& hi, bool scaled,
                                          float scale, bool rope, float cl,
                                          float ch, float sl, float sh) {
  if (scaled) {
    lo = round_to<T>(lo * scale);
    hi = round_to<T>(hi * scale);
  }
  if (rope) {
    const float l2 = round_to<T>(rot1(lo, hi, cl, sl));
    hi = round_to<T>(rot1(hi, lo, ch, sh));
    lo = l2;
  }
}

// Rows row0 .. row0 + rows - 1 of one (batch, head) of an operand (`src`
// at row 0, rows `sl` elements apart) into a tile of row stride SD, widened
// to fp32 and prepared by `prep_pair` (the rows' tables: `ct` / `st`, the
// batch's (L, D) tables, or null).  Rows at or past L are zeros.
// Consecutive threads take consecutive column pairs (c, c + D / 2) of a
// row: four pairs at a time by vector accesses when `vec` (every row and
// table row aligned to four elements), else one by element accesses, so
// any view with unit stride over D reads.
template <int SD, int NT, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long sl, int row0, int rows,
                                          int L, int D, bool scaled,
                                          float scale, const T* ct,
                                          const T* st, bool vec) {
  const int hd = D >> 1;
  const bool rope = ct != nullptr;
  if (vec) {
    const int groups = hd >> 2;
    for (int i = threadIdx.x; i < rows * groups; i += NT) {
      const int r = i / groups, c = (i - r * groups) * 4, pos = row0 + r;
      float lo[4] = {}, hi[4] = {};
      if (pos < L) {
        const T* x = src + pos * sl;
        ldg4(x + c, lo);
        ldg4(x + c + hd, hi);
        float cl[4] = {}, ch[4] = {}, sn[4] = {}, sh[4] = {};
        if (rope) {
          const long long t = (long long)pos * D;
          ldg4(ct + t + c, cl);
          ldg4(ct + t + c + hd, ch);
          ldg4(st + t + c, sn);
          ldg4(st + t + c + hd, sh);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          prep_pair<T>(lo[e], hi[e], scaled, scale, rope, cl[e], ch[e],
                       sn[e], sh[e]);
      }
      sts4(dst + r * SD + c, lo);
      sts4(dst + r * SD + c + hd, hi);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * hd; i += NT) {
    const int r = i / hd, c = i - r * hd, pos = row0 + r;
    float lo = 0.f, hi = 0.f;
    if (pos < L) {
      const T* x = src + pos * sl;
      lo = to_f32(x[c]);
      hi = to_f32(x[c + hd]);
      const long long t = (long long)pos * D;
      prep_pair<T>(lo, hi, scaled, scale, rope,
                   rope ? to_f32(ct[t + c]) : 0.f,
                   rope ? to_f32(ct[t + c + hd]) : 0.f,
                   rope ? to_f32(st[t + c]) : 0.f,
                   rope ? to_f32(st[t + c + hd]) : 0.f);
    }
    dst[r * SD + c] = lo;
    dst[r * SD + c + hd] = hi;
  }
}

// The rows row0 .. of a tile of fp32 sums (row stride SD) into `dst` (row 0
// of one (batch, head) of a contiguous (B, L, H, D) output, rows `sl`
// apart), inverse-rotated in fp32 by the rows' tables when given (the
// rotation with the sine negated); rows at or past L are not written.
template <int SD, int NT, typename O, typename T>
__device__ __forceinline__ void store_tile(O* dst, long long sl,
                                           const float* src, int row0,
                                           int rows, int L, int D,
                                           const T* ct, const T* st) {
  const int hd = D >> 1;
  for (int i = threadIdx.x; i < rows * hd; i += NT) {
    const int r = i / hd, c = i - r * hd, pos = row0 + r;
    if (pos >= L) continue;
    float lo = src[r * SD + c], hi = src[r * SD + c + hd];
    if (ct != nullptr) {
      const T* cr = ct + (long long)pos * D;
      const T* sr = st + (long long)pos * D;
      const float l2 = rot1(lo, hi, to_f32(cr[c]), -to_f32(sr[c]));
      hi = rot1(hi, lo, to_f32(cr[c + hd]), -to_f32(sr[c + hd]));
      lo = l2;
    }
    O* y = dst + pos * sl;
    y[c] = from_f32<O>(lo);
    y[c + hd] = from_f32<O>(hi);
  }
}

// s[i][j] += sum over d < D of A[(ra + i) SD + d] B[(cb + 16 j) SD + d]: a
// score micro-tile (rows ra .., keys cb, cb + 16, ..) in FFMA, d in order.
template <class C>
__device__ __forceinline__ void scores(float (&s)[C::RM][C::CN],
                                       const float* A, int ra, const float* B,
                                       int cb, int D) {
#pragma unroll
  for (int d0 = 0; d0 < C::DP; d0 += 8) {
    if (d0 < D) {
#pragma unroll
      for (int dd = 0; dd < 8; dd += 4) {
        float a[C::RM][4], b[C::CN][4];
#pragma unroll
        for (int j = 0; j < C::CN; ++j)
          lds(B + (cb + 16 * j) * C::SD + d0 + dd, b[j]);
#pragma unroll
        for (int i = 0; i < C::RM; ++i)
          lds(A + (ra + i) * C::SD + d0 + dd, a[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < C::RM; ++i)
#pragma unroll
            for (int j = 0; j < C::CN; ++j)
              s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
      }
    }
  }
}

// acc[i][g][e] += sum over c < BC of P[(ra + i) SP + c] X[c SD + col + 64 g
// + e]: rows of P (O += P V, dQ += dS K), c in order.
template <class C>
__device__ __forceinline__ void rows_times(float (&acc)[C::RM][C::NCH][4],
                                           const float* P, int ra,
                                           const float* X, int col) {
#pragma unroll 2
  for (int c0 = 0; c0 < C::BC; c0 += 4) {
    float p[C::RM][4];
#pragma unroll
    for (int i = 0; i < C::RM; ++i) lds(P + (ra + i) * C::SP + c0, p[i]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int g = 0; g < C::NCH; ++g) {
        float x[4];
        lds(X + (c0 + cc) * C::SD + col + 64 * g, x);
#pragma unroll
        for (int i = 0; i < C::RM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g][e] = fmaf(p[i][cc], x[e], acc[i][g][e]);
      }
    }
  }
}

// u[k][g][e] += sum over r < BR of P[r SP + ka + k] X[r SD + col + 64 g + e]
// and w likewise with (Q2, Y): columns of P (dV += P^T dO, dK += dS^T Q), r
// in order.
template <class C>
__device__ __forceinline__ void cols_times(float (&u)[C::KM][C::NCH][4],
                                           const float* P, const float* X,
                                           float (&w)[C::KM][C::NCH][4],
                                           const float* Q2, const float* Y,
                                           int ka, int col) {
#pragma unroll 2
  for (int r = 0; r < C::BR; ++r) {
    float p[C::KM], q[C::KM];
    lds(P + r * C::SP + ka, p);
    lds(Q2 + r * C::SP + ka, q);
#pragma unroll
    for (int g = 0; g < C::NCH; ++g) {
      float x[4], y[4];
      lds(X + r * C::SD + col + 64 * g, x);
      lds(Y + r * C::SD + col + 64 * g, y);
#pragma unroll
      for (int k = 0; k < C::KM; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          u[k][g][e] = fmaf(p[k], x[e], u[k][g][e]);
          w[k][g][e] = fmaf(q[k], y[e], w[k][g][e]);
        }
    }
  }
}

// The thread's registers of a tile (rows or keys base + .., 4-column groups
// col + 64 g) into a shared tile of row stride SD.
template <int RM, int NCH, int SD>
__device__ __forceinline__ void spill_tile(float* dst, int base, int col,
                                           const float (&acc)[RM][NCH][4]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int g = 0; g < NCH; ++g) sts4(dst + (base + i) * SD + col + 64 * g,
                                       acc[i][g]);
}

// The (batch, head) of a block and its operands' row-0 pointers.
template <typename T>
struct Head {
  int b, h;
  const T *q, *k, *v, *dout, *ct, *st;
  const uint8_t* mask;
  __device__ Head(const Args& a, int bh) : b(bh / a.H), h(bh % a.H) {
    q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
    k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
    v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
    dout = a.dout == nullptr
               ? nullptr
               : static_cast<const T*>(a.dout) + b * a.sd.b + h * a.sd.h;
    const long long tb = (long long)b * a.L * a.D;
    ct = a.cos_t == nullptr ? nullptr : static_cast<const T*>(a.cos_t) + tb;
    st = a.sin_t == nullptr ? nullptr : static_cast<const T*>(a.sin_t) + tb;
    mask = a.kv_mask == nullptr ? nullptr : a.kv_mask + (long long)b * a.L;
  }
  // row (b, pos, h) of a (B, L, H) or (B, L, H, D) contiguous tensor
  __device__ long long at(const Args& a, int pos) const {
    return ((long long)b * a.L + pos) * a.H + h;
  }
  __device__ bool key_ok(const Args& a, int kpos) const {
    return kpos < a.L && (mask == nullptr || mask[kpos] != 0);
  }
};

// Forward: one block per (q tile, batch * head), the longest tiles first.
template <class C, typename T>
__global__ void __launch_bounds__(C::NT, C::MINB)
flash_fwd_simt_tiled(Args a, T* __restrict__ o, float* __restrict__ lse) {
  constexpr int BR = C::BR, BC = C::BC, RM = C::RM, CN = C::CN,
                NCH = C::NCH, SD = C::SD, SP = C::SP, NT = C::NT;
  extern __shared__ float4 tile_smem[];
  float* qs = reinterpret_cast<float*>(tile_smem);
  float* ks = qs + BR * SD;
  float* vs = ks + BC * SD;
  float* ps = C::kOver ? ks : vs + BC * SD;  // P over K's tile if it fits
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const Head<T> bh(a, blockIdx.x);
  const int L = a.L, D = a.D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  load_tile<SD, NT, T>(qs, bh.q, a.sq.l, q0, BR, L, D, true, a.scale, bh.ct,
                       bh.st, a.vec);
  float acc[RM][NCH][4] = {};
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int kend = a.causal ? min(L, q0 + BR) : L;
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();  // the last tile's P and V are read
    load_tile<SD, NT, T>(ks, bh.k, a.sk.l, k0, BC, L, D, false, 1.f, bh.ct,
                         bh.st, a.vec);
    load_tile<SD, NT, T>(vs, bh.v, a.sv.l, k0, BC, L, D, false, 1.f, nullptr,
                         nullptr, a.vec);
    __syncthreads();
    float s[RM][CN] = {};
    scores<C>(s, qs, tr * RM, ks, tc, D);
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kpos = k0 + tc + 16 * j;
      const bool ok = bh.key_ok(a, kpos);
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (!ok || (a.causal && kpos > q0 + tr * RM + i))
          s[i][j] = -INFINITY;  // hidden: out of the max, p = 0
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mt = s[i][0];
#pragma unroll
      for (int j = 1; j < CN; ++j) mt = fmaxf(mt, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const bool none = mn == -INFINITY;  // no key seen by the row yet
      const float corr = none ? 1.f : expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = none ? 0.f : expf(s[i][j] - mn);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int g = 0; g < NCH; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
    }
    if (C::kOver) __syncthreads();  // every score is formed: K is free
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        ps[(tr * RM + i) * SP + tc + 16 * j] = s[i][j];
    __syncthreads();
    rows_times<C>(acc, ps, tr * RM, vs, 4 * tc);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = __shfl_sync(0xffffffffu, lt, threadIdx.x & 16);  // one row sum
    const int qpos = q0 + tr * RM + i;
    if (qpos >= L) continue;
    const long long at = bh.at(a, qpos);
    const float mul = lt == 0.f ? 0.f : 1.f / lt;
    T* row = o + at * D;
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      const int c = 4 * tc + 64 * g;
      if (c >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) row[c + e] = from_f32<T>(acc[i][g][e] * mul);
    }
    if (lse != nullptr && tc == 0)
      lse[at] = lt == 0.f ? kNegInf : m[i] + logf(lt);
  }
}

// dK, dV: one block per (key tile, batch * head); tile 0, which the most q
// tiles see under causality, first.
template <class C, typename T>
__global__ void __launch_bounds__(C::NT, C::MINB)
flash_bwd_dkdv_simt_tiled(Args a, T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int BR = C::BR, BC = C::BC, RM = C::RM, CN = C::CN, KM = C::KM,
                NCH = C::NCH, SD = C::SD, SP = C::SP, NT = C::NT;
  extern __shared__ float4 tile_smem[];
  float* ks = reinterpret_cast<float*>(tile_smem);
  float* vs = ks + BC * SD;
  float* qs = vs + BC * SD;
  float* os = qs + BR * SD;
  float* ps = os + BR * SD;
  float* dss = ps + BR * SP;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const Head<T> bh(a, blockIdx.x);
  const int L = a.L, D = a.D;
  const int k0 = blockIdx.y * BC;
  load_tile<SD, NT, T>(ks, bh.k, a.sk.l, k0, BC, L, D, false, 1.f, bh.ct,
                       bh.st, a.vec);
  load_tile<SD, NT, T>(vs, bh.v, a.sv.l, k0, BC, L, D, false, 1.f, nullptr,
                       nullptr, a.vec);
  bool kok[CN];
#pragma unroll
  for (int j = 0; j < CN; ++j) kok[j] = bh.key_ok(a, k0 + tc + 16 * j);
  float dka[KM][NCH][4] = {}, dva[KM][NCH][4] = {};
  for (int q0 = a.causal ? k0 / BR * BR : 0; q0 < L; q0 += BR) {
    __syncthreads();  // the last q tile's P, dS, Q and dO are read
    load_tile<SD, NT, T>(qs, bh.q, a.sq.l, q0, BR, L, D, true, a.scale,
                         bh.ct, bh.st, a.vec);
    load_tile<SD, NT, T>(os, bh.dout, a.sd.l, q0, BR, L, D, false, 1.f,
                         nullptr, nullptr, a.vec);
    __syncthreads();
    float s[RM][CN] = {}, dp[RM][CN] = {};
    scores<C>(s, qs, tr * RM, ks, tc, D);
    scores<C>(dp, os, tr * RM, vs, tc, D);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + tr * RM + i;
      const long long at = bh.at(a, qpos);
      const float lq = qpos < L ? a.lse[at] : kNegInf;
      const bool row_ok = lq > 0.5f * kNegInf;  // the row saw a key
      const float dl = row_ok ? a.delta[at] : 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tc + 16 * j;
        const bool vis = row_ok && kok[j] && !(a.causal && kpos > qpos);
        const float p = vis ? expf(s[i][j] - lq) : 0.f;
        ps[(tr * RM + i) * SP + tc + 16 * j] = round_to<T>(p);
        dss[(tr * RM + i) * SP + tc + 16 * j] =
            vis ? round_to<T>(p * (dp[i][j] - dl)) : 0.f;
      }
    }
    __syncthreads();
    cols_times<C>(dva, ps, os, dka, dss, qs, tr * KM, 4 * tc);
  }
#pragma unroll
  for (int kk = 0; kk < KM; ++kk) {
    const int kpos = k0 + tr * KM + kk;
    if (kpos >= L) continue;
    T* row = dv + bh.at(a, kpos) * D;
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      const int c = 4 * tc + 64 * g;
      if (c >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) row[c + e] = from_f32<T>(dva[kk][g][e]);
    }
  }
  __syncthreads();  // K's tile is free
  spill_tile<KM, NCH, SD>(ks, tr * KM, 4 * tc, dka);
  __syncthreads();
  store_tile<SD, NT, T, T>(dk + bh.at(a, 0) * D, (long long)a.H * D, ks, k0,
                           BC, L, D, bh.ct, bh.st);
}

// dQ in fp32, before the deferred scale: one block per (q tile, batch *
// head), the longest tiles first.
template <class C, typename T>
__global__ void __launch_bounds__(C::NT, C::MINB)
flash_bwd_dq_simt_tiled(Args a, float* __restrict__ dq) {
  constexpr int BR = C::BR, BC = C::BC, RM = C::RM, CN = C::CN,
                NCH = C::NCH, SD = C::SD, SP = C::SP, NT = C::NT;
  extern __shared__ float4 tile_smem[];
  float* qs = reinterpret_cast<float*>(tile_smem);
  float* os = qs + BR * SD;
  float* ks = os + BR * SD;
  float* vs = ks + BC * SD;
  float* dss = C::kOver ? vs : vs + BC * SD;  // dS over V's tile if it fits
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const Head<T> bh(a, blockIdx.x);
  const int L = a.L, D = a.D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  load_tile<SD, NT, T>(qs, bh.q, a.sq.l, q0, BR, L, D, true, a.scale, bh.ct,
                       bh.st, a.vec);
  load_tile<SD, NT, T>(os, bh.dout, a.sd.l, q0, BR, L, D, false, 1.f, nullptr,
                       nullptr, a.vec);
  float lq[RM], dl[RM];
  bool row_ok[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + tr * RM + i;
    const long long at = bh.at(a, qpos);
    lq[i] = qpos < L ? a.lse[at] : kNegInf;
    row_ok[i] = lq[i] > 0.5f * kNegInf;  // the row saw a key
    dl[i] = row_ok[i] ? a.delta[at] : 0.f;
  }
  float acc[RM][NCH][4] = {};
  const int kend = a.causal ? min(L, q0 + BR) : L;
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();  // the last tile's dS and K are read
    load_tile<SD, NT, T>(ks, bh.k, a.sk.l, k0, BC, L, D, false, 1.f, bh.ct,
                         bh.st, a.vec);
    load_tile<SD, NT, T>(vs, bh.v, a.sv.l, k0, BC, L, D, false, 1.f, nullptr,
                         nullptr, a.vec);
    __syncthreads();
    float s[RM][CN] = {}, dp[RM][CN] = {};
    scores<C>(s, qs, tr * RM, ks, tc, D);
    scores<C>(dp, os, tr * RM, vs, tc, D);
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kpos = k0 + tc + 16 * j;
      const bool ok = bh.key_ok(a, kpos);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const bool vis =
            row_ok[i] && ok && !(a.causal && kpos > q0 + tr * RM + i);
        const float p = vis ? expf(s[i][j] - lq[i]) : 0.f;
        s[i][j] = vis ? round_to<T>(p * (dp[i][j] - dl[i])) : 0.f;
      }
    }
    if (C::kOver) __syncthreads();  // every dP is formed: V is free
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        dss[(tr * RM + i) * SP + tc + 16 * j] = s[i][j];
    __syncthreads();
    rows_times<C>(acc, dss, tr * RM, ks, 4 * tc);
  }
  __syncthreads();  // Q's tile is free
  spill_tile<RM, NCH, SD>(qs, tr * RM, 4 * tc, acc);
  __syncthreads();
  store_tile<SD, NT, float, T>(dq + bh.at(a, 0) * D, (long long)a.H * D, qs,
                               q0, BR, L, D, bh.ct, bh.st);
}

template <int NT, typename Kernel, typename... Out>
int launch_tiled(Kernel kernel, size_t smem, unsigned* configured,
                 const Args& a, int B, int tile, cudaStream_t s,
                 Out... out) {
  const cudaError_t e = opt_in_smem(kernel, smem, configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * a.H, (a.L + tile - 1) / tile);
  kernel<<<grid, NT, smem, s>>>(a, out...);
  return (int)cudaGetLastError();
}

template <int DP, typename T>
int fwd_tiled(const Args& a, int B, void* o, float* lse, cudaStream_t s) {
  using C = FwdCfg<DP>;
  static unsigned configured = 0;
  return launch_tiled<C::NT>(flash_fwd_simt_tiled<C, T>, C::kFwdSmem,
                             &configured, a, B, C::BR, s, static_cast<T*>(o),
                             lse);
}

template <int DP, typename T>
int bwd_tiled(const Args& a, int B, float* dq, void* dk, void* dv,
              cudaStream_t s) {
  using K = DkvCfg<DP>;
  using Q = DqCfg<DP>;
  static unsigned conf_dkdv = 0, conf_dq = 0;
  const int e = launch_tiled<K::NT>(flash_bwd_dkdv_simt_tiled<K, T>,
                                    K::kDkvSmem, &conf_dkdv, a, B, K::BC, s,
                                    static_cast<T*>(dk), static_cast<T*>(dv));
  if (e != 0) return e;
  return launch_tiled<Q::NT>(flash_bwd_dq_simt_tiled<Q, T>, Q::kDqSmem,
                             &conf_dq, a, B, Q::BR, s, dq);
}

// ---------------------------------------------------------------------------
// The rows layout (D above kTiledMaxD).

// Where a warp's rows live: its slice of dynamic shared memory (only the
// shared-memory rows use it) and the pair chunks of a row, ceil(D / 64).
struct Slab {
  float* next;
  int chunks;
};

// A row's lane-held pairs in registers: lo(j) = x[c], hi(j) = x[c + D / 2]
// for c = lane + 32 j.
template <int P>
struct RegRow {
  float lo_[P], hi_[P];
  __device__ explicit RegRow(Slab&) {}
  __device__ __forceinline__ int pairs() const { return P; }
  __device__ __forceinline__ float& lo(int j) { return lo_[j]; }
  __device__ __forceinline__ float& hi(int j) { return hi_[j]; }
};

// The same pairs in the warp's shared memory: chunk j is 32 lo then 32 hi
// floats, so a warp's access hits 32 banks once.
struct SmemRow {
  float* p;
  int n;
  __device__ explicit SmemRow(Slab& s)
      : p(s.next + (threadIdx.x & 31)), n(s.chunks) {
    s.next += 64 * s.chunks;
  }
  __device__ __forceinline__ int pairs() const { return n; }
  __device__ __forceinline__ float& lo(int j) { return p[64 * j]; }
  __device__ __forceinline__ float& hi(int j) { return p[64 * j + 32]; }
};

// This warp's slab: `rows` rows of `chunks` pair chunks each.
__device__ __forceinline__ Slab warp_slab(int rows, int chunks) {
  extern __shared__ float slab_smem[];
  return Slab{slab_smem + (threadIdx.x >> 5) * rows * 64 * chunks, chunks};
}

// Load row `src` (unit stride over D) into the lane's pairs, times `scale`
// rounded to T when `scaled` (the pre-scale), then rotated by the row's
// tables (cr / sr, or null) and rounded to T.
template <class R, typename T>
__device__ __forceinline__ void load_row(R& x, const T* src, int D,
                                         bool scaled, float scale,
                                         const T* cr, const T* sr) {
  const int lane = threadIdx.x & 31, hd = D / 2;
#pragma unroll
  for (int j = 0; j < x.pairs(); ++j) {
    const int c = lane + 32 * j;
    float lo = 0.f, hi = 0.f;
    if (c < hd) {
      lo = to_f32(src[c]);
      hi = to_f32(src[c + hd]);
      const bool rope = cr != nullptr;
      prep_pair<T>(lo, hi, scaled, scale, rope, rope ? to_f32(cr[c]) : 0.f,
                   rope ? to_f32(cr[c + hd]) : 0.f,
                   rope ? to_f32(sr[c]) : 0.f,
                   rope ? to_f32(sr[c + hd]) : 0.f);
    }
    x.lo(j) = lo;
    x.hi(j) = hi;
  }
}

template <class R>
__device__ __forceinline__ void zero_row(R& x) {
#pragma unroll
  for (int j = 0; j < x.pairs(); ++j) x.lo(j) = x.hi(j) = 0.f;
}

template <class R>
__device__ __forceinline__ float dot(R& a, R& b) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < a.pairs(); ++j)
    s += a.lo(j) * b.lo(j) + a.hi(j) * b.hi(j);
  return warp_sum(s);
}

// acc = acc * keep + w * x, pair by pair.
template <class R>
__device__ __forceinline__ void axpy(R& acc, float keep, float w, R& x) {
#pragma unroll
  for (int j = 0; j < acc.pairs(); ++j) {
    acc.lo(j) = acc.lo(j) * keep + w * x.lo(j);
    acc.hi(j) = acc.hi(j) * keep + w * x.hi(j);
  }
}

// Inverse-rotate a row of fp32 sums (the lane rotation with the sine
// negated), in fp32.
template <class R, typename T>
__device__ __forceinline__ void unrotate(R& x, int D, const T* cr,
                                         const T* sr) {
  const int lane = threadIdx.x & 31, hd = D / 2;
#pragma unroll
  for (int j = 0; j < x.pairs(); ++j) {
    const int c = lane + 32 * j;
    if (c >= hd) continue;
    const float lo = x.lo(j), hi = x.hi(j);
    x.lo(j) = rot1(lo, hi, to_f32(cr[c]), -to_f32(sr[c]));
    x.hi(j) = rot1(hi, lo, to_f32(cr[c + hd]), -to_f32(sr[c + hd]));
  }
}

template <class R, typename O>
__device__ __forceinline__ void store_row(O* dst, R& x, int D, float mul) {
  const int lane = threadIdx.x & 31, hd = D / 2;
#pragma unroll
  for (int j = 0; j < x.pairs(); ++j) {
    const int c = lane + 32 * j;
    if (c >= hd) continue;
    dst[c] = from_f32<O>(x.lo(j) * mul);
    dst[c + hd] = from_f32<O>(x.hi(j) * mul);
  }
}

// Rows a warp holds in each kernel (the shared-memory rows' slab).
constexpr int kFwdRows = 4, kDkvRows = 6, kDqRows = 5;

// Forward: one warp per (query row, batch * head).
template <class R, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_rows(Args a, T* __restrict__ o, float* __restrict__ lse) {
  const int qpos = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  if (qpos >= a.L) return;
  const int L = a.L, D = a.D;
  const T* cb = static_cast<const T*>(a.cos_t);
  const T* sb = static_cast<const T*>(a.sin_t);
  const bool rope = cb != nullptr;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const long long tb = (long long)b * L * D;
  Slab slab = warp_slab(kFwdRows, a.chunks);
  R qr(slab), acc(slab), kr(slab), vr(slab);
  load_row<R, T>(qr, q + qpos * a.sq.l, D, true, a.scale,
                 rope ? cb + tb + (long long)qpos * D : nullptr,
                 rope ? sb + tb + (long long)qpos * D : nullptr);
  zero_row(acc);
  float m = kNegInf, l = 0.f;
  const int end = a.causal ? qpos + 1 : L;
  for (int kpos = 0; kpos < end; ++kpos) {
    if (a.kv_mask != nullptr && a.kv_mask[(long long)b * L + kpos] == 0)
      continue;
    load_row<R, T>(kr, k + kpos * a.sk.l, D, false, 1.f,
                   rope ? cb + tb + (long long)kpos * D : nullptr,
                   rope ? sb + tb + (long long)kpos * D : nullptr);
    load_row<R, T>(vr, v + kpos * a.sv.l, D, false, 1.f, nullptr, nullptr);
    const float s = dot(qr, kr);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    axpy(acc, corr, p, vr);
    m = m_new;
  }
  const long long at = ((long long)b * L + qpos) * a.H + h;
  store_row<R, T>(o + at * D, acc, D, l == 0.f ? 0.f : 1.f / l);
  if (lse != nullptr && (threadIdx.x & 31) == 0)
    lse[at] = l == 0.f ? kNegInf : m + logf(l);
}

// dK, dV: one warp per (key row, batch * head).
template <class R, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_simt_rows(Args a, T* __restrict__ dk, T* __restrict__ dv) {
  const int kpos = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  if (kpos >= a.L) return;
  const int L = a.L, D = a.D;
  const T* cb = static_cast<const T*>(a.cos_t);
  const T* sb = static_cast<const T*>(a.sin_t);
  const bool rope = cb != nullptr;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sd.b + h * a.sd.h;
  const long long tb = (long long)b * L * D;
  const T* ck = rope ? cb + tb + (long long)kpos * D : nullptr;
  const T* sk = rope ? sb + tb + (long long)kpos * D : nullptr;
  Slab slab = warp_slab(kDkvRows, a.chunks);
  R kr(slab), vr(slab), dka(slab), dva(slab), qr(slab), dor(slab);
  load_row<R, T>(kr, k + kpos * a.sk.l, D, false, 1.f, ck, sk);
  load_row<R, T>(vr, v + kpos * a.sv.l, D, false, 1.f, nullptr, nullptr);
  zero_row(dka);
  zero_row(dva);
  const bool key_ok =
      a.kv_mask == nullptr || a.kv_mask[(long long)b * L + kpos] != 0;
  for (int qpos = a.causal ? kpos : 0; key_ok && qpos < L; ++qpos) {
    const long long at = ((long long)b * L + qpos) * a.H + h;
    const float l_q = a.lse[at];
    if (!(l_q > 0.5f * kNegInf)) continue;  // the row saw no key
    load_row<R, T>(qr, q + qpos * a.sq.l, D, true, a.scale,
                   rope ? cb + tb + (long long)qpos * D : nullptr,
                   rope ? sb + tb + (long long)qpos * D : nullptr);
    load_row<R, T>(dor, dout + qpos * a.sd.l, D, false, 1.f, nullptr,
                   nullptr);
    const float p = expf(dot(qr, kr) - l_q);
    const float ds = round_to<T>(p * (dot(dor, vr) - a.delta[at]));
    const float pt = round_to<T>(p);
    axpy(dva, 1.f, pt, dor);
    axpy(dka, 1.f, ds, qr);
  }
  if (rope) unrotate<R, T>(dka, D, ck, sk);
  const long long o = (((long long)b * L + kpos) * a.H + h) * D;
  store_row<R, T>(dk + o, dka, D, 1.f);
  store_row<R, T>(dv + o, dva, D, 1.f);
}

// dQ in fp32, before the deferred scale: one warp per (query row,
// batch * head).
template <class R, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_simt_rows(Args a, float* __restrict__ dq) {
  const int qpos = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  if (qpos >= a.L) return;
  const int L = a.L, D = a.D;
  const T* cb = static_cast<const T*>(a.cos_t);
  const T* sb = static_cast<const T*>(a.sin_t);
  const bool rope = cb != nullptr;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sd.b + h * a.sd.h;
  const long long tb = (long long)b * L * D;
  const long long at = ((long long)b * L + qpos) * a.H + h;
  const float l_q = a.lse[at];
  const float d_q = a.delta[at];
  const T* cq = rope ? cb + tb + (long long)qpos * D : nullptr;
  const T* sq = rope ? sb + tb + (long long)qpos * D : nullptr;
  Slab slab = warp_slab(kDqRows, a.chunks);
  R qr(slab), dor(slab), acc(slab), kr(slab), vr(slab);
  load_row<R, T>(qr, q + qpos * a.sq.l, D, true, a.scale, cq, sq);
  load_row<R, T>(dor, dout + qpos * a.sd.l, D, false, 1.f, nullptr,
                 nullptr);
  zero_row(acc);
  const int end = (l_q > 0.5f * kNegInf) ? (a.causal ? qpos + 1 : L) : 0;
  for (int kpos = 0; kpos < end; ++kpos) {
    if (a.kv_mask != nullptr && a.kv_mask[(long long)b * L + kpos] == 0)
      continue;
    load_row<R, T>(kr, k + kpos * a.sk.l, D, false, 1.f,
                   rope ? cb + tb + (long long)kpos * D : nullptr,
                   rope ? sb + tb + (long long)kpos * D : nullptr);
    load_row<R, T>(vr, v + kpos * a.sv.l, D, false, 1.f, nullptr, nullptr);
    const float p = expf(dot(qr, kr) - l_q);
    const float ds = round_to<T>(p * (dot(dor, vr) - d_q));
    axpy(acc, 1.f, ds, kr);
  }
  if (rope) unrotate<R, T>(acc, D, cq, sq);
  store_row<R, float>(dq + at * D, acc, D, 1.f);
}

// Launch `kernel` over the L rows of every (batch, head): kWarps warps a
// block for register rows; for shared-memory rows (kRows of them a warp)
// as many warps as kMaxSmem holds, up to kWarps (the opt-in to kMaxSmem
// once per kernel).
template <class R, int kRows, typename Kernel, typename... Out>
int launch_rows(Kernel kernel, unsigned* configured, const Args& a, int B,
                cudaStream_t s, Out... out) {
  int warps = kWarps;
  size_t smem = 0;
  if constexpr (std::is_same<R, SmemRow>::value) {
    const size_t per_warp = (size_t)kRows * 64 * a.chunks * sizeof(float);
    warps = (int)(kMaxSmem / per_warp);
    if (warps < 1) return (int)cudaErrorInvalidValue;
    if (warps > kWarps) warps = kWarps;
    smem = warps * per_warp;
    const cudaError_t e = opt_in_smem(kernel, kMaxSmem, configured);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.L + warps - 1) / warps, B * a.H);
  kernel<<<grid, 32 * warps, smem, s>>>(a, out...);
  return (int)cudaGetLastError();
}

template <class R, typename T>
int fwd_rows(const Args& a, int B, void* o, float* lse, cudaStream_t s) {
  static unsigned configured = 0;
  return launch_rows<R, kFwdRows>(flash_fwd_simt_rows<R, T>, &configured, a, B,
                                  s, static_cast<T*>(o), lse);
}

template <class R, typename T>
int bwd_rows(const Args& a, int B, float* dq, void* dk, void* dv,
             cudaStream_t s) {
  static unsigned conf_dkdv = 0, conf_dq = 0;
  const int e = launch_rows<R, kDkvRows>(flash_bwd_dkdv_simt_rows<R, T>,
                                         &conf_dkdv, a, B, s,
                                         static_cast<T*>(dk),
                                         static_cast<T*>(dv));
  if (e != 0) return e;
  return launch_rows<R, kDqRows>(flash_bwd_dq_simt_rows<R, T>, &conf_dq, a,
                                 B, s, dq);
}

// ---------------------------------------------------------------------------
// Dispatch: the layout (0 tiled, 1 rows), then the padded width.

template <typename T>
int fwd_type(const Args& a, int B, int layout, void* o, float* lse,
             cudaStream_t s) {
  if (layout == 0) {
    if (a.D <= 64) return fwd_tiled<64, T>(a, B, o, lse, s);
    if (a.D <= 128) return fwd_tiled<128, T>(a, B, o, lse, s);
    if (a.D <= 192) return fwd_tiled<192, T>(a, B, o, lse, s);
    return fwd_tiled<256, T>(a, B, o, lse, s);
  }
  if (a.D <= 512) return fwd_rows<RegRow<8>, T>(a, B, o, lse, s);
  return fwd_rows<SmemRow, T>(a, B, o, lse, s);
}

template <typename T>
int bwd_type(const Args& a, int B, int layout, float* dq, void* dk, void* dv,
             cudaStream_t s) {
  if (layout == 0) {
    if (a.D <= 64) return bwd_tiled<64, T>(a, B, dq, dk, dv, s);
    if (a.D <= 128) return bwd_tiled<128, T>(a, B, dq, dk, dv, s);
    if (a.D <= 192) return bwd_tiled<192, T>(a, B, dq, dk, dv, s);
    return bwd_tiled<256, T>(a, B, dq, dk, dv, s);
  }
  if (a.D <= 512) return bwd_rows<RegRow<8>, T>(a, B, dq, dk, dv, s);
  return bwd_rows<SmemRow, T>(a, B, dq, dk, dv, s);
}

// Whether every row of a (B, L, H, D) operand with element strides (b, l,
// h) starts on a 4-element boundary (a stride over an extent of 1 is never
// stepped); a null operand is.
bool rows_aligned(const void* p, int dtype, long long sb, long long sl,
                  long long sh, int B, int L, int H) {
  const uintptr_t bytes = 4 * (dtype == 0 ? 4 : 2);
  return p == nullptr ||
         ((uintptr_t)p % bytes == 0 && (B == 1 || sb % 4 == 0) &&
          (L == 1 || sl % 4 == 0) && (H == 1 || sh % 4 == 0));
}

bool valid(int B, int L, int H, int D, int dtype, int layout) {
  return B > 0 && L > 0 && H > 0 && D > 0 && D % 8 == 0 && dtype >= 0 &&
         dtype <= 2 && (layout == 1 || (layout == 0 && D <= kTiledMaxD));
}

}  // namespace

// q, k, v: (B, L, H, D) of type dtype (0 fp32, 1 bf16, 2 fp16), element
// strides (b, l, h), unit stride over D; D a multiple of 8 whose rows fit
// a block's shared memory.  kv_mask: (B, L) uint8 or null.  cos_t / sin_t:
// contiguous (B, L, D) tables of that type, or both null.  o: contiguous
// (B, L, H, D) of that type.  lse: contiguous (B, L, H) fp32 or null.
// scale: the softmax scale rounded to the type.  layout: 0 the tiled
// kernels (D up to 256), 1 a warp a row.  Returns the cudaError_t of the
// launch.
extern "C" int apex_flash_fwd_simt(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* cos_t, const void* sin_t, void* o, void* lse, long long sqb,
    long long sql, long long sqh, long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh, int B, int L, int H, int D,
    float scale, int causal, int dtype, int layout, void* stream) {
  if (!valid(B, L, H, D, dtype, layout)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, nullptr, nullptr, nullptr,
               static_cast<const uint8_t*>(kv_mask), cos_t, sin_t,
               Strides{sqb, sql, sqh}, Strides{skb, skl, skh},
               Strides{svb, svl, svh}, Strides{0, 0, 0}, H, L, D, scale,
               causal, (D + 63) / 64,
               rows_aligned(q, dtype, sqb, sql, sqh, B, L, H) &&
                   rows_aligned(k, dtype, skb, skl, skh, B, L, H) &&
                   rows_aligned(v, dtype, svb, svl, svh, B, L, H) &&
                   rows_aligned(cos_t, dtype, 0, 0, 0, 1, 1, 1) &&
                   rows_aligned(sin_t, dtype, 0, 0, 0, 1, 1, 1)};
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_type<float>(a, B, layout, o, lp, s);
  if (dtype == 1) return fwd_type<__nv_bfloat16>(a, B, layout, o, lp, s);
  return fwd_type<__half>(a, B, layout, o, lp, s);
}

// The forward's operands and do (strides sd), lse and delta = rowsum(o *
// do) - dlse (contiguous (B, L, H) fp32).  dq: contiguous (B, L, H, D)
// fp32, before the deferred scale; dk, dv: contiguous (B, L, H, D) of the
// operands' type.  layout as the forward's.  Two launches (dk / dv, then
// dq).  Returns the cudaError_t of the launches.
extern "C" int apex_flash_bwd_simt(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask,
    const void* cos_t, const void* sin_t, void* dq, void* dk, void* dv,
    long long sqb, long long sql, long long sqh, long long skb,
    long long skl, long long skh, long long svb, long long svl,
    long long svh, long long sdb, long long sdl, long long sdh, int B, int L,
    int H, int D, float scale, int causal, int dtype, int layout,
    void* stream) {
  if (!valid(B, L, H, D, dtype, layout)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const uint8_t*>(kv_mask), cos_t, sin_t,
               Strides{sqb, sql, sqh}, Strides{skb, skl, skh},
               Strides{svb, svl, svh}, Strides{sdb, sdl, sdh}, H, L, D,
               scale, causal, (D + 63) / 64,
               rows_aligned(q, dtype, sqb, sql, sqh, B, L, H) &&
                   rows_aligned(k, dtype, skb, skl, skh, B, L, H) &&
                   rows_aligned(v, dtype, svb, svl, svh, B, L, H) &&
                   rows_aligned(dout, dtype, sdb, sdl, sdh, B, L, H) &&
                   rows_aligned(cos_t, dtype, 0, 0, 0, 1, 1, 1) &&
                   rows_aligned(sin_t, dtype, 0, 0, 0, 1, 1, 1)};
  float* dqp = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_type<float>(a, B, layout, dqp, dk, dv, s);
  if (dtype == 1)
    return bwd_type<__nv_bfloat16>(a, B, layout, dqp, dk, dv, s);
  return bwd_type<__half>(a, B, layout, dqp, dk, dv, s);
}
