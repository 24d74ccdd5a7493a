// K17, the multi-head flash-attention forward for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces: apex_tpu/ops/pallas/experimental/flash_mh.py, `_mh_fwd` and its
// kernel `_fwd_kernel` (entry point `flash_attention_mh`).
//
// Computes exact attention over (B, L, H, D) bf16 tensors read as their
// native (B, L, H * D) layout through the caller's strides (no transposed
// copy), for any head width D that is a multiple of 8 up to 128: q is
// pre-scaled by `scale` in bf16 (the JAX wrapper's `q * scale` before the
// kernel), scores and the online softmax are fp32, an optional key mask
// (B, L) hides keys, rows that see no key emit zeros and lse = NEG_INF, and a
// ragged L is masked in the kernel (the JAX wrapper pads L and biases the
// padded keys with NEG_INF: the same result on the real rows).  Outputs: o
// (B, L, H, D) bf16, contiguous, and lse (B, L, H) fp32.
//
// What bounds it on the H100: 4 * D flops a visible (q, k) pair (two
// products) against 8 * B * L * H * D bytes of q, k, v and o: operations
// above L ~ 1200, bytes below.
//
// Design.  The TPU block carries all H heads of a q tile (its lanes are the
// fused H * D); on Hopper all heads do not fit one block: at gpt_small's H *
// D = 768 a 64-row q tile plus one 64-row K and V tile of every head is 288
// KB of bf16 against the 227 KB a block may have, and the 64 x 64 fp32
// accumulators of 12 heads do not fit in one block's registers.  So a block
// takes one 64-row q tile of a GROUP of heads that share one 128-lane plane
// (G = 128 / DP heads of padded width DP, the pairing of the TPU kernel's
// 64-lane head slices: two heads at D 64, one at D 128, eight at D 16) and
// walks them one after another, streaming K and V head by head.  Per head
// it is the K2 design: Q, K, V tiles staged in shared memory with 16-byte
// loads, both products on the tensor cores through WMMA (bf16 operands,
// fp32 accumulators), each warp owning 16 query rows with its online-softmax
// state and its fp32 output accumulator in registers, causal blocks stopping
// at the diagonal tile.  A head width that is not a multiple of 16 (the WMMA
// k step) is zero-padded to DP in shared memory: the padding adds nothing
// to the scores and its output columns are never written.  No TMA or wgmma:
// the simple, right version.

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
constexpr int kPadH = 8;  // bf16 row padding (WMMA ldm a multiple of 8)
constexpr int kPadF = 4;  // fp32 row padding
constexpr int kPlane = 128;  // lanes of one head group

struct Strides {  // in elements; the last dimension has stride 1
  long long b, l, h;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ constexpr int heads_per_block(int dp) {
  return dp >= kPlane ? 1 : kPlane / dp;
}

template <int DP>
struct Smem {
  static constexpr int ldh = DP + kPadH;    // Q, K, V rows (bf16)
  static constexpr int lds = kBK + kPadF;   // scores (fp32)
  static constexpr int ldp = kBK + kPadH;   // probabilities (bf16)
  static constexpr int ldo = DP + kPadF;    // P @ V tile (fp32)
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(__nv_bfloat16) * kBQ * ldh);
  static constexpr size_t v = align128(k + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t s = align128(v + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t p = align128(s + sizeof(float) * kBQ * lds);
  static constexpr size_t o = align128(p + sizeof(__nv_bfloat16) * kBQ * ldp);
  static constexpr size_t bytes = align128(o + sizeof(float) * kBQ * ldo);
};

// Copy a (64, D) tile of one head of a strided bf16 tensor into shared
// memory as (64, DP) with 16-byte vectors: rows at or past L and columns at
// or past D are zero.  With `do_scale`, each value is multiplied by `scale`
// and rounded back to bf16 (the wrapper's q pre-scale).
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride_l, int row0,
                                          int L, int D, bool do_scale,
                                          float scale) {
  constexpr int kVec = 8;  // bf16 per 16 bytes
  constexpr int kPerRow = DP / kVec;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && c < D) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_l + c);
      if (do_scale) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<DP>::ldh + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_mh_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const uint8_t* __restrict__ kv_mask,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  Strides sq, Strides sk, Strides sv, int H, int L, int D,
                  float scale, int causal) {
  using S = Smem<DP>;
  constexpr int G = heads_per_block(DP);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::v);
  float* Ss = reinterpret_cast<float*>(smem + S::s);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + S::p);
  float* Os = reinterpret_cast<float*>(smem + S::o);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = (H + G - 1) / G;
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y % groups) * G;
  const int q0 = blockIdx.x * kBQ;
  const uint8_t* mb = kv_mask ? kv_mask + (long long)b * L : nullptr;
  const int n_tiles = (L + kBK - 1) / kBK;
  const int last = causal ? min(n_tiles, (q0 + kBQ - 1) / kBK + 1) : n_tiles;
  const int wrow = warp * 16;  // this warp's first row inside the tile
  constexpr int kCols = (DP + 31) / 32;  // accumulator columns per lane

  for (int h = h0; h < min(h0 + G, H); ++h) {
    const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
    const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
    const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
    __syncthreads();  // the previous head is done with Q
    load_tile<DP>(Qs, qb, sq.l, q0, L, D, true, scale);

    float acc[16][kCols];
    float m_r[16], l_r[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      m_r[r] = kNegInf;
      l_r[r] = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
    }

    for (int t = 0; t < last; ++t) {
      const int k0 = t * kBK;
      __syncthreads();  // every warp is done with the previous K / V tile
      load_tile<DP>(Ks, kb, sk.l, k0, L, D, false, 1.f);
      load_tile<DP>(Vs, vb, sv.l, k0, L, D, false, 1.f);
      __syncthreads();

      // S = Q K^T for this warp's 16 rows x 64 keys
#pragma unroll
      for (int nf = 0; nf < kBK / 16; ++nf) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
        wmma::fill_fragment(sf, 0.f);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(af, Qs + wrow * S::ldh + kk * 16, S::ldh);
          wmma::load_matrix_sync(bf, Ks + nf * 16 * S::ldh + kk * 16,
                                 S::ldh);
          wmma::mma_sync(sf, af, bf, sf);
        }
        wmma::store_matrix_sync(Ss + wrow * S::lds + nf * 16, sf, S::lds,
                                wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax, a row at a time; lanes hold keys lane, lane + 32
      float corr[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int qpos = q0 + wrow + r;
        float sv2[2];
        bool vis[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          const int kpos = k0 + c;
          bool ok = kpos < L;
          if (causal) ok = ok && kpos <= qpos;
          if (mb != nullptr && ok) ok = mb[kpos] != 0;
          vis[j] = ok;
          sv2[j] = ok ? Ss[(wrow + r) * S::lds + c] : kNegInf;
        }
        const float m_new = fmaxf(m_r[r], warp_max(fmaxf(sv2[0], sv2[1])));
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = vis[j] ? expf(sv2[j] - m_new) : 0.f;
          psum += p;
          Ps[(wrow + r) * S::ldp + lane + 32 * j] = __float2bfloat16(p);
        }
        corr[r] = expf(m_r[r] - m_new);
        l_r[r] = l_r[r] * corr[r] + warp_sum(psum);
        m_r[r] = m_new;
      }
      __syncwarp();

      // O_tile = P V (P in bf16, the value dtype, as the TPU kernel casts)
#pragma unroll
      for (int df = 0; df < DP / 16; ++df) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
        wmma::fill_fragment(of, 0.f);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(af, Ps + wrow * S::ldp + kk * 16, S::ldp);
          wmma::load_matrix_sync(bf, Vs + kk * 16 * S::ldh + df * 16,
                                 S::ldh);
          wmma::mma_sync(of, af, bf, of);
        }
        wmma::store_matrix_sync(Os + wrow * S::ldo + df * 16, of, S::ldo,
                                wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = lane + 32 * j;
          if (c < DP)
            acc[r][j] = acc[r][j] * corr[r] + Os[(wrow + r) * S::ldo + c];
        }
    }

    // o = acc / l (zeros where no key was visible), lse = m + log(l)
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qpos = q0 + wrow + r;
      if (qpos >= L) continue;
      const float l = l_r[r];
      const float safe_l = l == 0.f ? 1.f : l;
      __nv_bfloat16* orow =
          o + (((long long)b * L + qpos) * H + h) * (long long)D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + 32 * j;
        if (c < D) orow[c] = __float2bfloat16(acc[r][j] / safe_l);
      }
      if (lane == 0)
        lse[((long long)b * L + qpos) * H + h] =
            l == 0.f ? kNegInf : m_r[r] + logf(safe_l);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const uint8_t* mask,
           void* o, float* lse, Strides sq, Strides sk, Strides sv, int B,
           int H, int L, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = Smem<DP>::bytes;
  static unsigned configured = 0;  // the >48 KB opt-in, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(flash_mh_fwd_bf16<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) configured |= 1u << dev;
  }
  constexpr int G = heads_per_block(DP);
  const dim3 grid((L + kBQ - 1) / kBQ, B * ((H + G - 1) / G));
  flash_mh_fwd_bf16<DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask,
      static_cast<__nv_bfloat16*>(o), lse, sq, sk, sv, H, L, D, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Heads a block takes at head width D (0 if D is not a multiple of 8 in
// [8, 128]).
extern "C" int apex_flash_mh_heads_per_block(int D) {
  if (D < 8 || D > 128 || D % 8) return 0;
  return heads_per_block((D + 15) / 16 * 16);
}

// q, k, v: (B, L, H, D) bf16 with element strides (b, l, h) each, unit
// stride over D, rows starting on 16-byte boundaries.  kv_mask: (B, L)
// uint8 (1 = attend) or null.  o: contiguous (B, L, H, D) bf16.  lse:
// contiguous (B, L, H) fp32.  D: a multiple of 8 up to 128.  `scale` is
// applied to q in bf16.  Returns the cudaError_t of the launch.
extern "C" int apex_flash_mh_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    void* o, void* lse, long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh, long long svb,
    long long svl, long long svh, int B, int L, int H, int D, float scale,
    int causal, void* stream) {
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh};
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || D < 8 || D > 128 || D % 8)
    return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
#define APEX_MH_CASE(n)                                                    \
  case n:                                                                  \
    return launch<16 * n>(q, k, v, mask, o, lp, sq, sk, sv, B, H, L, D,    \
                          scale, causal, s);
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
