// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py, `_flash_fwd` and its
// kernel `_fwd_kernel` (wrapper semantics: `flash_attention`, `_flash_core`).
//
// Computes exact attention over (B, L, H, D) tensors (the "blhd" layout,
// read through the caller's strides, so a q/k/v split out of a fused qkv
// projection needs no copy): q is pre-scaled by `scale` in its storage
// dtype, as the TPU wrapper does; scores and the online softmax are fp32;
// an optional key mask (B, L) excludes keys (the TPU path's NEG_INF bias
// row); rows with no visible key emit zeros and lse = NEG_INF.  Outputs: o
// (B, L, H, D) in q's dtype, contiguous, and lse (B, L, H) fp32 (optional).
//
// What bounds it on the H100: causal attention does 2 * B * H * D * L *
// (L + 1) flops for its two products against 8 * B * L * H * D bytes of q,
// k, v and o: (L + 1) / 4 flops per byte, under the ~295 ridge of the bf16
// tensor cores until L is about 1200.  So at the serving path's prompt
// lengths (32 to 512) the floor is bytes, and above ~1200 operations.
//
// Design (bf16): one 128-thread block per (64-row q tile, batch * head).
// The TPU kernel's sequential k grid axis, with its m / l / acc scratch,
// becomes a loop inside the block: each 64-key tile of K and V is staged in
// shared memory, the two products run on the tensor cores through WMMA
// (bf16 operands, fp32 accumulators), each warp owns 16 query rows and does
// their online-softmax update with warp shuffles, and the fp32 output
// accumulator lives in registers.  Causal blocks stop at the diagonal tile;
// the ragged last tile is masked in the kernel, so nothing is padded in
// device memory.  No TMA or wgmma yet: this is the simple, right version.
//
// fp32 inputs (tests) take a SIMT kernel with the same conventions: one warp
// per query row, lanes across D, an online softmax over the keys.

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
constexpr int kPadH = 8;   // bf16 row padding (keeps WMMA ldm a multiple of 8)
constexpr int kPadF = 4;   // fp32 row padding (multiple of 4)

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

template <int D>
struct Smem {
  static constexpr int ldh = D + kPadH;         // Q, K, V rows (bf16)
  static constexpr int lds = kBK + kPadF;       // scores (fp32)
  static constexpr int ldp = kBK + kPadH;       // probabilities (bf16)
  static constexpr int ldo = D + kPadF;         // P @ V tile (fp32)
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(__nv_bfloat16) * kBQ * ldh);
  static constexpr size_t v = align128(k + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t s = align128(v + sizeof(__nv_bfloat16) * kBK * ldh);
  static constexpr size_t p = align128(s + sizeof(float) * kBQ * lds);
  static constexpr size_t o = align128(p + sizeof(__nv_bfloat16) * kBQ * ldp);
  static constexpr size_t bytes = align128(o + sizeof(float) * kBQ * ldo);
};

// Copy a (rows, D) tile of a strided bf16 tensor into shared memory with
// 16-byte vectors, zero-filling rows at or past `L`; optionally multiply by
// `scale` and round back to bf16 (the wrapper's q pre-scale).
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride_l, int row0,
                                          int L, bool do_scale, float scale) {
  constexpr int kVec = 8;  // bf16 per 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_l + c);
      if (do_scale) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::ldh + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const uint8_t* __restrict__ kv_mask,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               Strides sq, Strides sk, Strides sv, int H, int L,
               float scale, int causal) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + S::q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::v);
  float* Ss = reinterpret_cast<float*>(smem + S::s);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + S::p);
  float* Os = reinterpret_cast<float*>(smem + S::o);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const uint8_t* mb = kv_mask ? kv_mask + (long long)b * L : nullptr;

  load_tile<D>(Qs, qb, sq.l, q0, L, true, scale);

  constexpr int kCols = D / 32;  // accumulator columns per lane per row
  float acc[16][kCols];
  float m_r[16], l_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  }

  const int n_tiles = (L + kBK - 1) / kBK;
  const int last = causal ? min(n_tiles, (q0 + kBQ - 1) / kBK + 1) : n_tiles;
  const int wrow = warp * 16;  // this warp's first row inside the tile

  for (int t = 0; t < last; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // every warp is done with the previous K / V tile
    load_tile<D>(Ks, kb, sk.l, k0, L, false, 1.f);
    load_tile<D>(Vs, vb, sv.l, k0, L, false, 1.f);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
#pragma unroll
    for (int nf = 0; nf < kBK / 16; ++nf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(af, Qs + wrow * S::ldh + kk * 16, S::ldh);
        wmma::load_matrix_sync(bf, Ks + nf * 16 * S::ldh + kk * 16, S::ldh);
        wmma::mma_sync(sf, af, bf, sf);
      }
      wmma::store_matrix_sync(Ss + wrow * S::lds + nf * 16, sf, S::lds,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time; each lane holds keys lane, lane+32.
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

    // O_tile = P V for this warp's rows (P in bf16, as the TPU kernel casts
    // the probabilities to the value dtype for this product).
#pragma unroll
    for (int df = 0; df < D / 16; ++df) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(af, Ps + wrow * S::ldp + kk * 16, S::ldp);
        wmma::load_matrix_sync(bf, Vs + kk * 16 * S::ldh + df * 16, S::ldh);
        wmma::mma_sync(of, af, bf, of);
      }
      wmma::store_matrix_sync(Os + wrow * S::ldo + df * 16, of, S::ldo,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[r][j] = acc[r][j] * corr[r] +
                    Os[(wrow + r) * S::ldo + lane + 32 * j];
  }

  // Emit: o = acc / l (zeros where no key was visible), lse = m + log(l).
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qpos = q0 + wrow + r;
    if (qpos >= L) continue;
    const float l = l_r[r];
    const float safe_l = l == 0.f ? 1.f : l;
    __nv_bfloat16* orow =
        o + (((long long)b * L + qpos) * H + h) * (long long)D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      orow[lane + 32 * j] = __float2bfloat16(acc[r][j] / safe_l);
    if (lse != nullptr && lane == 0)
      lse[((long long)b * L + qpos) * H + h] =
          l == 0.f ? kNegInf : m_r[r] + logf(safe_l);
  }
}

// fp32: one warp per (query row, batch * head); lanes across D.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
              float* __restrict__ o, float* __restrict__ lse, Strides sq,
              Strides sk, Strides sv, int H, int L, float scale, int causal) {
  constexpr int kCols = D / 32;
  const int lane = threadIdx.x & 31;
  const int qpos = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  if (qpos >= L) return;
  const float* qr = q + b * sq.b + h * sq.h + qpos * sq.l;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const uint8_t* mb = kv_mask ? kv_mask + (long long)b * L : nullptr;
  float qv[kCols], acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    qv[j] = qr[lane + 32 * j] * scale;
    acc[j] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int end = causal ? qpos + 1 : L;
  for (int kpos = 0; kpos < end; ++kpos) {
    if (mb != nullptr && mb[kpos] == 0) continue;
    const float* kr = kb + kpos * sk.l;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) dot += qv[j] * kr[lane + 32 * j];
    const float s = warp_sum(dot);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    const float* vr = vb + kpos * sv.l;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[j] = acc[j] * corr + p * vr[lane + 32 * j];
    m = m_new;
  }
  const float safe_l = l == 0.f ? 1.f : l;
  float* orow = o + (((long long)b * L + qpos) * H + h) * (long long)D;
#pragma unroll
  for (int j = 0; j < kCols; ++j) orow[lane + 32 * j] = acc[j] / safe_l;
  if (lse != nullptr && lane == 0)
    lse[((long long)b * L + qpos) * H + h] =
        l == 0.f ? kNegInf : m + logf(safe_l);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const uint8_t* mask, void* o, float* lse, Strides sq,
                Strides sk, Strides sv, int B, int H, int L, float scale,
                int causal, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  // above 48 KB of dynamic shared memory needs an opt-in, once per device
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) configured |= 1u << dev;
  }
  const dim3 grid((L + kBQ - 1) / kBQ, B * H);
  flash_fwd_bf16<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask,
      static_cast<__nv_bfloat16*>(o), lse, sq, sk, sv, H, L, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v,
               const uint8_t* mask, void* o, float* lse, Strides sq,
               Strides sk, Strides sv, int B, int H, int L, float scale,
               int causal, cudaStream_t stream) {
  const dim3 grid((L + kWarps - 1) / kWarps, B * H);
  flash_fwd_f32<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(o), lse, sq, sk,
      sv, H, L, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the bf16 kernel at head dim D (0 if unsupported).
extern "C" int apex_flash_attn_smem_bytes(int D) {
  if (D == 64) return (int)Smem<64>::bytes;
  if (D == 128) return (int)Smem<128>::bytes;
  return 0;
}

// q, k, v: (B, L, H, D) with element strides (b, l, h) each and unit stride
// over D; bf16 rows must start on 16-byte boundaries.  kv_mask: (B, L)
// uint8 (1 = attend) or null.  o: contiguous (B, L, H, D) in the input
// dtype.  lse: contiguous (B, L, H) fp32 or null.  dtype: 0 = float32,
// 1 = bfloat16.  D is 64 or 128.  Returns the cudaError_t of the launch.
extern "C" int apex_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    void* o, void* lse, long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh, long long svb,
    long long svl, long long svh, int B, int L, int H, int D, float scale,
    int causal, int dtype, void* stream) {
  const Strides sq{sqb, sql, sqh}, sk{skb, skl, skh}, sv{svb, svl, svh};
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  float* lsep = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 64)
      return launch_bf16<64>(q, k, v, mask, o, lsep, sq, sk, sv, B, H, L,
                             scale, causal, s);
    if (D == 128)
      return launch_bf16<128>(q, k, v, mask, o, lsep, sq, sk, sv, B, H, L,
                              scale, causal, s);
  } else if (dtype == 0) {
    if (D == 64)
      return launch_f32<64>(q, k, v, mask, o, lsep, sq, sk, sv, B, H, L,
                            scale, causal, s);
    if (D == 128)
      return launch_f32<128>(q, k, v, mask, o, lsep, sq, sk, sv, B, H, L,
                             scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
