// Fused backward of a 1x1 stride-1 NHWC convolution for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces: apex_tpu/ops/pallas/experimental/conv1x1.py, `_bwd_fused` and
// its kernel `_bwd_kernel` (K16 of the port).
//
// Computes, over the flat views x (M, cin), dy (M, cout), w (cin, cout),
// M = B*H*W, all of one dtype T (bf16, fp16 or fp32):
//   dx = dy . w^T   (M, cin), summed in fp32 over cout, stored in T;
//   dW = x^T . dy   (cin, cout), summed in fp32 over all M, stored in T.
//
// What bounds it on the H100: for the early ResNet-50 stages (large M,
// 64-256 channels) the bytes (read x once and dy twice, write dx, at
// 4 * cin * cout / (2 * (cin + cout)) flops a byte, under the ~295 ridge);
// for the late stages (512-2048 channels) the tensor-core operations
// (4 * M * cin * cout).
//
// Design.  The TPU kernel walks M tiles in order on one core and keeps dW
// in a VMEM scratch across its sequential grid.  Blocks on Hopper run in
// no order, so one launch carries two kinds of block:
// - dx blocks: a 128 x 128 tile of dx (rows of M, columns of cin) summed
//   over cout in steps of 32;
// - dW blocks: a 128 x 128 tile of dW (cin x cout) summed over one chunk
//   of M rows, written as an fp32 partial plane (S chunks, S bounded so
//   the planes stay under kPlaneBudget bytes).  The planes are summed in
//   two fixed-order levels, each by the block that finishes last (told by
//   an integer ticket, never a float atomic): the last of each group of
//   kGroup chunks sums the group's planes in order into the group's
//   first plane, and the last of those group sums adds the group planes
//   in order, casts and writes dW; each resets its ticket.  Two runs give
//   equal bits.
// bf16 / fp16 products run on the tensor cores (WMMA 16x16x16, fp32
// accumulate), 8 warps a block, each a 64 x 32 sub-tile, two blocks a SM; fp32 runs as
// true fp32 FMAs (no TF32), 8 x 8 outputs a thread.  Operand tiles go
// global -> registers -> shared memory, the next step's loads in flight
// while the tensor cores work on the current one.  Rows past M and
// columns past cin / cout are masked (zero-filled on load, skipped on
// store), so every shape runs here; 16-byte vector loads where the
// channel counts and pointers allow, element loads otherwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;  // tile rows (dx: M; dW: cin)
constexpr int kBN = 128;  // tile columns (dx: cin; dW: cout)
constexpr int kBK = 32;   // reduction step
constexpr int kThreads = 256;
constexpr long long kPlaneBudget = 64ll << 20;  // bytes of dW partials
constexpr int kMaxSplit = 256;
constexpr int kTargetDwBlocks = 4 * 132;
constexpr int kGroup = 16;  // planes summed by one block at the first level

template <typename T> struct Cfg {
  static constexpr int kVec = 16 / sizeof(T);       // elements a 16-B load
  static constexpr int kPad = sizeof(T) == 2 ? 8 : 1;  // shared row padding
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// A TR x TC tile of a row-major global matrix (row pitch `ld`, unit column
// stride), held in registers between its load and its store to shared
// memory (pitch TC + kPad).  Rows at or past r_lim and columns at or past
// c_lim (both relative to the tile origin) read as zero.
template <typename T, int TR, int TC>
struct Tile {
  static constexpr int kVec = Cfg<T>::kVec;
  static constexpr int kPerRow = TC / kVec;
  static constexpr int kN = TR * TC / kVec / kThreads;
  static constexpr int kLd = TC + Cfg<T>::kPad;
  static_assert(TR * TC % (kVec * kThreads) == 0, "tile / thread mismatch");
  uint4 v[kN];

  __device__ __forceinline__ void load(const T* __restrict__ g, long long ld,
                                       long long r_lim, int c_lim,
                                       bool vec) {
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < r_lim) {
        const T* p = g + (long long)r * ld + c;
        if (vec && c + kVec <= c_lim) {
          val = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          T* e = reinterpret_cast<T*>(&val);
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            if (c + j < c_lim) e[j] = p[j];
        }
      }
      v[q] = val;
    }
  }

  __device__ __forceinline__ void store(T* s) const {
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * kVec;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(s + r * kLd + c) = v[q];
      } else {
        const T* e = reinterpret_cast<const T*>(&v[q]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) s[r * kLd + c + j] = e[j];
      }
    }
  }
};

// The shared tiles of one step.  KM (k-major, the dx blocks): A is held
// [m][k] and B [n][k]; otherwise (the dW blocks) A is [k][m] and B [k][n].
// Either way the global matrix's unit-stride dimension stays unit-stride.
template <typename T, bool KM>
struct Smem {
  using TA = Tile<T, KM ? kBM : kBK, KM ? kBK : kBM>;
  using TB = Tile<T, KM ? kBN : kBK, KM ? kBK : kBN>;
  static constexpr int kA = (KM ? kBM : kBK) * TA::kLd;
  static constexpr int kB = (KM ? kBN : kBK) * TB::kLd;
};

// Bytes of static shared memory: the larger role's A + B tiles (rounded to
// 128 B), plus for 16-bit types a 16 x 16 fp32 staging square per warp.
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int a = (Smem<T, true>::kA + Smem<T, true>::kB) * sizeof(T);
  constexpr int b = (Smem<T, false>::kA + Smem<T, false>::kB) * sizeof(T);
  constexpr int ab = ((a > b ? a : b) + 127) / 128 * 128;
  return ab + (sizeof(T) == 2 ? (kThreads / 32) * 256 * 4 : 0);
}

// Tensor-core path: the block's 128 x 128 fp32 sums in WMMA fragments;
// warp (wm, wn) of 2 x 4 holds rows wm*64.. and columns wn*32.. .
template <typename T, bool KM>
struct MmaAcc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ __forceinline__ void step(const T* As, const T* Bs) {
    using LA = typename std::conditional<KM, wmma::row_major,
                                         wmma::col_major>::type;
    using LB = typename std::conditional<KM, wmma::col_major,
                                         wmma::row_major>::type;
    constexpr int lda = Smem<T, KM>::TA::kLd;
    constexpr int ldb = Smem<T, KM>::TB::kLd;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm * 64 + i * 16;
        wmma::load_matrix_sync(a[i], KM ? As + m * lda + kk
                                        : As + kk * lda + m, lda);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(b[j], KM ? Bs + n * ldb + kk
                                        : Bs + kk * ldb + n, ldb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // out(r, c, v) for every element of the tile, through the warp's fp32
  // staging square; the caller masks.
  template <typename Out>
  __device__ __forceinline__ void emit(float* stage_all, Out out) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3;
    float* stage = stage_all + warp * 256;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 256; e += 32)
          out(wm * 64 + i * 16 + (e >> 4), wn * 32 + j * 16 + (e & 15),
              stage[e]);
        __syncwarp();
      }
  }
};

// fp32 path: true fp32 FMAs, thread (ty, tx) of 16 x 16 holding rows
// ty + 16 i and columns tx + 16 j (conflict-free shared reads).
template <bool KM>
struct FmaAcc {
  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void step(const float* As, const float* Bs) {
    constexpr int lda = Smem<float, KM>::TA::kLd;
    constexpr int ldb = Smem<float, KM>::TB::kLd;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty + 16 * i;
        a[i] = KM ? As[m * lda + k] : As[k * lda + m];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        b[j] = KM ? Bs[n * ldb + k] : Bs[k * ldb + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  template <typename Out>
  __device__ __forceinline__ void emit(float*, Out out) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out(ty + 16 * i, tx + 16 * j, acc[i][j]);
  }
};

template <typename T, bool KM>
using Acc = typename std::conditional<std::is_same<T, float>::value,
                                      FmaAcc<KM>, MmaAcc<T, KM>>::type;

// The block's reduction over `k_len` indices in steps of kBK, from operand
// tile origins a0 / b0 whose other dimension has `a_lim` / `b_lim` valid
// indices.  KM: the reduction runs along the tiles' columns; otherwise
// along their rows.
template <typename T, bool KM>
__device__ __forceinline__ void block_gemm(
    Acc<T, KM>& acc, T* As, T* Bs, const T* a0, long long lda, int a_lim,
    const T* b0, long long ldb, int b_lim, long long k_len, bool vec) {
  using S = Smem<T, KM>;
  typename S::TA ta;
  typename S::TB tb;
  auto load = [&](long long k0) {
    const long long kr = k_len - k0;
    if (KM) {
      const int kc = (int)(kr < kBK ? kr : kBK);
      ta.load(a0 + k0, lda, a_lim, kc, vec);
      tb.load(b0 + k0, ldb, b_lim, kc, vec);
    } else {
      ta.load(a0 + k0 * lda, lda, kr, a_lim, vec);
      tb.load(b0 + k0 * ldb, ldb, kr, b_lim, vec);
    }
  };
  acc.zero();
  load(0);
  for (long long k0 = 0; k0 < k_len; k0 += kBK) {
    ta.store(As);
    tb.store(Bs);
    __syncthreads();
    if (k0 + kBK < k_len) load(k0 + kBK);
    acc.step(As, Bs);
    __syncthreads();
  }
}

// Sum `count` fp32 planes of cin x cout (`stride` floats apart, from
// `src`) over this block's 128 x 128 tile at (i0, j0), plane by plane in
// order, into `dst` (an fp32 plane, which may be src's first, or dW);
// 16 elements a thread at a time, so 16 loads are in flight a thread.
template <typename O>
__device__ __forceinline__ void sum_tile(const float* src, long long stride,
                                         int count, O* dst, int i0, int j0,
                                         int cin, int cout) {
  constexpr int kPer = 16;
#pragma unroll 1
  for (int pass = 0; pass < kBM * kBN / (kThreads * kPer); ++pass) {
    float acc[kPer];
    long long off[kPer];
    bool ok[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + (pass * kPer + j) * kThreads;
      const int r = e / kBN, c = e % kBN;
      ok[j] = i0 + r < cin && j0 + c < cout;
      off[j] = (long long)(i0 + r) * cout + j0 + c;
      acc[j] = 0.f;
    }
    for (int q = 0; q < count; ++q) {
      const float* pl = src + q * stride;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (ok[j]) acc[j] += __ldcg(pl + off[j]);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (ok[j]) dst[off[j]] = from_f<O>(acc[j]);
  }
}

struct Args {
  const void* x;
  const void* dy;
  const void* w;
  void* dx;
  void* dw;
  float* part;
  unsigned* tickets;
  long long m;
  int cin, cout, split, vec;
  long long chunk;
  int dw_blocks, tiles_j;
};

// Two blocks a SM: at most 128 registers a thread (a few spills to L1).
// Over ResNet-50's shapes that was faster on the H100 than one block at
// ~200 registers, as 256 M chunks (4 x 132 dW blocks) were than 64.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_bwd_kernel(Args p) {
  __shared__ __align__(128) unsigned char smem[smem_bytes<T>()];
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  const T* w = static_cast<const T*>(p.w);
  const int cin = p.cin, cout = p.cout;
  const bool vec = p.vec != 0;
  constexpr int kAB = smem_bytes<T>() -
                      (sizeof(T) == 2 ? (kThreads / 32) * 256 * 4 : 0);
  float* stage = reinterpret_cast<float*>(smem + kAB);

  if ((int)blockIdx.x < p.dw_blocks) {
    // dW: tile t of cin x cout over M chunk s
    using S = Smem<T, false>;
    T* As = reinterpret_cast<T*>(smem);
    T* Bs = As + S::kA;
    const int n_tiles = p.dw_blocks / p.split;
    const int t = blockIdx.x % n_tiles, s = blockIdx.x / n_tiles;
    const int i0 = (t / p.tiles_j) * kBM, j0 = (t % p.tiles_j) * kBN;
    const long long k0 = (long long)s * p.chunk;
    const long long k1 = k0 + p.chunk < p.m ? k0 + p.chunk : p.m;
    Acc<T, false> acc;
    block_gemm<T, false>(acc, As, Bs, x + k0 * cin + i0, cin, cin - i0,
                         dy + k0 * cout + j0, cout, cout - j0, k1 - k0, vec);
    float* plane = p.part + (long long)s * cin * cout;
    acc.emit(stage, [&](int r, int c, float v) {
      if (i0 + r < cin && j0 + c < cout)
        plane[(long long)(i0 + r) * cout + j0 + c] = v;
    });
    // level 1: the last block of this chunk's group sums the group
    const long long plane_n = (long long)cin * cout;
    const int n_groups = (p.split + kGroup - 1) / kGroup;
    const int g = s / kGroup;
    const int g_size = min(kGroup, p.split - g * kGroup);
    unsigned* t1 = p.tickets + (long long)t * n_groups + g;
    unsigned* t2 = p.tickets + (long long)n_tiles * n_groups + t;
    float* gplane = p.part + (long long)g * kGroup * plane_n;
    __shared__ unsigned ticket;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) ticket = atomicAdd(t1, 1u);
    __syncthreads();
    if (ticket != (unsigned)(g_size - 1)) return;
    __threadfence();
    sum_tile<float>(gplane, plane_n, g_size, gplane, i0, j0, cin, cout);
    // level 2: the last group sum adds the groups and writes dW
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      *t1 = 0u;
      ticket = atomicAdd(t2, 1u);
    }
    __syncthreads();
    if (ticket != (unsigned)(n_groups - 1)) return;
    __threadfence();
    sum_tile<T>(p.part, kGroup * plane_n, n_groups, static_cast<T*>(p.dw),
                i0, j0, cin, cout);
    if (threadIdx.x == 0) *t2 = 0u;
    return;
  }

  // dx: tile (tm, tn) of M x cin over all of cout
  using S = Smem<T, true>;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + S::kA;
  const long long b = (long long)blockIdx.x - p.dw_blocks;
  const int tiles_n = (cin + kBN - 1) / kBN;
  const long long m0 = (b / tiles_n) * kBM;
  const int n0 = (int)(b % tiles_n) * kBN;
  const long long rows = p.m - m0;
  Acc<T, true> acc;
  block_gemm<T, true>(acc, As, Bs, dy + m0 * cout, cout,
                      (int)(rows < kBM ? rows : kBM), w + (long long)n0 * cout,
                      cout, cin - n0, cout, vec);
  T* dx = static_cast<T*>(p.dx);
  acc.emit(stage, [&](int r, int c, float v) {
    if (r < rows && n0 + c < cin)
      dx[(m0 + r) * cin + n0 + c] = from_f<T>(v);
  });
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The M chunks of the dW partial planes: enough dW blocks to fill the card
// with the dx blocks beside them, at most kMaxSplit, the planes within
// kPlaneBudget, each chunk a whole number of kBK steps.
void plan(long long m, int cin, int cout, int* split, long long* chunk) {
  const long long tiles = cdiv(cin, kBM) * cdiv(cout, kBN);
  long long s = cdiv(kTargetDwBlocks, tiles);
  const long long by_budget = kPlaneBudget / (4ll * cin * cout);
  if (s > kMaxSplit) s = kMaxSplit;
  if (s > by_budget) s = by_budget;
  if (s < 1) s = 1;
  long long c = cdiv(cdiv(m, s), kBK) * kBK;
  *chunk = c;
  *split = (int)cdiv(m, c);
}

template <typename T>
int launch(Args a, cudaStream_t stream) {
  const long long dx_blocks = cdiv(a.m, kBM) * cdiv(a.cin, kBN);
  const long long blocks = a.dw_blocks + dx_blocks;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  conv1x1_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The M split of the dW partial planes for (m, cin, cout): the caller
// allocates split * cin * cout fp32 of partials and
// apex_conv1x1_bwd_tickets(m, cin, cout) uint32 tickets, zero on first
// use (each launch leaves them zero).
extern "C" int apex_conv1x1_bwd_split(long long m, int cin, int cout) {
  int split;
  long long chunk;
  if (m <= 0 || cin <= 0 || cout <= 0) return 0;
  plan(m, cin, cout, &split, &chunk);
  return split;
}

extern "C" int apex_conv1x1_bwd_tickets(long long m, int cin, int cout) {
  const int split = apex_conv1x1_bwd_split(m, cin, cout);
  return (int)(cdiv(cin, kBM) * cdiv(cout, kBN) *
               (cdiv(split, kGroup) + 1));
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  x (m, cin),
// dy (m, cout), w (cin, cout), dx (m, cin), dw (cin, cout): contiguous, all
// in `dtype`.  vec = 1 when every pointer is 16-byte aligned and cin and
// cout are multiples of 16 / itemsize.  Returns the cudaError_t of the
// launch.
extern "C" int apex_conv1x1_bwd(const void* x, const void* dy, const void* w,
                                void* dx, void* dw, void* part, void* tickets,
                                long long m, int cin, int cout, int dtype,
                                int vec, void* stream) {
  if (m <= 0 || cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.dy = dy;
  a.w = w;
  a.dx = dx;
  a.dw = dw;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<unsigned*>(tickets);
  a.m = m;
  a.cin = cin;
  a.cout = cout;
  a.vec = vec;
  plan(m, cin, cout, &a.split, &a.chunk);
  a.tiles_j = (int)cdiv(cout, kBN);
  a.dw_blocks = (int)(cdiv(cin, kBM) * a.tiles_j) * a.split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, s);
    case 1: return launch<__nv_bfloat16>(a, s);
    case 2: return launch<__half>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
