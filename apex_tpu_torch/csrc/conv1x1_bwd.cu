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
// What bounds it on the H100: for ResNet-50's early stages (M 802816,
// 64-256 channels) the bytes: x and dy read once, dx written, at
// 4 cin cout / (2 (2 cin + cout)) flops a byte, far under the ~295 ridge;
// for the late stages (512-2048 channels) the tensor-core operations
// (4 M cin cout).
//
// The TPU kernel walks M tiles in order on one core and keeps dW in a VMEM
// scratch across its sequential grid.  Blocks on Hopper run in no order,
// so dW is summed over M into fp32 partial planes that are added in a
// fixed order: no float atomics, two runs give equal bits.  Python picks
// one of three routes (`conv1x1_route` in ops/cuda/conv1x1.py):
//
// one_pass  bf16 / fp16 where dW fits on chip: ceil(cin / 64) ceil(cout /
//   64) <= 8 tiles of 64 x 64 (cin cout <= 256 x 128).  A persistent
//   block (one an SM) walks its own contiguous range of 64-row M tiles, a
//   static split of ceil(M / 64) tiles by the grid, which is fixed by the
//   shape.  w (cin x cout, at most 64 KB) is loaded once into shared
//   memory.  A producer thread streams each tile's x and dy rows by TMA
//   into a ring of stages under full / empty mbarriers; two consumer
//   warpgroups run `wgmma` on them: dW += x^T dy (both operands MN-major)
//   into fp32 accumulators that stay in registers for the whole range,
//   and the tile's dx = dy w^T (both K-major, w resident) in 64-column
//   chunks.  So x and dy are read from device memory once.  Budget a
//   consumer thread: dW's 64 x 64 tiles split between the two
//   warpgroups, at most 4 a warpgroup (4 x 32 fp32 registers), plus a
//   32-register dx chunk, under the 224 registers that setmaxnreg gives
//   each consumer (the producer keeps 56).  With one 64 x 64 dW tile
//   (cin, cout <= 64) each warpgroup takes every other M tile whole (dx
//   and its own dW plane); otherwise a warpgroup computes the dx of every
//   other M tile.  Shared memory: w, a warpgroup's 8 KB dx staging box
//   each, then as many ring stages of (cin + cout) x 128 bytes as fit 227
//   KB, up to 8 (3 at 256 x 128, 8 at 64 x 64).  Each block (each
//   warpgroup, with one dW tile) writes one fp32 plane.
// two_role  bf16 / fp16 elsewhere (cin or cout >= 512 in ResNet-50): one
//   persistent launch of two kinds of block on the same ring, each with a
//   fixed list of items.  dW blocks take 128 (cin) x 256 (cout) tiles of
//   dW over a chunk of M (split-M: `split` chunks, one fp32 plane each);
//   dx blocks take 128 (M) x 256 (cin) tiles of dx over all of cout, so
//   dy is read once per 256 columns of cin.  Each warpgroup owns 64 rows
//   of the tile in 2 x 64 fp32 registers (two m64n128 products a k-step).
//   Shared memory: four 48 KB stages (a 16 KB and a 32 KB operand tile)
//   and a warpgroup's 16 KB dx staging tile each.  The host plans `split`
//   and the number of dW blocks so that both kinds finish together
//   (`plan_two_role`).
// dx leaves both routes the same way: rounded to T into a staging tile in
//   the 128-byte swizzled layout by stmatrix, then TMA stores of whole
//   64 x 64 boxes, clipped at M and cin.  (Stores of the accumulator's
//   4-byte pairs left half-written 32-byte sectors, and the card read each
//   one back from DRAM: dx cost about twice its bytes.)
// fma  fp32 (true fp32 FMAs, no TF32: wgmma has no fp32 form and the plain
//   version sums true fp32 products), and half types whose channel counts
//   or pointers TMA cannot take (a row pitch or base off 16 bytes): 128 x
//   128 tiles over steps of 32 through registers and shared memory on the
//   CUDA cores, dW over chunks of M into planes summed in two levels by
//   the last blocks of each tile (told by integer tickets).
//
// On the two Hopper routes every block ends in a grid-wide barrier (the
// launch is cooperative, so every block is resident), after which all
// blocks add the planes together, each a slice of dW, plane after plane in
// index order, and cast.  TMA zero-fills rows past M and columns past
// cin / cout; stores skip them, so every shape whose channel counts are
// multiples of 8 runs there.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

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

__host__ __device__ __forceinline__ long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// == the fma route ==========================================================

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

// Bytes of static shared memory: the larger role's A + B tiles.
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int a = (Smem<T, true>::kA + Smem<T, true>::kB) * sizeof(T);
  constexpr int b = (Smem<T, false>::kA + Smem<T, false>::kB) * sizeof(T);
  return ((a > b ? a : b) + 127) / 128 * 128;
}

// True fp32 FMAs on values of T widened to fp32, thread (ty, tx) of 16 x 16
// holding rows ty + 16 i and columns tx + 16 j (conflict-free shared reads
// in fp32).
template <typename T, bool KM>
struct FmaAcc {
  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void step(const T* As, const T* Bs) {
    constexpr int lda = Smem<T, KM>::TA::kLd;
    constexpr int ldb = Smem<T, KM>::TB::kLd;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty + 16 * i;
        a[i] = to_f(KM ? As[m * lda + k] : As[k * lda + m]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        b[j] = to_f(KM ? Bs[n * ldb + k] : Bs[k * ldb + n]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  template <typename Out>
  __device__ __forceinline__ void emit(Out out) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out(ty + 16 * i, tx + 16 * j, acc[i][j]);
  }
};

// The block's reduction over `k_len` indices in steps of kBK, from operand
// tile origins a0 / b0 whose other dimension has `a_lim` / `b_lim` valid
// indices.  KM: the reduction runs along the tiles' columns; otherwise
// along their rows.
template <typename T, bool KM>
__device__ __forceinline__ void block_gemm(
    FmaAcc<T, KM>& acc, T* As, T* Bs, const T* a0, long long lda, int a_lim,
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
    FmaAcc<T, false> acc;
    block_gemm<T, false>(acc, As, Bs, x + k0 * cin + i0, cin, cin - i0,
                         dy + k0 * cout + j0, cout, cout - j0, k1 - k0, vec);
    float* plane = p.part + (long long)s * cin * cout;
    acc.emit([&](int r, int c, float v) {
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
  FmaAcc<T, true> acc;
  block_gemm<T, true>(acc, As, Bs, dy + m0 * cout, cout,
                      (int)(rows < kBM ? rows : kBM), w + (long long)n0 * cout,
                      cout, cin - n0, cout, vec);
  T* dx = static_cast<T*>(p.dx);
  acc.emit([&](int r, int c, float v) {
    if (r < rows && n0 + c < cin)
      dx[(m0 + r) * cin + n0 + c] = from_f<T>(v);
  });
}

// The M chunks of the dW partial planes: enough dW blocks to fill the card
// with the dx blocks beside them, at most kMaxSplit, the planes within
// kPlaneBudget, each chunk a whole number of kBK steps.
void plan_fma(long long m, int cin, int cout, int* split, long long* chunk) {
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
int launch_fma(Args a, cudaStream_t stream) {
  const long long dx_blocks = cdiv(a.m, kBM) * cdiv(a.cin, kBN);
  const long long blocks = a.dw_blocks + dx_blocks;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  conv1x1_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// == the Hopper routes (one_pass, two_role) =================================

namespace sm90 = apex_sm90;

constexpr int kWgThreads = 128;
constexpr int kHopperThreads = 3 * kWgThreads;  // two consumers, a producer
constexpr int kProducerRegs = 56;   // 56 * 128 + 224 * 256 = 168 * 384
constexpr int kConsumerRegs = 224;
constexpr int kBoxBytes = sm90::kBox * sm90::kRowBytes;  // 64 x 64 x 2 bytes
constexpr int kSmemCap = 232448;   // a block's shared memory on the H100
constexpr int kMaxStages = 8;
constexpr int kTileQ = 4;          // one_pass: dW 64 x 64 tiles a warpgroup
constexpr int kTwoRoleStages = 4;
constexpr int kStage2 = 3 * 2 * kBoxBytes;  // two_role: 16 KB + 32 KB
constexpr int kOut2 = 2 * kBoxBytes;        // two_role: a warpgroup's dx
                                            // staging, 64 x 128
constexpr int kOut1 = kBoxBytes;            // one_pass: 64 x 64
constexpr unsigned long long kSyncTimeoutNs = 2000000000ull;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A barrier of the consumer threads of every block: each block's global
// writes before it are visible to every block's reads after it.  sync[0]
// counts arrivals, sync[1] is the generation: the last arrival resets the
// count and moves the generation on.  The launch is cooperative, so every
// block is resident.  A wait past kSyncTimeoutNs gives up (the sums then
// come out wrong, and the checks against the plain version fail) rather
// than hold the card.
__device__ __forceinline__ void grid_sync(unsigned* sync, unsigned blocks,
                                          int tid) {
  __threadfence();
  consumers_sync();
  if (tid == 0) {
    const unsigned gen = ld_acquire(sync + 1);
    if (atomicAdd(sync, 1u) == blocks - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      const unsigned long long t0 = now_ns();
      while (ld_acquire(sync + 1) == gen && now_ns() - t0 < kSyncTimeoutNs)
        __nanosleep(128);
    }
    __threadfence();
  }
  consumers_sync();
}

// dW (n = cin cout elements, a multiple of 4) = the sum of `planes` fp32
// planes, plane after plane in index order from zero, in T; this block's
// share of 4-element groups, consumer thread `tid` of 256.
template <typename T>
__device__ __forceinline__ void sum_planes(const float* part, int planes,
                                           long long n, T* dw, int block,
                                           int blocks, int tid) {
  const long long groups = n / 4;
  const float4* src = reinterpret_cast<const float4*>(part);
  for (long long g = (long long)block * 256 + tid; g < groups;
       g += (long long)blocks * 256) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    int q = 0;
    for (; q + 8 <= planes; q += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(src + (q + u) * groups + g);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        a[0] += v[u].x;
        a[1] += v[u].y;
        a[2] += v[u].z;
        a[3] += v[u].w;
      }
    }
    for (; q < planes; ++q) {
      const float4 v = __ldcg(src + q * groups + g);
      a[0] += v.x;
      a[1] += v.y;
      a[2] += v.z;
      a[3] += v.w;
    }
    uint2 out;
    out.x = sm90::pack2<T>(a[0], a[1]);
    out.y = sm90::pack2<T>(a[2], a[3]);
    reinterpret_cast<uint2*>(dw)[g] = out;
  }
}

// Store a warpgroup's 64 x N fp32 accumulator into the fp32 plane `out`
// (pitch `ld`) at rows row0 + .., columns col0 + .., skipping those at or
// past `rows` / `cols`; `cols` is even, so a pair is wholly in or out, and
// a row's four lanes write 32 contiguous bytes.
template <int N>
__device__ __forceinline__ void store_plane(float* out, long long ld,
                                            const float* acc, int row0,
                                            int rows, int col0, int cols,
                                            int tid) {
  const int r = row0 + (tid / 32) * 16 + (tid % 32) / 4;
  const int c = col0 + 2 * (tid % 4);
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = r + 8 * i, cc = c + 8 * n;
      if (rr < rows && cc < cols)
        *reinterpret_cast<float2*>(out + rr * ld + cc) =
            make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
}

// -- the dx epilogue: stmatrix into a swizzled staging tile, TMA stores ---

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// One 64 x 64 box of shared memory at `src` to (col, row) of a 2-D map.
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map,
                                              uint32_t src, int col,
                                              int row) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(0), "r"(row), "r"(0)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's stores have read their shared memory (kRead)
// or are done.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A warpgroup's 64 x N fp32 accumulator (N a multiple of 64) rounded to T
// into `stage`: N / 64 boxes of 64 rows x 128 bytes, each row's 16-byte
// chunks permuted by the 128-byte swizzle (chunk ^ row % 8), as a TMA
// store reads them.  stmatrix.x4 takes two 8-column groups of the warp's
// 16 rows a call: lanes 8 q .. 8 q + 7 give the row addresses of matrix q
// (rows + 8 (q % 2), group + q / 2); bank-conflict free under the swizzle.
template <int N, typename T>
__device__ __forceinline__ void stage_tile(uint32_t stage, const float* acc,
                                           int tid) {
  const int lane = tid % 32, q = lane / 8;
  const int row = 16 * (tid / 32) + 8 * (q % 2) + lane % 8;
#pragma unroll
  for (int n = 0; n < N / 8; n += 2) {
    const int chunk = n + q / 2;
    const uint32_t addr = stage + (chunk / 8) * kBoxBytes + row * 128 +
                          (((chunk % 8) ^ (row % 8)) << 4);
    stmatrix_x4(addr, sm90::pack2<T>(acc[4 * n], acc[4 * n + 1]),
                sm90::pack2<T>(acc[4 * n + 2], acc[4 * n + 3]),
                sm90::pack2<T>(acc[4 * n + 4], acc[4 * n + 5]),
                sm90::pack2<T>(acc[4 * n + 6], acc[4 * n + 7]));
  }
}

// Store a warpgroup's 64 x N accumulator to dx at (row0, col0) through its
// staging tile: wait until the last store has read the tile, stage, fence
// for the async proxy, then one thread stores the boxes that reach into
// cin (TMA clips rows past M and columns past cin).  `bar` is the
// warpgroup's named barrier.
template <int N, typename T>
__device__ __forceinline__ void store_dx(const CUtensorMap* map,
                                         uint32_t stage, const float* acc,
                                         int row0, int col0, int cin,
                                         int tid, int bar) {
  if (tid == 0) bulk_wait<true>();
  sm90::warpgroup_sync(bar);
  stage_tile<N, T>(stage, acc, tid);
  sm90::fence_proxy_async();
  sm90::warpgroup_sync(bar);
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < N / 64; ++b)
      if (col0 + 64 * b < cin)
        tma_store_box(map, stage + b * kBoxBytes, col0 + 64 * b, row0);
    bulk_commit();
  }
}

struct OnePass {
  int cin, cout;
  int ci, cj;        // 64-wide tiles of cin and cout
  int n_tiles;       // 64-row tiles of M
  int stages;
  int ksplit;        // one dW tile: each warpgroup sums its own M tiles
  unsigned out;      // shared-memory offsets: w at 0, the warpgroups' dx
  unsigned ring;     // staging boxes, the ring, the barriers
  unsigned bars;
  unsigned stage;    // bytes of a stage: x's ci boxes, then dy's cj
};

template <typename T>
__global__ void __launch_bounds__(kHopperThreads, 1)
conv1x1_one_pass(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_dy,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_dx,
                 T* __restrict__ dw, float* part, unsigned* sync,
                 OnePass p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_w = base + p.bars;
  const uint32_t bar_full = bar_w + 8;
  const uint32_t bar_empty = bar_full + 8 * p.stages;
  const int blocks = (int)gridDim.x, b = (int)blockIdx.x;
  const int t0 = (int)((long long)b * p.n_tiles / blocks);
  const int t1 = (int)((long long)(b + 1) * p.n_tiles / blocks);
  const uint32_t x_bytes = (uint32_t)p.ci * kBoxBytes;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_w, 1);
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, 8);  // one arrival a consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / kWgThreads, 0);
  if (wg == 2) {
    // -- producer: w once, then each M tile's x and dy rows ------------------
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWgThreads) {
      sm90::mbar_expect(bar_w, (uint32_t)(p.ci * p.cj) * kBoxBytes);
      for (int j = 0; j < p.cj; ++j)
        for (int i = 0; i < p.ci; ++i)
          sm90::tma_box(base + (j * p.ci + i) * kBoxBytes, &tm_w, bar_w,
                        64 * j, 0, 64 * i, 0);
      for (int it = 0; t0 + it < t1; ++it) {
        const int s = it % p.stages;
        if (it >= p.stages)
          sm90::mbar_wait(bar_empty + 8 * s, (it / p.stages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t st = base + p.ring + s * p.stage;
        const int row = (t0 + it) * 64;
        sm90::mbar_expect(full, p.stage);
        for (int c = 0; c < p.ci; ++c)
          sm90::tma_box(st + c * kBoxBytes, &tm_x, full, 64 * c, 0, row, 0);
        for (int c = 0; c < p.cj; ++c)
          sm90::tma_box(st + x_bytes + c * kBoxBytes, &tm_dy, full, 64 * c, 0,
                        row, 0);
      }
    }
    return;
  }

  // -- consumers -------------------------------------------------------------
  sm90::regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x % kWgThreads;
  const int lane = tid % 32;
  const int n_dw = p.ci * p.cj;
  float acc[kTileQ][32];
#pragma unroll
  for (int q = 0; q < kTileQ; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
  float dxa[32];
  sm90::mbar_wait(bar_w, 0);
  for (int it = 0; t0 + it < t1; ++it) {
    const int s = it % p.stages;
    sm90::mbar_wait(bar_full + 8 * s, (it / p.stages) & 1);
    const uint32_t xs = base + p.ring + s * p.stage;
    const uint32_t ys = xs + x_bytes;
    const bool mine = (it & 1) == wg;
    if (!p.ksplit || mine) {
      // dW += x^T dy over the tile's 64 rows: this warpgroup's 64 x 64 tiles
      sm90::wgmma_fence();
#pragma unroll
      for (int q = 0; q < kTileQ; ++q) {
        const int t = p.ksplit ? q : wg + 2 * q;
        if ((p.ksplit && q == 0) || (!p.ksplit && t < n_dw)) {
          const uint32_t xa = xs + (t / p.cj) * kBoxBytes;
          const uint32_t yb = ys + (t % p.cj) * kBoxBytes;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_ss_mn<true, T>(acc[q], sm90::mnmajor(xa, 64, kk),
                                       sm90::mnmajor(yb, 64, kk));
        }
      }
      sm90::wgmma_commit();
    }
    if (mine) {
      // dx = dy w^T for the tile, 64 columns of cin at a time
      for (int c = 0; c < p.ci; ++c) {
        sm90::wgmma_fence();
        sm90::wgmma_ss<64, false, T>(dxa, sm90::kmajor(ys, 64, 0, 0),
                                     sm90::kmajor(base, 64 * p.ci, 64 * c, 0));
        for (int kk = 1; kk < 4 * p.cj; ++kk)
          sm90::wgmma_ss<64, true, T>(dxa, sm90::kmajor(ys, 64, 0, kk),
                                      sm90::kmajor(base, 64 * p.ci, 64 * c,
                                                   kk));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::pin<32>(dxa);
        store_dx<64, T>(&tm_dx, base + p.out + wg * kBoxBytes, dxa,
                        (t0 + it) * 64, 64 * c, p.cin, tid, 2 + wg);
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < kTileQ; ++q) sm90::pin<32>(acc[q]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * s);
  }

  if (tid == 0) bulk_wait<false>();
  // This block's plane (with ksplit, this warpgroup's), then the sum.
  const long long plane_n = (long long)p.cin * p.cout;
  const int plane = p.ksplit ? 2 * b + wg : b;
  float* pl = part + plane * plane_n;
#pragma unroll
  for (int q = 0; q < kTileQ; ++q) {
    const int t = p.ksplit ? q : wg + 2 * q;
    if ((p.ksplit && q == 0) || (!p.ksplit && t < n_dw))
      store_plane<64>(pl, p.cout, acc[q], (t / p.cj) * 64, p.cin,
                           (t % p.cj) * 64, p.cout, tid);
  }
  grid_sync(sync, blocks, threadIdx.x);
  sum_planes<T>(part, p.ksplit ? 2 * blocks : blocks, plane_n, dw, b, blocks,
                threadIdx.x);
}

struct TwoRole {
  long long m;
  int cin, cout;
  int dw_blocks;     // blocks 0 .. dw_blocks - 1 take dW items, the rest dx
  int split;         // dW over `split` chunks of M of `chunk` rows
  long long chunk;
  int dw_tn;         // 256-wide tiles of cout
  int dw_items;      // 128-wide tiles of cin x dw_tn x split
  int dx_tn;         // 256-wide tiles of cin
  long long dx_items;  // 128-row tiles of M x dx_tn
};

template <typename T>
__global__ void __launch_bounds__(kHopperThreads, 1)
conv1x1_two_role(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_dy,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_dx,
                 T* __restrict__ dw, float* part, unsigned* sync,
                 TwoRole p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t out = base + kTwoRoleStages * kStage2;  // dx staging
  const uint32_t bar_full = out + 2 * kOut2;
  const uint32_t bar_empty = bar_full + 8 * kTwoRoleStages;
  const int blocks = (int)gridDim.x, b = (int)blockIdx.x;
  const bool is_dw = b < p.dw_blocks;
  // items j = first, first + step, ...
  const long long first = is_dw ? b : b - p.dw_blocks;
  const long long step = is_dw ? p.dw_blocks : blocks - p.dw_blocks;
  const long long n_items = is_dw ? p.dw_items : p.dx_items;
  const int dw_tiles = (int)cdiv(p.cin, 128) * p.dw_tn;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTwoRoleStages; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / kWgThreads, 0);
  if (wg == 2) {
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x != 2 * kWgThreads) return;
    int it = 0;
    for (long long j = first; j < n_items; j += step) {
      long long k0, k1, kstep = 64;
      int a_col = 0, b_col = 0;
      long long a_row = 0, b_row = 0;
      if (is_dw) {
        const int s = (int)(j / dw_tiles), t = (int)(j % dw_tiles);
        a_col = (t / p.dw_tn) * 128;       // x: cin columns
        b_col = (t % p.dw_tn) * 256;       // dy: cout columns
        k0 = s * p.chunk;
        k1 = k0 + p.chunk < p.m ? k0 + p.chunk : p.m;
      } else {
        a_row = (j / p.dx_tn) * 128;       // dy: M rows
        b_row = (j % p.dx_tn) * 256;       // w: cin rows
        k0 = 0;
        k1 = p.cout;
      }
      for (long long k = k0; k < k1; k += kstep, ++it) {
        const int s = it % kTwoRoleStages;
        if (it >= kTwoRoleStages)
          sm90::mbar_wait(bar_empty + 8 * s, (it / kTwoRoleStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t st = base + s * kStage2;
        uint32_t boxes = 0;
        if (is_dw) {
          for (int q = 0; q < 2; ++q) boxes += a_col + 64 * q < p.cin;
          for (int q = 0; q < 4; ++q) boxes += b_col + 64 * q < p.cout;
        } else {
          for (int q = 0; q < 2; ++q) boxes += a_row + 64 * q < p.m;
          for (int q = 0; q < 4; ++q) boxes += b_row + 64 * q < p.cin;
        }
        sm90::mbar_expect(full, boxes * kBoxBytes);
        if (is_dw) {
          for (int q = 0; q < 2; ++q)
            if (a_col + 64 * q < p.cin)
              sm90::tma_box(st + q * kBoxBytes, &tm_x, full, a_col + 64 * q,
                            0, (int)k, 0);
          for (int q = 0; q < 4; ++q)
            if (b_col + 64 * q < p.cout)
              sm90::tma_box(st + (2 + q) * kBoxBytes, &tm_dy, full,
                            b_col + 64 * q, 0, (int)k, 0);
        } else {
          for (int q = 0; q < 2; ++q)
            if (a_row + 64 * q < p.m)
              sm90::tma_box(st + q * kBoxBytes, &tm_dy, full, (int)k, 0,
                            (int)(a_row + 64 * q), 0);
          for (int q = 0; q < 4; ++q)
            if (b_row + 64 * q < p.cin)
              sm90::tma_box(st + (2 + q) * kBoxBytes, &tm_w, full, (int)k, 0,
                            (int)(b_row + 64 * q), 0);
        }
      }
    }
    return;
  }

  // -- consumers: warpgroup wg owns rows 64 wg .. of each 128-row tile -------
  sm90::regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x % kWgThreads;
  const int lane = tid % 32;
  float acc[2][64];
  int it = 0;
  for (long long j = first; j < n_items; j += step) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    long long k0, k1;
    bool half_ok[2], active;
    int s_chunk = 0, t = 0;
    long long m0 = 0;
    int n0 = 0;
    if (is_dw) {
      s_chunk = (int)(j / dw_tiles);
      t = (int)(j % dw_tiles);
      const int c0 = (t / p.dw_tn) * 128, j0 = (t % p.dw_tn) * 256;
      active = c0 + 64 * wg < p.cin;
      half_ok[0] = true;
      half_ok[1] = j0 + 128 < p.cout;
      k0 = (long long)s_chunk * p.chunk;
      k1 = k0 + p.chunk < p.m ? k0 + p.chunk : p.m;
    } else {
      m0 = (j / p.dx_tn) * 128;
      n0 = (int)(j % p.dx_tn) * 256;
      active = m0 + 64 * wg < p.m;
      half_ok[0] = true;
      half_ok[1] = n0 + 128 < p.cin;
      k0 = 0;
      k1 = p.cout;
    }
    int pending = -1;
    for (long long k = k0; k < k1; k += 64, ++it) {
      const int s = it % kTwoRoleStages;
      sm90::mbar_wait(bar_full + 8 * s, (it / kTwoRoleStages) & 1);
      const uint32_t st = base + s * kStage2;
      sm90::wgmma_fence();
      if (active) {
        if (is_dw) {
          // dW (64 cin x 256 cout) += x^T dy over 64 rows of M
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (half_ok[h])
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                sm90::wgmma_ss_mn_n128<T>(
                    acc[h], sm90::mnmajor(st + wg * kBoxBytes, 64, kk),
                    sm90::mnmajor(st + (2 + 2 * h) * kBoxBytes, 64, kk));
        } else {
          // dx (64 M x 256 cin) += dy w^T over 64 columns of cout
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (half_ok[h])
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                sm90::wgmma_ss<128, true, T>(
                    acc[h], sm90::kmajor(st, 128, 64 * wg, kk),
                    sm90::kmajor(st + 2 * kBoxBytes, 256, 128 * h, kk));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (pending >= 0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * pending);
      }
      pending = s;
    }
    sm90::wgmma_wait<0>();
    sm90::pin<64>(acc[0]);
    sm90::pin<64>(acc[1]);
    if (pending >= 0) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * pending);
    }
    if (!active) continue;
    if (is_dw) {
      const int c0 = (t / p.dw_tn) * 128, j0 = (t % p.dw_tn) * 256;
      float* pl = part + (long long)s_chunk * p.cin * p.cout;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_plane<128>(pl, p.cout, acc[h], c0 + 64 * wg, p.cin,
                              j0 + 128 * h, p.cout, tid);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (half_ok[h])
          store_dx<128, T>(&tm_dx, out + wg * kOut2, acc[h],
                           (int)m0 + 64 * wg, n0 + 128 * h, p.cin, tid,
                           2 + wg);
    }
  }
  if (tid == 0) bulk_wait<false>();
  grid_sync(sync, blocks, threadIdx.x);
  sum_planes<T>(part, p.split, (long long)p.cin * p.cout, dw, b, blocks,
                threadIdx.x);
}

// -- host side of the Hopper routes ------------------------------------------

// route codes, as ops/cuda/conv1x1.py numbers them
constexpr int kRouteFma = 0, kRouteOnePass = 1, kRouteTwoRole = 2;

OnePass plan_one_pass(long long m, int cin, int cout) {
  OnePass p{};
  p.cin = cin;
  p.cout = cout;
  p.ci = (int)cdiv(cin, 64);
  p.cj = (int)cdiv(cout, 64);
  p.n_tiles = (int)cdiv(m, 64);
  p.ksplit = p.ci * p.cj == 1;
  p.stage = (uint32_t)(p.ci + p.cj) * kBoxBytes;
  p.out = (uint32_t)(p.ci * p.cj) * kBoxBytes;
  p.ring = p.out + 2 * kOut1;
  const long long room = kSmemCap - 1024 - p.ring - 8 * (1 + 2 * kMaxStages);
  p.stages = (int)(room / p.stage);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.bars = p.ring + p.stages * p.stage;
  return p;
}

int one_pass_grid(const OnePass& p) {
  const int sms = apex_fa::sm_count();
  return p.n_tiles < sms ? p.n_tiles : sms;
}

// The dW split and the share of dW blocks: the two kinds of block should
// finish together.  Cost in 128 x 256 x 64 products (one stage), scaled by
// the share of each tile's 128-wide halves (and, for dW, of its two
// 64-row warpgroups) that fall inside cin / cout: a dW item is chunk / 64
// stages, a dx item ceil(cout / 64) and its epilogue (about half a stage);
// the fixed-order sum reads `split` planes over the grid.
TwoRole plan_two_role(long long m, int cin, int cout, int grid) {
  TwoRole best{};
  double best_cost = 1e300;
  const int ti = (int)cdiv(cin, 128), tj = (int)cdiv(cout, 256);
  const int dw_tiles = ti * tj;
  double dw_share = 0.0;  // valid (warpgroup, half) pairs of a dW tile
  for (int i = 0; i < ti; ++i)
    for (int j = 0; j < tj; ++j)
      dw_share += (cin - 128 * i > 64 ? 2 : 1) *
                  (cout - 256 * j > 128 ? 2 : 1) / 4.0;
  dw_share /= dw_tiles;
  const int tn = (int)cdiv(cin, 256);
  double dx_share = 0.0;  // valid halves of a dx tile
  for (int j = 0; j < tn; ++j) dx_share += (cin - 256 * j > 128 ? 2 : 1) / 2.0;
  dx_share /= tn;
  const long long dx_items = cdiv(m, 128) * tn;
  const double dx_steps = (cdiv(cout, 64) + 0.5) * dx_share;
  for (int split = 1; split <= 32; ++split) {
    const long long chunk = cdiv(cdiv(m, split), 64) * 64;
    const int s_eff = (int)cdiv(m, chunk);
    if (s_eff != split) continue;
    const double sum = 2.0 * s_eff * cin * (double)cout * 4 /
                       ((double)grid * kStage2);
    auto dw_cost = [&](int g) {
      return (double)cdiv((long long)dw_tiles * s_eff, g) * (chunk / 64) *
             dw_share;
    };
    auto dx_cost = [&](int g) {
      return (double)cdiv(dx_items, grid - g) * dx_steps;
    };
    auto cost = [&](int g) {
      return (dw_cost(g) > dx_cost(g) ? dw_cost(g) : dx_cost(g)) + sum;
    };
    // dW's cost falls and dx's rises with g: the larger of the two is
    // least where they cross, found by bisection; then the fewest dW
    // blocks at that cost
    int g = 1, hi = grid - 1;
    while (g < hi) {
      const int mid = (g + hi) / 2;
      if (dw_cost(mid) <= dx_cost(mid)) hi = mid;
      else g = mid + 1;
    }
    while (g > 1 && cost(g - 1) <= cost(g)) --g;
    if (cost(g) < best_cost) {
      best_cost = cost(g);
      best.dw_blocks = g;
      best.split = s_eff;
      best.chunk = chunk;
    }
  }
  best.m = m;
  best.cin = cin;
  best.cout = cout;
  best.dw_tn = tj;
  best.dw_items = dw_tiles * best.split;
  best.dx_tn = tn;
  best.dx_items = dx_items;
  return best;
}

// A 2-D row-major (rows, cols) matrix of 16-bit elements as the 4-D map
// encode_map takes: dims (cols, 1, rows, 1), 64 x 64 boxes.
int encode_matrix(CUtensorMap* map, const void* p, long long rows, int cols,
                  bool half) {
  const long long geo[sm90::kGeoWords] = {cols, 1, rows, 1, 2ll * cols,
                                          2ll * cols, 2ll * cols * rows};
  return sm90::encode_map(map, p, geo, half);
}

// One cooperative launch of `kernel` (every block resident, as grid_sync
// needs) with the three maps and the rest of its arguments.  The kernel
// opts in to a block's whole shared memory once: its size varies with the
// shape.
template <typename K, typename P>
int launch_cooperative(K kernel, unsigned* configured, size_t smem, int grid,
                       CUtensorMap* maps, void* dw, float* part,
                       unsigned* sync, P p, cudaStream_t stream) {
  cudaError_t e = apex_fa::opt_in_smem(kernel, kSmemCap, configured);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3],
                  &dw,      &part,    &sync,    &p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(kHopperThreads), args,
                                  smem, stream);
  return (int)e;
}

template <typename T>
int launch_hopper(const void* x, const void* dy, const void* w, void* dx,
                  void* dw, float* part, unsigned* sync, long long m, int cin,
                  int cout, int route, cudaStream_t stream) {
  const bool is_half = std::is_same<T, __half>::value;
  CUtensorMap maps[4];
  int e = encode_matrix(&maps[0], x, m, cin, is_half);
  if (e == 0) e = encode_matrix(&maps[1], dy, m, cout, is_half);
  if (e == 0) e = encode_matrix(&maps[2], w, cin, cout, is_half);
  if (e == 0) e = encode_matrix(&maps[3], dx, m, cin, is_half);
  if (e != 0) return e;
  if (route == kRouteOnePass) {
    static unsigned configured = 0;
    const OnePass p = plan_one_pass(m, cin, cout);
    if (p.stages < 2) return (int)cudaErrorInvalidValue;
    return launch_cooperative(conv1x1_one_pass<T>, &configured,
                              p.bars + 8 * (1 + 2 * p.stages) + 1024,
                              one_pass_grid(p), maps, dw, part, sync, p,
                              stream);
  }
  static unsigned configured2 = 0;
  const int sms = apex_fa::sm_count();
  const TwoRole p = plan_two_role(m, cin, cout, sms);
  return launch_cooperative(conv1x1_two_role<T>, &configured2,
                            kTwoRoleStages * kStage2 + 2 * kOut2 +
                                16 * kTwoRoleStages + 1024,
                            sms, maps, dw, part, sync, p, stream);
}

}  // namespace

// fp32 partial floats the caller allocates for (m, cin, cout) on `route`
// (0 fma, 1 one_pass, 2 two_role): the dW planes.
extern "C" long long apex_conv1x1_bwd_part_floats(long long m, int cin,
                                                  int cout, int route) {
  if (m <= 0 || cin <= 0 || cout <= 0) return 0;
  const long long plane = (long long)cin * cout;
  if (route == kRouteOnePass) {
    const OnePass p = plan_one_pass(m, cin, cout);
    return plane * one_pass_grid(p) * (p.ksplit ? 2 : 1);
  }
  if (route == kRouteTwoRole)
    return plane * plan_two_role(m, cin, cout, apex_fa::sm_count()).split;
  int split;
  long long chunk;
  plan_fma(m, cin, cout, &split, &chunk);
  return plane * split;
}

// uint32 tickets the caller allocates, zero on first use (each launch
// leaves them zero, or, on the Hopper routes, at their next generation).
extern "C" int apex_conv1x1_bwd_tickets(long long m, int cin, int cout,
                                        int route) {
  if (route != kRouteFma) return 2;
  int split;
  long long chunk;
  if (m <= 0 || cin <= 0 || cout <= 0) return 0;
  plan_fma(m, cin, cout, &split, &chunk);
  return (int)(cdiv(cin, kBM) * cdiv(cout, kBN) * (cdiv(split, kGroup) + 1));
}

// The blocks of the launch and (two_role) its dW blocks and split, for a
// record: out[0] blocks, out[1] dW blocks, out[2] planes, out[3] stages.
extern "C" void apex_conv1x1_bwd_plan(long long m, int cin, int cout,
                                      int route, long long* out) {
  out[0] = out[1] = out[2] = out[3] = 0;
  if (m <= 0 || cin <= 0 || cout <= 0) return;
  if (route == kRouteOnePass) {
    const OnePass p = plan_one_pass(m, cin, cout);
    out[0] = one_pass_grid(p);
    out[2] = out[0] * (p.ksplit ? 2 : 1);
    out[3] = p.stages;
  } else if (route == kRouteTwoRole) {
    const TwoRole p = plan_two_role(m, cin, cout, apex_fa::sm_count());
    out[0] = apex_fa::sm_count();
    out[1] = p.dw_blocks;
    out[2] = p.split;
    out[3] = kTwoRoleStages;
  } else {
    int split;
    long long chunk;
    plan_fma(m, cin, cout, &split, &chunk);
    out[1] = cdiv(cin, kBM) * cdiv(cout, kBN) * split;
    out[0] = out[1] + cdiv(m, kBM) * cdiv(cin, kBN);
    out[2] = split;
  }
}

// mode, one int: the dtype (bits 0-1: 0 = float32, 1 = bfloat16,
// 2 = float16), the route (bits 2-3: 0 fma, 1 one_pass, 2 two_role) and,
// on the fma route, bit 4: 16-byte loads (every pointer 16-byte aligned,
// cin and cout multiples of 16 / itemsize).  The Hopper routes take bf16
// and fp16 with cin and cout multiples of 8 and 16-byte aligned pointers.
// x (m, cin), dy (m, cout), w (cin, cout), dx (m, cin), dw (cin, cout):
// contiguous, all in the dtype; part and tickets as the two calls above
// size them.  Returns 0, the cudaError_t of the launch, or an encoder
// error (kMapErrorBase - CUresult).
extern "C" int apex_conv1x1_bwd(const void* x, const void* dy, const void* w,
                                void* dx, void* dw, void* part, void* tickets,
                                long long m, int cin, int cout, int mode,
                                void* stream) {
  if (m <= 0 || cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  const int dtype = mode & 3, route = (mode >> 2) & 3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  if (route != kRouteFma) {
    if (cin % 8 != 0 || cout % 8 != 0 || m > 0x7fffffffll)
      return (int)cudaErrorInvalidValue;
    if (dtype == 1)
      return launch_hopper<__nv_bfloat16>(x, dy, w, dx, dw, pp, tk, m, cin,
                                          cout, route, s);
    if (dtype == 2)
      return launch_hopper<__half>(x, dy, w, dx, dw, pp, tk, m, cin, cout,
                                   route, s);
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = x;
  a.dy = dy;
  a.w = w;
  a.dx = dx;
  a.dw = dw;
  a.part = pp;
  a.tickets = tk;
  a.m = m;
  a.cin = cin;
  a.cout = cout;
  a.vec = (mode >> 4) & 1;
  plan_fma(m, cin, cout, &a.split, &a.chunk);
  a.tiles_j = (int)cdiv(cout, kBN);
  a.dw_blocks = (int)(cdiv(cin, kBM) * a.tiles_j) * a.split;
  switch (dtype) {
    case 0: return launch_fma<float>(a, s);
    case 1: return launch_fma<__nv_bfloat16>(a, s);
    case 2: return launch_fma<__half>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
