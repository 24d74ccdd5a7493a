// Hopper (sm_90a) building blocks of the flash-attention forward, K2 / K17
// (flash_fwd_sm90.cu), of the fused backward, K4 / K18
// (flash_bwd_fused_sm90.cu), of the two-pass backward, K13
// (flash_attn_bwd_dq.cu) and K14 (flash_attn_bwd_dkv.cu), and of the 1x1
// conv backward, K16 (conv1x1_bwd.cu, which reads its (rows, channels)
// matrices through the same maps as (channels, 1, rows, 1)): mbarriers, TMA
// tile loads, wgmma descriptors and instructions in inline PTX (bf16 or
// fp16 operands, fp32 accumulators), and the host-side encoding of the
// tensor maps.
//
// Operand tiles.  Every bf16 / fp16 operand is read through a 4-D TMA map
// with dims (D, H, L, B), the caller's byte strides, and a box of 64
// columns x 1 head x 64 rows x 1 batch, with the 128-byte swizzle that
// wgmma's descriptors expect.  Rows past L and columns past the true D come back as
// zeros, so a head width that is any multiple of 8 up to 128 runs as a
// padded width DP of 64 or 128.  A tile of R rows (64 or 128) and DP columns
// is stored as DP / 64 column halves of R x 128 bytes, one after the other;
// row r of half c sits at c * R * 128 + r * 128, its 16-byte chunks permuted
// by the swizzle (chunk ^ (r % 8)).  Every tile starts on a 1024-byte
// boundary.
//
// The same tile serves as a K-major operand (its columns are the reduction:
// S = Q K^T reads Q and K so) and as an MN-major operand (its rows are the
// reduction: dQ = dS K reads K so, and the fused backward's dS from a dS^T
// tile its consumers store in this layout).  A warpgroup's accumulator holds, for
// thread (warp w, lane l), rows 16 w + l / 4 (+ 8) and columns
// 8 n + 2 (l % 4) (+ 1): register 4 n + 2 i + j is (row + 8 i, column + j).
// Converted to bf16 / fp16 pairs, the accumulator of a 64 x 64 product is,
// without any exchange between threads, the register A operand of the next
// product whose reduction runs over those 64 columns (four k-steps of 16).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace apex_sm90 {

using apex_fa::from_f32;
using apex_fa::kNegInf;
using apex_fa::rot1;
using apex_fa::to_f32;

constexpr int kBox = 64;            // rows and columns of one TMA box
constexpr int kRowBytes = 128;      // one swizzled row of a column half
constexpr int kConsumers = 2;       // consumer warpgroups of a block
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
// Registers a thread after the producer warpgroup gives its own up: the
// launch bound allows 168 (12 warps, three to each quarter of the register
// file); the consumers need ~200 at DP 128, the producer's TMA thread and
// its stats / mask warp more than 40 there.  56 * 128 + 224 * 256 =
// 168 * 384.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  (No timeout that
// traps: a trap path, even one never taken, keeps the compiler from giving
// the consumers the registers that setmaxnreg grants them.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// -- TMA --------------------------------------------------------------------

// One box (64 columns x 64 rows) of a 4-D map at (col, head, row, batch)
// into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int head,
                                        int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// A tile of `rows` (a multiple of 64) rows starting at `row`, all DP / 64
// column halves, into the tile layout above.
template <int DP>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int head,
                                         int row, int batch) {
#pragma unroll
  for (int c = 0; c < DP / kBox; ++c)
    for (int r = 0; r < rows; r += kBox)
      tma_box(dst + (c * rows + r) * kRowBytes, map, bar, c * kBox, head,
              row + r, batch);
}

// -- warp specialisation ----------------------------------------------------

// Give up (dec) or take (inc) registers for the whole warpgroup; the roles
// split in one if / else.  The compiler allocates the code after
// `regs_inc` up to N, unless the kernel holds a trap (see mbar_wait).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// A barrier among the 128 threads of one warpgroup (ids 1.. : 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// -- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: the 64-row slab at row `r0` of a tile of `rows` rows,
// k-step `kk` (columns 16 kk .. 16 kk + 15).  Eight rows are 1024 bytes
// apart; within the swizzle atom a k-step is 32 bytes on.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int r0,
                                           int kk) {
  const uint32_t a = tile + (kk / 4) * rows * kRowBytes + r0 * kRowBytes +
                     (kk % 4) * 32;
  return sw128_desc(a, 16, 8 * kRowBytes);
}

// MN-major operand: rows 16 kk .. 16 kk + 15 of a tile of `rows` rows are
// the reduction, its columns the output's; column halves are rows * 128
// bytes apart, eight rows 1024.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + kk * 16 * kRowBytes, rows * kRowBytes,
                    8 * kRowBytes);
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most `N` committed groups of this warpgroup's products are
// still running (groups retire in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes at this point of
// the program, so the compiler neither reads an accumulator before the wait
// nor reuses an A register while the product may still read it.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The wgmma instructions, in bf16 or fp16 (TY: "bf16" or "f16"); D's
// registers are listed by the APEX_D* macros.  SS: A and B K-major in
// shared memory, D written (p = 0) or accumulated (p = 1).  RS: A from
// registers, B MN-major in shared memory (the transpose bit), accumulated.
#define APEX_WGMMA_SS_N32(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15" \
  "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
#define APEX_WGMMA_SS_N64(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
#define APEX_WGMMA_SS_N128(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
#define APEX_WGMMA_RS_N64(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
#define APEX_WGMMA_RS_N128(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
#define APEX_D16_RW \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define APEX_D16_W \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
  "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), \
  "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
#define APEX_D32_RW \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define APEX_D32_W \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
  "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), \
  "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), \
  "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), \
  "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), \
  "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
#define APEX_D64_W \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
  "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), \
  "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), \
  "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), \
  "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), \
  "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), \
  "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), \
  "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), \
  "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), \
  "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), \
  "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), \
  "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), \
  "=f"(d[62]), "=f"(d[63])
#define APEX_D64_RW \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
  "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63])

// Whether T is fp16 (the f16 instructions) rather than bf16.
template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// D (64 x N fp32) = A B (kAccumulate: += A B), N 32, 64 or 128, A and B
// of type T K-major in shared memory.  The first k-step writes D without
// reading it, so the previous tile's scores are dead while the other
// products run.
template <int N, bool kAccumulate, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128,
                "wgmma_ss: N is 32, 64 or 128");
  if constexpr (N == 32 && kAccumulate) {
    if constexpr (kIsHalf<T>)
      asm volatile(APEX_WGMMA_SS_N32("f16") : APEX_D16_RW
                   : "l"(da), "l"(db), "r"(1));
    else
      asm volatile(APEX_WGMMA_SS_N32("bf16") : APEX_D16_RW
                   : "l"(da), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    if constexpr (kIsHalf<T>)
      asm volatile(APEX_WGMMA_SS_N32("f16") : APEX_D16_W
                   : "l"(da), "l"(db), "r"(0));
    else
      asm volatile(APEX_WGMMA_SS_N32("bf16") : APEX_D16_W
                   : "l"(da), "l"(db), "r"(0));
  } else if constexpr (N == 128 && kAccumulate) {
    if constexpr (kIsHalf<T>)
      asm volatile(APEX_WGMMA_SS_N128("f16") : APEX_D64_RW
                   : "l"(da), "l"(db), "r"(1));
    else
      asm volatile(APEX_WGMMA_SS_N128("bf16") : APEX_D64_RW
                   : "l"(da), "l"(db), "r"(1));
  } else if constexpr (N == 128) {
    if constexpr (kIsHalf<T>)
      asm volatile(APEX_WGMMA_SS_N128("f16") : APEX_D64_W
                   : "l"(da), "l"(db), "r"(0));
    else
      asm volatile(APEX_WGMMA_SS_N128("bf16") : APEX_D64_W
                   : "l"(da), "l"(db), "r"(0));
  } else if constexpr (kAccumulate) {
    if constexpr (kIsHalf<T>)
      asm volatile(APEX_WGMMA_SS_N64("f16") : APEX_D32_RW
                   : "l"(da), "l"(db), "r"(1));
    else
      asm volatile(APEX_WGMMA_SS_N64("bf16") : APEX_D32_RW
                   : "l"(da), "l"(db), "r"(1));
  } else {
    if constexpr (kIsHalf<T>)
      asm volatile(APEX_WGMMA_SS_N64("f16") : APEX_D32_W
                   : "l"(da), "l"(db), "r"(0));
    else
      asm volatile(APEX_WGMMA_SS_N64("bf16") : APEX_D32_W
                   : "l"(da), "l"(db), "r"(0));
  }
}

// D (64 x 64 fp32) += A B, A (64 x 16, type T) from registers, B of type T
// MN-major in shared memory (the transpose bit).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  if constexpr (kIsHalf<T>)
    asm volatile(APEX_WGMMA_RS_N64("f16") : APEX_D32_RW
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else
    asm volatile(APEX_WGMMA_RS_N64("bf16") : APEX_D32_RW
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
}

// D (64 x 128 fp32) += A B, as wgmma_rs_n64.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  if constexpr (kIsHalf<T>)
    asm volatile(APEX_WGMMA_RS_N128("f16") : APEX_D64_RW
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else
    asm volatile(APEX_WGMMA_RS_N128("bf16") : APEX_D64_RW
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
}

// The SS form with both operands MN-major (the two transpose bits).
#define APEX_WGMMA_SS_MN_N64(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}, %32, %33, p, 1, 1, 1, 1;\n}\n"

// D (64 x 64 fp32) = A B (kAccumulate: += A B), A and B of type T both
// MN-major in shared memory (descriptors from `mnmajor`): A's rows are its
// columns in the tile, B as the RS products read it.
template <bool kAccumulate, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_mn(float* d, uint64_t da,
                                            uint64_t db) {
  if constexpr (kAccumulate) {
    if constexpr (kIsHalf<T>)
      asm volatile(APEX_WGMMA_SS_MN_N64("f16") : APEX_D32_RW
                   : "l"(da), "l"(db), "r"(1));
    else
      asm volatile(APEX_WGMMA_SS_MN_N64("bf16") : APEX_D32_RW
                   : "l"(da), "l"(db), "r"(1));
  } else {
    if constexpr (kIsHalf<T>)
      asm volatile(APEX_WGMMA_SS_MN_N64("f16") : APEX_D32_W
                   : "l"(da), "l"(db), "r"(0));
    else
      asm volatile(APEX_WGMMA_SS_MN_N64("bf16") : APEX_D32_W
                   : "l"(da), "l"(db), "r"(0));
  }
}

#define APEX_WGMMA_SS_MN_N128(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}, %64, %65, p, 1, 1, 1, 1;\n}\n"

// D (64 x 128 fp32) += A B, A and B of type T both MN-major in shared
// memory (the 1x1-conv backward's dW = x^T dy: B spans two column halves).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_mn_n128(float* d, uint64_t da,
                                                 uint64_t db) {
  if constexpr (kIsHalf<T>)
    asm volatile(APEX_WGMMA_SS_MN_N128("f16") : APEX_D64_RW
                 : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(APEX_WGMMA_SS_MN_N128("bf16") : APEX_D64_RW
                 : "l"(da), "l"(db), "r"(1));
}

#undef APEX_WGMMA_SS_MN_N128
#undef APEX_WGMMA_SS_MN_N64
#undef APEX_WGMMA_SS_N32
#undef APEX_WGMMA_SS_N64
#undef APEX_WGMMA_SS_N128
#undef APEX_WGMMA_RS_N64
#undef APEX_WGMMA_RS_N128
#undef APEX_D16_RW
#undef APEX_D16_W
#undef APEX_D32_RW
#undef APEX_D32_W
#undef APEX_D64_RW
#undef APEX_D64_W

// D (64 x DP fp32) += A B: the output-width product of a pass.
template <int DP, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_n64<T>(d, a, db);
  else
    wgmma_rs_n128<T>(d, a, db);
}

// S (64 x N) = A B^T over DP columns: A's 64-row slab at row a_r0 and B's
// N-row slab at row b_r0, both K-major.
template <int DP, int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void scores(float* s, uint32_t a, int a_rows,
                                       int a_r0, uint32_t b, int b_rows,
                                       int b_r0) {
  wgmma_ss<N, false, T>(s, kmajor(a, a_rows, a_r0, 0),
                        kmajor(b, b_rows, b_r0, 0));
#pragma unroll
  for (int kk = 1; kk < DP / 16; ++kk)
    wgmma_ss<N, true, T>(s, kmajor(a, a_rows, a_r0, kk),
                         kmajor(b, b_rows, b_r0, kk));
}

// Two fp32 values rounded to T and packed into one register (lo first).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The register A operand of a product over the N columns of accumulator
// `x`: k-step kk's four registers pack (x[8 kk + 2 j], x[8 kk + 2 j + 1]).
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void to_a_operand(const float* x, uint32_t* a) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) a[j] = pack2<T>(x[2 * j], x[2 * j + 1]);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (x = (s - lse) log2 e, formed by one fma): the exponential of the
// probabilities, on the special-function unit in one instruction.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Store a warpgroup's 64 x DP fp32 accumulator into `stage` (row pitch
// DP + 8 floats: the 16 float2 stores of a half-warp hit 32 banks once).
template <int DP>
__device__ __forceinline__ void stage_acc(float* stage, const float* acc,
                                          int tid) {
  constexpr int kPitch = DP + 8;
  const int r = (tid / 32) * 16 + (tid % 32) / 4;
  const int c = 2 * (tid % 4);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(stage + (r + 8 * i) * kPitch + 8 * n + c) =
          make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
}

// Write 64 staged rows (row0 .. row0 + 63 of (B, L, H, D) `out`, rows at or
// past L skipped) in T: inverse-rotated first when tables are given (the
// lane rotation with the sine negated, in fp32), rounded to T, then, when
// `scaled`, times `scale` in T (rounded again).
template <int DP, typename T = __nv_bfloat16>
__device__ __forceinline__ void write_rows(T* out, const float* stage,
                                           int tid, int b, int h, int row0,
                                           int L, int H, int D,
                                           const T* cos_t, const T* sin_t,
                                           bool scaled, float scale) {
  constexpr int kPitch = DP + 8;
  const int hd = D / 2;
  for (int i = tid; i < 64 * hd; i += 128) {
    const int r = i / hd, c = i % hd;
    const int pos = row0 + r;
    if (pos >= L) break;  // rows run in order: the rest are past L too
    float lo = stage[r * kPitch + c], hi = stage[r * kPitch + c + hd];
    if (cos_t != nullptr) {
      const long long t = ((long long)b * L + pos) * D;
      const float l2 =
          rot1(lo, hi, to_f32(cos_t[t + c]), -to_f32(sin_t[t + c]));
      hi = rot1(hi, lo, to_f32(cos_t[t + c + hd]), -to_f32(sin_t[t + c + hd]));
      lo = l2;
    }
    T ol = from_f32<T>(lo), oh = from_f32<T>(hi);
    if (scaled) {
      ol = from_f32<T>(__fmul_rn(to_f32(ol), scale));
      oh = from_f32<T>(__fmul_rn(to_f32(oh), scale));
    }
    T* o = out + (((long long)b * L + pos) * H + h) * D;
    o[c] = ol;
    o[c + hd] = oh;
  }
}

// -- host -------------------------------------------------------------------

// An error of the tensor-map encoder (a CUresult), told apart from the
// cudaError_t values the entry points otherwise return.
constexpr int kMapErrorBase = -1000;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Encode the 4-D map of one bf16 (or, with `half`, fp16) operand: `geo`
// holds its dims (D, H, L, B) and the byte strides of H, L and B, as the
// wrapper computed them.  Returns 0, a cudaError_t, or kMapErrorBase -
// CUresult.
inline int encode_map(CUtensorMap* map, const void* base,
                      const long long* geo, bool half = false) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)geo[0], (cuuint64_t)geo[1],
                              (cuuint64_t)geo[2], (cuuint64_t)geo[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)geo[4], (cuuint64_t)geo[5],
                                 (cuuint64_t)geo[6]};
  const cuuint32_t box[4] = {kBox, 1, kBox, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapErrorBase - (int)r;
}

// Words of `geo` per operand.
constexpr int kGeoWords = 7;

}  // namespace apex_sm90
