// Hopper (sm_90a) building blocks of the tensor-core attention kernels
// (sr_attention_*.cu, flash_attention_*.cu): 16-byte cp.async staging into
// the 128-byte-swizzled shared-memory layout that wgmma reads, the wgmma
// shared-memory descriptors, the m64n64k16 bf16 wgmma in its two operand
// forms, an m64n128k16 form with both operands in shared memory, and the
// fences that order them.
//
// Shared-memory tiles. Every bf16 operand is staged as "panels" of 64
// columns (128 bytes a row). Inside a panel, row r lies at byte r * 128, and
// its 16-byte chunk c (elements 8c .. 8c + 7) at chunk position c ^ (r % 8):
// the 128-byte swizzle of TMA's CU_TENSOR_MAP_SWIZZLE_128B, which wgmma's
// layout type 1 reads. A panel starts on a 1024-byte boundary (8 rows, one
// swizzle atom). A head dim of 128 takes two panels, one after the other.
//
// One staged tile serves both operand majors of wgmma:
//   * K-major (the product's k runs along the row): q, k, g as the
//     operands of q k^T and g v^T. A k step of 16 moves the start 32 bytes
//     along the row; 8-row groups lie 1024 bytes apart (SBO).
//   * MN-major (k runs down the rows, n along them): v, k, g, q as the B of
//     p v, dl k, p^T g and dl^T q. A k step of 16 rows moves the start 2048
//     bytes; 8-row groups (8 k values) lie 1024 bytes apart (SBO). n spans
//     the panel's 64 columns, so one m64n64 instruction never leaves it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPanel = 64;                 // bf16 columns of a panel
constexpr int kPanelRowBytes = 128;
constexpr int kWgThreads = 128;            // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of element chunk `c` (8 bf16) of row `r` inside a panel.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * kPanelRowBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared, asynchronously; `bytes` = 0 writes zeros
// and reads nothing (the ragged edges).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed generic-proxy writes to shared memory
// (cp.async, st.shared) visible to wgmma, which reads through the async
// proxy. Each writer fences, then the readers synchronise with it.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of one warpgroup (ids 1.., 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWgThreads) : "memory");
}

// Rows [r0, r0 + rows) of a (n_rows, d) bf16 operand (row stride ld
// elements, rows 16-byte aligned, d % 8 == 0) into `panels` swizzled panels
// of `rows` rows at `dst`; rows past n_rows and columns past d are zero.
// Issued by `nthreads` threads numbered `tid`; the caller commits.
__device__ __forceinline__ void stage_rows_async(uint32_t dst,
                                                 const __nv_bfloat16* src,
                                                 long long ld, int r0,
                                                 int n_rows, int d, int rows,
                                                 int panels, int tid,
                                                 int nthreads) {
  const int chunks = rows * panels * 8;
  for (int i = tid; i < chunks; i += nthreads) {
    const int c = i & 7;
    const int rp = i >> 3;
    const int pnl = rp / rows;
    const int r = rp - pnl * rows;
    const int col = pnl * kPanel + c * 8;
    const bool in = r0 + r < n_rows && col < d;
    const __nv_bfloat16* s = in ? src + (long long)(r0 + r) * ld + col : src;
    cp_async16(dst + pnl * rows * kPanelRowBytes + sw128(r, c), s,
               in ? 16 : 0);
  }
}

// ---------------------------------------------------------------- wgmma ----

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1), for a
// tile starting at shared address `addr` (a multiple of 16; the swizzle
// atom's own base on a 1024-byte boundary). LBO is unused by both majors
// here (n and k stay inside a panel); SBO = 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// K-major descriptor of k step `ks` (16 columns) of a tile whose panels
// hold `rows` rows each.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int ks) {
  return sw128_desc(tile + (ks >> 2) * rows * kPanelRowBytes + (ks & 3) * 32);
}

// MN-major descriptor of k step `ks` (16 rows) of panel `pnl` of a tile
// whose panels hold `rows` rows each.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int pnl, int ks) {
  return sw128_desc(tile + pnl * rows * kPanelRowBytes + ks * 16 * kPanelRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Ties the registers of a wgmma operand (accumulator or A) to the asm
// statements around it: called before wgmma_fence, it keeps their last
// ordinary writes in front of the fence (else ptxas sees a register written
// between wgmmas and serialises them with injected waits); called after
// wgmma_wait, it keeps their reads and reuse behind the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SR_WGMMA_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define SR_WGMMA_OUT32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64), A and B from shared memory,
// both K-major. Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// (+ 8) and columns 8j + 2 (t % 4) (+ 1) of d: d[4j + 2h + e] is row
// (+ 8h), column 8j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SR_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SR_WGMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d += A B with A (64 x 16, bf16) from registers in the layout of the
// accumulator (a[0] rows r, columns 2(t % 4) + {0, 1}; a[1] rows r + 8; a[2],
// a[3] the same 8 columns further) and B (16 x 64) from shared memory,
// MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SR_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SR_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define SR_WGMMA_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"
#define SR_WGMMA_OUT64(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),        \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),        \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),        \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128) + (accumulate ? d : 0), A and
// B from shared memory, both K-major (B: 128 rows of one panel, 8-row groups
// 1024 bytes apart). The layout of d extends wgmma_ss's: d[4j + 2h + e] is
// row 16 (t / 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + e, j < 16.
// With accumulate = 0 the old d is not read: no zeroing before a product.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SR_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SR_WGMMA_OUT64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef SR_WGMMA_D32
#undef SR_WGMMA_OUT32
#undef SR_WGMMA_D64
#undef SR_WGMMA_OUT64

// Columns [16k, 16k + 16) of a rounded accumulator tile (R floats a thread:
// 64 x 64 for R = 32, 64 x 128 for R = 64) as the A operand of k step k.
template <int R>
__device__ __forceinline__ void pack_a(const float (&s)[R], int k,
                                       uint32_t (&a)[4]) {
  const float* x = s + 8 * k;
  __nv_bfloat162 h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    a[i] = *reinterpret_cast<uint32_t*>(&h);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte aligned operands with strides in multiples of 8 elements: what the
// 16-byte cp.async staging takes.
inline bool rows_aligned16(const void* ptr, long long b, long long h,
                           long long row) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0 && b % 8 == 0 &&
         h % 8 == 0 && row % 8 == 0;
}

}  // namespace
