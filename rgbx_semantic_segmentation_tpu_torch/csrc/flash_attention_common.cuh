// Helpers shared by the long-kv flash attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the operand layouts and
// their slicing (Layout, slice: attention_common.cuh), the checks of sizes
// and of what the 16-byte and TMA copies of the tensor-core kernels may read,
// and the fp32 scalar form every kernel has beside its tensor-core one.
//
// Every kernel has the same shape. A block owns a few rows of one operand
// ("owner" rows: q rows in the forward and the dq kernel, kv rows in the
// dk/dv kernel) and keeps them on chip for its whole life; it walks the
// other operand in tiles staged in shared memory. Per tile it forms owner x
// tile^T products (logits, dp), turns them into weights (p, ds), and
// accumulates weights x tile products (out, dq, dk, dv) in fp32 registers,
// while the next tiles are on their way from device memory. No (N, M)
// tensor ever leaves the chip. The tensor-core forms build on
// wgmma_common.cuh.
#pragma once

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kFlashMaxD = 128;

// ---------------------------------------------------------------------------
// Scalar fp32 form. A block has kScalarWarps warps; a warp owns kOwn rows,
// kept in shared memory as [e][kOwn] so that one 16-byte broadcast load
// brings element e of all its rows; a tile has 32 rows, one per lane, with
// an odd row stride of d + 1 floats (32 lanes reading 32 rows hit 32 banks,
// and 32 lanes reading 32 neighbouring dims of one row do too).
// ---------------------------------------------------------------------------

constexpr int kScalarWarps = 8;
constexpr int kOwn = 4;
constexpr int kScalarRows = kScalarWarps * kOwn;  // owner rows of a block
constexpr int kScalarTile = 32;
constexpr int kFlashDimTiles = kFlashMaxD / 32;

// Floats of shared memory a scalar kernel needs with `owners` owner operands
// and `weights` weight buffers (two tiles always).
inline size_t scalar_smem_bytes(int d, int owners, int weights) {
  return sizeof(float) * ((size_t)owners * kScalarRows * d +
                          2 * (size_t)kScalarTile * (d + 1) +
                          (size_t)weights * kScalarWarps * kScalarTile * kOwn);
}

// This warp's kOwn rows [r0, r0 + kOwn) of a (n_rows, d) operand into
// xw[e][kOwn]; zero past n_rows.
__device__ __forceinline__ void stage_own(float* xw, const float* src,
                                          long long ld_src, int r0, int n_rows,
                                          int d, int lane) {
  for (int i = lane; i < kOwn * d; i += 32) {
    const int r = i / d;
    const int e = i - r * d;
    xw[e * kOwn + r] =
        r0 + r < n_rows ? src[(long long)(r0 + r) * ld_src + e] : 0.f;
  }
}

// Rows [r0, r0 + kScalarTile) of a (n_rows, d) operand into a
// (kScalarTile, d + 1) tile, by the whole block; zero past n_rows.
__device__ __forceinline__ void stage_scalar_tile(float* dst, const float* src,
                                                  long long ld_src, int r0,
                                                  int n_rows, int d) {
  for (int i = threadIdx.x; i < kScalarTile * d; i += blockDim.x) {
    const int r = i / d;
    const int e = i - r * d;
    dst[r * (d + 1) + e] =
        r0 + r < n_rows ? src[(long long)(r0 + r) * ld_src + e] : 0.f;
  }
}

// s[r] = <owner row r, this lane's tile row>.
__device__ __forceinline__ void dots_own(const float* xw, const float* yrow,
                                         int d, float (&s)[kOwn]) {
#pragma unroll
  for (int r = 0; r < kOwn; ++r) s[r] = 0.f;
  for (int e = 0; e < d; ++e) {
    const float4 x = *reinterpret_cast<const float4*>(xw + e * kOwn);
    const float y = yrow[e];
    s[0] = fmaf(x.x, y, s[0]);
    s[1] = fmaf(x.y, y, s[1]);
    s[2] = fmaf(x.z, y, s[2]);
    s[3] = fmaf(x.w, y, s[3]);
  }
}

// acc[r][u] += sum_j ww[j][r] * Y_s[j][lane + 32u]: the warp's weights
// (kScalarTile, kOwn) times the tile; lane owns dims lane + 32u.
__device__ __forceinline__ void weights_times_scalar_tile(
    const float* ww, const float* Y_s, int d, int lane,
    float (&acc)[kOwn][kFlashDimTiles]) {
  for (int j = 0; j < kScalarTile; ++j) {
    const float4 w = *reinterpret_cast<const float4*>(ww + j * kOwn);
#pragma unroll
    for (int u = 0; u < kFlashDimTiles; ++u) {
      const int e = lane + 32 * u;
      if (e < d) {
        const float y = Y_s[j * (d + 1) + e];
        acc[0][u] = fmaf(w.x, y, acc[0][u]);
        acc[1][u] = fmaf(w.y, y, acc[1][u]);
        acc[2][u] = fmaf(w.z, y, acc[2][u]);
        acc[3][u] = fmaf(w.w, y, acc[3][u]);
      }
    }
  }
}

// True when the 16-byte copies and the TMA loads of the tensor-core kernels
// may read `ptr` with these (batch, head, row) strides: the base on a
// 16-byte boundary, every stride a multiple of 8 bf16 elements.
inline bool aligned16(const void* ptr, const Layout& l) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0 && l.b % 8 == 0 &&
         l.h % 8 == 0 && l.row % 8 == 0;
}

inline Layout layout_at(const long long* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

inline bool flash_sizes_ok(int B, int H, int N, int M, int d) {
  return B > 0 && H > 0 && (long long)B * H <= 65535 && N > 0 && M > 0 &&
         d > 0 && d <= kFlashMaxD && d % 8 == 0;
}


}  // namespace
