// Helpers shared by the long-kv flash attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the 64-row shared-memory
// tiles of the tensor-core kernels and the two products every kernel is made
// of, in a tensor-core (bf16, mma.sync m16n8k16) and a scalar (fp32) form.
//
// Every kernel has the same shape. A warp owns a few rows of one operand
// ("owner" rows: q rows in the forward and the dq kernel, kv rows in the
// dk/dv kernel) and keeps them on chip for its whole life; the block walks
// the other operand in tiles staged in shared memory. Per tile a warp forms
// owner x tile^T products (logits, dp), turns them into weights (p, ds) in
// registers, and accumulates weights x tile products (out, dq, dk, dv) in
// fp32 registers, while the next tile is on its way from device memory
// (TileRegs). No (N, M) tensor ever leaves the chip.
#pragma once

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kFlashMaxD = 128;
constexpr int kFlashWarps = 4;  // tensor-core kernels: warps of a block
constexpr int kTile = 64;       // rows of a staged tile

// A block's share of rows [r0, r0 + kTile) of a (n_rows, d) bf16 operand
// (row stride ld_src elements) on its way into a (kTile, DP + 8) shared
// tile, DP = 16 * KS: KS 16-byte chunks a thread; rows past n_rows and
// columns past d are zero. `load` only issues the reads, so a kernel loads
// tile t + 1 into registers, computes on tile t and stores tile t + 1
// afterwards: the reads' latency hides behind the products. d is a multiple
// of 8 and every row starts on a 16-byte boundary (checked by the host
// side). The shared row stride of DP + 8 elements keeps both the 32-bit
// fragment loads and ldmatrix free of bank conflicts.
template <int KS>
struct TileRegs {
  static constexpr int CH = 2 * KS;  // 16-byte chunks of a row
  uint4 x[KS];

  __device__ __forceinline__ void load(const bf16* src, long long ld_src,
                                       int r0, int n_rows, int d) {
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int at = threadIdx.x + i * kFlashWarps * 32;
      const int r = at / CH;
      const int c = (at - r * CH) * 8;
      x[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n_rows && c < d)
        x[i] = *reinterpret_cast<const uint4*>(
            src + (long long)(r0 + r) * ld_src + c);
    }
  }

  __device__ __forceinline__ void store(bf16* dst) const {
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int at = threadIdx.x + i * kFlashWarps * 32;
      const int r = at / CH;
      *reinterpret_cast<uint4*>(dst + r * (16 * KS + 8) + (at - r * CH) * 8) =
          x[i];
    }
  }
};

// A fragments of rows [r0, r0 + 16) of a (n_rows, d) bf16 matrix in device
// memory (row stride ld); zero outside. Pairs are read as 32 bits: columns
// are even and d is a multiple of 8.
template <int KS>
__device__ __forceinline__ void load_a_fragments(uint32_t (&a)[KS][4],
                                                 const bf16* base,
                                                 long long ld, int r0,
                                                 int n_rows, int d, int gq,
                                                 int tq) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + gq + 8 * (i & 1);
      const int col = kk * 16 + 2 * tq + 8 * (i >> 1);
      uint32_t x = 0u;
      if (row < n_rows && col < d)
        x = *reinterpret_cast<const uint32_t*>(base + (long long)row * ld + col);
      a[kk][i] = x;
    }
  }
}

// s = X @ Y^T: `xa` are the A fragments of a 16-row tile of x, `Y_s` a
// staged (kTile, ld) tile of y. s[t] is the 16 x 8 accumulator of tile
// columns [8t, 8t + 8): thread (gq, tq) holds rows gq (elements 0, 1) and
// gq + 8 (elements 2, 3), columns 8t + 2tq and 8t + 2tq + 1.
template <int KS>
__device__ __forceinline__ void xyT_tile(const uint32_t (&xa)[KS][4],
                                         const bf16* Y_s, int ld, int gq,
                                         int tq, float (&s)[kTile / 8][4]) {
#pragma unroll
  for (int t = 0; t < kTile / 8; ++t) {
    s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    const bf16* yr = Y_s + (t * 8 + gq) * ld + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma16816(s[t], xa[kk], *reinterpret_cast<const uint32_t*>(yr + kk * 16),
               *reinterpret_cast<const uint32_t*>(yr + kk * 16 + 8));
  }
}

// The accumulators of xyT_tile, rounded to bf16, are already laid out as the
// A fragments of a product over the tile's rows: fragment j covers tile
// columns [16j, 16j + 16).
__device__ __forceinline__ void pack_weights(const float (&w)[kTile / 8][4],
                                             uint32_t (&a)[kTile / 16][4]) {
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
    a[j][0] = pack_bf16(w[2 * j][0], w[2 * j][1]);
    a[j][1] = pack_bf16(w[2 * j][2], w[2 * j][3]);
    a[j][2] = pack_bf16(w[2 * j + 1][0], w[2 * j + 1][1]);
    a[j][3] = pack_bf16(w[2 * j + 1][2], w[2 * j + 1][3]);
  }
}

// o += W @ Y: `wa` from pack_weights, `Y_s` the staged (kTile, ld) tile,
// row-major; its B fragments come transposed out of ldmatrix, two 8-wide
// output tiles per instruction.
template <int DT>
__device__ __forceinline__ void weights_times_tile(
    const uint32_t (&wa)[kTile / 16][4], const bf16* Y_s, int ld, int lane,
    float (&o)[DT][4]) {
  static_assert(DT % 2 == 0, "two 8-wide output tiles per ldmatrix");
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
    const bf16* yr =
        Y_s + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
    for (int u = 0; u < DT; u += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, yr + u * 8);
      mma16816(o[u], wa[j], b[0], b[1]);
      mma16816(o[u + 1], wa[j], b[2], b[3]);
    }
  }
}

// Rows r0 + gq and r0 + gq + 8 of a 16-row accumulator tile to a (n_rows, d)
// bf16 matrix in device memory, each value times mul[half], as 32-bit pairs.
template <int DT>
__device__ __forceinline__ void store_rows(bf16* base, long long ld, int r0,
                                           int n_rows, int d, int gq, int tq,
                                           const float (&o)[DT][4],
                                           const float (&mul)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + gq + 8 * half;
    if (row >= n_rows) continue;
    bf16* dst = base + (long long)row * ld;
#pragma unroll
    for (int u = 0; u < DT; ++u) {
      const int c = u * 8 + 2 * tq;
      if (c < d)
        *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16(
            o[u][2 * half] * mul[half], o[u][2 * half + 1] * mul[half]);
    }
  }
}

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

// True when the 16-byte loads of the tensor-core kernels may read `ptr` with
// these (batch, head, row) strides: the base on a 16-byte boundary, every
// stride a multiple of 8 bf16 elements.
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

inline int flash_ks(int d) { return d <= 32 ? 2 : (d <= 64 ? 4 : 8); }

}  // namespace
