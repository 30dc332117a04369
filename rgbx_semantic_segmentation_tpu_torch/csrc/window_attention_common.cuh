// Helpers shared by the window-attention kernels (window_attention_fwd.cu,
// window_attention_bwd.cu): the geometry of a call, the addressing of a
// window's tokens inside the whole image, asynchronous staging of one head's
// q, k, v (or cotangent) tile and of the bias block into shared memory, the
// tensor-core tiles both kernels compute the same way (logits and
// probabilities of 16 query rows; a bf16 tile in accumulator layout times a
// row-major shared-memory matrix).
#pragma once

#include "attention_common.cuh"
#include "wgmma_common.cuh"  // cp.async

namespace {

constexpr int kWinMaxN = 256;  // ops/window_attention.usable()
constexpr int kWinMaxD = 128;

// One call. qkv is the padded, rolled image (B, Hp, Wp, 3C), channels in
// (3, h, d) order, C = h * d; window w = (w / nWj, w % nWj) owns the ws x ws
// pixels from (ws * (w / nWj), ws * (w % nWj)), token t = (t / ws, t % ws).
// A unit is one (window, head): unit = w * h + head.
struct Window {
  int B, Hp, Wp, h, d, ws, N, nWj, nW;
  long long bias_w;  // elements between two windows' (h, N, N) bias blocks;
                     // 0 when all windows share one block
  float scale;
};

__device__ __forceinline__ long long token_pixel(const Window& g, int b, int w,
                                                 int t) {
  const int wi = w / g.nWj, wj = w - wi * g.nWj;
  const int r = t / g.ws, c = t - r * g.ws;
  return ((long long)b * g.Hp + wi * g.ws + r) * g.Wp + wj * g.ws + c;
}

// The (N, N) fp32 bias block of a unit.
__device__ __forceinline__ const float* bias_block(const float* bias,
                                                   const Window& g, int w,
                                                   int head) {
  return bias + (long long)w * g.bias_w + (long long)head * g.N * g.N;
}

// Reads the seed from device memory (no host sync) into the key.
__device__ __forceinline__ void load_seed(Dropout& dr, const long long* seed) {
  if (dr.on) {
    const unsigned long long s = (unsigned long long)*seed;
    dr.k0 = (uint32_t)s;
    dr.k1 = (uint32_t)(s >> 32);
  }
}

// ---- tensor-core (bf16) helpers -------------------------------------------

// Whether a kernel with NT 8-wide key tiles keeps the unit's bias block in
// shared memory: N rows of kBiasLd<NT> = NT * 8 fp32 columns, -inf past
// column N (at most 56 x 56 x 4 bytes). With rows kBiasLd apart, the eight
// rows and four column pairs a warp reads at once fall in distinct banks.
template <int NT>
constexpr bool kStageBias = NT <= 8;
template <int NT>
constexpr int kBiasLd = NT * 8;
template <int NT>  // shared memory of the staged block (room for N <= NT * 8)
constexpr size_t kBiasBytes =
    kStageBias<NT> ? (size_t)NT * 8 * kBiasLd<NT> * sizeof(float) : 0;

// The pixel, within one image, of every token of window w: pix[t] for t <
// rows, -1 for the padding rows t >= N. Written by the block; the caller
// synchronises before reading it.
__device__ __forceinline__ void window_pixels(int* pix, const Window& g, int w,
                                              int rows) {
  for (int t = threadIdx.x; t < rows; t += blockDim.x)
    pix[t] = t < g.N ? (int)token_pixel(g, 0, w, t) : -1;
}

// Stage d channels of every token of one window into a (rows, ld) bf16
// tile at shared address `dst`, by 16-byte cp.async; rows >= N and channels
// [d, DP) are zero-filled. `src` points at the first channel of the head
// inside pixel 0 of the image; pixels are `pixel_stride` elements apart; d is
// a multiple of 8. The caller commits and waits.
template <int DP>
__device__ __forceinline__ void stage_tile_async(uint32_t dst, int ld,
                                                 const __nv_bfloat16* src,
                                                 long long pixel_stride,
                                                 const int* pix, int d,
                                                 int rows) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int row = i / CH;
    const int ch = i - row * CH;
    const int p = pix[row];
    const bool in = p >= 0 && ch * 8 < d;
    cp_async16(dst + (uint32_t)(row * ld + ch * 8) * 2,
               in ? src + p * pixel_stride + ch * 8 : src, in ? 16 : 0);
  }
}

// The unit's (N, N) fp32 bias block `bb` into shared memory as N rows of
// LDB columns, -inf in columns [N, LDB): 4-byte cp.async (a block starts
// on any 4-byte boundary) and plain stores for the padding. The caller
// commits, waits and synchronises.
template <int LDB>
__device__ __forceinline__ void stage_bias_async(float* Bs, const float* bb,
                                                 int N) {
  for (int i = threadIdx.x; i < N * LDB; i += blockDim.x) {
    const int r = i / LDB;
    const int c = i - r * LDB;
    if (c < N)
      cp_async4(smem_u32(Bs + i), bb + r * N + c, 4);
    else
      Bs[i] = -INFINITY;
  }
}

// Rows [row0, row0 + 16) of a (rows, ld) shared tile to their pixels of one
// image (`dst` at the head's first channel of pixel 0), 16 bytes a thread,
// one warp.
template <int DP>
__device__ __forceinline__ void unstage_rows(__nv_bfloat16* dst,
                                             long long pixel_stride,
                                             const __nv_bfloat16* tile, int ld,
                                             const int* pix, int d, int row0,
                                             int lane) {
  constexpr int CH = DP / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int row = row0 + i / CH;
    const int ch = i % CH;
    const int p = pix[row];
    if (p >= 0 && ch * 8 < d)
      *reinterpret_cast<uint4*>(dst + p * pixel_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + row * ld + ch * 8);
  }
}

// A (16 x DP) accumulator tile, rounded to bf16, into rows [row0, row0 + 16)
// of a shared tile. Thread (gq, tq) holds rows gq, gq + 8, columns 2tq,
// 2tq + 1 of every 8-wide tile.
template <int DT>
__device__ __forceinline__ void store_acc(__nv_bfloat16* tile, int ld, int row0,
                                          int gq, int tq,
                                          const float (&o)[DT][4]) {
#pragma unroll
  for (int u = 0; u < DT; ++u) {
    __nv_bfloat16* p = tile + (row0 + gq) * ld + u * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(o[u][0], o[u][1]);
    *reinterpret_cast<uint32_t*>(p + 8 * ld) = pack_bf16(o[u][2], o[u][3]);
  }
}

// acc[t] = A[rt*16 .. +16, :] @ Bm[t*8 .. +8, :]^T for t < NT: both
// operands row-major (rows, ld) bf16 tiles with the contraction along the
// row (KS * 16 elements).
template <int KS, int NT>
__device__ __forceinline__ void rows_times_rows(const __nv_bfloat16* A,
                                                const __nv_bfloat16* Bm, int ld,
                                                int rt, int gq, int tq,
                                                float (&acc)[NT][4]) {
  uint32_t a[KS][4];
  const __nv_bfloat16* ar = A + (rt * 16 + gq) * ld + 2 * tq;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(ar + kk * 16);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * ld + kk * 16);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(ar + kk * 16 + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * ld + kk * 16 + 8);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    const __nv_bfloat16* br = Bm + (t * 8 + gq) * ld + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma16816(acc[t], a[kk],
               *reinterpret_cast<const uint32_t*>(br + kk * 16),
               *reinterpret_cast<const uint32_t*>(br + kk * 16 + 8));
  }
}

// fp32 probabilities of query rows [rt*16, rt*16 + 16) against all N keys:
// s = softmax((q k^T) * scale + bias), the scale applied to the fp32 logits
// and the fp32 bias added after it. Columns >= N get probability exactly 0;
// rows >= N get finite values the callers drop. With kStageBias<NT>, `bias`
// is the block staged by stage_bias_async (rows >= N read row N - 1, columns
// >= N hold -inf); else the (N, N) block in device memory.
template <int KS, int NT>
__device__ __forceinline__ void probs_tile(const __nv_bfloat16* Qs,
                                           const __nv_bfloat16* Ks, int ld,
                                           const float* bias, const Window& g,
                                           int rt, int gq, int tq,
                                           float (&s)[NT][4]) {
  rows_times_rows<KS, NT>(Qs, Ks, ld, rt, gq, tq, s);
  const int ra = rt * 16 + gq, rb = ra + 8;
  float mx[2] = {-INFINITY, -INFINITY};
  if constexpr (kStageBias<NT>) {
    const float* ba = bias + min(ra, g.N - 1) * kBiasLd<NT> + 2 * tq;
    const float* bbr = bias + min(rb, g.N - 1) * kBiasLd<NT> + 2 * tq;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float2 x = *reinterpret_cast<const float2*>(ba + t * 8);
      const float2 y = *reinterpret_cast<const float2*>(bbr + t * 8);
      s[t][0] = s[t][0] * g.scale + x.x;
      s[t][1] = s[t][1] * g.scale + x.y;
      s[t][2] = s[t][2] * g.scale + y.x;
      s[t][3] = s[t][3] * g.scale + y.y;
      mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
    }
  } else {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb;
        const int col = t * 8 + 2 * tq + (e & 1);
        float l = -INFINITY;
        if (col < g.N)
          l = s[t][e] * g.scale + (row < g.N ? bias[row * g.N + col] : 0.f);
        s[t][e] = l;
        mx[e >> 1] = fmaxf(mx[e >> 1], l);
      }
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = expf(s[t][e] - mx[e >> 1]);
      sum[e >> 1] += s[t][e];
    }
  }
  // One division a row, then products: exp(-100 - max) of a masked key is a
  // denormal, and a division by or of a denormal leaves the fast path.
  const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] *= inv[e >> 1];
  }
}

// o += P @ M for a (16 x NT*8) bf16 tile P held in accumulator layout
// (pk[t][0]: row gq, pk[t][1]: row gq + 8, columns 2tq, 2tq + 1 of tile t)
// and a row-major (rows, ld) shared tile M whose rows [NT*8, 16*ceil(NT/2))
// are zero. The tile's column pairs are already mma A fragments; the B
// fragments of M come transposed out of ldmatrix.
template <int NT, int DT>
__device__ __forceinline__ void acc_tile_times(const uint32_t (&pk)[NT][2],
                                               const __nv_bfloat16* M, int ld,
                                               int lane, float (&o)[DT][4]) {
  static_assert(DT % 2 == 0, "two 8-wide output tiles per ldmatrix");
#pragma unroll
  for (int j = 0; j < (NT + 1) / 2; ++j) {
    uint32_t a[4];
    a[0] = pk[2 * j][0];
    a[1] = pk[2 * j][1];
    if (2 * j + 1 < NT) {
      a[2] = pk[2 * j + 1][0];
      a[3] = pk[2 * j + 1][1];
    } else {
      a[2] = a[3] = 0u;
    }
    const __nv_bfloat16* mr =
        M + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
    for (int u = 0; u < DT; u += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, mr + u * 8);
      mma16816(o[u], a, b[0], b[1]);
      mma16816(o[u + 1], a, b[2], b[3]);
    }
  }
}

// The rounding points of the probabilities after the softmax: p = bf16(pf);
// with dropout pd = keep ? bf16(p / (1 - rate)) : 0.
template <typename T>
__device__ __forceinline__ float dropped_prob(float pf, bool keep,
                                              const Dropout& dr) {
  const float p = round_to<T>(pf);
  if (!dr.on) return p;
  return keep ? round_to<T>(p * dr.inv_keep) : 0.f;
}

// dropped_prob of two neighbouring probabilities, as the bf16 pair an mma
// A fragment takes: p rounded once, scaled, rounded again, and the dropped
// halves cleared in the packed bits.
__device__ __forceinline__ uint32_t dropped_pair(float pf0, float pf1,
                                                 bool keep0, bool keep1,
                                                 const Dropout& dr) {
  const uint32_t p = pack_bf16(pf0, pf1);
  if (!dr.on) return p;
  const uint32_t pd = pack_bf16(__uint_as_float(p << 16) * dr.inv_keep,
                                __uint_as_float(p & 0xFFFF0000u) * dr.inv_keep);
  return pd & ((keep0 ? 0x0000FFFFu : 0u) | (keep1 ? 0xFFFF0000u : 0u));
}

}  // namespace
