// Helpers shared by the window-attention kernels (window_attention_fwd.cu,
// window_attention_bwd.cu): the geometry of a call, the addressing of a
// window's tokens inside the whole image, staging of one head's q, k, v (or
// cotangent) tile into shared memory, and the tensor-core tiles both kernels
// compute the same way (logits and probabilities of 16 query rows; a bf16
// tile in accumulator layout times a row-major shared-memory matrix).
#pragma once

#include "attention_common.cuh"

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

// Whether a kernel with NT 8-wide key tiles keeps the unit's (N, N) fp32
// bias block in shared memory (at most 64 * 64 * 4 bytes).
template <int NT>
constexpr bool kStageBias = NT <= 8;

// Stage d channels of every token of window w, image b, into a (rows, ld)
// bf16 tile, 16 bytes a thread; rows >= N and channels [d, DP) are zero.
// `src` points at the first channel of the head inside pixel 0; pixels are
// `pixel_stride` elements apart. d is a multiple of 8.
template <int DP>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           long long pixel_stride,
                                           const Window& g, int b, int w,
                                           int rows) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int row = i / CH;
    const int ch = i - row * CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < g.N && ch * 8 < g.d)
      x = *reinterpret_cast<const uint4*>(
          src + token_pixel(g, b, w, row) * pixel_stride + ch * 8);
    *reinterpret_cast<uint4*>(dst + row * ld + ch * 8) = x;
  }
}

// Rows [row0, row0 + 16) of a (rows, ld) shared tile to their pixels, 16
// bytes a thread, one warp.
template <int DP>
__device__ __forceinline__ void unstage_rows(__nv_bfloat16* dst,
                                             long long pixel_stride,
                                             const __nv_bfloat16* tile, int ld,
                                             const Window& g, int b, int w,
                                             int row0, int lane) {
  constexpr int CH = DP / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int row = row0 + i / CH;
    const int ch = i % CH;
    if (row < g.N && ch * 8 < g.d)
      *reinterpret_cast<uint4*>(dst + token_pixel(g, b, w, row) * pixel_stride +
                                ch * 8) =
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
// rows >= N (zero q, no bias) get finite values the callers drop.
template <int KS, int NT>
__device__ __forceinline__ void probs_tile(const __nv_bfloat16* Qs,
                                           const __nv_bfloat16* Ks, int ld,
                                           const float* bias, const Window& g,
                                           int rt, int gq, int tq,
                                           float (&s)[NT][4]) {
  rows_times_rows<KS, NT>(Qs, Ks, ld, rt, gq, tq, s);
  const int ra = rt * 16 + gq, rb = ra + 8;
  float mx[2] = {-INFINITY, -INFINITY};
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

}  // namespace
