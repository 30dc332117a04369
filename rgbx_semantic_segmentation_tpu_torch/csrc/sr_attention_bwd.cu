// Short-kv SR-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel rgbx_semantic_segmentation_tpu/ops/sr_attention.py
// `_bwd_kernel` (launched by `_bwd_call`). For every (batch*head) slice, from
// the residual (q, k, v) and the cotangent g of the output:
//
//     pf = softmax(q @ k^T * scale)          fp32, recomputed, never stored
//     p  = pf rounded to the input dtype
//     dv = p^T @ g
//     dp = g @ v^T
//     dl = ((dp - rowsum(dp * pf)) * pf * scale) rounded to the input dtype
//     dq = dl @ k
//     dk = dl^T @ q
//
// with the TPU kernel's rounding points: every product accumulates in fp32;
// the softmax backward uses the UNROUNDED pf, only dv uses the rounded p;
// dl is rounded before the dq and dk products; dq, dk, dv are rounded to the
// input dtype at the end.
//
// What bounds it on the H100: the five products are 10*G*N*M*d operations
// and the device-memory traffic is q, g, dq (G*N*d each) plus k, v, dk, dv.
// At the flagship stage-1 shape (G, N, M, d) = (8, 19200, 300, 64) in bf16
// that is ~30 us of tensor-core time against ~18 us of bytes: operations
// bind at stage 1, bytes at the short stages.
//
// What the design does about it. The TPU kernel walks the N tiles of a slice
// in order and carries fp32 dk/dv accumulators from tile to tile; CUDA blocks
// run in no order, so the work is cut twice, each cut owning its outputs:
//   1. `row` kernels: a block owns a run of q rows. It computes the softmax
//      statistics of each row (max, sum of exp, delta = rowsum(dp * pf)),
//      writes them to a small fp32 workspace (4 floats a row), and computes
//      dq, which needs nothing from other rows.
//   2. `kv` kernels: a block owns a run of kv rows of a slice and a share of
//      its q rows (a "split"). From q, g and the row statistics it
//      recomputes p^T and dl^T for its kv rows and accumulates dv and dk in
//      fp32 registers over its q rows, then writes one fp32 partial per
//      split to a workspace.
//   3. `reduce` kernel: sums the partials of the splits in a fixed order and
//      writes dk and dv in the input dtype. No atomics: the result is the
//      same from run to run.
// The (N, M) tensors pf, dp and dl never reach device memory; they are
// recomputed on chip (q @ k^T three times and g @ v^T twice in the row
// kernel, each once more in the kv kernel), which is cheap on tensor cores
// beside what storing them would move. delta is computed as
// rowsum(dp * e) / rowsum(e) with e = exp(logit - max), which is
// rowsum(dp * pf) up to fp32 rounding.
//
// bf16 where k, v and k^T of a slice fit in shared memory (all flagship
// shapes): tensor cores (mma.sync m16n8k16, fp32 accumulation), logits and dp
// in registers. fp32, and bf16 with a large M*d: scalar fp32 FMAs, one warp a
// q row (row kernel) or a kv row (kv kernel), k and v read through L1/L2.
//
// Ragged edges: kv columns >= M carry probability exactly 0 and kv is read
// unpadded; q rows past the end of a run are staged as zeros (q = g = 0), so
// they add exactly 0 to dk and dv.
//
// Layouts: q, k, v, g are read and dq, dk, dv written through (batch, head,
// row) element strides, head dim unit-stride, so the model's head-split
// views go in and the gradients land in the layouts of the q and kv
// projections without a copy.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the entry returns cudaGetLastError() after the launches. The
// caller allocates the workspaces (`sr_attention_bwd_splits` says how many
// splits the kv kernel will use for a shape; `max_splits` > 0 caps them).

#include "attention_common.cuh"

namespace {

constexpr int kStatsPerRow = 4;  // max, sum of exp, delta, unused (alignment)

struct BwdLayouts {
  Layout q, k, v, g, dq, dk, dv;
};

// One call: operands, layouts, sizes (G = B * H slices) and the split plan.
struct Problem {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* stats;     // (G, N, kStatsPerRow) fp32
  float* partials;  // (2, G, splits, M, d) fp32: dk partials, then dv
  BwdLayouts l;
  int G, H, N, M, d;
  int splits;          // shares of a slice's q rows in the kv kernel
  int rows_per_split;  // q rows of one share
  float scale;
};

__device__ __forceinline__ float* partial_ptr(const Problem& p, int which,
                                              int g, int split) {
  return p.partials +
         (((size_t)which * p.G + g) * p.splits + split) * (size_t)p.M * p.d;
}

// ---------------------------------------------------------------------------
// Scalar path (fp32, and bf16 that does not fit the tensor-core kernels).
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 4;   // row kernel: one q row per warp at a time
constexpr int kKvWarps = 8;    // kv kernel: one kv row per warp
constexpr int kDimTiles = kMaxD / 32;

// Row kernel. Shared memory per warp: logits/e (mpad), dp/dl (mpad), q (d),
// g (d), all fp32.
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
    sr_attention_bwd_row_kernel(const Problem p, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mpad = (p.M + 3) & ~3;
  float* s_row = reinterpret_cast<float*>(smem) + warp * (2 * mpad + 2 * p.d);
  float* dp_row = s_row + mpad;
  float* q_row = dp_row + mpad;
  float* g_row = q_row + p.d;

  const int g = blockIdx.y;
  const T* qg = slice(static_cast<const T*>(p.q), p.l.q, g, p.H);
  const T* kg = slice(static_cast<const T*>(p.k), p.l.k, g, p.H);
  const T* vg = slice(static_cast<const T*>(p.v), p.l.v, g, p.H);
  const T* gg = slice(static_cast<const T*>(p.g), p.l.g, g, p.H);
  T* dqg = slice(static_cast<T*>(p.dq), p.l.dq, g, p.H);
  const int row_begin = blockIdx.x * rows_per_cta;
  const int row_end = min(row_begin + rows_per_cta, p.N);

  for (int r = row_begin + warp; r < row_end; r += kRowWarps) {
    __syncwarp();
    for (int e = lane; e < p.d; e += 32) {
      q_row[e] = to_float(qg[r * p.l.q.row + e]);
      g_row[e] = to_float(gg[r * p.l.g.row + e]);
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < p.M; j += 32) {
      const T* kr = kg + j * p.l.k.row;
      const T* vr = vg + j * p.l.v.row;
      float s = 0.f, dp = 0.f;
      for (int e = 0; e < p.d; ++e) {
        s = fmaf(q_row[e], to_float(kr[e]), s);
        dp = fmaf(g_row[e], to_float(vr[e]), dp);
      }
      s *= p.scale;
      s_row[j] = s;
      dp_row[j] = dp;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < p.M; j += 32) {
      const float ex = expf(s_row[j] - mx);
      s_row[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < p.M; j += 32) {
      const float pf = s_row[j] / sum;
      s_row[j] = pf;
      delta = fmaf(dp_row[j], pf, delta);
    }
    delta = warp_sum(delta);
    for (int j = lane; j < p.M; j += 32)
      dp_row[j] = round_to<T>((dp_row[j] - delta) * s_row[j] * p.scale);
    __syncwarp();
    // dq = dl @ k: lane owns dims lane + 32u.
    float acc[kDimTiles];
#pragma unroll
    for (int u = 0; u < kDimTiles; ++u) acc[u] = 0.f;
    for (int j = 0; j < p.M; ++j) {
      const float dl = dp_row[j];
      const T* kr = kg + j * p.l.k.row;
#pragma unroll
      for (int u = 0; u < kDimTiles; ++u) {
        const int e = lane + 32 * u;
        if (e < p.d) acc[u] = fmaf(dl, to_float(kr[e]), acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDimTiles; ++u) {
      const int e = lane + 32 * u;
      if (e < p.d) dqg[r * p.l.dq.row + e] = from_float<T>(acc[u]);
    }
    if (lane == 0) {
      float* st = p.stats + ((size_t)g * p.N + r) * kStatsPerRow;
      st[0] = mx;
      st[1] = sum;
      st[2] = delta;
    }
  }
}

// kv kernel. grid = (ceil(M / kKvWarps), splits, G); warp owns one kv row.
template <typename T>
__global__ void __launch_bounds__(kKvWarps * 32)
    sr_attention_bwd_kv_kernel(const Problem p) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kKvWarps + warp;
  if (m >= p.M) return;  // no block-wide barrier below
  const int split = blockIdx.y;
  const int g = blockIdx.z;
  const T* qg = slice(static_cast<const T*>(p.q), p.l.q, g, p.H);
  const T* kg = slice(static_cast<const T*>(p.k), p.l.k, g, p.H);
  const T* vg = slice(static_cast<const T*>(p.v), p.l.v, g, p.H);
  const T* gg = slice(static_cast<const T*>(p.g), p.l.g, g, p.H);
  const float* stats = p.stats + (size_t)g * p.N * kStatsPerRow;

  float kr[kDimTiles], vr[kDimTiles], dk[kDimTiles], dv[kDimTiles];
#pragma unroll
  for (int u = 0; u < kDimTiles; ++u) {
    const int e = lane + 32 * u;
    kr[u] = e < p.d ? to_float(kg[m * p.l.k.row + e]) : 0.f;
    vr[u] = e < p.d ? to_float(vg[m * p.l.v.row + e]) : 0.f;
    dk[u] = dv[u] = 0.f;
  }
  const int n_begin = split * p.rows_per_split;
  const int n_end = min(n_begin + p.rows_per_split, p.N);
  for (int n = n_begin; n < n_end; ++n) {
    float qv[kDimTiles], gv[kDimTiles];
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int u = 0; u < kDimTiles; ++u) {
      const int e = lane + 32 * u;
      qv[u] = e < p.d ? to_float(qg[n * p.l.q.row + e]) : 0.f;
      gv[u] = e < p.d ? to_float(gg[n * p.l.g.row + e]) : 0.f;
      s = fmaf(qv[u], kr[u], s);
      dp = fmaf(gv[u], vr[u], dp);
    }
    s = warp_sum(s) * p.scale;
    dp = warp_sum(dp);
    const float* st = stats + (size_t)n * kStatsPerRow;
    const float pf = expf(s - st[0]) / st[1];
    const float pr = round_to<T>(pf);
    const float dl = round_to<T>((dp - st[2]) * pf * p.scale);
#pragma unroll
    for (int u = 0; u < kDimTiles; ++u) {
      dv[u] = fmaf(pr, gv[u], dv[u]);
      dk[u] = fmaf(dl, qv[u], dk[u]);
    }
  }
  float* dk_out = partial_ptr(p, 0, g, split) + (size_t)m * p.d;
  float* dv_out = partial_ptr(p, 1, g, split) + (size_t)m * p.d;
#pragma unroll
  for (int u = 0; u < kDimTiles; ++u) {
    const int e = lane + 32 * u;
    if (e < p.d) {
      dk_out[e] = dk[u];
      dv_out[e] = dv[u];
    }
  }
}

// Sum of the splits' partials in split order; dk and dv in the input dtype.
template <typename T>
__global__ void sr_attention_bwd_reduce_kernel(const Problem p) {
  const long long total = (long long)p.G * p.M * p.d;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int e = (int)(i % p.d);
  const int m = (int)((i / p.d) % p.M);
  const int g = (int)(i / ((long long)p.d * p.M));
  float dk = 0.f, dv = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    dk += partial_ptr(p, 0, g, s)[(size_t)m * p.d + e];
    dv += partial_ptr(p, 1, g, s)[(size_t)m * p.d + e];
  }
  slice(static_cast<T*>(p.dk), p.l.dk, g, p.H)[m * p.l.dk.row + e] =
      from_float<T>(dk);
  slice(static_cast<T*>(p.dv), p.l.dv, g, p.H)[m * p.l.dv.row + e] =
      from_float<T>(dv);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, bf16 inputs, fp32 accumulation.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaRows = kMmaWarps * 16;  // q rows of one pass of the warps
constexpr int kKvMmaWarps = 4;
constexpr int kKvChunk = kKvMmaWarps * 16;  // kv rows owned by a block
constexpr int kQTile = 64;                  // q rows staged at a time

struct MmaGeometry {
  int mp;    // M rounded up to 16 (zero rows in k, v and k^T)
  int ldk;   // k and v row stride: padded head dim + 8 (conflict-free)
  int ldkt;  // k^T row stride: mp + 8
};

// A 16 x 16 tile of x @ y^T as two 16x8 accumulators: `xa` are the A
// fragments of the warp's 16 rows of x, `Y_s` holds y row-major (row stride
// ld), the tile covers rows [16j, 16j + 16) of y. Thread (gq, tq) holds rows
// gq and gq + 8 of x, columns 2tq and 2tq + 1 of each half.
template <int KS>
__device__ __forceinline__ void xyT_tile(const uint32_t (&xa)[KS][4],
                                         const __nv_bfloat16* Y_s, int ld,
                                         int j, int gq, int tq,
                                         float (&s)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
    const __nv_bfloat16* yr = Y_s + (j * 16 + h * 8 + gq) * ld + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(yr + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(yr + kk * 16 + 8);
      mma16816(s[h], xa[kk], b0, b1);
    }
  }
}

// Logits * scale of a tile; kv columns >= M are -inf (probability 0).
template <int KS>
__device__ __forceinline__ void logits_tile(const uint32_t (&qa)[KS][4],
                                            const __nv_bfloat16* K_s, int ld,
                                            int M, float scale, int j, int gq,
                                            int tq, float (&s)[2][4]) {
  xyT_tile<KS>(qa, K_s, ld, j, gq, tq, s);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = j * 16 + h * 8 + 2 * tq;
    s[h][0] = c < M ? s[h][0] * scale : -INFINITY;
    s[h][1] = c + 1 < M ? s[h][1] * scale : -INFINITY;
    s[h][2] = c < M ? s[h][2] * scale : -INFINITY;
    s[h][3] = c + 1 < M ? s[h][3] * scale : -INFINITY;
  }
}

// A fragments of rows [r0, r0 + 16) of a (n_rows, d) bf16 matrix in device
// memory (row stride ld); zero outside.
template <int KS>
__device__ __forceinline__ void load_a_fragments(uint32_t (&a)[KS][4],
                                                 const __nv_bfloat16* base,
                                                 long long ld, int r0,
                                                 int n_rows, int d, int gq,
                                                 int tq) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * tq;
    a[kk][0] = load_pair(base, ld, r0 + gq, c, n_rows, d);
    a[kk][1] = load_pair(base, ld, r0 + gq + 8, c, n_rows, d);
    a[kk][2] = load_pair(base, ld, r0 + gq, c + 8, n_rows, d);
    a[kk][3] = load_pair(base, ld, r0 + gq + 8, c + 8, n_rows, d);
  }
}

// Row kernel: statistics and dq. k, v row-major and k^T in shared memory;
// each warp owns 16 q rows at a time with its q and g fragments in
// registers. Pass 1: row max. Pass 2: sum of e and sum of dp * e. Pass 3:
// dl in bf16, laid out as the A fragment of dl @ k.
template <int KS>
__global__ void __launch_bounds__(kMmaWarps * 32)
    sr_attention_bwd_row_mma_kernel(const Problem p, const MmaGeometry geo,
                                    int rows_per_cta) {
  constexpr int DP = KS * 16;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* K_s = reinterpret_cast<__nv_bfloat16*>(smem);  // (mp, ldk)
  __nv_bfloat16* V_s = K_s + geo.mp * geo.ldk;                  // (mp, ldk)
  __nv_bfloat16* Kt_s = V_s + geo.mp * geo.ldk;                 // (DP, ldkt)

  using bf16 = __nv_bfloat16;
  const int g = blockIdx.y;
  const bf16* qg = slice(static_cast<const bf16*>(p.q), p.l.q, g, p.H);
  const bf16* kg = slice(static_cast<const bf16*>(p.k), p.l.k, g, p.H);
  const bf16* vg = slice(static_cast<const bf16*>(p.v), p.l.v, g, p.H);
  const bf16* gg = slice(static_cast<const bf16*>(p.g), p.l.g, g, p.H);
  bf16* dqg = slice(static_cast<bf16*>(p.dq), p.l.dq, g, p.H);

  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < geo.mp * DP; i += blockDim.x) {
    const int m = i / DP;
    const int e = i - m * DP;
    const bool in = m < p.M && e < p.d;
    const bf16 kx = in ? kg[m * p.l.k.row + e] : zero;
    K_s[m * geo.ldk + e] = kx;
    Kt_s[e * geo.ldkt + m] = kx;
    V_s[m * geo.ldk + e] = in ? vg[m * p.l.v.row + e] : zero;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int ktiles = geo.mp / 16;
  const int row_begin = blockIdx.x * rows_per_cta;
  const int row_end = min(row_begin + rows_per_cta, p.N);

  for (int r0 = row_begin + warp * 16; r0 < row_end; r0 += kMmaRows) {
    uint32_t qa[KS][4], ga[KS][4];
    load_a_fragments<KS>(qa, qg, p.l.q.row, r0, row_end, p.d, gq, tq);
    load_a_fragments<KS>(ga, gg, p.l.g.row, r0, row_end, p.d, gq, tq);

    float mx[2] = {-INFINITY, -INFINITY};
    for (int j = 0; j < ktiles; ++j) {
      float s[2][4];
      logits_tile<KS>(qa, K_s, geo.ldk, p.M, p.scale, j, gq, tq, s);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[0] = fmaxf(mx[0], fmaxf(s[h][0], s[h][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[h][2], s[h][3]));
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);

    float sum[2] = {0.f, 0.f};
    float dsum[2] = {0.f, 0.f};  // rowsum(dp * e)
    for (int j = 0; j < ktiles; ++j) {
      float s[2][4], dp[2][4];
      logits_tile<KS>(qa, K_s, geo.ldk, p.M, p.scale, j, gq, tq, s);
      xyT_tile<KS>(ga, V_s, geo.ldk, j, gq, tq, dp);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float e0 = expf(s[h][0] - mx[0]), e1 = expf(s[h][1] - mx[0]);
        const float e2 = expf(s[h][2] - mx[1]), e3 = expf(s[h][3] - mx[1]);
        sum[0] += e0 + e1;
        sum[1] += e2 + e3;
        dsum[0] = fmaf(dp[h][0], e0, fmaf(dp[h][1], e1, dsum[0]));
        dsum[1] = fmaf(dp[h][2], e2, fmaf(dp[h][3], e3, dsum[1]));
      }
    }
    float delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = quad_sum(sum[i]);
      delta[i] = quad_sum(dsum[i]) / sum[i];
    }

    float o[DT][4];
#pragma unroll
    for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    for (int j = 0; j < ktiles; ++j) {
      float s[2][4], dp[2][4];
      logits_tile<KS>(qa, K_s, geo.ldk, p.M, p.scale, j, gq, tq, s);
      xyT_tile<KS>(ga, V_s, geo.ldk, j, gq, tq, dp);
      uint32_t la[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float l0 = (dp[h][0] - delta[0]) *
                         (expf(s[h][0] - mx[0]) / sum[0]) * p.scale;
        const float l1 = (dp[h][1] - delta[0]) *
                         (expf(s[h][1] - mx[0]) / sum[0]) * p.scale;
        const float l2 = (dp[h][2] - delta[1]) *
                         (expf(s[h][2] - mx[1]) / sum[1]) * p.scale;
        const float l3 = (dp[h][3] - delta[1]) *
                         (expf(s[h][3] - mx[1]) / sum[1]) * p.scale;
        la[2 * h] = pack_bf16(l0, l1);
        la[2 * h + 1] = pack_bf16(l2, l3);
      }
      const bf16* kr = Kt_s + gq * geo.ldkt + j * 16 + 2 * tq;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const bf16* kt = kr + t * 8 * geo.ldkt;
        mma16816(o[t], la, *reinterpret_cast<const uint32_t*>(kt),
                 *reinterpret_cast<const uint32_t*>(kt + 8));
      }
    }

    const int ra = r0 + gq;
    const int rb = ra + 8;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int c = t * 8 + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? rb : ra;
        if (row < row_end) {
          bf16* dst = dqg + row * p.l.dq.row;
          if (c < p.d) dst[c] = __float2bfloat16_rn(o[t][2 * half]);
          if (c + 1 < p.d) dst[c + 1] = __float2bfloat16_rn(o[t][2 * half + 1]);
        }
      }
    }
    if (tq == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? rb : ra;
        if (row < row_end) {
          float* st = p.stats + ((size_t)g * p.N + row) * kStatsPerRow;
          st[0] = mx[half];
          st[1] = sum[half];
          st[2] = delta[half];
        }
      }
    }
  }
}

// kv kernel: grid = (ceil(M / kKvChunk), splits, G). Each warp owns 16 kv
// rows with their k and v fragments in registers and walks the split's q
// rows in tiles of kQTile staged in shared memory (q and g row-major for
// the transposed logits and dp, q^T and g^T for the dk and dv products).
template <int KS>
__global__ void __launch_bounds__(kKvMmaWarps * 32)
    sr_attention_bwd_kv_mma_kernel(const Problem p) {
  constexpr int DP = KS * 16;
  constexpr int DT = DP / 8;
  constexpr int LD = DP + 8;       // row stride of Q_s, G_s
  constexpr int LDT = kQTile + 8;  // row stride of Qt_s, Gt_s
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];  // kv_mma_smem(KS)
  float* st_s = reinterpret_cast<float*>(smem);  // (kQTile, kStatsPerRow)
  bf16* Q_s = reinterpret_cast<bf16*>(st_s + kQTile * kStatsPerRow);
  bf16* G_s = Q_s + kQTile * LD;
  bf16* Qt_s = G_s + kQTile * LD;
  bf16* Gt_s = Qt_s + DP * LDT;

  const int split = blockIdx.y;
  const int g = blockIdx.z;
  const bf16* qg = slice(static_cast<const bf16*>(p.q), p.l.q, g, p.H);
  const bf16* kg = slice(static_cast<const bf16*>(p.k), p.l.k, g, p.H);
  const bf16* vg = slice(static_cast<const bf16*>(p.v), p.l.v, g, p.H);
  const bf16* gg = slice(static_cast<const bf16*>(p.g), p.l.g, g, p.H);
  const float* stats = p.stats + (size_t)g * p.N * kStatsPerRow;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int m0 = blockIdx.x * kKvChunk + warp * 16;  // this warp's kv rows

  uint32_t ka[KS][4], va[KS][4];
  load_a_fragments<KS>(ka, kg, p.l.k.row, m0, p.M, p.d, gq, tq);
  load_a_fragments<KS>(va, vg, p.l.v.row, m0, p.M, p.d, gq, tq);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[t][i] = dv[t][i] = 0.f;

  const bf16 zero = __float2bfloat16(0.f);
  const int n_begin = split * p.rows_per_split;
  const int n_end = min(n_begin + p.rows_per_split, p.N);
  for (int n0 = n_begin; n0 < n_end; n0 += kQTile) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kQTile * DP; i += blockDim.x) {
      const int r = i / DP;
      const int e = i - r * DP;
      const bool in = n0 + r < n_end && e < p.d;
      const bf16 qx = in ? qg[(n0 + r) * p.l.q.row + e] : zero;
      const bf16 gx = in ? gg[(n0 + r) * p.l.g.row + e] : zero;
      Q_s[r * LD + e] = qx;
      G_s[r * LD + e] = gx;
      Qt_s[e * LDT + r] = qx;
      Gt_s[e * LDT + r] = gx;
    }
    for (int i = threadIdx.x; i < kQTile; i += blockDim.x) {
      // Rows past the end: q = g = 0, and statistics that keep p finite.
      const bool in = n0 + i < n_end;
      const float* st = stats + (size_t)(n0 + i) * kStatsPerRow;
      st_s[i * kStatsPerRow + 0] = in ? st[0] : 0.f;
      st_s[i * kStatsPerRow + 1] = in ? st[1] : 1.f;
      st_s[i * kStatsPerRow + 2] = in ? st[2] : 0.f;
    }
    __syncthreads();
    if (m0 >= p.M) continue;  // a warp past the kv edge only helps staging

#pragma unroll 1
    for (int j = 0; j < kQTile / 16; ++j) {
      // Transposed tiles: rows = this warp's kv rows, columns = q rows
      // [16j, 16j + 16) of the staged tile.
      float s[2][4], dp[2][4];
      xyT_tile<KS>(ka, Q_s, LD, j, gq, tq, s);
      xyT_tile<KS>(va, G_s, LD, j, gq, tq, dp);
      uint32_t pa[4], la[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* s0 = st_s + (j * 16 + h * 8 + 2 * tq) * kStatsPerRow;
        const float* s1 = s0 + kStatsPerRow;
        const float p0 = expf(s[h][0] * p.scale - s0[0]) / s0[1];
        const float p1 = expf(s[h][1] * p.scale - s1[0]) / s1[1];
        const float p2 = expf(s[h][2] * p.scale - s0[0]) / s0[1];
        const float p3 = expf(s[h][3] * p.scale - s1[0]) / s1[1];
        pa[2 * h] = pack_bf16(p0, p1);
        pa[2 * h + 1] = pack_bf16(p2, p3);
        la[2 * h] = pack_bf16((dp[h][0] - s0[2]) * p0 * p.scale,
                              (dp[h][1] - s1[2]) * p1 * p.scale);
        la[2 * h + 1] = pack_bf16((dp[h][2] - s0[2]) * p2 * p.scale,
                                  (dp[h][3] - s1[2]) * p3 * p.scale);
      }
      const bf16* gr = Gt_s + gq * LDT + j * 16 + 2 * tq;
      const bf16* qr = Qt_s + gq * LDT + j * 16 + 2 * tq;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const bf16* gt = gr + t * 8 * LDT;
        const bf16* qt = qr + t * 8 * LDT;
        mma16816(dv[t], pa, *reinterpret_cast<const uint32_t*>(gt),
                 *reinterpret_cast<const uint32_t*>(gt + 8));
        mma16816(dk[t], la, *reinterpret_cast<const uint32_t*>(qt),
                 *reinterpret_cast<const uint32_t*>(qt + 8));
      }
    }
  }

  float* dk_out = partial_ptr(p, 0, g, split);
  float* dv_out = partial_ptr(p, 1, g, split);
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int c = t * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + gq + 8 * half;
      if (m < p.M) {
        const size_t at = (size_t)m * p.d + c;
        if (c < p.d) {
          dk_out[at] = dk[t][2 * half];
          dv_out[at] = dv[t][2 * half];
        }
        if (c + 1 < p.d) {
          dk_out[at + 1] = dk[t][2 * half + 1];
          dv_out[at + 1] = dv[t][2 * half + 1];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum KernelId {
  kRowMma2, kRowMma4, kRowMma8, kKvMma2, kKvMma4, kKvMma8, kNumKernels
};
std::atomic<bool> g_opted_in[kMaxDevices][kNumKernels];

int ceil_div(int a, int b) { return (a + b - 1) / b; }

MmaGeometry mma_geometry(int M, int ks) {
  MmaGeometry geo;
  geo.mp = (M + 15) & ~15;
  geo.ldk = ks * 16 + 8;
  geo.ldkt = geo.mp + 8;
  return geo;
}

int mma_ks(int d) { return d <= 32 ? 2 : (d <= 64 ? 4 : 8); }

size_t row_mma_smem(int M, int d) {
  const int ks = mma_ks(d);
  const MmaGeometry geo = mma_geometry(M, ks);
  return ((size_t)2 * geo.mp * geo.ldk + (size_t)ks * 16 * geo.ldkt) *
         sizeof(__nv_bfloat16);
}

// Shared memory of the kv tensor-core kernel: the statistics of a q tile,
// then q, g row-major and q^T, g^T.
size_t kv_mma_smem(int ks) {
  const int dp = ks * 16;
  return (size_t)kQTile * kStatsPerRow * sizeof(float) +
         ((size_t)2 * kQTile * (dp + 8) + (size_t)2 * dp * (kQTile + 8)) *
             sizeof(__nv_bfloat16);
}

// bf16 runs on the tensor cores when k, v and k^T of a slice fit in shared
// memory.
bool use_mma(const DeviceState* st, int M, int d, int dtype) {
  return dtype == 1 && row_mma_smem(M, d) <= (size_t)st->smem_optin;
}

// The kv kernel's split plan: enough blocks for ~4 (tensor cores) or ~8
// (scalar) per SM, each split at least one tile of q rows, at most
// `max_splits` of them when that is positive (1: a block owns its kv rows
// over the whole of N).
void plan_splits(const DeviceState* st, int G, int N, int M, int d, int dtype,
                 int max_splits, int* splits, int* rows_per_split) {
  const bool mma = use_mma(st, M, d, dtype);
  const int chunks = ceil_div(M, mma ? kKvChunk : kKvWarps);
  const int tile = mma ? kQTile : 32;
  const long long want = (long long)(mma ? 4 : 8) * st->sms;
  long long s = (want + (long long)G * chunks - 1) / ((long long)G * chunks);
  int max_s = ceil_div(N, tile);
  if (max_splits > 0 && max_splits < max_s) max_s = max_splits;
  if (s > max_s) s = max_s;
  if (s < 1) s = 1;
  *rows_per_split = ceil_div(ceil_div(N, (int)s), tile) * tile;
  *splits = ceil_div(N, *rows_per_split);
}

// Blocks of the row kernels: ~4 per SM across the G slices, at most 8
// passes of the warps each.
int rows_per_cta(const DeviceState* st, int G, int N, int rows_per_pass) {
  const int groups = ceil_div(N, rows_per_pass);
  const int per_slice = ceil_div(4 * st->sms, G);
  int gpc = ceil_div(groups, per_slice);
  gpc = gpc < 1 ? 1 : (gpc > 8 ? 8 : gpc);
  return gpc * rows_per_pass;
}

template <int KS>
int launch_mma_ks(const Problem& pr, const DeviceState* st,
                  cudaStream_t stream) {
  constexpr KernelId row_id =
      KS == 2 ? kRowMma2 : (KS == 4 ? kRowMma4 : kRowMma8);
  constexpr KernelId kv_id = KS == 2 ? kKvMma2 : (KS == 4 ? kKvMma4 : kKvMma8);
  std::atomic<bool>* opted = g_opted_in[device_index(st)];
  int rc = opt_in_smem(st, &opted[row_id], sr_attention_bwd_row_mma_kernel<KS>);
  if (rc == 0)
    rc = opt_in_smem(st, &opted[kv_id], sr_attention_bwd_kv_mma_kernel<KS>);
  if (rc != 0) return rc;
  const MmaGeometry geo = mma_geometry(pr.M, KS);
  const int rpc = rows_per_cta(st, pr.G, pr.N, kMmaRows);
  const dim3 row_grid(ceil_div(pr.N, rpc), pr.G);
  sr_attention_bwd_row_mma_kernel<KS>
      <<<row_grid, kMmaWarps * 32, row_mma_smem(pr.M, pr.d), stream>>>(
          pr, geo, rpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid(ceil_div(pr.M, kKvChunk), pr.splits, pr.G);
  sr_attention_bwd_kv_mma_kernel<KS>
      <<<kv_grid, kKvMmaWarps * 32, kv_mma_smem(KS), stream>>>(pr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scalar(const Problem& pr, const DeviceState* st,
                  cudaStream_t stream) {
  const int mpad = (pr.M + 3) & ~3;
  const size_t smem =
      (size_t)kRowWarps * (2 * mpad + 2 * pr.d) * sizeof(float);
  const int rpc = rows_per_cta(st, pr.G, pr.N, 8 * kRowWarps);
  const dim3 row_grid(ceil_div(pr.N, rpc), pr.G);
  sr_attention_bwd_row_kernel<T>
      <<<row_grid, kRowWarps * 32, smem, stream>>>(pr, rpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid(ceil_div(pr.M, kKvWarps), pr.splits, pr.G);
  sr_attention_bwd_kv_kernel<T><<<kv_grid, kKvWarps * 32, 0, stream>>>(pr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const Problem& pr, cudaStream_t stream) {
  const long long total = (long long)pr.G * pr.M * pr.d;
  const int threads = 256;
  sr_attention_bwd_reduce_kernel<T>
      <<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(pr);
  return (int)cudaGetLastError();
}

bool valid_sizes(int B, int H, int N, int M, int d, int dtype) {
  return B > 0 && H > 0 && (long long)B * H <= 65535 && N > 0 && M > 0 &&
         M <= kMaxM && d > 0 && d <= kMaxD && (dtype == 0 || dtype == 1);
}

}  // namespace

// Number of splits of a slice's q rows that `sr_attention_bwd` uses on the
// current device for these sizes and this cap (0: none); the `partials`
// workspace holds 2 * B * H * splits * M * d floats. Negative:
// -(cudaError_t code).
extern "C" int sr_attention_bwd_splits(int B, int H, int N, int M, int d,
                                       int dtype, int max_splits) {
  if (!valid_sizes(B, H, N, M, d, dtype)) return -(int)cudaErrorInvalidValue;
  DeviceState* st = nullptr;
  const int rc = current_device(&st);
  if (rc != 0) return -rc;
  int splits = 0, rows = 0;
  plan_splits(st, B * H, N, M, d, dtype, max_splits, &splits, &rows);
  return splits;
}

// dtype: 0 = float32, 1 = bfloat16. q/g/dq: (B, H, N, d); k/v/dk/dv:
// (B, H, M, d), on the current device, each with unit stride along d.
// `strides` holds 21 element strides: (batch, head, row) of q, k, v, g, dq,
// dk, dv, in that order. `stats`: B*H*N*4 floats; `partials`: see
// sr_attention_bwd_splits, called with the same `max_splits`. Returns a
// cudaError_t code (0 = launched).
extern "C" int sr_attention_bwd(const void* q, const void* k, const void* v,
                                const void* g, void* dq, void* dk, void* dv,
                                void* stats, void* partials, int B, int H,
                                int N, int M, int d, const long long* strides,
                                float scale, int dtype, int max_splits,
                                void* stream) {
  if (!valid_sizes(B, H, N, M, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear an earlier non-sticky error: report our own
  DeviceState* st = nullptr;
  int rc = current_device(&st);
  if (rc != 0) return rc;
  Problem pr;
  pr.q = q;
  pr.k = k;
  pr.v = v;
  pr.g = g;
  pr.dq = dq;
  pr.dk = dk;
  pr.dv = dv;
  pr.stats = static_cast<float*>(stats);
  pr.partials = static_cast<float*>(partials);
  Layout* layouts[7] = {&pr.l.q,  &pr.l.k,  &pr.l.v, &pr.l.g,
                        &pr.l.dq, &pr.l.dk, &pr.l.dv};
  for (int i = 0; i < 7; ++i)
    *layouts[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  pr.G = B * H;
  pr.H = H;
  pr.N = N;
  pr.M = M;
  pr.d = d;
  pr.scale = scale;
  plan_splits(st, pr.G, N, M, d, dtype, max_splits, &pr.splits,
              &pr.rows_per_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma(st, M, d, dtype)) {
    const int ks = mma_ks(d);
    rc = ks == 2 ? launch_mma_ks<2>(pr, st, s)
                 : (ks == 4 ? launch_mma_ks<4>(pr, st, s)
                            : launch_mma_ks<8>(pr, st, s));
    if (rc != 0) return rc;
    return launch_reduce<__nv_bfloat16>(pr, s);
  }
  rc = dtype == 0 ? launch_scalar<float>(pr, st, s)
                  : launch_scalar<__nv_bfloat16>(pr, st, s);
  if (rc != 0) return rc;
  return dtype == 0 ? launch_reduce<float>(pr, s)
                    : launch_reduce<__nv_bfloat16>(pr, s);
}

extern "C" const char* sr_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
