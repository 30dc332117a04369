// Short-kv SR-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel rgbx_semantic_segmentation_tpu/ops/sr_attention.py
// `_bwd_kernel` (launched by `_bwd_call`). For every (batch*head) slice, from
// the residual and the cotangent g of the output:
//
//     pf = softmax(q @ k^T * scale)          fp32, recomputed, never stored
//     p  = pf rounded to the input dtype
//     dv = p^T @ g
//     dp = g @ v^T
//     dl = ((dp - delta) * pf * scale) rounded to the input dtype
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
// Two routes; the wrapper picks one.
//
// Tensor cores (bf16, d % 8 == 0, 16-byte-aligned rows: every layout of the
// model). The residual is the forward's (q, k, v, lse2): lse2, each q row's
// fp32 logsumexp in base 2 of the scaled logits, gives
// pf = 2^(s * scale * log2 e - lse2) without recomputing the row's max and
// sum (with M = 1 it is exactly 1, as the plain version's). Two launches,
// no workspace beyond delta (4 bytes a q row):
//   1. `sr_bwd_dq`: a warpgroup owns 64 q rows; k and v stream past in
//      64-row tiles, twice: pass 1 sums delta = rowsum(dp * pf), pass 2
//      forms dl in registers as the A operand of dl k. It writes delta for
//      the second launch. 5 products (q k^T and g v^T twice, dl k).
//   2. `sr_bwd_dkv`: a warpgroup owns 64 kv rows and a share of the q tiles;
//      per q tile k q^T and v g^T, then p^T and dl^T in registers as the A
//      operands of p^T g and dl^T q. 4 products. The shares of one kv tile
//      form a thread-block cluster and sum their fp32 dk, dv partials
//      through distributed shared memory in a fixed order, so the result is
//      the same from run to run without atomics or a partial workspace.
// 9 products in all (the mma.sync design before it took 10 and 3
// launches). Every operand is staged with 16-byte cp.async into the
// 128-byte-swizzled layout wgmma reads (wgmma_common.cuh), double-buffered
// under the products; one staged tile is both the K-major operand of one
// product and the MN-major B of another.
//
// Scalar (fp32, and bf16 views the tensor-core route does not take): the
// residual is (q, k, v) and the work is cut twice, each cut owning its
// outputs:
//   1. `row` kernel: a block owns a run of q rows. It computes the softmax
//      statistics of each row (max, sum of exp, delta = rowsum(dp * pf)),
//      writes them to a small fp32 workspace (4 floats a row), and computes
//      dq, which needs nothing from other rows.
//   2. `kv` kernel: a block owns a run of kv rows of a slice and a share of
//      its q rows (a "split"). From q, g and the row statistics it
//      recomputes p^T and dl^T for its kv rows and accumulates dv and dk in
//      fp32 registers over its q rows, then writes one fp32 partial per
//      split to a workspace.
//   3. `reduce` kernel: sums the partials of the splits in a fixed order and
//      writes dk and dv in the input dtype. No atomics: the result is the
//      same from run to run.
// Scalar fp32 FMAs, one warp a q row (row kernel) or a kv row (kv kernel),
// k and v read through L1/L2. delta is computed as rowsum(dp * e) /
// rowsum(e) with e = exp(logit - max), which is rowsum(dp * pf) up to fp32
// rounding.
//
// Ragged edges: kv columns >= M carry probability exactly 0 and kv is read
// unpadded; q rows past the end of a tile or run are staged as zeros
// (q = g = 0), so they add exactly 0 to dk and dv.
//
// Layouts: q, k, v, g are read and dq, dk, dv written through (batch, head,
// row) element strides, head dim unit-stride, so the model's head-split
// views go in and the gradients land in the layouts of the q and kv
// projections without a copy.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the entries return cudaGetLastError() after the launches. The
// caller allocates the workspaces.

#include "attention_common.cuh"
#include "wgmma_common.cuh"

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
// Scalar route (fp32, and bf16 views the tensor-core route does not take).
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
// bf16 on the tensor cores: wgmma m64n64k16, fp32 accumulation. Two kernels,
// one warpgroup a block, from the forward's residual (q, k, v, lse2).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTileBytes = 64 * kPanelRowBytes;  // one 64-row panel
constexpr int kMaxShares = 8;                    // portable cluster size

struct TcProblem {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  const float* lse;  // (G, N): log2 of sum_j 2^(s_j * scale * log2 e)
  float* delta;      // (G, N): rowsum(dp * pf), written by the dq kernel
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Layout lq, lk, lv, lg, ldq, ldk, ldv;
  int H, N, M, d;
  int qtiles, ktiles;  // 64-row tiles of q and of kv
  int shares;          // dkv kernel: blocks (one cluster) per kv tile
  float scale;
};

// dq kernel: a block walks q tiles of slice blockIdx.y (persistent); per q
// tile, k and v stream twice through a two-stage ring of 64-row tiles.
// Both passes form S = q k^T and dp = g v^T per kv tile (wgmma, both
// operands from shared memory) and pf = 2^(S * scale * log2 e - lse2).
// Pass 1 sums delta = rowsum(dp * pf), the TPU kernel's definition, and
// writes it for the dkv kernel; pass 2 rounds dl = (dp - delta) * pf * scale
// to bf16 in registers and accumulates dq += dl k (dl the register A
// operand, k MN-major). 5 products. x = S * scale * log2 e is rounded as
// the forward rounds it (no FMA), so pf is exactly 1 where the forward's p
// was (M = 1).
template <int PN>
__global__ void __launch_bounds__(kWgThreads) sr_bwd_dq(const TcProblem p) {
  constexpr int TB = PN * kTileBytes;  // bytes of one staged 64-row tile
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t Qs = base, Gs = Qs + 2 * TB, Ks = Gs + 2 * TB;
  const uint32_t Vs = Ks + 2 * TB;
  const int tid = threadIdx.x;
  const int tq = tid % 4;
  const int rl = 16 * (tid / 32) + (tid % 32) / 4;  // first of the two rows
  const int g = blockIdx.y;
  const bf16* qg = slice(p.q, p.lq, g, p.H);
  const bf16* gg = slice(p.g, p.lg, g, p.H);
  const bf16* kg = slice(p.k, p.lk, g, p.H);
  const bf16* vg = slice(p.v, p.lv, g, p.H);
  const int T = p.ktiles;
  const float c = p.scale * kLog2e;

  // Step u of q tile t: pass 1 on kv tile u (u < T), pass 2 on u - T.
  auto issue = [&](int t, int u, int stage, int qbuf) {
    const int j = u < T ? u : u - T;
    stage_rows_async(Ks + stage * TB, kg, p.lk.row, j * 64, p.M, p.d, 64, PN,
                     tid, kWgThreads);
    stage_rows_async(Vs + stage * TB, vg, p.lv.row, j * 64, p.M, p.d, 64, PN,
                     tid, kWgThreads);
    if (u == 0) {
      stage_rows_async(Qs + qbuf * TB, qg, p.lq.row, t * 64, p.N, p.d, 64, PN,
                       tid, kWgThreads);
      stage_rows_async(Gs + qbuf * TB, gg, p.lg.row, t * 64, p.N, p.d, 64, PN,
                       tid, kWgThreads);
    }
  };

  int t = blockIdx.x;
  if (t < p.qtiles) issue(t, 0, 0, 0);
  cp_async_commit();
  int stage = 0;
  for (int qbuf = 0; t < p.qtiles; t += gridDim.x, qbuf ^= 1) {
    const uint32_t qt = Qs + qbuf * TB, gt = Gs + qbuf * TB;
    float acc[PN][32];
#pragma unroll
    for (int pn = 0; pn < PN; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
    float l2[2], delta[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = t * 64 + rl + 8 * h;
      l2[h] = row < p.N ? p.lse[(long long)g * p.N + row] : 0.f;
    }

    for (int u = 0; u < 2 * T; ++u, stage ^= 1) {
      if (u + 1 < 2 * T)
        issue(t, u + 1, stage ^ 1, qbuf);
      else if (t + gridDim.x < p.qtiles)
        issue(t + gridDim.x, 0, stage ^ 1, qbuf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      fence_async_smem();
      __syncthreads();

      const int j = u < T ? u : u - T;
      const uint32_t kt = Ks + stage * TB, vt = Vs + stage * TB;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * PN; ++ks) {
        wgmma_ss(s, kmajor_desc(qt, 64, ks), kmajor_desc(kt, 64, ks));
        wgmma_ss(dp, kmajor_desc(gt, 64, ks), kmajor_desc(vt, 64, ks));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 64 * j + 8 * (i / 4) + 2 * tq + (i & 1);
        s[i] = col < p.M ? ex2(__fmul_rn(s[i], c) - l2[(i >> 1) & 1]) : 0.f;
      }
      if (u < T) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          delta[(i >> 1) & 1] = fmaf(dp[i], s[i], delta[(i >> 1) & 1]);
        if (u == T - 1) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            delta[h] = quad_sum(delta[h]);
            const int row = t * 64 + rl + 8 * h;
            if (tq == 0 && row < p.N)
              p.delta[(long long)g * p.N + row] = delta[h];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = (dp[i] - delta[(i >> 1) & 1]) * s[i] * p.scale;
        uint32_t la[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) pack_a(s, kk, la[kk]);
#pragma unroll
        for (int pn = 0; pn < PN; ++pn) fence_regs(acc[pn]);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) fence_regs(la[ks]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int pn = 0; pn < PN; ++pn)
            wgmma_rs(acc[pn], la[ks], mnmajor_desc(kt, 64, pn, ks));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int pn = 0; pn < PN; ++pn) fence_regs(acc[pn]);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) fence_regs(la[ks]);
      }
      __syncthreads();  // this stage is read: the next step may refill it
    }

    bf16* dqg = slice(p.dq, p.ldq, g, p.H);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = t * 64 + rl + 8 * h;
      if (row >= p.N) continue;
      bf16* dst = dqg + (long long)row * p.ldq.row;
#pragma unroll
      for (int pn = 0; pn < PN; ++pn)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = pn * kPanel + 8 * jj + 2 * tq;
          if (col < p.d)
            *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(
                acc[pn][4 * jj + 2 * h], acc[pn][4 * jj + 2 * h + 1]);
        }
    }
  }
  cp_async_wait<0>();
}

// dkv kernel: block (share s, kv tile c) of slice blockIdx.y keeps k and v
// of kv rows [64c, 64c + 64) staged and walks q tiles s, s + shares, ...
// with q, g (and the rows' lse and delta) double-buffered. Per q tile:
// S^T = k q^T and dp^T = v g^T (wgmma), p^T = 2^(S^T * scale * log2 e - lse2),
// dl^T = (dp^T - delta) p^T * scale, both rounded to bf16 in registers, then
// dv += p^T g and dk += dl^T q (registers as A, g and q MN-major). The
// `shares` blocks of a kv tile form one thread-block cluster: at the end
// each writes its fp32 dk, dv partial to its own shared memory, and block s
// sums rows [s * 64 / shares, ...) of all partials over distributed shared
// memory, in share order (no atomics: the same bits every run).
template <int PN>
__global__ void __launch_bounds__(kWgThreads) sr_bwd_dkv(const TcProblem p) {
  constexpr int TB = PN * kTileBytes;
  constexpr int DP = PN * kPanel;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const uint32_t Ks = base, Vs = Ks + TB, Qs = Vs + TB, Gs = Qs + 2 * TB;
  const uint32_t Ss = Gs + 2 * TB;  // [2][lse 64, delta 64] fp32
  const float* stats = reinterpret_cast<const float*>(gbase + (Ss - base));
  const int tid = threadIdx.x;
  const int tq = tid % 4;
  const int share = blockIdx.x % p.shares;
  const int m0 = (blockIdx.x / p.shares) * 64;
  const int g = blockIdx.y;
  const bf16* qg = slice(p.q, p.lq, g, p.H);
  const bf16* gg = slice(p.g, p.lg, g, p.H);
  const float* lse = p.lse + (long long)g * p.N;
  const float* delta = p.delta + (long long)g * p.N;
  const float c = p.scale * kLog2e;

  auto issue = [&](int t, int buf) {
    stage_rows_async(Qs + buf * TB, qg, p.lq.row, t * 64, p.N, p.d, 64, PN,
                     tid, kWgThreads);
    stage_rows_async(Gs + buf * TB, gg, p.lg.row, t * 64, p.N, p.d, 64, PN,
                     tid, kWgThreads);
    const int row = t * 64 + (tid % 64);
    const bool in = row < p.N;
    const float* src = tid < 64 ? lse : delta;
    cp_async4(Ss + (buf * 128 + tid) * 4, in ? src + row : src, in ? 4 : 0);
  };

  stage_rows_async(Ks, slice(p.k, p.lk, g, p.H), p.lk.row, m0, p.M, p.d, 64,
                   PN, tid, kWgThreads);
  stage_rows_async(Vs, slice(p.v, p.lv, g, p.H), p.lv.row, m0, p.M, p.d, 64,
                   PN, tid, kWgThreads);
  int t = share;
  if (t < p.qtiles) issue(t, 0);
  cp_async_commit();

  float dk[PN][32], dv[PN][32];
#pragma unroll
  for (int pn = 0; pn < PN; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[pn][i] = dv[pn][i] = 0.f;

  for (int buf = 0; t < p.qtiles; t += p.shares, buf ^= 1) {
    if (t + p.shares < p.qtiles) issue(t + p.shares, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();

    const uint32_t qt = Qs + buf * TB, gt = Gs + buf * TB;
    const float* lse_s = stats + buf * 128;
    const float* delta_s = lse_s + 64;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * PN; ++ks) {
      wgmma_ss(s, kmajor_desc(Ks, 64, ks), kmajor_desc(qt, 64, ks));
      wgmma_ss(dp, kmajor_desc(Vs, 64, ks), kmajor_desc(gt, 64, ks));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // Rows: this block's kv rows; columns: the tile's q rows.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * tq + (i & 1);
      const float pf = ex2(__fmul_rn(s[i], c) - lse_s[col]);
      s[i] = pf;
      dp[i] = (dp[i] - delta_s[col]) * pf * p.scale;
    }
    uint32_t pa[4][4], la[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_a(s, kk, pa[kk]);
      pack_a(dp, kk, la[kk]);
    }
#pragma unroll
    for (int pn = 0; pn < PN; ++pn) {
      fence_regs(dv[pn]);
      fence_regs(dk[pn]);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      fence_regs(pa[ks]);
      fence_regs(la[ks]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int pn = 0; pn < PN; ++pn) {
        wgmma_rs(dv[pn], pa[ks], mnmajor_desc(gt, 64, pn, ks));
        wgmma_rs(dk[pn], la[ks], mnmajor_desc(qt, 64, pn, ks));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < PN; ++pn) {
      fence_regs(dv[pn]);
      fence_regs(dk[pn]);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      fence_regs(pa[ks]);
      fence_regs(la[ks]);
    }
    __syncthreads();  // this buffer is read: the next tile may refill it
  }
  cp_async_wait<0>();
  __syncthreads();

  // The partials, fp32, [dk | dv][64 rows][DP], over the q and g buffers.
  float* red = reinterpret_cast<float*>(gbase + (Qs - base));
  const int rl = 16 * (tid / 32) + (tid % 32) / 4;
#pragma unroll
  for (int pn = 0; pn < PN; ++pn)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (rl + 8 * h) * DP + pn * kPanel + 8 * jj + 2 * tq;
        *reinterpret_cast<float2*>(red + at) =
            make_float2(dk[pn][4 * jj + 2 * h], dk[pn][4 * jj + 2 * h + 1]);
        *reinterpret_cast<float2*>(red + 64 * DP + at) =
            make_float2(dv[pn][4 * jj + 2 * h], dv[pn][4 * jj + 2 * h + 1]);
      }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = (64 + p.shares - 1) / p.shares;
  const int r0 = share * rows;
  const int r1 = min(64, r0 + rows);
  const int n = r1 > r0 ? (r1 - r0) * DP : 0;
  bf16* dkg = slice(p.dk, p.ldk, g, p.H);
  bf16* dvg = slice(p.dv, p.ldv, g, p.H);
  for (int i = tid; i < 2 * n; i += kWgThreads) {
    const int which = i >= n;
    const int rem = i - which * n;
    const int row = r0 + rem / DP;
    const int col = rem % DP;
    const int at = (which * 64 + row) * DP + col;
    float sum = 0.f;
    for (int r = 0; r < p.shares; ++r) sum += cluster.map_shared_rank(red, r)[at];
    const int m = m0 + row;
    if (m < p.M && col < p.d) {
      if (which)
        dvg[(long long)m * p.ldv.row + col] = __float2bfloat16_rn(sum);
      else
        dkg[(long long)m * p.ldk.row + col] = __float2bfloat16_rn(sum);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The scalar kv kernel's split plan: enough blocks for ~8 per SM, each
// split at least 32 q rows, at most `max_splits` of them when that is
// positive (1: a block owns its kv rows over the whole of N).
void plan_splits(const DeviceState* st, int G, int N, int M, int max_splits,
                 int* splits, int* rows_per_split) {
  const int chunks = ceil_div(M, kKvWarps);
  const int tile = 32;
  const long long want = 8LL * st->sms;
  long long s = (want + (long long)G * chunks - 1) / ((long long)G * chunks);
  int max_s = ceil_div(N, tile);
  if (max_splits > 0 && max_splits < max_s) max_s = max_splits;
  if (s > max_s) s = max_s;
  if (s < 1) s = 1;
  *rows_per_split = ceil_div(ceil_div(N, (int)s), tile) * tile;
  *splits = ceil_div(N, *rows_per_split);
}

// Blocks of the scalar row kernel: ~4 per SM across the G slices, at most 8
// passes of the warps each.
int rows_per_cta(const DeviceState* st, int G, int N, int rows_per_pass) {
  const int groups = ceil_div(N, rows_per_pass);
  const int per_slice = ceil_div(4 * st->sms, G);
  int gpc = ceil_div(groups, per_slice);
  gpc = gpc < 1 ? 1 : (gpc > 8 ? 8 : gpc);
  return gpc * rows_per_pass;
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

bool valid_sizes(int B, int H, int N, int M, int d) {
  return B > 0 && H > 0 && (long long)B * H <= 65535 && N > 0 && M > 0 &&
         M <= kMaxM && d > 0 && d <= kMaxD;
}

// Tensor-core kernels: shared-memory opt-in flags, dq PN 1, 2, dkv PN 1, 2.
std::atomic<bool> g_opted_in[kMaxDevices][4];

size_t dq_smem(int pn) { return 1024 + (size_t)8 * pn * kTileBytes; }
size_t dkv_smem(int pn) { return 1024 + (size_t)6 * pn * kTileBytes + 1024; }

// Blocks of a kernel an SM holds, read once per (device, kernel), after the
// kernel's shared-memory opt-in. Kernel ids: dq PN 1, 2, dkv PN 1, 2.
std::atomic<int> g_per_sm[kMaxDevices][4];

template <typename Kernel>
int blocks_per_sm(const DeviceState* st, int id, Kernel kernel, size_t smem,
                  int* out) {
  int rc = opt_in_smem(st, &g_opted_in[device_index(st)][id], kernel);
  if (rc != 0) return rc;
  std::atomic<int>& cached = g_per_sm[device_index(st)][id];
  *out = cached.load(std::memory_order_relaxed);
  if (*out > 0) return 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                          kWgThreads, smem);
  if (rc == 0 && *out < 1) return (int)cudaErrorInvalidConfiguration;
  if (rc == 0) cached.store(*out, std::memory_order_relaxed);
  return rc;
}

// Blocks (one cluster) per kv tile of the dkv kernel: about as many blocks
// in all as fit on the card at once, at most kMaxShares and one q tile
// each; `max_shares` > 0 caps them.
int plan_shares(const DeviceState* st, int per_sm, int G, int qtiles,
                int ktiles, int max_shares) {
  int s = per_sm * st->sms / (G * ktiles);
  if (s > kMaxShares) s = kMaxShares;
  if (s > qtiles) s = qtiles;
  if (max_shares > 0 && s > max_shares) s = max_shares;
  return s < 1 ? 1 : s;
}

template <int PN>
int launch_tc(TcProblem p, int G, int max_shares, DeviceState* st,
              cudaStream_t stream) {
  int dq_per_sm = 0, dkv_per_sm = 0;
  int rc = blocks_per_sm(st, PN - 1, sr_bwd_dq<PN>, dq_smem(PN), &dq_per_sm);
  if (rc == 0)
    rc = blocks_per_sm(st, 1 + PN, sr_bwd_dkv<PN>, dkv_smem(PN), &dkv_per_sm);
  if (rc != 0) return rc;

  // dq (and delta): blocks persistent over a slice's q tiles, about one
  // wave of them, at least two q tiles each.
  int per_slice = dq_per_sm * st->sms / G;
  if (per_slice > ceil_div(p.qtiles, 2)) per_slice = ceil_div(p.qtiles, 2);
  if (per_slice < 1) per_slice = 1;
  sr_bwd_dq<PN><<<dim3(per_slice, G), kWgThreads, dq_smem(PN), stream>>>(p);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;

  p.shares = plan_shares(st, dkv_per_sm, G, p.qtiles, p.ktiles, max_shares);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ktiles * p.shares, G);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = dkv_smem(PN);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.shares;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, sr_bwd_dkv<PN>, p);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// The scalar route: number of splits of a slice's q rows that
// `sr_attention_bwd` uses on the current device for these sizes and this
// cap (0: none); the `partials` workspace holds 2 * B * H * splits * M * d
// floats. Negative: -(cudaError_t code).
extern "C" int sr_attention_bwd_splits(int B, int H, int N, int M, int d,
                                       int dtype, int max_splits) {
  if (!valid_sizes(B, H, N, M, d) || (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  DeviceState* st = nullptr;
  const int rc = current_device(&st);
  if (rc != 0) return -rc;
  int splits = 0, rows = 0;
  plan_splits(st, B * H, N, M, max_splits, &splits, &rows);
  return splits;
}

// The scalar route. dtype: 0 = float32, 1 = bfloat16. q/g/dq: (B, H, N, d);
// k/v/dk/dv: (B, H, M, d), on the current device, each with unit stride
// along d. `strides` holds 21 element strides: (batch, head, row) of q, k,
// v, g, dq, dk, dv, in that order. `stats`: B*H*N*4 floats; `partials`: see
// sr_attention_bwd_splits, called with the same `max_splits`. Returns a
// cudaError_t code (0 = launched).
extern "C" int sr_attention_bwd(const void* q, const void* k, const void* v,
                                const void* g, void* dq, void* dk, void* dv,
                                void* stats, void* partials, int B, int H,
                                int N, int M, int d, const long long* strides,
                                float scale, int dtype, int max_splits,
                                void* stream) {
  if (!valid_sizes(B, H, N, M, d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
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
  plan_splits(st, pr.G, N, M, max_splits, &pr.splits, &pr.rows_per_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = dtype == 0 ? launch_scalar<float>(pr, st, s)
                  : launch_scalar<__nv_bfloat16>(pr, st, s);
  if (rc != 0) return rc;
  return dtype == 0 ? launch_reduce<float>(pr, s)
                    : launch_reduce<__nv_bfloat16>(pr, s);
}

// The tensor-core route: shares (blocks of one cluster) per kv tile that
// `sr_attention_bwd_tc` plans on the current device; negative: -(error).
extern "C" int sr_attention_bwd_tc_shares(int B, int H, int N, int M, int d,
                                          int max_shares) {
  if (!valid_sizes(B, H, N, M, d)) return -(int)cudaErrorInvalidValue;
  DeviceState* st = nullptr;
  int rc = current_device(&st);
  if (rc != 0) return -rc;
  int per_sm = 0;
  rc = d <= 64 ? blocks_per_sm(st, 2, sr_bwd_dkv<1>, dkv_smem(1), &per_sm)
               : blocks_per_sm(st, 3, sr_bwd_dkv<2>, dkv_smem(2), &per_sm);
  if (rc != 0) return -rc;
  return plan_shares(st, per_sm, B * H, ceil_div(N, 64), ceil_div(M, 64),
                     max_shares);
}

// The tensor-core route: bf16, d % 8 == 0, every row of q, k, v, g 16-byte
// aligned (base and strides). q/g/dq: (B, H, N, d); k/v/dk/dv: (B, H, M, d);
// `strides` holds 21 element strides: (batch, head, row) of q, k, v, g, dq,
// dk, dv. `lse`: the forward's (B * H, N) fp32 row logsumexp in base 2;
// `delta`: (B * H, N) fp32 scratch. Two launches: the dq kernel (which also
// writes delta), then the dkv kernel in clusters of `shares` blocks
// (planned; `max_shares` > 0 caps them). Returns a cudaError_t code.
extern "C" int sr_attention_bwd_tc(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse, void* delta,
                                   void* dq, void* dk, void* dv, int B, int H,
                                   int N, int M, int d,
                                   const long long* strides, float scale,
                                   int max_shares, void* stream) {
  if (!valid_sizes(B, H, N, M, d) || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const void* loaded[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i)
    if (!rows_aligned16(loaded[i], strides[3 * i], strides[3 * i + 1],
                        strides[3 * i + 2]))
      return (int)cudaErrorMisalignedAddress;
  cudaGetLastError();
  DeviceState* st = nullptr;
  const int rc = current_device(&st);
  if (rc != 0) return rc;
  TcProblem p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.g = static_cast<const bf16*>(g);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  Layout* layouts[7] = {&p.lq, &p.lk, &p.lv, &p.lg, &p.ldq, &p.ldk, &p.ldv};
  for (int i = 0; i < 7; ++i)
    *layouts[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.H = H;
  p.N = N;
  p.M = M;
  p.d = d;
  p.qtiles = ceil_div(N, 64);
  p.ktiles = ceil_div(M, 64);
  p.shares = 1;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= 64 ? launch_tc<1>(p, B * H, max_shares, st, s)
                 : launch_tc<2>(p, B * H, max_shares, st, s);
}

extern "C" const char* sr_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
