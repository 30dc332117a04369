// Short-kv SR-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel rgbx_semantic_segmentation_tpu/ops/sr_attention.py
// `_fwd_kernel` (launched by `_fwd_call`). For every (batch*head) slice g:
//
//     out[g] = softmax(q[g] @ k[g]^T * scale) @ v[g]
//
// with the TPU kernel's rounding points (mirrored by ops/attention._sdpa_fwd):
// logits accumulated in fp32 and multiplied by `scale`; row max, exp and sum
// in fp32; p normalised in fp32, THEN rounded to the input dtype; p @ v
// accumulated in fp32; the output rounded to the input dtype. The
// tensor-core kernels can also write each row's fp32 logsumexp in base 2 of
// the scaled logits, log2(sum_j 2^(s_j * scale * log2 e)): the residual of
// the backward kernels, which then need neither the row max nor the sum.
//
// What bounds it on the H100: the (N, M) probs never reach device memory,
// so device-memory traffic is q and out (G*N*d each) plus k and v (G*M*d
// each). At the flagship shapes (M = 300, d = 64, bf16) that is ~2 bytes
// read and written per 300 multiply-adds of each q row: memory-bound in
// principle; on the chip the softmax's one exp a logit (the MUFU unit, 16 a
// clock an SM) and the products bind first.
//
// Three kernels; the wrapper picks the route, the C entries the kernel:
//   * `sr_fwd_onepass` (bf16, M <= 320; every MiT shape at 480x640 has
//     M = 300): k and v of a slice are staged once per block with 16-byte
//     cp.async into the 128-byte-swizzled layout wgmma reads, and serve all
//     the q tiles the block's two warpgroups walk (blocks are persistent
//     over a slice's q tiles; about one block an SM across the slices). A
//     warpgroup owns 64 q rows at a time: S = q k^T is one batch of
//     m64n64k16 wgmmas whose fp32 accumulators hold the whole logits row
//     (ceil(M / 64) * 32 registers a thread); max, sum and p come from that
//     one product with one exp a logit and one reciprocal a row; p, rounded
//     to bf16 in registers, is the register A operand of the p @ v wgmmas,
//     whose B is v straight from its row-major staging (MN-major). The next
//     q tile's cp.async runs under the current tile's products. The logits
//     row holds a thread at ~255 registers, so an SM runs one block (two
//     warpgroups).
//   * `sr_fwd_twopass` (bf16, 320 < M <= 1024): one warpgroup a block, k
//     and v stream through a two-stage cp.async ring in 64-row tiles. Pass
//     1: S tile by tile, online row max and sum; pass 2: S again, p and
//     p @ v. Three products instead of two; the same rounding points.
//   * `sr_attention_fwd_kernel` (fp32, and bf16 views the tensor-core route
//     does not take: a head dim that is not a multiple of 8, rows that are
//     not 16-byte aligned): scalar fp32 FMAs from shared memory, described
//     by the rest of this list.
//   * One block per (tile of q rows, slice g): blockIdx.y = g, blockIdx.x =
//     a run of q rows; offsets come from blockIdx and the operands' strides.
//     q, k, v and out are read and written where they lie: (batch, head,
//     row) strides are arguments and only the head dim must be unit-stride,
//     so the head-split views of the model's (B, N, h*d) token tensors need
//     no copy in and none out.
//   * k and v of the slice are staged in dynamic shared memory once per block
//     when they fit (M = 300, d = 64 in bf16: ~78 KB) and serve every q row
//     the block owns, so kv is read from L2 once per block, not once per row.
//   * The fp32 logits of the block's 32 current q rows live in shared memory
//     only. Where k and v do not fit beside them (large M, or fp32 at
//     d = 128), they stream through shared memory in chunks in two passes:
//     all logits first (exact row max and sum), then normalised p @ v. This
//     keeps the rounding points above, which an online-rescaled softmax
//     would not.
//   * Each warp owns 4 q rows; each lane owns a set of kv columns for the
//     logits and a set of head dims for p @ v, so one shared-memory load of
//     k or v feeds 4 (rows) FMAs. Row strides of the k buffer are padded to
//     an odd number of 32-bit words, so the 32 lanes reading 32 different k
//     rows hit 32 different banks.
//   * The ragged kv edge is masked here: columns >= M are never computed and
//     their probability is exactly 0. kv is not padded in device memory.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch. The
// device's limits and each kernel's shared-memory opt-in are set up once per
// device, not per launch.

#include "attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // q rows resident per group
constexpr int kThreads = kWarps * 32;
constexpr int kColTiles = 4;                  // 32-column tiles per lane pass
constexpr int kDimTiles = kMaxD / 32;

// Elements of T read by one 32-bit shared-memory load in the logits loop.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int n = 1;
  __device__ static void load(const float* p, float* out) { out[0] = *p; }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 2;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  }
};

template <typename T>
struct Params {
  const T* q;  // (B, H, N, d)
  const T* k;  // (B, H, M, d)
  const T* v;  // (B, H, M, d)
  T* out;      // (B, H, N, d)
  Layout lq, lk, lv, lo;
  int H, N, M, d;
  int dq;            // d rounded up to Pack<T>::n (zero-padded in smem)
  int ldk;           // row stride of the k buffer, in elements
  int ldp;           // row stride of the logits buffer: M rounded up to 4
  int chunk;         // kv rows staged at a time (>= M: k and v resident)
  int buf_rows;      // rows of each kv buffer: min(chunk, M) rounded up to 4
  int rows_per_cta;  // q rows owned by one block, a multiple of kRows
  float scale;
};

// Copy rows [0, rows) of a (rows, d) source with row stride src_ld into a
// shared buffer with row stride ld; columns [d, cols) and rows
// [rows, zero_rows) are zero.
template <typename T>
__device__ void stage_rows(T* dst, int ld, const T* src, long long src_ld,
                           int rows, int d, int cols, int zero_rows) {
  const int total = zero_rows * cols;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / cols;
    const int e = i - r * cols;
    T x = from_float<T>(0.f);
    if (r < rows && e < d) x = src[r * src_ld + e];
    dst[r * ld + e] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sr_attention_fwd_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* P_s = reinterpret_cast<float*>(smem);   // (kRows, ldp) fp32
  float* Q_s = P_s + kRows * p.ldp;              // (kRows, dq) fp32
  T* K_s = reinterpret_cast<T*>(Q_s + kRows * p.dq);  // (buf_rows, ldk)
  T* V_s = K_s + p.buf_rows * p.ldk;                  // (buf_rows, d)

  constexpr int n = Pack<T>::n;
  const int g = blockIdx.y;
  const T* qg = slice(p.q, p.lq, g, p.H);
  const T* kg = slice(p.k, p.lk, g, p.H);
  const T* vg = slice(p.v, p.lv, g, p.H);
  T* og = slice(p.out, p.lo, g, p.H);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rbase = warp * kRowsPerWarp;  // this warp's rows in the group
  const bool resident = p.chunk >= p.M;
  const int row_begin = blockIdx.x * p.rows_per_cta;
  const int row_end = min(row_begin + p.rows_per_cta, p.N);

  if (resident) {
    stage_rows(K_s, p.ldk, kg, p.lk.row, p.M, p.d, p.dq, p.M);
    stage_rows(V_s, p.d, vg, p.lv.row, p.M, p.d, p.d, p.buf_rows);
  }

  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    __syncthreads();  // the previous group is done with Q_s
    for (int i = threadIdx.x; i < kRows * p.dq; i += kThreads) {
      const int r = i / p.dq;
      const int e = i - r * p.dq;
      float x = 0.f;
      if (r0 + r < row_end && e < p.d)
        x = to_float(qg[(r0 + r) * p.lq.row + e]);
      Q_s[i] = x;
    }
    __syncthreads();

    // Pass 1: fp32 logits * scale for this warp's rows, all M columns.
    for (int c0 = 0; c0 < p.M; c0 += p.chunk) {
      const int mc = min(p.chunk, p.M - c0);
      if (!resident) {
        __syncthreads();
        stage_rows(K_s, p.ldk, kg + c0 * p.lk.row, p.lk.row, mc, p.d, p.dq,
                   mc);
        __syncthreads();
      }
      for (int jb = 0; jb < mc; jb += 32 * kColTiles) {
        float acc[kRowsPerWarp][kColTiles];
        const T* krow[kColTiles];
#pragma unroll
        for (int t = 0; t < kColTiles; ++t) {
          // Lanes past the ragged edge read a valid row; the result is
          // dropped below.
          const int j = min(jb + t * 32 + lane, mc - 1);
          krow[t] = K_s + j * p.ldk;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][t] = 0.f;
        }
        for (int e = 0; e < p.dq; e += n) {
          float qv[kRowsPerWarp][n];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float* qr = Q_s + (rbase + r) * p.dq + e;
            if constexpr (n == 2) {
              const float2 f = *reinterpret_cast<const float2*>(qr);
              qv[r][0] = f.x;
              qv[r][1] = f.y;
            } else {
              qv[r][0] = qr[0];
            }
          }
#pragma unroll
          for (int t = 0; t < kColTiles; ++t) {
            float kv[n];
            Pack<T>::load(krow[t] + e, kv);
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
              for (int u = 0; u < n; ++u)
                acc[r][t] = fmaf(qv[r][u], kv[u], acc[r][t]);
          }
        }
#pragma unroll
        for (int t = 0; t < kColTiles; ++t) {
          const int j = jb + t * 32 + lane;
          if (j < mc) {
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r)
              P_s[(rbase + r) * p.ldp + c0 + j] = acc[r][t] * p.scale;
          }
        }
      }
    }
    __syncwarp();

    // Softmax over the full row, fp32; p rounded to T after normalising.
    // Columns [M, ldp) are set to exactly 0 for the 4-wide p @ v loop.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float* row = P_s + (rbase + r) * p.ldp;
      float mx = -INFINITY;
      for (int j = lane; j < p.M; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int j = lane; j < p.M; j += 32) {
        const float ex = expf(row[j] - mx);
        row[j] = ex;
        s += ex;
      }
      s = warp_sum(s);
      for (int j = lane; j < p.M; j += 32) row[j] = round_to<T>(row[j] / s);
      for (int j = p.M + lane; j < p.ldp; j += 32) row[j] = 0.f;
    }
    __syncwarp();

    // Pass 2: out = p @ v, fp32 accumulation; lane owns dims lane + 32*u.
    float acc[kRowsPerWarp][kDimTiles];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int u = 0; u < kDimTiles; ++u) acc[r][u] = 0.f;
    for (int c0 = 0; c0 < p.M; c0 += p.chunk) {
      const int mc = min(p.chunk, p.M - c0);
      const int mc4 = (mc + 3) & ~3;
      if (!resident) {
        __syncthreads();
        stage_rows(V_s, p.d, vg + c0 * p.lv.row, p.lv.row, mc, p.d, p.d,
                   mc4);
        __syncthreads();
      }
      for (int j = 0; j < mc4; j += 4) {
        float4 pr[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          pr[r] = *reinterpret_cast<const float4*>(
              P_s + (rbase + r) * p.ldp + c0 + j);
#pragma unroll
        for (int u = 0; u < kDimTiles; ++u) {
          const int e = lane + 32 * u;
          if (e < p.d) {
            const T* vc = V_s + j * p.d + e;
            const float v0 = to_float(vc[0]);
            const float v1 = to_float(vc[p.d]);
            const float v2 = to_float(vc[2 * p.d]);
            const float v3 = to_float(vc[3 * p.d]);
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              float a = acc[r][u];
              a = fmaf(pr[r].x, v0, a);
              a = fmaf(pr[r].y, v1, a);
              a = fmaf(pr[r].z, v2, a);
              a = fmaf(pr[r].w, v3, a);
              acc[r][u] = a;
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = r0 + rbase + r;
      if (row < row_end) {
#pragma unroll
        for (int u = 0; u < kDimTiles; ++u) {
          const int e = lane + 32 * u;
          if (e < p.d) og[row * p.lo.row + e] = from_float<T>(acc[r][u]);
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma m64n64k16, fp32 accumulation.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kOnePassWgs = 2;     // warpgroups of a one-pass block
constexpr int kMaxOnePassTiles = 5;  // 64-column kv tiles held as logits
constexpr int kTileBytes = 64 * kPanelRowBytes;  // one 64-row panel

struct TcParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;  // (G, N) or null: log2 of sum_j 2^(s_j * scale * log2 e)
  Layout lq, lk, lv, lo;
  int H, N, M, d;
  int tiles;   // 64-row q tiles of a slice
  float scale;
};

// Row statistics of the two rows a thread holds, combined over its quad.
__device__ __forceinline__ void quad_combine(float (&mx)[2], float (&sum)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = quad_max(mx[h]);
    sum[h] = quad_sum(sum[h] * ex2(mx[h] - m));
    mx[h] = m;
  }
}

// The output tile (rows r0 + 16 * warp + gq (+ 8)) and its logsumexp.
template <int PN>
__device__ __forceinline__ void store_out(const TcParams& p, int g, int r0,
                                          const float (&o)[PN][32],
                                          const float (&mx)[2],
                                          const float (&sum)[2]) {
  const int t = threadIdx.x % kWgThreads;
  const int row0 = r0 + 16 * (t / 32) + (t % 32) / 4;
  const int tq = t % 4;
  bf16* og = slice(p.out, p.lo, g, p.H);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.N) continue;
    bf16* dst = og + (long long)row * p.lo.row;
#pragma unroll
    for (int pn = 0; pn < PN; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = pn * kPanel + 8 * j + 2 * tq;
        if (c < p.d)
          *reinterpret_cast<uint32_t*>(dst + c) =
              pack_bf16(o[pn][4 * j + 2 * h], o[pn][4 * j + 2 * h + 1]);
      }
    if (p.lse != nullptr && tq == 0)
      p.lse[(long long)g * p.N + row] = mx[h] + log2f(sum[h]);
  }
}

// One pass: k and v of slice blockIdx.y resident (NT 64-row tiles, PN
// panels of the head dim); each warpgroup walks its own q tiles.
template <int NT, int PN>
__global__ void __launch_bounds__(kOnePassWgs * kWgThreads, 1)
    sr_fwd_onepass(const TcParams p) {
  constexpr int KV = NT * 64;  // kv rows staged (zero past M)
  constexpr int TB = PN * kTileBytes;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t Ks = base;
  const uint32_t Vs = Ks + PN * KV * kPanelRowBytes;
  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;
  const uint32_t Qs = Vs + PN * KV * kPanelRowBytes + wg * 2 * TB;

  const int g = blockIdx.y;
  const bf16* qg = slice(p.q, p.lq, g, p.H);
  stage_rows_async(Ks, slice(p.k, p.lk, g, p.H), p.lk.row, 0, p.M, p.d, KV,
                   PN, threadIdx.x, blockDim.x);
  stage_rows_async(Vs, slice(p.v, p.lv, g, p.H), p.lv.row, 0, p.M, p.d, KV,
                   PN, threadIdx.x, blockDim.x);
  const int stride = gridDim.x * kOnePassWgs;
  int t = blockIdx.x * kOnePassWgs + wg;
  if (t < p.tiles)
    stage_rows_async(Qs, qg, p.lq.row, t * 64, p.N, p.d, 64, PN, tid,
                     kWgThreads);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  const int tq = tid % 4;
  const float c = p.scale * kLog2e;
  for (int buf = 0; t < p.tiles; t += stride, buf ^= 1) {
    if (t + stride < p.tiles)
      stage_rows_async(Qs + (buf ^ 1) * TB, qg, p.lq.row, (t + stride) * 64,
                       p.N, p.d, 64, PN, tid, kWgThreads);
    cp_async_commit();
    const uint32_t qt = Qs + buf * TB;

    // S = q k^T, the whole row in registers.
    float s[NT][32];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_regs(s[j]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * PN; ++ks)
#pragma unroll
      for (int j = 0; j < NT; ++j)  // interleaved: no chain on one tile
        wgmma_ss(s[j], kmajor_desc(qt, 64, ks),
                 kmajor_desc(Ks + j * kTileBytes, KV, ks));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_regs(s[j]);

    // Softmax in base 2: x = s * scale * log2(e), rounded before any use
    // (never contracted into an FMA: the backward recomputes the same x and
    // subtracts lse2 from it); columns >= M (last tile only) are -inf. Max
    // and sum run as one chain a tile, combined afterwards: short
    // dependency chains with two warps an SM sub-partition.
    float tmx[NT][2], tsum[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tmx[j][0] = tmx[j][1] = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 64 * j + 8 * (i / 4) + 2 * tq + (i & 1);
        float x = __fmul_rn(s[j][i], c);
        if (j == NT - 1 && col >= p.M) x = -INFINITY;
        s[j][i] = x;
        tmx[j][(i >> 1) & 1] = fmaxf(tmx[j][(i >> 1) & 1], x);
      }
    }
    float mx[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = tmx[0][h];
#pragma unroll
      for (int j = 1; j < NT; ++j) mx[h] = fmaxf(mx[h], tmx[j][h]);
      mx[h] = quad_max(mx[h]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tsum[j][0] = tsum[j][1] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float e = ex2(s[j][i] - mx[(i >> 1) & 1]);
        s[j][i] = e;
        tsum[j][(i >> 1) & 1] += e;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sum[0] += tsum[j][0];
      sum[1] += tsum[j][1];
    }
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = quad_sum(sum[h]);
      inv[h] = 1.f / sum[h];
    }
    // p = e / sum in fp32, rounded to bf16: the A operand of p @ v.
    uint32_t pa[4 * NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[j][i] *= inv[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(s[j], kk, pa[4 * j + kk]);
    }

    float o[PN][32];
#pragma unroll
    for (int pn = 0; pn < PN; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pn][i] = 0.f;
#pragma unroll
    for (int pn = 0; pn < PN; ++pn) fence_regs(o[pn]);
#pragma unroll
    for (int ks = 0; ks < 4 * NT; ++ks) fence_regs(pa[ks]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * NT; ++ks)
#pragma unroll
      for (int pn = 0; pn < PN; ++pn)
        wgmma_rs(o[pn], pa[ks], mnmajor_desc(Vs, KV, pn, ks));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < PN; ++pn) fence_regs(o[pn]);
#pragma unroll
    for (int ks = 0; ks < 4 * NT; ++ks) fence_regs(pa[ks]);

    store_out<PN>(p, g, t * 64, o, mx, sum);
    cp_async_wait<0>();
    fence_async_smem();
    wg_barrier(1 + wg);
  }
}

// Two passes: one warpgroup a block, k (pass 1) and k, v (pass 2) stream
// through a two-stage ring of 64-row tiles; q tiles are double-buffered.
template <int PN>
__global__ void __launch_bounds__(kWgThreads)
    sr_fwd_twopass(const TcParams p) {
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t Qs = base;                          // 2 q tiles
  const uint32_t Ks = Qs + 2 * PN * kTileBytes;      // 2 k tiles
  const uint32_t Vs = Ks + 2 * PN * kTileBytes;      // 2 v tiles
  const int tid = threadIdx.x;
  const int tq = tid % 4;
  const int g = blockIdx.y;
  const bf16* qg = slice(p.q, p.lq, g, p.H);
  const bf16* kg = slice(p.k, p.lk, g, p.H);
  const bf16* vg = slice(p.v, p.lv, g, p.H);
  const int T = (p.M + 63) / 64;
  const float c = p.scale * kLog2e;

  // Step u of q tile t: pass 1 on kv tile u (u < T), pass 2 on u - T.
  auto issue = [&](int t, int u, int stage, int qbuf) {
    const int j = u < T ? u : u - T;
    stage_rows_async(Ks + stage * PN * kTileBytes, kg, p.lk.row, j * 64, p.M,
                     p.d, 64, PN, tid, kWgThreads);
    if (u >= T)
      stage_rows_async(Vs + stage * PN * kTileBytes, vg, p.lv.row, j * 64,
                       p.M, p.d, 64, PN, tid, kWgThreads);
    if (u == 0)
      stage_rows_async(Qs + qbuf * PN * kTileBytes, qg, p.lq.row, t * 64,
                       p.N, p.d, 64, PN, tid, kWgThreads);
  };

  int t = blockIdx.x;
  if (t < p.tiles) issue(t, 0, 0, 0);
  cp_async_commit();
  int stage = 0;
  for (int qbuf = 0; t < p.tiles; t += gridDim.x, qbuf ^= 1) {
    const uint32_t qt = Qs + qbuf * PN * kTileBytes;
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2];
    float o[PN][32];
#pragma unroll
    for (int pn = 0; pn < PN; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pn][i] = 0.f;

    for (int u = 0; u < 2 * T; ++u, stage ^= 1) {
      if (u + 1 < 2 * T)
        issue(t, u + 1, stage ^ 1, qbuf);
      else if (t + gridDim.x < p.tiles)
        issue(t + gridDim.x, 0, stage ^ 1, qbuf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      fence_async_smem();
      __syncthreads();

      const int j = u < T ? u : u - T;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * PN; ++ks)
        wgmma_ss(s, kmajor_desc(qt, 64, ks),
                 kmajor_desc(Ks + stage * PN * kTileBytes, 64, ks));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 64 * j + 8 * (i / 4) + 2 * tq + (i & 1);
        s[i] = col < p.M ? __fmul_rn(s[i], c) : -INFINITY;
      }
      if (u < T) {  // online max and sum of this thread's columns
        float tmax[2] = {mx[0], mx[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // Both -inf: no column of this thread so far, the sum stays 0.
          sum[h] *= mx[h] == tmax[h] ? 1.f : ex2(mx[h] - tmax[h]);
          mx[h] = tmax[h];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (s[i] != -INFINITY) sum[(i >> 1) & 1] += ex2(s[i] - mx[(i >> 1) & 1]);
        if (u == T - 1) {
          quad_combine(mx, sum);
#pragma unroll
          for (int h = 0; h < 2; ++h) inv[h] = 1.f / sum[h];
        }
      } else {
        uint32_t pa[4][4];
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = ex2(s[i] - mx[(i >> 1) & 1]) * inv[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) pack_a(s, kk, pa[kk]);
#pragma unroll
        for (int pn = 0; pn < PN; ++pn) fence_regs(o[pn]);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) fence_regs(pa[ks]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int pn = 0; pn < PN; ++pn)
            wgmma_rs(o[pn], pa[ks],
                     mnmajor_desc(Vs + stage * PN * kTileBytes, 64, pn, ks));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int pn = 0; pn < PN; ++pn) fence_regs(o[pn]);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) fence_regs(pa[ks]);
      }
      __syncthreads();  // this stage is read: the next step may refill it
    }
    store_out<PN>(p, g, t * 64, o, mx, sum);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// One call: the operands, their layouts and sizes (G = B * H slices).
struct Problem {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  Layout lq, lk, lv, lo;
  int G, H, N, M, d;
  float scale;
};

template <typename P, typename T>
void fill(P& p, const Problem& pr) {
  p.q = static_cast<const T*>(pr.q);
  p.k = static_cast<const T*>(pr.k);
  p.v = static_cast<const T*>(pr.v);
  p.out = static_cast<T*>(pr.out);
  p.lq = pr.lq;
  p.lk = pr.lk;
  p.lv = pr.lv;
  p.lo = pr.lo;
  p.H = pr.H;
  p.N = pr.N;
  p.M = pr.M;
  p.d = pr.d;
  p.scale = pr.scale;
}

// Shared-memory opt-in flags: the two scalar kernels, the one-pass kernels
// (NT, PN) and the two-pass kernels (PN).
constexpr int kScalarF32 = 0, kScalarBf16 = 1, kOnePass0 = 2;
constexpr int kTwoPass0 = kOnePass0 + 2 * kMaxOnePassTiles;
constexpr int kNumKernels = kTwoPass0 + 2;
std::atomic<bool> g_opted_in[kMaxDevices][kNumKernels];

// Blocks a slice gets: about as many blocks in all as fit on the card at
// once, each with at least `min_tiles` q tiles when there are that many.
int blocks_per_slice(const DeviceState* st, int per_sm, int G, int tiles,
                     int min_tiles) {
  int b = per_sm * st->sms / G;
  const int most = (tiles + min_tiles - 1) / min_tiles;
  if (b > most) b = most;
  return b < 1 ? 1 : b;
}

// Blocks of a kernel an SM holds, read once per (device, kernel).
std::atomic<int> g_per_sm[kMaxDevices][kNumKernels];

template <typename Kernel>
int launch_tc(Kernel kernel, int id, const TcParams& p, int G, int threads,
              size_t smem, int min_tiles, DeviceState* st,
              cudaStream_t stream) {
  int rc = opt_in_smem(st, &g_opted_in[device_index(st)][id], kernel);
  if (rc != 0) return rc;
  std::atomic<int>& cached = g_per_sm[device_index(st)][id];
  int per_sm = cached.load(std::memory_order_relaxed);
  if (per_sm == 0) {
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, smem);
    if (rc != 0) return rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached.store(per_sm, std::memory_order_relaxed);
  }
  const dim3 grid(blocks_per_slice(st, per_sm, G, p.tiles, min_tiles), G);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Passes the tensor-core route takes for these sizes: 1 while the logits
// row fits the registers (M <= 320; M <= 256 at d > 64), else 2.
int planned_passes(int M, int d) {
  const int nt = (M + 63) / 64;
  return nt <= (d <= 64 ? kMaxOnePassTiles : kMaxOnePassTiles - 1) ? 1 : 2;
}

template <int NT, int PN>
int launch_onepass(const TcParams& p, int G, DeviceState* st,
                   cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)2 * PN * NT * kTileBytes +
                      (size_t)kOnePassWgs * 2 * PN * kTileBytes;
  if (smem > (size_t)st->smem_optin) return (int)cudaErrorInvalidValue;
  return launch_tc(sr_fwd_onepass<NT, PN>, kOnePass0 + 2 * (NT - 1) + PN - 1,
                   p, G, kOnePassWgs * kWgThreads, smem, 2 * kOnePassWgs, st,
                   stream);
}

template <int PN>
int launch_onepass_pn(const TcParams& p, int G, int nt, DeviceState* st,
                      cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_onepass<1, PN>(p, G, st, stream);
    case 2: return launch_onepass<2, PN>(p, G, st, stream);
    case 3: return launch_onepass<3, PN>(p, G, st, stream);
    case 4: return launch_onepass<4, PN>(p, G, st, stream);
    default: break;
  }
  if constexpr (PN == 1) return launch_onepass<5, 1>(p, G, st, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const Problem& pr, DeviceState* st, cudaStream_t stream) {
  constexpr int id = sizeof(T) == sizeof(float) ? kScalarF32 : kScalarBf16;
  const int rc = opt_in_smem(st, &g_opted_in[device_index(st)][id],
                             sr_attention_fwd_kernel<T>);
  if (rc != 0) return rc;
  const int M = pr.M, d = pr.d;
  Params<T> p;
  fill<Params<T>, T>(p, pr);
  constexpr int n = Pack<T>::n;
  p.dq = (d + n - 1) / n * n;
  int words = (int)(p.dq * sizeof(T) / 4);
  if (words % 2 == 0) words += 1;  // odd word stride: conflict-free k reads
  p.ldk = (int)(words * 4 / sizeof(T));
  p.ldp = (M + 3) & ~3;

  const size_t fixed = (size_t)kRows * (p.ldp + p.dq) * sizeof(float);
  const size_t per_row = (size_t)(p.ldk + d) * sizeof(T);
  if ((size_t)st->smem_optin <= fixed + 4 * per_row)
    return (int)cudaErrorInvalidValue;
  const int fit = (int)((st->smem_optin - fixed) / per_row) & ~3;
  if (((M + 3) & ~3) <= fit) {
    p.chunk = M;
    p.buf_rows = (M + 3) & ~3;
  } else {
    p.chunk = fit;
    p.buf_rows = fit;
  }
  const size_t smem = fixed + (size_t)p.buf_rows * per_row;

  // Enough blocks for ~4 per SM across the G slices, each owning at most 8
  // groups of kRows q rows so that kv staging is amortised over them.
  const int groups = (pr.N + kRows - 1) / kRows;
  const int per_slice = (4 * st->sms + pr.G - 1) / pr.G;
  int groups_per_cta = (groups + per_slice - 1) / per_slice;
  groups_per_cta = groups_per_cta < 1 ? 1 : (groups_per_cta > 8 ? 8 : groups_per_cta);
  p.rows_per_cta = groups_per_cta * kRows;
  const dim3 grid((pr.N + p.rows_per_cta - 1) / p.rows_per_cta, pr.G);
  sr_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool valid_sizes(int B, int H, int N, int M, int d) {
  return B > 0 && H > 0 && (long long)B * H <= 65535 && N > 0 && M > 0 &&
         M <= kMaxM && d > 0 && d <= kMaxD;
}

Problem make_problem(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int N, int M, int d,
                     const long long* strides, float scale) {
  Problem pr;
  pr.q = q;
  pr.k = k;
  pr.v = v;
  pr.out = out;
  Layout* layouts[4] = {&pr.lq, &pr.lk, &pr.lv, &pr.lo};
  for (int i = 0; i < 4; ++i)
    *layouts[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  pr.G = B * H;
  pr.H = H;
  pr.N = N;
  pr.M = M;
  pr.d = d;
  pr.scale = scale;
  return pr;
}

}  // namespace

// The scalar route. dtype: 0 = float32, 1 = bfloat16. q/out: (B, H, N, d);
// k/v: (B, H, M, d), on the current device, each with unit stride along d.
// `strides` holds 12 element strides: (batch, head, row) of q, k, v and
// out, in that order. Returns a cudaError_t code (0 = launched).
extern "C" int sr_attention_fwd(const void* q, const void* k, const void* v,
                                void* out, int B, int H, int N, int M, int d,
                                const long long* strides, float scale,
                                int dtype, void* stream) {
  if (!valid_sizes(B, H, N, M, d)) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear an earlier non-sticky error: report our own
  DeviceState* st = nullptr;
  const int rc = current_device(&st);
  if (rc != 0) return rc;
  const Problem pr = make_problem(q, k, v, out, B, H, N, M, d, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(pr, st, s);
  if (dtype == 1) return launch<__nv_bfloat16>(pr, st, s);
  return (int)cudaErrorInvalidValue;
}

// Passes the tensor-core route plans for (M, d): 1 or 2.
extern "C" int sr_attention_fwd_tc_passes(int M, int d) {
  return planned_passes(M, d);
}

// The tensor-core route: bf16, d % 8 == 0, every row of q, k, v, out
// 16-byte aligned (base and strides). Layouts as `sr_attention_fwd`. `lse`:
// (B * H, N) fp32, each row's logsumexp in base 2 of the scaled logits, or
// null.
// `passes`: 0 = planned, 1 = one pass (an error where the row does not fit),
// 2 = two passes.
extern "C" int sr_attention_fwd_tc(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int H, int N,
                                   int M, int d, const long long* strides,
                                   float scale, int passes, void* stream) {
  if (!valid_sizes(B, H, N, M, d) || d % 8 != 0 || passes < 0 || passes > 2)
    return (int)cudaErrorInvalidValue;
  const Problem pr = make_problem(q, k, v, out, B, H, N, M, d, strides, scale);
  const Layout* ls[4] = {&pr.lq, &pr.lk, &pr.lv, &pr.lo};
  const void* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i)
    if (!rows_aligned16(ptrs[i], ls[i]->b, ls[i]->h, ls[i]->row))
      return (int)cudaErrorMisalignedAddress;
  cudaGetLastError();
  DeviceState* st = nullptr;
  const int rc = current_device(&st);
  if (rc != 0) return rc;
  TcParams p;
  fill<TcParams, bf16>(p, pr);
  p.lse = static_cast<float*>(lse);
  p.tiles = (N + 63) / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 0) passes = planned_passes(M, d);
  const int nt = (M + 63) / 64;
  if (passes == 1) {
    if (planned_passes(M, d) != 1) return (int)cudaErrorInvalidValue;
    return d <= 64 ? launch_onepass_pn<1>(p, pr.G, nt, st, s)
                   : launch_onepass_pn<2>(p, pr.G, nt, st, s);
  }
  const size_t smem = 1024 + (size_t)6 * (d <= 64 ? 1 : 2) * kTileBytes;
  return d <= 64 ? launch_tc(sr_fwd_twopass<1>, kTwoPass0, p, pr.G, kWgThreads,
                             smem, 1, st, s)
                 : launch_tc(sr_fwd_twopass<2>, kTwoPass0 + 1, p, pr.G,
                             kWgThreads, smem, 1, st, s);
}

extern "C" const char* sr_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
