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
// accumulated in fp32; the output rounded to the input dtype.
//
// What bounds it on the H100: the (N, M) probs never reach device memory,
// so the only device-memory traffic is q and out (G*N*d each) plus k and v
// (G*M*d each, re-read from L2 by every block of a slice). At the flagship
// shapes (M = 300, d = 64) that is ~2 bytes read and written per 300
// multiply-adds of each q row: memory-bound on q/out/kv in principle, and in
// practice bounded by the on-chip work: the products (on tensor cores in
// bf16) and the exps of the softmax.
//
// What the design does about it (two kernels; the C entry picks one):
//   * bf16 where k and v^T of a slice fit in shared memory (all flagship
//     shapes): `sr_attention_fwd_mma_kernel`, tensor cores (mma.sync
//     m16n8k16, fp32 accumulation) with the logits kept in registers and
//     recomputed per softmax pass; see its own note below.
//   * fp32, and bf16 with a large M*d: `sr_attention_fwd_kernel`, scalar
//     fp32 FMAs from shared memory, described by the rest of this list.
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

#include "sr_attention_common.cuh"

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
// bf16 on the tensor cores: mma.sync m16n8k16, bf16 inputs, fp32
// accumulation. Used when k and v^T of a slice fit in shared memory (the
// flagship shapes); the kernel above takes the rest.
//
// Each warp owns 16 q rows at a time, with its q fragments in registers.
// The logits of a 16-column tile are an mma accumulator; they never leave
// registers. Three passes over the kv columns recompute them (the products
// are cheap on tensor cores; shared memory for a (rows, M) fp32 buffer is
// not): pass 1 the row max, pass 2 the row sum of exp, pass 3 p = exp / sum
// rounded to bf16, which is already laid out as the A fragment of the
// p @ v mma. Warps never synchronise after k and v^T are staged.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaRows = kMmaWarps * 16;  // q rows of one pass of the warps
constexpr int kNoFit = -1;                // launch_mma: use the other kernel

struct MmaParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  Layout lq, lk, lv, lo;
  int H, N, M, d;
  int mp;            // M rounded up to 16 (zero rows in k and v^T)
  int ldk;           // k row stride: padded head dim + 8 (conflict-free)
  int ldvt;          // v^T row stride: mp + 8 (conflict-free)
  int rows_per_cta;
  float scale;
};

// Logits * scale of the warp's 16 rows x kv columns [16j, 16j + 16) as two
// 16x8 accumulators; columns >= M are -inf (probability exactly 0).
// Thread (gq, tq) holds rows gq and gq + 8, columns 2tq and 2tq + 1 of each.
template <int KS>
__device__ __forceinline__ void logits_tile(const uint32_t (&qa)[KS][4],
                                            const __nv_bfloat16* K_s,
                                            const MmaParams& p, int j, int gq,
                                            int tq, float (&s)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
    const __nv_bfloat16* kr = K_s + (j * 16 + h * 8 + gq) * p.ldk + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
      mma16816(s[h], qa[kk], b0, b1);
    }
    const int c = j * 16 + h * 8 + 2 * tq;
    s[h][0] = c < p.M ? s[h][0] * p.scale : -INFINITY;
    s[h][1] = c + 1 < p.M ? s[h][1] * p.scale : -INFINITY;
    s[h][2] = c < p.M ? s[h][2] * p.scale : -INFINITY;
    s[h][3] = c + 1 < p.M ? s[h][3] * p.scale : -INFINITY;
  }
}

template <int KS>  // KS = padded head dim / 16
__global__ void __launch_bounds__(kMmaWarps * 32)
    sr_attention_fwd_mma_kernel(const MmaParams p) {
  constexpr int DP = KS * 16;
  constexpr int DT = DP / 8;  // 8-wide output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* K_s = reinterpret_cast<__nv_bfloat16*>(smem);  // (mp, ldk)
  __nv_bfloat16* Vt_s = K_s + p.mp * p.ldk;                      // (DP, ldvt)

  const int g = blockIdx.y;
  const __nv_bfloat16* qg = slice(p.q, p.lq, g, p.H);
  const __nv_bfloat16* kg = slice(p.k, p.lk, g, p.H);
  const __nv_bfloat16* vg = slice(p.v, p.lv, g, p.H);
  __nv_bfloat16* og = slice(p.out, p.lo, g, p.H);

  // Stage k row-major and v transposed, zero-padded to (mp, DP).
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < p.mp * DP; i += blockDim.x) {
    const int m = i / DP;
    const int e = i - m * DP;
    const bool in = m < p.M && e < p.d;
    K_s[m * p.ldk + e] = in ? kg[m * p.lk.row + e] : zero;
    Vt_s[e * p.ldvt + m] = in ? vg[m * p.lv.row + e] : zero;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // mma group: rows gq and gq + 8
  const int tq = lane & 3;   // thread in group: columns 2tq, 2tq + 1
  const int ktiles = p.mp / 16;
  const int row_begin = blockIdx.x * p.rows_per_cta;
  const int row_end = min(row_begin + p.rows_per_cta, p.N);

  for (int r0 = row_begin + warp * 16; r0 < row_end; r0 += kMmaRows) {
    const int ra = r0 + gq;
    const int rb = ra + 8;
    uint32_t qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + 2 * tq;
      qa[kk][0] = load_pair(qg, p.lq.row, ra, c, p.N, p.d);
      qa[kk][1] = load_pair(qg, p.lq.row, rb, c, p.N, p.d);
      qa[kk][2] = load_pair(qg, p.lq.row, ra, c + 8, p.N, p.d);
      qa[kk][3] = load_pair(qg, p.lq.row, rb, c + 8, p.N, p.d);
    }

    float mx[2] = {-INFINITY, -INFINITY};
    for (int j = 0; j < ktiles; ++j) {
      float s[2][4];
      logits_tile<KS>(qa, K_s, p, j, gq, tq, s);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[0] = fmaxf(mx[0], fmaxf(s[h][0], s[h][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[h][2], s[h][3]));
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);

    float sum[2] = {0.f, 0.f};
    for (int j = 0; j < ktiles; ++j) {
      float s[2][4];
      logits_tile<KS>(qa, K_s, p, j, gq, tq, s);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[0] += expf(s[h][0] - mx[0]) + expf(s[h][1] - mx[0]);
        sum[1] += expf(s[h][2] - mx[1]) + expf(s[h][3] - mx[1]);
      }
    }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);

    float o[DT][4];
#pragma unroll
    for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    for (int j = 0; j < ktiles; ++j) {
      float s[2][4];
      logits_tile<KS>(qa, K_s, p, j, gq, tq, s);
      // p = exp / sum in fp32, then rounded to bf16: the A fragment of p @ v.
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pa[2 * h] = pack_bf16(expf(s[h][0] - mx[0]) / sum[0],
                              expf(s[h][1] - mx[0]) / sum[0]);
        pa[2 * h + 1] = pack_bf16(expf(s[h][2] - mx[1]) / sum[1],
                                  expf(s[h][3] - mx[1]) / sum[1]);
      }
      const __nv_bfloat16* vr = Vt_s + gq * p.ldvt + j * 16 + 2 * tq;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const __nv_bfloat16* vt = vr + t * 8 * p.ldvt;
        mma16816(o[t], pa, *reinterpret_cast<const uint32_t*>(vt),
                 *reinterpret_cast<const uint32_t*>(vt + 8));
      }
    }

#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int c = t * 8 + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? rb : ra;
        if (row < row_end) {
          __nv_bfloat16* dst = og + row * p.lo.row;
          if (c < p.d) dst[c] = __float2bfloat16_rn(o[t][2 * half]);
          if (c + 1 < p.d) dst[c + 1] = __float2bfloat16_rn(o[t][2 * half + 1]);
        }
      }
    }
  }
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

enum KernelId { kScalarF32, kScalarBf16, kMma2, kMma4, kMma8, kNumKernels };
std::atomic<bool> g_opted_in[kMaxDevices][kNumKernels];

template <int KS>
int launch_mma_ks(MmaParams p, int G, size_t smem, DeviceState* st,
                  cudaStream_t stream) {
  constexpr KernelId id = KS == 2 ? kMma2 : (KS == 4 ? kMma4 : kMma8);
  const int rc = opt_in_smem(st, &g_opted_in[device_index(st)][id],
                             sr_attention_fwd_mma_kernel<KS>);
  if (rc != 0) return rc;
  // ~4 blocks per SM across the G slices, at most 8 passes of the warps each.
  const int groups = (p.N + kMmaRows - 1) / kMmaRows;
  const int per_slice = (4 * st->sms + G - 1) / G;
  int gpc = (groups + per_slice - 1) / per_slice;
  gpc = gpc < 1 ? 1 : (gpc > 8 ? 8 : gpc);
  p.rows_per_cta = gpc * kMmaRows;
  const dim3 grid((p.N + p.rows_per_cta - 1) / p.rows_per_cta, G);
  sr_attention_fwd_mma_kernel<KS><<<grid, kMmaWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches the tensor-core kernel, or returns kNoFit when k and v^T of a
// slice do not fit in shared memory.
int launch_mma(const Problem& pr, DeviceState* st, cudaStream_t stream) {
  const int ks = pr.d <= 32 ? 2 : (pr.d <= 64 ? 4 : 8);
  MmaParams p;
  fill<MmaParams, __nv_bfloat16>(p, pr);
  p.mp = (pr.M + 15) & ~15;
  p.ldk = ks * 16 + 8;
  p.ldvt = p.mp + 8;
  p.rows_per_cta = 0;
  const size_t smem =
      ((size_t)p.mp * p.ldk + (size_t)ks * 16 * p.ldvt) * sizeof(__nv_bfloat16);
  if (smem > (size_t)st->smem_optin) return kNoFit;
  if (ks == 2) return launch_mma_ks<2>(p, pr.G, smem, st, stream);
  if (ks == 4) return launch_mma_ks<4>(p, pr.G, smem, st, stream);
  return launch_mma_ks<8>(p, pr.G, smem, st, stream);
}

template <typename T>
int launch(const Problem& pr, DeviceState* st, cudaStream_t stream) {
  constexpr KernelId id =
      sizeof(T) == sizeof(float) ? kScalarF32 : kScalarBf16;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out: (B, H, N, d); k/v: (B, H, M, d),
// on the current device, each with unit stride along d. `strides` holds 12
// element strides: (batch, head, row) of q, k, v and out, in that order.
// Returns a cudaError_t code (0 = launched).
extern "C" int sr_attention_fwd(const void* q, const void* k, const void* v,
                                void* out, int B, int H, int N, int M, int d,
                                const long long* strides, float scale,
                                int dtype, void* stream) {
  if (B <= 0 || H <= 0 || (long long)B * H > 65535 || N <= 0 || M <= 0 ||
      M > kMaxM || d <= 0 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear an earlier non-sticky error: report our own
  DeviceState* st = nullptr;
  const int rc = current_device(&st);
  if (rc != 0) return rc;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(pr, st, s);
  if (dtype == 1) {
    const int mma = launch_mma(pr, st, s);
    if (mma != kNoFit) return mma;
    return launch<__nv_bfloat16>(pr, st, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sr_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
