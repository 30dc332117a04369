// Window attention backward (Swin W-MSA / SW-MSA) for Hopper (sm_90a).
//
// Replaces the TPU kernel rgbx_semantic_segmentation_tpu/ops/
// window_attention.py `_bwd_kernel` (launched by `_wbwd_call`, the VJP of
// `window_attention`). Residual: qkv, bias and the dropout seed only. For
// every (image b, window w, head i), with g the output's cotangent:
//
//     pf, p, pd, keep   recomputed as in the forward (window_attention_fwd.cu)
//     dv  = pd^T g
//     dp  = g v^T, then keep ? dp / (1 - rate) : 0
//     dl  = (dp - rowsum(dp * pf)) * pf        with the UNROUNDED fp32 pf
//     db[w, i] += dl                           fp32, unscaled, over the batch
//     dlf = T(dl * scale)
//     dq  = dlf k,  dk = dlf^T q
//
// dq, dk, dv land in one tensor in the qkv layout (B, Hp, Wp, 3C), channels
// in (3, h, d) order.
//
// What bounds it on the H100: bytes (qkv, g and the bias read once, dqkv and
// db written once), as the forward.
//
// What the design does about it. As in the forward, issue slots bind more
// than bytes (Philox, exps, the softmax's and dl's elementwise work), so
// the design keeps copies in flight and the card filled.
//   * db is a sum over the batch. The TPU kernel makes the batch its
//     sequential grid axis and accumulates in scratch memory; CUDA blocks run
//     in no order. Here one block owns a unit (w, i), walks all B images of
//     it and keeps the unit's db tile in registers, written once at the end
//     (the scalar kernel: its threads own their elements of the block). No
//     atomics, no workspace: the same bits every run. Splitting a unit's
//     images over a thread-block cluster that sums db through distributed
//     shared memory measured 13-86% slower a swin_s step at batch 8 (PERF.md
//     section 6): a block's own cost (its first copy, the bias, the zeroed
//     tiles, the sum) outweighs the waves it saves.
//   * bf16, d a multiple of 8 up to 64, N <= 56 (window 7):
//     `window_attention_bwd_tc`, 4 warps. q, k, v, g of the next image
//     arrive by 16-byte cp.async in a two-stage ring while the current one
//     is computed; the unit's bias block is staged once a block (as N
//     rows of 56 columns, -inf past N: padding needs no masks), and the
//     window's pixel offsets are computed once. Per image: phase 1, a warp
//     per 16 query rows: pf, pd, dp, dl in mma accumulator registers; dl adds
//     into the warp's db registers; dq = dlf k with dlf straight from the
//     registers as the A operand; pd and dlf also go to shared memory.
//     Phase 2, a warp per 16 keys: dv = pd^T g and dk = dlf^T q, the
//     transposed A fragments and the B fragments both out of ldmatrix.trans.
//     The three output tiles go back through the staged q, k, v rows and
//     leave in 16-byte stores.
//   * fp32 and every other shape up to N = 256, d = 128:
//     `window_attention_bwd_scalar_kernel`: phase A a warp per query row
//     (row statistics, db, dq), phase B a warp per key (the column of pd and
//     dlf recomputed from the statistics, then dv and dk).
//
// Interface: plain C, loaded with ctypes; the launch goes on the caller's
// stream and the function returns cudaGetLastError() after it.

#include "window_attention_common.cuh"

namespace {

constexpr int kMmaWarps = 4;
constexpr int kNT = 7;                // 8-wide key tiles: N <= 56
constexpr int kRows = kMmaWarps * 16;  // one 16-row tile per warp
constexpr int kLdp = kRows + 8;        // pd, dlf: (query row, key) rows
template <int KS>
constexpr int kLd = KS * 16 + 8;

// Dynamic shared memory of the tensor-core kernel: the window's pixels, the
// staged bias block, a ring of two (q, k, v, g) stages and the pd and dlf
// tiles.
template <int KS>
constexpr size_t kBwdSmem =
    (size_t)kRows * sizeof(int) + kBiasBytes<kNT> +
    ((size_t)2 * 4 * kRows * kLd<KS> + (size_t)2 * kRows * kLdp) *
        sizeof(__nv_bfloat16);

// One block a unit (window, head), walking all B images of it with the
// unit's db tile in registers.
template <int KS>  // padded head dim / 16
__global__ void __launch_bounds__(kMmaWarps * 32)
    window_attention_bwd_tc(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const __nv_bfloat16* __restrict__ gout,
                            __nv_bfloat16* __restrict__ dqkv,
                            float* __restrict__ db,
                            const long long* __restrict__ seed, const Window g,
                            Dropout dr) {
  constexpr int NT = kNT;
  constexpr int DP = KS * 16;
  constexpr int DT = DP / 8;
  constexpr int LD = kLd<KS>;
  constexpr int LDP = kLdp;
  constexpr int TILE = kRows * LD;  // elements of one staged tile
  static_assert(NT * 8 <= kRows, "one row tile per warp covers all keys");
  extern __shared__ __align__(16) unsigned char smem[];
  int* pix = reinterpret_cast<int*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + kRows * sizeof(int));
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(
      smem + kRows * sizeof(int) + kBiasBytes<NT>);
  __nv_bfloat16* Pd = ring + 2 * 4 * TILE;
  __nv_bfloat16* Dl = Pd + kRows * LDP;

  const int unit = blockIdx.x;
  const int w = unit / g.h;
  const int head = unit - w * g.h;
  const int C = g.h * g.d;
  const long long image = (long long)g.Hp * g.Wp;  // pixels an image
  load_seed(dr, seed);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int ra = warp * 16 + gq, rb = ra + 8;

  // Key columns [NT*8, kRows) of pd and dlf are never written: zero both
  // tiles once (two bf16 a word). The unit's bias block serves every image:
  // it is staged once, with the first image.
  for (int i = threadIdx.x; i < kRows * LDP; i += blockDim.x)
    reinterpret_cast<uint32_t*>(Pd)[i] = 0u;
  window_pixels(pix, g, w, kRows);
  stage_bias_async<kBiasLd<NT>>(Bs, bias_block(bias, g, w, head), g.N);
  __syncthreads();  // pix

  // Image b: q, k, v, g into ring stage b % 2, one commit group.
  auto stage = [&](int b) {
    const long long px = b * image;
    const __nv_bfloat16* src = qkv + px * 3 * C + head * g.d;
    const uint32_t dst = smem_u32(ring + (b & 1) * 4 * TILE);
    stage_tile_async<DP>(dst, LD, src, 3 * C, pix, g.d, kRows);
    stage_tile_async<DP>(dst + TILE * 2, LD, src + C, 3 * C, pix, g.d, kRows);
    stage_tile_async<DP>(dst + TILE * 4, LD, src + 2 * C, 3 * C, pix, g.d,
                         kRows);
    stage_tile_async<DP>(dst + TILE * 6, LD, gout + px * C + head * g.d, C,
                         pix, g.d, kRows);
    cp_async_commit();
  };
  stage(0);  // with the bias block

  float dbacc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
    dbacc[t][0] = dbacc[t][1] = dbacc[t][2] = dbacc[t][3] = 0.f;

  for (int b = 0; b < g.B; ++b) {
    // Image b has landed, and every thread is done with image b - 1, whose
    // stage the copy of image b + 1 now refills under image b's compute.
    cp_async_wait<0>();
    __syncthreads();
    if (b + 1 < g.B) stage(b + 1);
    __nv_bfloat16* Qs = ring + (b & 1) * 4 * TILE;
    __nv_bfloat16* Ks = Qs + TILE;
    __nv_bfloat16* Vs = Ks + TILE;
    const __nv_bfloat16* Gs = Vs + TILE;

    // Phase 1: this warp's 16 query rows against all keys. Padding needs no
    // masks: q, g rows >= N and v rows >= N are zero and the bias is -inf
    // in columns >= N, so pf and dp vanish in columns >= N, and dp, delta,
    // dl in rows >= N; pd of a row >= N meets only zero g rows.
    float dq[DT][4];
    {
      float s[NT][4], dp[NT][4];
      probs_tile<KS, NT>(Qs, Ks, LD, Bs, g, warp, gq, tq, s);
      rows_times_rows<KS, NT>(Gs, Vs, LD, warp, gq, tq, dp);
      float delta[2] = {0.f, 0.f};
      uint32_t pdk[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bits[4] = {0u, 0u, 0u, 0u};
        if (dr.on) dropout_bits(dr, t * 4 + tq, warp * 8 + gq, unit, b, bits);
        bool keep[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          keep[e] = !dr.on || bits[e] >= dr.thr;
          float x = keep[e] ? dp[t][e] : 0.f;
          if (dr.on) x *= dr.inv_keep;
          dp[t][e] = x;
          delta[e >> 1] += x * s[t][e];
        }
        pdk[t][0] = dropped_pair(s[t][0], s[t][1], keep[0], keep[1], dr);
        pdk[t][1] = dropped_pair(s[t][2], s[t][3], keep[2], keep[3], dr);
      }
      delta[0] = quad_sum(delta[0]);
      delta[1] = quad_sum(delta[1]);
      uint32_t dlk[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float dlf[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dl = (dp[t][e] - delta[e >> 1]) * s[t][e];
          dbacc[t][e] += dl;
          dlf[e] = dl * g.scale;
        }
        dlk[t][0] = pack_bf16(dlf[0], dlf[1]);
        dlk[t][1] = pack_bf16(dlf[2], dlf[3]);
        const int c = t * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(Pd + ra * LDP + c) = pdk[t][0];
        *reinterpret_cast<uint32_t*>(Pd + rb * LDP + c) = pdk[t][1];
        *reinterpret_cast<uint32_t*>(Dl + ra * LDP + c) = dlk[t][0];
        *reinterpret_cast<uint32_t*>(Dl + rb * LDP + c) = dlk[t][1];
      }
#pragma unroll
      for (int u = 0; u < DT; ++u)
        dq[u][0] = dq[u][1] = dq[u][2] = dq[u][3] = 0.f;
      acc_tile_times<NT, DT>(dlk, Ks, LD, lane, dq);
    }
    __syncthreads();

    // Phase 2: this warp's 16 keys, contracting over all query rows.
    float dv[DT][4], dk[DT][4];
#pragma unroll
    for (int u = 0; u < DT; ++u) {
      dv[u][0] = dv[u][1] = dv[u][2] = dv[u][3] = 0.f;
      dk[u][0] = dk[u][1] = dk[u][2] = dk[u][3] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMmaWarps; ++j) {
      // A = (pd^T, dlf^T)[keys warp*16 .. +16][rows j*16 .. +16], read
      // transposed from the (row, key) tiles.
      const int arow = j * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
      const int acol = warp * 16 + ((lane >> 3) & 1) * 8;
      uint32_t ap[4], ad[4];
      ldmatrix_x4_trans(ap, Pd + arow * LDP + acol);
      ldmatrix_x4_trans(ad, Dl + arow * LDP + acol);
      const int brow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int u = 0; u < DT; u += 2) {
        uint32_t bg[4], bq[4];
        ldmatrix_x4_trans(bg, Gs + brow * LD + (u + (lane >> 4)) * 8);
        ldmatrix_x4_trans(bq, Qs + brow * LD + (u + (lane >> 4)) * 8);
        mma16816(dv[u], ap, bg[0], bg[1]);
        mma16816(dv[u + 1], ap, bg[2], bg[3]);
        mma16816(dk[u], ad, bq[0], bq[1]);
        mma16816(dk[u + 1], ad, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every read of this stage's tiles is done

    // dq, dk, dv through this warp's rows of the q, k, v tiles to the image.
    store_acc<DT>(Qs, LD, warp * 16, gq, tq, dq);
    store_acc<DT>(Ks, LD, warp * 16, gq, tq, dk);
    store_acc<DT>(Vs, LD, warp * 16, gq, tq, dv);
    __syncwarp();
    __nv_bfloat16* dst = dqkv + b * image * 3 * C + head * g.d;
    unstage_rows<DP>(dst, 3 * C, Qs, LD, pix, g.d, warp * 16, lane);
    unstage_rows<DP>(dst + C, 3 * C, Ks, LD, pix, g.d, warp * 16, lane);
    unstage_rows<DP>(dst + 2 * C, 3 * C, Vs, LD, pix, g.d, warp * 16, lane);
  }

  float* dbu = db + (long long)unit * g.N * g.N;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? ra : rb;
      const int col = t * 8 + 2 * tq + (e & 1);
      if (row < g.N && col < g.N) dbu[row * g.N + col] = dbacc[t][e];
    }
  }
}

// ---------------------------------------------------------------------------
// Scalar kernel: any T, N <= 256, d <= 128. One block per unit (w, i), looping
// over the images. The logits expression repeats the forward's scalar kernel
// term for term, in both phases, so pf has the same bits everywhere.
// ---------------------------------------------------------------------------

constexpr int kScalarWarps = 8;
constexpr int kColsPerLane = kWinMaxN / 32;
constexpr int kDimsPerLane = kWinMaxD / 32;

template <typename T>
__global__ void __launch_bounds__(kScalarWarps * 32)
    window_attention_bwd_scalar_kernel(const T* __restrict__ qkv,
                                       const float* __restrict__ bias,
                                       const T* __restrict__ gout,
                                       T* __restrict__ dqkv,
                                       float* __restrict__ db,
                                       const long long* __restrict__ seed,
                                       const Window g, Dropout dr) {
  __shared__ long long pix[kWinMaxN];
  __shared__ float stats[kWinMaxN][3];  // row max, 1 / row sum of exp, delta
  __shared__ float a_s[kScalarWarps][kWinMaxD];  // q row (A), k row (B)
  __shared__ float b_s[kScalarWarps][kWinMaxD];  // g row (A), v row (B)
  __shared__ float p_s[kScalarWarps][kWinMaxN];  // pd column (B)
  __shared__ float l_s[kScalarWarps][kWinMaxN];  // dlf row (A), column (B)

  const int unit = blockIdx.x;
  const int w = unit / g.h;
  const int head = unit - w * g.h;
  const int C = g.h * g.d;
  const int N = g.N, d = g.d;
  load_seed(dr, seed);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* qh = qkv + head * d;
  const T* kh = qh + C;
  const T* vh = qh + 2 * C;
  const T* gh = gout + head * d;
  T* dqh = dqkv + head * d;
  const float* bb = bias_block(bias, g, w, head);
  float* dbu = db + (long long)unit * N * N;

  for (int b = 0; b < g.B; ++b) {
    __syncthreads();  // the previous image is done with pix and stats
    for (int t = threadIdx.x; t < N; t += blockDim.x)
      pix[t] = token_pixel(g, b, w, t);
    __syncthreads();

    // Phase A: a warp per query row; lane j owns keys j, j + 32, ...
    for (int row = warp; row < N; row += kScalarWarps) {
      for (int e = lane; e < d; e += 32) {
        a_s[warp][e] = to_float(qh[pix[row] * 3 * C + e]);
        b_s[warp][e] = to_float(gh[pix[row] * C + e]);
      }
      __syncwarp();
      float pf[kColsPerLane], dp[kColsPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int col = lane + 32 * j;
        pf[j] = -INFINITY;
        dp[j] = 0.f;
        if (col < N) {
          const T* kr = kh + pix[col] * 3 * C;
          const T* vr = vh + pix[col] * 3 * C;
          float acc = 0.f, acc2 = 0.f;
          for (int e = 0; e < d; ++e) {
            acc = fmaf(a_s[warp][e], to_float(kr[e]), acc);
            acc2 = fmaf(b_s[warp][e], to_float(vr[e]), acc2);
          }
          pf[j] = acc * g.scale + bb[row * N + col];
          dp[j] = acc2;
        }
        mx = fmaxf(mx, pf[j]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        pf[j] = lane + 32 * j < N ? expf(pf[j] - mx) : 0.f;
        sum += pf[j];
      }
      const float inv = 1.f / warp_sum(sum);
      float delta = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int col = lane + 32 * j;
        if (col < N) {
          pf[j] *= inv;
          if (dr.on) {
            const bool keep = dropout_bits_at(dr, row, col, unit, b) >= dr.thr;
            dp[j] = keep ? dp[j] * dr.inv_keep : 0.f;
          }
          delta += dp[j] * pf[j];
        }
      }
      delta = warp_sum(delta);
      if (lane == 0) {
        stats[row][0] = mx;
        stats[row][1] = inv;
        stats[row][2] = delta;
      }
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int col = lane + 32 * j;
        if (col < N) {
          const float dl = (dp[j] - delta) * pf[j];
          // This thread owns (row, col) of the unit's db block for every
          // image: a plain read-modify-write, in image order.
          float* p = dbu + row * N + col;
          *p = b == 0 ? dl : *p + dl;
          l_s[warp][col] = round_to<T>(dl * g.scale);
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kDimsPerLane; ++u) {
        const int e = lane + 32 * u;
        if (e < d) {
          float acc = 0.f;
          for (int col = 0; col < N; ++col)
            acc = fmaf(l_s[warp][col], to_float(kh[pix[col] * 3 * C + e]), acc);
          dqh[pix[row] * 3 * C + e] = from_float<T>(acc);
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // Phase B: a warp per key; lane j owns query rows j, j + 32, ...
    for (int col = warp; col < N; col += kScalarWarps) {
      for (int e = lane; e < d; e += 32) {
        a_s[warp][e] = to_float(kh[pix[col] * 3 * C + e]);
        b_s[warp][e] = to_float(vh[pix[col] * 3 * C + e]);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int row = lane + 32 * j;
        if (row < N) {
          const T* qr = qh + pix[row] * 3 * C;
          const T* gr = gh + pix[row] * C;
          float acc = 0.f, acc2 = 0.f;
          for (int e = 0; e < d; ++e) {
            acc = fmaf(to_float(qr[e]), a_s[warp][e], acc);
            acc2 = fmaf(to_float(gr[e]), b_s[warp][e], acc2);
          }
          const float l = acc * g.scale + bb[row * N + col];
          const float pf = expf(l - stats[row][0]) * stats[row][1];
          const bool keep =
              !dr.on || dropout_bits_at(dr, row, col, unit, b) >= dr.thr;
          p_s[warp][row] = dropped_prob<T>(pf, keep, dr);
          float dp = acc2;
          if (dr.on) dp = keep ? dp * dr.inv_keep : 0.f;
          const float dl = (dp - stats[row][2]) * pf;
          l_s[warp][row] = round_to<T>(dl * g.scale);
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kDimsPerLane; ++u) {
        const int e = lane + 32 * u;
        if (e < d) {
          float dv = 0.f, dk = 0.f;
          for (int row = 0; row < N; ++row) {
            dv = fmaf(p_s[warp][row], to_float(gh[pix[row] * C + e]), dv);
            dk = fmaf(l_s[warp][row], to_float(qh[pix[row] * 3 * C + e]), dk);
          }
          dqh[pix[col] * 3 * C + C + e] = from_float<T>(dk);
          dqh[pix[col] * 3 * C + 2 * C + e] = from_float<T>(dv);
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum KernelId { kTc2, kTc4, kNumKernels };
std::atomic<bool> g_opted_in[kMaxDevices][kNumKernels];

// The tensor-core route: one block a unit.
template <int KS>
int launch_tc(KernelId id, const void* qkv, const float* bias,
              const void* gout, void* dqkv, float* db, const long long* seed,
              const Window& g, const Dropout& dr, int units, DeviceState* st,
              cudaStream_t stream) {
  constexpr size_t smem = kBwdSmem<KS>;
  const int rc = opt_in_smem(st, &g_opted_in[device_index(st)][id],
                             window_attention_bwd_tc<KS>);
  if (rc != 0) return rc;
  window_attention_bwd_tc<KS><<<units, kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), bias,
      static_cast<const __nv_bfloat16*>(gout),
      static_cast<__nv_bfloat16*>(dqkv), db, seed, g, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scalar(const void* qkv, const float* bias, const void* gout,
                  void* dqkv, float* db, const long long* seed,
                  const Window& g, const Dropout& dr, int units,
                  cudaStream_t stream) {
  window_attention_bwd_scalar_kernel<T>
      <<<units, kScalarWarps * 32, 0, stream>>>(
          static_cast<const T*>(qkv), bias, static_cast<const T*>(gout),
          static_cast<T*>(dqkv), db, seed, g, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of window_attention_fwd, plus g: the output's cotangent
// (B, Hp, Wp, h * d) contiguous in qkv's type; dqkv: (B, Hp, Wp, 3 * h * d)
// contiguous, every element written; db: fp32 (nW, h, ws^2, ws^2)
// contiguous, every element written. Returns a cudaError_t code.
extern "C" int window_attention_bwd(const void* qkv, const float* bias,
                                    const void* g, void* dqkv, float* db,
                                    const long long* seed, int B, int Hp,
                                    int Wp, int h, int d, int ws,
                                    long long bias_w_stride, float scale,
                                    float inv_keep, unsigned int thr,
                                    int dropout, int dtype, void* stream) {
  if (B <= 0 || h <= 0 || d <= 0 || d > kWinMaxD || ws <= 0 ||
      ws * ws > kWinMaxN || Hp <= 0 || Wp <= 0 || Hp % ws || Wp % ws)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear an earlier non-sticky error: report our own
  DeviceState* st = nullptr;
  const int rc = current_device(&st);
  if (rc != 0) return rc;
  Window win;
  win.B = B;
  win.Hp = Hp;
  win.Wp = Wp;
  win.h = h;
  win.d = d;
  win.ws = ws;
  win.N = ws * ws;
  win.nWj = Wp / ws;
  win.nW = (Hp / ws) * win.nWj;
  win.bias_w = bias_w_stride;
  win.scale = scale;
  Dropout dr;
  dr.k0 = dr.k1 = 0u;
  dr.thr = thr;
  dr.inv_keep = inv_keep;
  dr.on = dropout;
  const long long units = (long long)win.nW * h;
  if (units > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d % 8 == 0 && d <= 64 && win.N <= kNT * 8) {
    if (d <= 32)
      return launch_tc<2>(kTc2, qkv, bias, g, dqkv, db, seed, win, dr,
                          (int)units, st, s);
    return launch_tc<4>(kTc4, qkv, bias, g, dqkv, db, seed, win, dr,
                        (int)units, st, s);
  }
  if (dtype == 1)
    return launch_scalar<__nv_bfloat16>(qkv, bias, g, dqkv, db, seed, win, dr,
                                        (int)units, s);
  if (dtype == 0)
    return launch_scalar<float>(qkv, bias, g, dqkv, db, seed, win, dr,
                                (int)units, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* window_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
