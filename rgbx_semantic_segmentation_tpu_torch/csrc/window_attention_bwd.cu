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
//     in no order. Here, for N <= 56, one block owns a unit (w, i), walks
//     all B images of it and keeps the unit's db tile in registers, written
//     once at the end (the scalar kernel: its threads own their elements of
//     the block; the cluster kernel below: its blocks own row shares). No
//     atomics, no workspace: the same bits every run. For 7x7 windows,
//     splitting a unit's images over a thread-block cluster that sums db
//     through distributed shared memory measured 13-86% slower a swin_s step
//     at batch 8 (PERF.md section 6): a block's own cost (its first copy, the
//     bias, the zeroed tiles, the sum) outweighs the waves it saves.
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
//   * bf16, d a multiple of 8 up to 64, 56 < N <= 144 (window 12, swin_b):
//     `window_attention_bwd_cluster`. A unit-image is 8.6x the work of a
//     7x7 one and a unit alone no longer fills the card (192 units at
//     swin_b's stage 3 on 132 SMs), so a unit's work is split over a
//     thread-block cluster of 3 blocks. Block s owns query rows and keys
//     [48s, 48s + 48) and walks all B images with 6 warps: one (q, k, v, g)
//     stage, the next image's k and v copied in under phase 2, its q and g
//     after it. Phase 1, two warps a 16-row tile, each against 72 keys:
//     logits, softmax (the forward's expressions and row-sum order, the
//     first warp's running sums handed to the second, so pf has the
//     forward's bits), dp = g v^T (computed again in the second sweep
//     rather than held), keep bits, pd, dl; dl adds into the block's db
//     rows in shared memory (fp32, each element owned by one thread, image
//     after image), and pd and dlf go by st.shared::cluster into the
//     exchange tiles of the block that owns their keys; dq = dlf k, the two
//     warps' partials added in order. Phase 2, after a cluster barrier, two
//     warps a 16-key tile, half the head dim each: dv = pd^T g and
//     dk = dlf^T q over all 144 rows of the local exchange tiles
//     (ldmatrix.trans), in one block, in mma order. A thread's bias
//     elements stay in registers, read once (re-read every image from L2
//     they cost 40% of the time). No atomics, no workspace: the same bits
//     every run. Shared memory (108.5 KB) and registers (158-168) allow 2
//     blocks an SM. Splitting a unit's images over two such clusters too
//     (6 blocks, db summed through distributed shared memory) measured 1%
//     faster a swin_b step: 3.5% at stage 3, 8% slower at stages 2 and 4
//     (PERF.md section 6), so it is not done.
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
// Tensor-core kernel for 56 < N <= 144 (window 12): a cluster of kShares
// blocks a unit, each owning kShareRows query rows and as many keys.
// ---------------------------------------------------------------------------

constexpr int kWideNT = 18;                   // 8-wide key tiles: N <= 144
constexpr int kWideRows = kWideNT * 8;        // 9 tiles of 16 rows
constexpr int kShares = 3;                    // blocks (one cluster) a unit
constexpr int kShareTiles = kWideRows / 16 / kShares;  // 16-row tiles a block
constexpr int kShareRows = kShareTiles * 16;  // 48
constexpr int kClusterWarps = 2 * kShareTiles;  // two warps a row tile
constexpr int kHalfNT = kWideNT / 2;          // key tiles of a warp
constexpr int kTilesAShare = kShareRows / 8;  // 8-wide key tiles of a share
constexpr int kKRows = kWideRows + 8;         // k, v rows: the last pair's
                                              // second tile is zero
constexpr int kLdx = kShareRows + 8;          // pd, dlf: (row, key of the share)
constexpr int kLdb = kWideRows + 8;           // db rows, fp32, conflict-free
// Per row tile: the two warps' row maxima, the first warp's running sums
// (32 lanes x 2), the row inverses, the two warps' row deltas.
constexpr int kPairFloats = 2 * 16 + 64 + 16 + 2 * 16;

// Dynamic shared memory of the cluster kernel: the window's pixels, the
// block's fp32 db rows, one (q, k, v, g) stage, the pd and dlf tiles of all
// rows against the block's keys, and the row tiles' exchange of row
// statistics between their two warps.
template <int KS>
constexpr size_t kClusterSmem =
    (size_t)kKRows * sizeof(int) + (size_t)kShareRows * kLdb * sizeof(float) +
    ((size_t)2 * (kWideRows + kKRows) * kLd<KS> +
     (size_t)2 * kWideRows * kLdx) * sizeof(__nv_bfloat16) +
    (size_t)kShareTiles * kPairFloats * sizeof(float);

// Four 8x8 bf16 matrices from shared memory, as they lie: lane l gives the
// address of row l % 8 of matrix l / 8; r[m] then holds elements
// (lane / 4, 2 * (lane % 4)) and (lane / 4, 2 * (lane % 4) + 1) of matrix m,
// the B fragment of mma16816 for a row-major [n][k] tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of the same shared-memory offset in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// The two halves of a cluster barrier (release on arrive, acquire on wait):
// every thread of the cluster arrives before any wait returns.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Barrier `id` (1..) of the two warps of a row tile.
__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// Block `share` of unit blockIdx.x / kShares walks all B images. Phase 1,
// warps 2i and 2i + 1: query rows of tile rt = share * kShareTiles + i
// against key tiles [0, 9) and [9, 18); pd and dlf go, by key share, into
// the exchange tiles of the block that owns those keys. Phase 2, warps 2i
// and 2i + 1: the block's keys of 16-key tile i, half of the head dim each,
// contracting over all rows of the exchange tiles.
template <int KS>  // padded head dim / 16
__global__ void __launch_bounds__(kClusterWarps * 32, 2)
    window_attention_bwd_cluster(const __nv_bfloat16* __restrict__ qkv,
                                 const float* __restrict__ bias,
                                 const __nv_bfloat16* __restrict__ gout,
                                 __nv_bfloat16* __restrict__ dqkv,
                                 float* __restrict__ db,
                                 const long long* __restrict__ seed,
                                 const Window g, Dropout dr) {
  constexpr int NT = kHalfNT;
  constexpr int DP = KS * 16;
  constexpr int DT = DP / 8;
  constexpr int DH = DT / 2;  // 8-wide output tiles of a phase-2 warp
  constexpr int LD = kLd<KS>;
  constexpr int QT = kWideRows * LD;  // q, g tiles
  constexpr int KT = kKRows * LD;     // k, v tiles
  static_assert(kShareRows * LD <= kWideRows * kLdx,
                "the dv tile fits in the pd exchange tile");
  static_assert(kShareTiles * 32 * DT * 4 <= kWideRows * kLdx / 2,
                "the dq partials fit in the dlf exchange tile");
  extern __shared__ __align__(16) unsigned char smem[];
  int* pix = reinterpret_cast<int*>(smem);
  float* Db = reinterpret_cast<float*>(smem + kKRows * sizeof(int));
  __nv_bfloat16* Qs =
      reinterpret_cast<__nv_bfloat16*>(Db + kShareRows * kLdb);
  __nv_bfloat16* Gs = Qs + QT;
  __nv_bfloat16* Ks = Gs + QT;
  __nv_bfloat16* Vs = Ks + KT;
  __nv_bfloat16* Px = Vs + KT;                // pd: all rows, this block's keys
  __nv_bfloat16* Lx = Px + kWideRows * kLdx;  // dlf likewise
  float* pair = reinterpret_cast<float*>(Lx + kWideRows * kLdx);

  const int share = (int)cluster_rank();
  const int unit = blockIdx.x / kShares;
  const int w = unit / g.h;
  const int head = unit - w * g.h;
  const int C = g.h * g.d;
  const long long image = (long long)g.Hp * g.Wp;  // pixels an image
  load_seed(dr, seed);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int tile = warp >> 1;  // row tile (1), key tile (2) of the share
  const int half = warp & 1;   // key half (1), head-dim half (2)
  const int rt = share * kShareTiles + tile;
  const int ra = rt * 16 + gq;
  const int t0 = half * NT;    // this warp's first key tile in phase 1
  float* pmax = pair + tile * kPairFloats;  // [half][16]
  float* psum = pmax + 32;                  // [lane][2]
  float* pinv = psum + 64;                  // [16]
  float* pdelta = pinv + 16;                // [half][16]

  for (int i = threadIdx.x; i < kShareRows * kLdb; i += blockDim.x) Db[i] = 0.f;
  window_pixels(pix, g, w, kKRows);
  __syncthreads();  // pix

  // Image b's q and g, or k and v, into the stage; one commit group.
  auto stage = [&](int b, bool qg, bool kv) {
    const __nv_bfloat16* src = qkv + b * image * 3 * C + head * g.d;
    if (qg) {
      stage_tile_async<DP>(smem_u32(Qs), LD, src, 3 * C, pix, g.d, kWideRows);
      stage_tile_async<DP>(smem_u32(Gs), LD, gout + b * image * C + head * g.d,
                           C, pix, g.d, kWideRows);
    }
    if (kv) {
      stage_tile_async<DP>(smem_u32(Ks), LD, src + C, 3 * C, pix, g.d,
                           kKRows);
      stage_tile_async<DP>(smem_u32(Vs), LD, src + 2 * C, 3 * C, pix, g.d,
                           kKRows);
    }
    cp_async_commit();
  };
  stage(0, true, true);

  // This thread's (row ra, key pair 2tq) in the exchange tiles; row ra + 8
  // lies kRowB bytes further. The owner of a key tile is mapped per store.
  const uint32_t px_at = smem_u32(Px + ra * kLdx + 2 * tq);
  const uint32_t lx_at = smem_u32(Lx + ra * kLdx + 2 * tq);
  constexpr uint32_t kRowB = 8 * kLdx * 2;
  float* dba = Db + (tile * 16 + gq) * kLdb + 2 * tq;
  float* dbb = dba + 8 * kLdb;

  // This thread's bias elements (rows ra, ra + 8 against its key half, 0 in
  // rows >= N), the same for every image: read once.
  float br[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ra + (e >> 1) * 8;
      const int col = (t0 + t) * 8 + 2 * tq + (e & 1);
      br[t][e] = row < g.N && col < g.N
                     ? bias_block(bias, g, w, head)[row * g.N + col]
                     : 0.f;
    }
  }

  // Every block of the cluster runs before any writes another's tiles.
  cluster_arrive();
  for (int b = 0; b < g.B; ++b) {
    cp_async_wait<0>();
    __syncthreads();  // image b's stage has landed

    // Phase 1. Padding needs no masks, as in window_attention_bwd_tc; the
    // exchange with the other warp of the row tile goes through `pair`.
    float dq[DT][4];
    {
      // The logits and probs_tile's softmax with the bias from registers:
      // the same expressions and, over the two warps, the same order of the
      // row sum, so pf has the forward's bits.
      float s[NT][4];
      rows_times_rows<KS, NT>(Qs, Ks + t0 * 8 * LD, LD, rt, gq, tq, s);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (t0 + t) * 8 + 2 * tq + (e & 1);
          const float l =
              col < g.N ? s[t][e] * g.scale + br[t][e] : -INFINITY;
          s[t][e] = l;
          mx[e >> 1] = fmaxf(mx[e >> 1], l);
        }
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      if (tq == 0) {
        pmax[half * 16 + gq] = mx[0];
        pmax[half * 16 + gq + 8] = mx[1];
      }
      pair_barrier(1 + tile);
      mx[0] = fmaxf(mx[0], pmax[(1 - half) * 16 + gq]);
      mx[1] = fmaxf(mx[1], pmax[(1 - half) * 16 + gq + 8]);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = expf(s[t][e] - mx[e >> 1]);
      }
      // The row sum runs through key tiles 0..17 in order: the second warp
      // goes on from the first one's running sums.
      float sum[2] = {0.f, 0.f};
      if (half == 1) {
        pair_barrier(1 + tile);
        sum[0] = psum[lane * 2];
        sum[1] = psum[lane * 2 + 1];
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e >> 1] += s[t][e];
      }
      float inv[2];
      if (half == 0) {
        psum[lane * 2] = sum[0];
        psum[lane * 2 + 1] = sum[1];
        pair_barrier(1 + tile);
        pair_barrier(1 + tile);
        inv[0] = pinv[gq];
        inv[1] = pinv[gq + 8];
      } else {
        inv[0] = 1.f / quad_sum(sum[0]);
        inv[1] = 1.f / quad_sum(sum[1]);
        if (tq == 0) {
          pinv[gq] = inv[0];
          pinv[gq + 8] = inv[1];
        }
        pair_barrier(1 + tile);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] *= inv[e >> 1];
      }

      // dp = g v^T a key tile at a time, computed again in the second sweep
      // (holding it would take the bias's registers); the keep mask is
      // kept as bits between the sweeps.
      uint32_t ga[KS][4];
      {
        const __nv_bfloat16* ar = Gs + (rt * 16 + gq) * LD + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ga[kk][0] = *reinterpret_cast<const uint32_t*>(ar + kk * 16);
          ga[kk][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * LD + kk * 16);
          ga[kk][2] = *reinterpret_cast<const uint32_t*>(ar + kk * 16 + 8);
          ga[kk][3] =
              *reinterpret_cast<const uint32_t*>(ar + 8 * LD + kk * 16 + 8);
        }
      }
      const __nv_bfloat16* vr =
          Vs + (t0 * 8 + (lane & 7)) * LD + (lane >> 3) * 8;
      auto dp_tile = [&](int t, float (&c)[4]) {
        c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          uint32_t bv[4];  // v rows (t0 + t) * 8 .. +8, channels kk*16 .. +32
          ldmatrix_x4(bv, vr + t * 8 * LD + kk * 16);
          mma16816(c, ga[kk], bv[0], bv[1]);
          mma16816(c, ga[kk + 1], bv[2], bv[3]);
        }
      };
      float delta[2] = {0.f, 0.f};
      uint32_t kb[(NT * 4 + 31) / 32] = {};
      // Every block is done with image b - 1's exchange tiles.
      cluster_wait();
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float dp[4];
        dp_tile(t, dp);
        uint32_t bits[4] = {0u, 0u, 0u, 0u};
        if (dr.on)
          dropout_bits(dr, (t0 + t) * 4 + tq, rt * 8 + gq, unit, b, bits);
        bool keep[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          keep[e] = !dr.on || bits[e] >= dr.thr;
          kb[(t * 4 + e) >> 5] |= (uint32_t)keep[e] << ((t * 4 + e) & 31);
          float x = keep[e] ? dp[e] : 0.f;
          if (dr.on) x *= dr.inv_keep;
          delta[e >> 1] += x * s[t][e];
        }
        const int kt = t0 + t;
        const uint32_t at = map_to_rank(
            px_at + (kt % kTilesAShare) * 8 * 2, kt / kTilesAShare);
        st_cluster(at, dropped_pair(s[t][0], s[t][1], keep[0], keep[1], dr));
        st_cluster(at + kRowB,
                   dropped_pair(s[t][2], s[t][3], keep[2], keep[3], dr));
      }
      delta[0] = quad_sum(delta[0]);
      delta[1] = quad_sum(delta[1]);
      if (tq == 0) {
        pdelta[half * 16 + gq] = delta[0];
        pdelta[half * 16 + gq + 8] = delta[1];
      }
      pair_barrier(1 + tile);
      // Both warps add the two halves in the same order.
      delta[0] = pdelta[gq] + pdelta[16 + gq];
      delta[1] = pdelta[gq + 8] + pdelta[16 + gq + 8];
#pragma unroll
      for (int u = 0; u < DT; ++u)
        dq[u][0] = dq[u][1] = dq[u][2] = dq[u][3] = 0.f;
      // Two key tiles at a time (the last with a zero tile): dl into the db
      // rows, dlf to its owner and into this warp's share of dq = dlf k as
      // one A fragment.
#pragma unroll
      for (int j = 0; j < (NT + 1) / 2; ++j) {
        uint32_t a[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = 2 * j + h;
          if (t >= NT) continue;
          float dp[4];
          dp_tile(t, dp);
          float dl[4], dlf[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool keep = (kb[(t * 4 + e) >> 5] >> ((t * 4 + e) & 31)) & 1u;
            float x = keep ? dp[e] : 0.f;
            if (dr.on) x *= dr.inv_keep;
            dl[e] = (x - delta[e >> 1]) * s[t][e];
            dlf[e] = dl[e] * g.scale;
          }
          const int kt = t0 + t;
          float2* pa = reinterpret_cast<float2*>(dba + kt * 8);
          float2* pb = reinterpret_cast<float2*>(dbb + kt * 8);
          float2 x = *pa, y = *pb;
          x.x += dl[0];
          x.y += dl[1];
          y.x += dl[2];
          y.y += dl[3];
          *pa = x;
          *pb = y;
          a[2 * h] = pack_bf16(dlf[0], dlf[1]);
          a[2 * h + 1] = pack_bf16(dlf[2], dlf[3]);
          const uint32_t at = map_to_rank(
              lx_at + (kt % kTilesAShare) * 8 * 2, kt / kTilesAShare);
          st_cluster(at, a[2 * h]);
          st_cluster(at + kRowB, a[2 * h + 1]);
        }
        const __nv_bfloat16* mr =
            Ks + ((t0 + 2 * j) * 8 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
            (lane >> 4) * 8;
#pragma unroll
        for (int u = 0; u < DT; u += 2) {
          uint32_t bm[4];
          ldmatrix_x4_trans(bm, mr + u * 8);
          mma16816(dq[u], a, bm[0], bm[1]);
          mma16816(dq[u + 1], a, bm[2], bm[3]);
        }
      }
    }
    // Every block's exchange tiles hold image b, and this block is done
    // with k and v: image b + 1's arrive under phase 2.
    cluster_arrive();
    cluster_wait();
    if (b + 1 < g.B) stage(b + 1, false, true);

    // Phase 2: keys of tile `tile`, head-dim half `half`, contracting over
    // all rows.
    float dv[DH][4], dk[DH][4];
#pragma unroll
    for (int u = 0; u < DH; ++u) {
      dv[u][0] = dv[u][1] = dv[u][2] = dv[u][3] = 0.f;
      dk[u][0] = dk[u][1] = dk[u][2] = dk[u][3] = 0.f;
    }
    const int c0 = half * DH;  // first 8-wide output tile
#pragma unroll
    for (int j = 0; j < kWideRows / 16; ++j) {
      const int arow = j * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
      const int acol = tile * 16 + ((lane >> 3) & 1) * 8;
      uint32_t ap[4], ad[4];
      ldmatrix_x4_trans(ap, Px + arow * kLdx + acol);
      ldmatrix_x4_trans(ad, Lx + arow * kLdx + acol);
      const int brow = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int u = 0; u < DH; u += 2) {
        uint32_t bg[4], bq[4];
        ldmatrix_x4_trans(bg, Gs + brow * LD + (c0 + u + (lane >> 4)) * 8);
        ldmatrix_x4_trans(bq, Qs + brow * LD + (c0 + u + (lane >> 4)) * 8);
        mma16816(dv[u], ap, bg[0], bg[1]);
        mma16816(dv[u + 1], ap, bg[2], bg[3]);
        mma16816(dk[u], ad, bq[0], bq[1]);
        mma16816(dk[u + 1], ad, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every read of q, g and the exchange tiles is done

    // The second warp's dq partial (fp32, over the dlf exchange tile), dk
    // through g's rows of key tile rt, dv through the pd exchange tile (rows
    // tile * 16 ..); then the first warp adds the partials in order and
    // puts dq through q's rows of tile rt.
    float* part = reinterpret_cast<float*>(Lx) + (tile * 32 + lane) * DT * 4;
    if (half == 1) {
#pragma unroll
      for (int u = 0; u < DT; ++u)
        *reinterpret_cast<float4*>(part + u * 4) =
            make_float4(dq[u][0], dq[u][1], dq[u][2], dq[u][3]);
    }
#pragma unroll
    for (int u = 0; u < DH; ++u) {
      const int col = (c0 + u) * 8 + 2 * tq;
      __nv_bfloat16* pk = Gs + (rt * 16 + gq) * LD + col;
      __nv_bfloat16* pv = Px + (tile * 16 + gq) * LD + col;
      *reinterpret_cast<uint32_t*>(pk) = pack_bf16(dk[u][0], dk[u][1]);
      *reinterpret_cast<uint32_t*>(pk + 8 * LD) = pack_bf16(dk[u][2], dk[u][3]);
      *reinterpret_cast<uint32_t*>(pv) = pack_bf16(dv[u][0], dv[u][1]);
      *reinterpret_cast<uint32_t*>(pv + 8 * LD) = pack_bf16(dv[u][2], dv[u][3]);
    }
    __syncthreads();
    __nv_bfloat16* dst = dqkv + b * image * 3 * C + head * g.d;
    if (half == 0) {
#pragma unroll
      for (int u = 0; u < DT; ++u) {
        const float4 o = *reinterpret_cast<const float4*>(part + u * 4);
        dq[u][0] += o.x;
        dq[u][1] += o.y;
        dq[u][2] += o.z;
        dq[u][3] += o.w;
      }
      store_acc<DT>(Qs, LD, rt * 16, gq, tq, dq);
      __syncwarp();
      unstage_rows<DP>(dst, 3 * C, Qs, LD, pix, g.d, rt * 16, lane);
    } else {
      unstage_rows<DP>(dst + C, 3 * C, Gs, LD, pix, g.d, rt * 16, lane);
      // pix shifted so that tile row tile * 16 + i meets pixel row rt * 16 + i
      unstage_rows<DP>(dst + 2 * C, 3 * C, Px, LD, pix + (rt - tile) * 16,
                       g.d, tile * 16, lane);
    }
    __syncthreads();  // q and g are read out: image b + 1's may land
    if (b + 1 < g.B) stage(b + 1, true, false);
    // This block is done with image b's exchange tiles.
    cluster_arrive();
  }
  cluster_wait();
  __syncthreads();  // the db rows

  // The block's db rows, summed over the images in order, to the unit's
  // block.
  float* dbu = db + (long long)unit * g.N * g.N;
  const int r0 = share * kShareRows;
  const int rows = min(kShareRows, g.N - r0);
  for (int i = threadIdx.x; i < rows * g.N; i += blockDim.x) {
    const int r = i / g.N;
    const int c = i - r * g.N;
    dbu[(r0 + r) * g.N + c] = Db[r * kLdb + c];
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

enum KernelId { kTc2, kTc4, kCluster2, kCluster4, kNumKernels };
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

// The cluster route: kShares blocks (one cluster) a unit.
template <int KS>
int launch_cluster(KernelId id, const void* qkv, const float* bias,
                   const void* gout, void* dqkv, float* db,
                   const long long* seed, const Window& g, const Dropout& dr,
                   int units, DeviceState* st, cudaStream_t stream) {
  const int rc = opt_in_smem(st, &g_opted_in[device_index(st)][id],
                             window_attention_bwd_cluster<KS>);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)units * kShares);
  cfg.blockDim = dim3(kClusterWarps * 32);
  cfg.dynamicSmemBytes = kClusterSmem<KS>;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kShares;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, window_attention_bwd_cluster<KS>,
      static_cast<const __nv_bfloat16*>(qkv), bias,
      static_cast<const __nv_bfloat16*>(gout),
      static_cast<__nv_bfloat16*>(dqkv), db, seed, g, dr);
  if (err != cudaSuccess) return (int)err;
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
                                    int dropout, int window0, int dtype,
                                    void* stream) {
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
  dr.unit0 = window0 * h;
  const long long units = (long long)win.nW * h;
  if (units * kShares > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == 1 && d % 8 == 0 && d <= 64;
  if (tc && win.N <= kNT * 8) {
    if (d <= 32)
      return launch_tc<2>(kTc2, qkv, bias, g, dqkv, db, seed, win, dr,
                          (int)units, st, s);
    return launch_tc<4>(kTc4, qkv, bias, g, dqkv, db, seed, win, dr,
                        (int)units, st, s);
  }
  if (tc && win.N <= kWideRows) {
    if (d <= 32)
      return launch_cluster<2>(kCluster2, qkv, bias, g, dqkv, db, seed, win,
                               dr, (int)units, st, s);
    return launch_cluster<4>(kCluster4, qkv, bias, g, dqkv, db, seed, win, dr,
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
