// Long-kv flash attention backward for Hopper (sm_90a): the dk/dv kernel and
// the dq kernel.
//
// Replace the TPU kernels the JAX package reaches through
// rgbx_semantic_segmentation_tpu/ops/attention.py `_flash_attention` under
// differentiation: the two backward `pallas_call`s of
// jax.experimental.pallas.ops.tpu.flash_attention
// (`_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`). For every
// (batch*head) slice, from the residual (q, k, v, lse), the cotangent g of
// the output and di = rowsum(out * g) (fp32, computed by the caller, as the
// TPU code computes it outside its kernels):
//
//     p  = exp(q @ k^T * scale - lse)        fp32, recomputed, never stored
//     dv = p^T @ g                           p rounded to the input dtype
//     dp = g @ v^T
//     ds = (dp - di) * p * scale             rounded to the input dtype
//     dk = ds^T @ q
//     dq = ds @ k
//
// with the TPU kernels' rounding points: every product accumulates in fp32;
// ds is formed from the unrounded p; dq, dk, dv are rounded at the end.
//
// What bounds them on the H100: operations. The dk/dv kernel does four
// products and the dq kernel three (each recomputes the logits and dp):
// 14*G*N*M*d operations, 2.6e12 at N = M = 19200, d = 64, G = 8 (2.7 ms at
// the dense bf16 rate) against ~60 MB of bytes.
//
// What the design does about it. The TPU kernels walk a sequential grid and
// carry fp32 accumulators in scratch from step to step; CUDA blocks run in no
// order, so each kernel's block owns its outputs and loops itself:
//   * dk/dv kernel: a block owns 64 kv rows of a slice (a warp 16, its k and
//     v fragments in registers) and walks ALL q rows in tiles of 64 (q, g
//     staged row-major in shared memory, lse and di beside them, the next
//     tile's loads in flight in registers meanwhile). The
//     transposed logits k q^T and dp^T = v g^T are mma accumulators; turned
//     into p^T and ds^T and rounded to bf16 they are the A fragments of
//     p^T @ g and ds^T @ q, whose B fragments come transposed out of
//     ldmatrix. dk and dv accumulate in fp32 registers over the whole walk
//     and are written once: no partial sums in device memory, no atomics,
//     the same bits every run.
//   * dq kernel: a block owns 64 q rows (a warp 16, its q and g fragments,
//     lse and di in registers) and walks all kv rows in tiles of 64.
//   * exp is `__expf` in the bf16 kernels, as in the forward (it took a
//     third of the dq kernel's time); the fp32 kernels keep expf.
//   * M is long here (19200 / 4800 / 1200 on the model's path), so 300 / 75
//     / 19 kv blocks times 8 / 16 / 40 slices fill the card without
//     splitting a slice's q rows.
//   * Ragged edges: kv columns >= M have p = 0 (dq kernel) or are rows that
//     are not written (dk/dv kernel); q rows >= N are staged as zeros with
//     lse = di = 0, so p is finite and they add exactly 0.
//   * Layouts as in the forward: every operand through (batch, head, row)
//     strides, so dq lands in the q projection's layout and dk, dv in the
//     two halves of the kv projection's.
// fp32: the same two kernels in scalar fp32 FMAs (flash_attention_common.cuh).
//
// Interface: plain C, loaded with ctypes, one entry per kernel. Launches go
// on the caller's stream; an entry returns cudaGetLastError() after its
// launch.

#include "flash_attention_common.cuh"

namespace {

// Operands of either kernel; the dk/dv kernel leaves dq unused and the dq
// kernel dk and dv.
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;     // cotangent of out, (B, H, N, d)
  const float* lse;  // (B * H, N) fp32, contiguous
  const float* di;   // (B * H, N) fp32, contiguous
  void* dq;
  void* dk;
  void* dv;
  Layout lq, lk, lv, lg, ldq, ldk, ldv;
  int H, N, M, d;
  float scale;
};

template <int KS>
__global__ void __launch_bounds__(kFlashWarps * 32)
    flash_attention_bwd_dkv_mma_kernel(const BwdParams p) {
  constexpr int DP = KS * 16;
  constexpr int DT = DP / 8;
  constexpr int LD = DP + 8;
  constexpr int NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Q_s = reinterpret_cast<bf16*>(smem);               // (kTile, LD)
  bf16* G_s = Q_s + kTile * LD;                            // (kTile, LD)
  float* lse_s = reinterpret_cast<float*>(G_s + kTile * LD);  // (kTile)
  float* di_s = lse_s + kTile;                                // (kTile)

  const int g = blockIdx.y;
  const bf16* qg = slice(static_cast<const bf16*>(p.q), p.lq, g, p.H);
  const bf16* kg = slice(static_cast<const bf16*>(p.k), p.lk, g, p.H);
  const bf16* vg = slice(static_cast<const bf16*>(p.v), p.lv, g, p.H);
  const bf16* gg = slice(static_cast<const bf16*>(p.g), p.lg, g, p.H);
  const float* lse = p.lse + (size_t)g * p.N;
  const float* di = p.di + (size_t)g * p.N;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int m0 = (blockIdx.x * kFlashWarps + warp) * 16;  // this warp's kv rows

  uint32_t ka[KS][4], va[KS][4];
  load_a_fragments<KS>(ka, kg, p.lk.row, m0, p.M, p.d, gq, tq);
  load_a_fragments<KS>(va, vg, p.lv.row, m0, p.M, p.d, gq, tq);
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int u = 0; u < DT; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[u][i] = dv[u][i] = 0.f;

  // Threads [0, kTile) also carry the tile's row statistics.
  const auto stat = [&](const float* src, int n0) {
    return threadIdx.x < kTile && n0 + threadIdx.x < p.N ? src[n0 + threadIdx.x]
                                                         : 0.f;
  };
  TileRegs<KS> qr, gr;
  qr.load(qg, p.lq.row, 0, p.N, p.d);
  gr.load(gg, p.lg.row, 0, p.N, p.d);
  float lse_r = stat(lse, 0), di_r = stat(di, 0);
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    qr.store(Q_s);
    gr.store(G_s);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse_r;
      di_s[threadIdx.x] = di_r;
    }
    __syncthreads();
    if (n0 + kTile < p.N) {
      qr.load(qg, p.lq.row, n0 + kTile, p.N, p.d);
      gr.load(gg, p.lg.row, n0 + kTile, p.N, p.d);
      lse_r = stat(lse, n0 + kTile);
      di_r = stat(di, n0 + kTile);
    }

    // Transposed tiles: rows = this warp's kv rows, columns = the q rows of
    // the staged tile.
    float s[NT][4], dp[NT][4];
    xyT_tile<KS>(ka, Q_s, LD, gq, tq, s);
    xyT_tile<KS>(va, G_s, LD, gq, tq, dp);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = t * 8 + 2 * tq;
      const float l0 = lse_s[c], l1 = lse_s[c + 1];
      const float d0 = di_s[c], d1 = di_s[c + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float p0 = __expf(s[t][2 * half] * p.scale - l0);
        const float p1 = __expf(s[t][2 * half + 1] * p.scale - l1);
        s[t][2 * half] = p0;
        s[t][2 * half + 1] = p1;
        dp[t][2 * half] = (dp[t][2 * half] - d0) * p0 * p.scale;
        dp[t][2 * half + 1] = (dp[t][2 * half + 1] - d1) * p1 * p.scale;
      }
    }
    uint32_t pa[kTile / 16][4], da[kTile / 16][4];
    pack_weights(s, pa);
    pack_weights(dp, da);
    weights_times_tile<DT>(pa, G_s, LD, lane, dv);
    weights_times_tile<DT>(da, Q_s, LD, lane, dk);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<DT>(slice(static_cast<bf16*>(p.dk), p.ldk, g, p.H), p.ldk.row, m0,
                 p.M, p.d, gq, tq, dk, one);
  store_rows<DT>(slice(static_cast<bf16*>(p.dv), p.ldv, g, p.H), p.ldv.row, m0,
                 p.M, p.d, gq, tq, dv, one);
}

template <int KS>
__global__ void __launch_bounds__(kFlashWarps * 32)
    flash_attention_bwd_dq_mma_kernel(const BwdParams p) {
  constexpr int DP = KS * 16;
  constexpr int DT = DP / 8;
  constexpr int LD = DP + 8;
  constexpr int NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* K_s = reinterpret_cast<bf16*>(smem);  // (kTile, LD)
  bf16* V_s = K_s + kTile * LD;               // (kTile, LD)

  const int g = blockIdx.y;
  const bf16* qg = slice(static_cast<const bf16*>(p.q), p.lq, g, p.H);
  const bf16* kg = slice(static_cast<const bf16*>(p.k), p.lk, g, p.H);
  const bf16* vg = slice(static_cast<const bf16*>(p.v), p.lv, g, p.H);
  const bf16* gg = slice(static_cast<const bf16*>(p.g), p.lg, g, p.H);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int r0 = (blockIdx.x * kFlashWarps + warp) * 16;  // this warp's q rows

  uint32_t qa[KS][4], ga[KS][4];
  load_a_fragments<KS>(qa, qg, p.lq.row, r0, p.N, p.d, gq, tq);
  load_a_fragments<KS>(ga, gg, p.lg.row, r0, p.N, p.d, gq, tq);
  float lse[2], di[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + gq + 8 * half;
    lse[half] = row < p.N ? p.lse[(size_t)g * p.N + row] : 0.f;
    di[half] = row < p.N ? p.di[(size_t)g * p.N + row] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int u = 0; u < DT; ++u) dq[u][0] = dq[u][1] = dq[u][2] = dq[u][3] = 0.f;

  TileRegs<KS> kr, vr;
  kr.load(kg, p.lk.row, 0, p.M, p.d);
  vr.load(vg, p.lv.row, 0, p.M, p.d);
  for (int c0 = 0; c0 < p.M; c0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    kr.store(K_s);
    vr.store(V_s);
    __syncthreads();
    if (c0 + kTile < p.M) {
      kr.load(kg, p.lk.row, c0 + kTile, p.M, p.d);
      vr.load(vg, p.lv.row, c0 + kTile, p.M, p.d);
    }

    float s[NT][4], dp[NT][4];
    xyT_tile<KS>(qa, K_s, LD, gq, tq, s);
    xyT_tile<KS>(ga, V_s, LD, gq, tq, dp);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = c0 + t * 8 + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float p0 =
            c < p.M ? __expf(s[t][2 * half] * p.scale - lse[half]) : 0.f;
        const float p1 =
            c + 1 < p.M ? __expf(s[t][2 * half + 1] * p.scale - lse[half]) : 0.f;
        dp[t][2 * half] = (dp[t][2 * half] - di[half]) * p0 * p.scale;
        dp[t][2 * half + 1] = (dp[t][2 * half + 1] - di[half]) * p1 * p.scale;
      }
    }
    uint32_t da[kTile / 16][4];
    pack_weights(dp, da);
    weights_times_tile<DT>(da, K_s, LD, lane, dq);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<DT>(slice(static_cast<bf16*>(p.dq), p.ldq, g, p.H), p.ldq.row, r0,
                 p.N, p.d, gq, tq, dq, one);
}

// fp32 dk/dv kernel: a warp owns kOwn kv rows, a lane a q row of the tile.
// Shared memory: the warps' k and v rows, a q tile, a g tile, the warps' p
// and ds of the current tile.
__global__ void __launch_bounds__(kScalarWarps * 32)
    flash_attention_bwd_dkv_scalar_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = p.d;
  float* Xk_s = reinterpret_cast<float*>(smem);   // (warps, d, kOwn)
  float* Xv_s = Xk_s + kScalarRows * d;           // (warps, d, kOwn)
  float* Q_s = Xv_s + kScalarRows * d;            // (kScalarTile, d + 1)
  float* G_s = Q_s + kScalarTile * (d + 1);       // (kScalarTile, d + 1)
  float* Wp_s = G_s + kScalarTile * (d + 1);      // (warps, kScalarTile, kOwn)
  float* Wd_s = Wp_s + kScalarWarps * kScalarTile * kOwn;

  const int g = blockIdx.y;
  const float* qg = slice(static_cast<const float*>(p.q), p.lq, g, p.H);
  const float* kg = slice(static_cast<const float*>(p.k), p.lk, g, p.H);
  const float* vg = slice(static_cast<const float*>(p.v), p.lv, g, p.H);
  const float* gg = slice(static_cast<const float*>(p.g), p.lg, g, p.H);
  const float* lse = p.lse + (size_t)g * p.N;
  const float* di = p.di + (size_t)g * p.N;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kScalarRows + warp * kOwn;
  float* xk = Xk_s + warp * d * kOwn;
  float* xv = Xv_s + warp * d * kOwn;
  float* wp = Wp_s + warp * kScalarTile * kOwn;
  float* wd = Wd_s + warp * kScalarTile * kOwn;
  stage_own(xk, kg, p.lk.row, m0, p.M, d, lane);
  stage_own(xv, vg, p.lv.row, m0, p.M, d, lane);

  float dk[kOwn][kFlashDimTiles], dv[kOwn][kFlashDimTiles];
#pragma unroll
  for (int r = 0; r < kOwn; ++r)
#pragma unroll
    for (int u = 0; u < kFlashDimTiles; ++u) dk[r][u] = dv[r][u] = 0.f;

  for (int n0 = 0; n0 < p.N; n0 += kScalarTile) {
    __syncthreads();  // the previous tile and its weights are consumed
    stage_scalar_tile(Q_s, qg, p.lq.row, n0, p.N, d);
    stage_scalar_tile(G_s, gg, p.lg.row, n0, p.N, d);
    __syncthreads();
    float s[kOwn], dp[kOwn];
    dots_own(xk, Q_s + lane * (d + 1), d, s);
    dots_own(xv, G_s + lane * (d + 1), d, dp);
    const bool in = n0 + lane < p.N;
    const float l_row = in ? lse[n0 + lane] : 0.f;
    const float d_row = in ? di[n0 + lane] : 0.f;
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const float pr = expf(s[r] * p.scale - l_row);
      wp[lane * kOwn + r] = pr;
      wd[lane * kOwn + r] = (dp[r] - d_row) * pr * p.scale;
    }
    __syncwarp();
    weights_times_scalar_tile(wp, G_s, d, lane, dv);
    weights_times_scalar_tile(wd, Q_s, d, lane, dk);
  }

  float* dkg = slice(static_cast<float*>(p.dk), p.ldk, g, p.H);
  float* dvg = slice(static_cast<float*>(p.dv), p.ldv, g, p.H);
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int row = m0 + r;
    if (row >= p.M) continue;
#pragma unroll
    for (int u = 0; u < kFlashDimTiles; ++u) {
      const int e = lane + 32 * u;
      if (e < d) {
        dkg[(long long)row * p.ldk.row + e] = dk[r][u];
        dvg[(long long)row * p.ldv.row + e] = dv[r][u];
      }
    }
  }
}

// fp32 dq kernel: a warp owns kOwn q rows, a lane a kv row of the tile.
// Shared memory: the warps' q and g rows, a k tile, a v tile, the warps' ds.
__global__ void __launch_bounds__(kScalarWarps * 32)
    flash_attention_bwd_dq_scalar_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = p.d;
  float* Xq_s = reinterpret_cast<float*>(smem);   // (warps, d, kOwn)
  float* Xg_s = Xq_s + kScalarRows * d;           // (warps, d, kOwn)
  float* K_s = Xg_s + kScalarRows * d;            // (kScalarTile, d + 1)
  float* V_s = K_s + kScalarTile * (d + 1);       // (kScalarTile, d + 1)
  float* W_s = V_s + kScalarTile * (d + 1);       // (warps, kScalarTile, kOwn)

  const int g = blockIdx.y;
  const float* qg = slice(static_cast<const float*>(p.q), p.lq, g, p.H);
  const float* kg = slice(static_cast<const float*>(p.k), p.lk, g, p.H);
  const float* vg = slice(static_cast<const float*>(p.v), p.lv, g, p.H);
  const float* gg = slice(static_cast<const float*>(p.g), p.lg, g, p.H);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kScalarRows + warp * kOwn;
  float* xq = Xq_s + warp * d * kOwn;
  float* xg = Xg_s + warp * d * kOwn;
  float* ww = W_s + warp * kScalarTile * kOwn;
  stage_own(xq, qg, p.lq.row, r0, p.N, d, lane);
  stage_own(xg, gg, p.lg.row, r0, p.N, d, lane);

  float lse[kOwn], di[kOwn], dq[kOwn][kFlashDimTiles];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const bool in = r0 + r < p.N;
    lse[r] = in ? p.lse[(size_t)g * p.N + r0 + r] : 0.f;
    di[r] = in ? p.di[(size_t)g * p.N + r0 + r] : 0.f;
#pragma unroll
    for (int u = 0; u < kFlashDimTiles; ++u) dq[r][u] = 0.f;
  }

  for (int c0 = 0; c0 < p.M; c0 += kScalarTile) {
    __syncthreads();  // the previous tile and its weights are consumed
    stage_scalar_tile(K_s, kg, p.lk.row, c0, p.M, d);
    stage_scalar_tile(V_s, vg, p.lv.row, c0, p.M, d);
    __syncthreads();
    float s[kOwn], dp[kOwn];
    dots_own(xq, K_s + lane * (d + 1), d, s);
    dots_own(xg, V_s + lane * (d + 1), d, dp);
    const bool valid = c0 + lane < p.M;
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const float pr = valid ? expf(s[r] * p.scale - lse[r]) : 0.f;
      ww[lane * kOwn + r] = (dp[r] - di[r]) * pr * p.scale;
    }
    __syncwarp();
    weights_times_scalar_tile(ww, K_s, d, lane, dq);
  }

  float* dqg = slice(static_cast<float*>(p.dq), p.ldq, g, p.H);
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int row = r0 + r;
    if (row >= p.N) continue;
#pragma unroll
    for (int u = 0; u < kFlashDimTiles; ++u) {
      const int e = lane + 32 * u;
      if (e < d) dqg[(long long)row * p.ldq.row + e] = dq[r][u];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum ScalarKernel { kDkvScalar, kDqScalar, kNumScalarKernels };
std::atomic<bool> g_opted_in[kMaxDevices][kNumScalarKernels];

// The operands every entry shares; the entry fills in its outputs.
int fill(BwdParams& p, const void* q, const void* k, const void* v,
         const void* g, const void* lse, const void* di, int B, int H, int N,
         int M, int d, const long long* strides, float scale, int dtype) {
  if (!flash_sizes_ok(B, H, N, M, d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = p.dk = p.dv = nullptr;
  p.lq = layout_at(strides, 0);
  p.lk = layout_at(strides, 1);
  p.lv = layout_at(strides, 2);
  p.lg = layout_at(strides, 3);
  p.ldq = p.ldk = p.ldv = Layout{0, 0, 0};
  p.H = H;
  p.N = N;
  p.M = M;
  p.d = d;
  p.scale = scale;
  if (dtype == 1 && !(aligned16(q, p.lq) && aligned16(k, p.lk) &&
                      aligned16(v, p.lv) && aligned16(g, p.lg)))
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

template <typename Kernel>
int launch_scalar(Kernel kernel, ScalarKernel id, const BwdParams& p,
                  int owner_rows, int G, int weights, cudaStream_t stream) {
  DeviceState* st = nullptr;
  int rc = current_device(&st);
  if (rc != 0) return rc;
  rc = opt_in_smem(st, &g_opted_in[device_index(st)][id], kernel);
  if (rc != 0) return rc;
  const size_t smem = scalar_smem_bytes(p.d, 2, weights);
  if (smem > (size_t)st->smem_optin) return (int)cudaErrorInvalidValue;
  const dim3 grid((owner_rows + kScalarRows - 1) / kScalarRows, G);
  kernel<<<grid, kScalarWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_dkv_mma(const BwdParams& p, int G, cudaStream_t stream) {
  constexpr size_t smem = 2 * (size_t)kTile * (KS * 16 + 8) * sizeof(bf16) +
                          2 * kTile * sizeof(float);
  static_assert(smem <= 48 * 1024, "fits without the opt-in");
  const dim3 grid((p.M + kTile - 1) / kTile, G);
  flash_attention_bwd_dkv_mma_kernel<KS>
      <<<grid, kFlashWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_dq_mma(const BwdParams& p, int G, cudaStream_t stream) {
  constexpr size_t smem = 2 * (size_t)kTile * (KS * 16 + 8) * sizeof(bf16);
  static_assert(smem <= 48 * 1024, "fits without the opt-in");
  const dim3 grid((p.N + kTile - 1) / kTile, G);
  flash_attention_bwd_dq_mma_kernel<KS>
      <<<grid, kFlashWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, g: (B, H, N, d); k, v, dk, dv:
// (B, H, M, d), on the current device, unit stride along d, d a multiple of
// 8, at most 128. lse, di: (B * H, N) fp32, contiguous. `strides` holds 18
// element strides: (batch, head, row) of q, k, v, g, dk, dv. bf16 operands
// start on 16-byte boundaries and have strides that are multiples of 8.
// Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const void* lse, const void* di,
                                       void* dk, void* dv, int B, int H, int N,
                                       int M, int d, const long long* strides,
                                       float scale, int dtype, void* stream) {
  BwdParams p;
  const int rc = fill(p, q, k, v, g, lse, di, B, H, N, M, d, strides, scale,
                      dtype);
  if (rc != 0) return rc;
  p.dk = dk;
  p.dv = dv;
  p.ldk = layout_at(strides, 4);
  p.ldv = layout_at(strides, 5);
  cudaGetLastError();  // clear an earlier non-sticky error: report our own
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scalar(flash_attention_bwd_dkv_scalar_kernel, kDkvScalar, p,
                         M, B * H, 2, s);
  if (!aligned16(dk, p.ldk) || !aligned16(dv, p.ldv))
    return (int)cudaErrorMisalignedAddress;
  switch (flash_ks(d)) {
    case 2: return launch_dkv_mma<2>(p, B * H, s);
    case 4: return launch_dkv_mma<4>(p, B * H, s);
    default: return launch_dkv_mma<8>(p, B * H, s);
  }
}

// As above; `strides` holds 15 element strides: (batch, head, row) of q, k,
// v, g, dq. dq: (B, H, N, d).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* di,
                                      void* dq, int B, int H, int N, int M,
                                      int d, const long long* strides,
                                      float scale, int dtype, void* stream) {
  BwdParams p;
  const int rc = fill(p, q, k, v, g, lse, di, B, H, N, M, d, strides, scale,
                      dtype);
  if (rc != 0) return rc;
  p.dq = dq;
  p.ldq = layout_at(strides, 4);
  cudaGetLastError();  // clear an earlier non-sticky error: report our own
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scalar(flash_attention_bwd_dq_scalar_kernel, kDqScalar, p, N,
                         B * H, 1, s);
  if (!aligned16(dq, p.ldq)) return (int)cudaErrorMisalignedAddress;
  switch (flash_ks(d)) {
    case 2: return launch_dq_mma<2>(p, B * H, s);
    case 4: return launch_dq_mma<4>(p, B * H, s);
    default: return launch_dq_mma<8>(p, B * H, s);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
