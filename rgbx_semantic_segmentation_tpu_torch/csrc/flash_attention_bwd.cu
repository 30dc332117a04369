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
// ds is formed from the unrounded p; dq, dk, dv are rounded once, at the end.
//
// What bounds them on the H100: operations. The dk/dv kernel does four
// products and the dq kernel three (each forms the logits and dp): 14*G*N*M*d
// operations, 2.6e12 at N = M = 19200, d = 64, G = 8 (2.7 ms at the dense
// bf16 rate), and two exps a logit (5.9e9, ~1.6 ms at 16 a clock on 132
// SMs), against ~60 MB of bytes.
//
// bf16, tensor cores: wgmma m64n64k16 with fp32 accumulators; every operand
// staged by 16-byte cp.async into the 128-byte-swizzled layout wgmma reads
// (wgmma_common.cuh), where one staged tile is the K-major operand of one
// product and the MN-major B of another. A block is one warpgroup that owns
// 64 rows of a slice (kv rows for dk/dv, q rows for dq), staged once, and
// walks the other operand in 64-row tiles through a ring of buffers, the
// next tiles' copies in flight under the products; two blocks share an SM.
//   * dk/dv: per q tile S^T = k q^T and dP^T = v g^T (both operands in
//     shared memory) become p^T and ds^T in the accumulator registers and,
//     rounded to bf16, the register A operands of dv += p^T g and dk +=
//     ds^T q (g and q MN-major from the same staged tiles). Those two
//     products are issued one step late, after the next tile's logits, so
//     that they run on the tensor cores under that tile's exps. dk and dv
//     stay in fp32 registers over the whole walk and are written once: no
//     partial sums, no atomics, the same bits every run.
//   * dq: per kv tile S = q k^T and dP = g v^T become ds in registers, the A
//     operand of dq += ds k (k MN-major).
//   * One fused kernel for all five products (dq partials of the kv blocks
//     summed into an fp32 workspace in a fixed order) was built and measured
//     2x slower: PERF.md section 6.
//   * exp is one ex2.approx of s * scale * log2(e) - lse * log2(e).
//   * Ragged edges: kv rows >= M are staged as zeros (their dk, dv are not
//     written; the dq kernel gives kv columns >= M probability 0); q rows
//     >= N are staged as zeros with lse = di = 0, so they add exactly 0 and
//     are not written. A head dim below 64 is a panel with zero columns.
//   * Layouts: every operand through (batch, head, row) strides, so dq lands
//     in the q projection's layout and dk, dv in the two halves of the kv
//     projection's.
// fp32: the same two kernels in scalar fp32 FMAs (flash_attention_common.cuh).
//
// Interface: plain C, loaded with ctypes, one entry per kernel. Launches go
// on the caller's stream; an entry returns cudaGetLastError() after its
// launch.

#include "flash_attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: one warpgroup a block, two blocks an SM.
// ---------------------------------------------------------------------------

constexpr int kStages = 4;                       // dk/dv: ring of q tiles
constexpr int kAhead = kStages - 2;              // tiles copied ahead
constexpr int kDqStages = 3;                     // dq: ring of kv tiles
constexpr int kTileBytes = 64 * kPanelRowBytes;  // one 64-row panel

struct TcBwd {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  const float* lse;  // (G, N) fp32
  const float* di;   // (G, N) fp32
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Layout lq, lk, lv, lg, ldq, ldk, ldv;
  int H, N, M, d;
  float scale;
};

// Bytes of dynamic shared memory: the 1024-byte alignment slack, the two
// owner tiles (k and v, or q and g), the ring of the two streamed tiles and
// (dk/dv kernel) their lse and di rows.
template <int PN>
constexpr size_t dkv_smem_bytes() {
  return 1024 + (size_t)(2 + 2 * kStages) * PN * kTileBytes +
         (size_t)kStages * 128 * 4;
}

template <int PN>
constexpr size_t dq_smem_bytes() {
  return 1024 + (size_t)(2 + 2 * kDqStages) * PN * kTileBytes;
}

// One wgmma group, not waited for: s = x y^T and dp = u w^T over 64-row
// tiles, all four K-major in shared memory.
template <int PN>
__device__ __forceinline__ void issue_logits(float (&s)[32], float (&dp)[32],
                                             uint32_t x, uint32_t y,
                                             uint32_t u, uint32_t w) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4 * PN; ++ks) {
    wgmma_ss(s, kmajor_desc(x, 64, ks), kmajor_desc(y, 64, ks));
    wgmma_ss(dp, kmajor_desc(u, 64, ks), kmajor_desc(w, 64, ks));
  }
  wgmma_commit();
}

// One wgmma group, not waited for: o1 += a1 b1 and o2 += a2 b2, the A
// operands 64 x 64 bf16 weights in registers, b1 and b2 64-row tiles
// MN-major in shared memory (o2, a2 may be absent: N2 = 0).
template <int PN, int N2>
__device__ __forceinline__ void issue_weights(float (&o1)[PN][32],
                                              float (&o2)[PN][32],
                                              uint32_t (&a1)[4][4],
                                              uint32_t (&a2)[4][4],
                                              uint32_t b1, uint32_t b2) {
#pragma unroll
  for (int pn = 0; pn < PN; ++pn) {
    fence_regs(o1[pn]);
    if (N2) fence_regs(o2[pn]);
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    fence_regs(a1[ks]);
    if (N2) fence_regs(a2[ks]);
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int pn = 0; pn < PN; ++pn) {
      wgmma_rs(o1[pn], a1[ks], mnmajor_desc(b1, 64, pn, ks));
      if (N2) wgmma_rs(o2[pn], a2[ks], mnmajor_desc(b2, 64, pn, ks));
    }
  wgmma_commit();
}

// Rows r0 + rl and r0 + rl + 8 of a (64, d) fp32 accumulator tile to a
// (n_rows, d) bf16 matrix (row stride ld), as bf16 pairs.
template <int PN>
__device__ __forceinline__ void store_tile(bf16* base, long long ld, int r0,
                                           int n_rows, int d, int rl, int tq,
                                           const float (&o)[PN][32]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + rl + 8 * h;
    if (row >= n_rows) continue;
    bf16* dst = base + (long long)row * ld;
#pragma unroll
    for (int pn = 0; pn < PN; ++pn)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = pn * kPanel + 8 * jj + 2 * tq;
        if (col < d)
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack_bf16(o[pn][4 * jj + 2 * h], o[pn][4 * jj + 2 * h + 1]);
      }
  }
}

// dk/dv kernel: block (kv tile, slice) keeps k and v of its 64 kv rows
// staged and walks the q tiles. Step t issues S^T = k q_t^T and dP^T =
// v g_t^T, then the previous tile's dv += p^T g and dk += ds^T q, so that
// those run on the tensor cores under tile t's exps; waits for the logits
// only; turns them into p^T and ds^T (rounded to bf16 into the A registers
// the next step's products read).
template <int PN>
__global__ void __launch_bounds__(kWgThreads, 2)
    flash_bwd_dkv(const TcBwd p) {
  constexpr int TB = PN * kTileBytes;  // one 64-row tile, all panels
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const uint32_t Ks = base, Vs = Ks + TB, Qs = Vs + TB;
  const uint32_t Gs = Qs + kStages * TB, Ss = Gs + kStages * TB;
  const float* stats = reinterpret_cast<const float*>(gbase + (Ss - base));
  const int tid = threadIdx.x;
  const int tq = tid % 4;
  const int rl = 16 * (tid / 32) + (tid % 32) / 4;
  const int g = blockIdx.y;
  const int m0 = blockIdx.x * 64;
  const int T = (p.N + 63) / 64;
  const float c = p.scale * kLog2e;
  const bf16* qg = slice(p.q, p.lq, g, p.H);
  const bf16* gg = slice(p.g, p.lg, g, p.H);
  const float* lse = p.lse + (long long)g * p.N;
  const float* di = p.di + (long long)g * p.N;

  auto issue = [&](int t) {
    const int st = t % kStages;
    stage_rows_async(Qs + st * TB, qg, p.lq.row, t * 64, p.N, p.d, 64, PN,
                     tid, kWgThreads);
    stage_rows_async(Gs + st * TB, gg, p.lg.row, t * 64, p.N, p.d, 64, PN,
                     tid, kWgThreads);
    const int row = t * 64 + (tid % 64);
    const bool in = row < p.N;
    const float* src = tid < 64 ? lse : di;
    cp_async4(Ss + (st * 128 + tid) * 4, in ? src + row : src, in ? 4 : 0);
  };
  stage_rows_async(Ks, slice(p.k, p.lk, g, p.H), p.lk.row, m0, p.M, p.d, 64,
                   PN, tid, kWgThreads);
  stage_rows_async(Vs, slice(p.v, p.lv, g, p.H), p.lv.row, m0, p.M, p.d, 64,
                   PN, tid, kWgThreads);
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < T) issue(t);
    cp_async_commit();
  }

  float dk[PN][32], dv[PN][32];
#pragma unroll
  for (int pn = 0; pn < PN; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[pn][i] = dv[pn][i] = 0.f;
  float s[32], dp[32];
  uint32_t pa0[4][4], la0[4][4], pa1[4][4], la1[4][4];

  auto step = [&](int t, uint32_t(&pa)[4][4], uint32_t(&la)[4][4],
                  uint32_t(&pa_prev)[4][4], uint32_t(&la_prev)[4][4]) {
    const int st = t % kStages;
    cp_async_wait<kAhead - 1>();  // tile t has landed
    fence_async_smem();
    __syncthreads();
    issue_logits<PN>(s, dp, Ks, Qs + st * TB, Vs, Gs + st * TB);
    if (t > 0) {
      const int sp = (t - 1) % kStages;
      issue_weights<PN, 1>(dv, dk, pa_prev, la_prev, Gs + sp * TB,
                           Qs + sp * TB);
      wgmma_wait<1>();  // the logits; tile t - 1's products may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    fence_regs(dp);
    // Tile t - 2's products are done (older than the logits): its buffers
    // take tile t + kAhead.
    if (t + kAhead < T) issue(t + kAhead);
    cp_async_commit();
    // Rows: this block's kv rows; columns: the tile's q rows.
    const float* lse_s = stats + st * 128;
    const float* di_s = lse_s + 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 e = *reinterpret_cast<const float2*>(di_s + col);
      const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
      const float dd[2] = {e.x, e.y};
#pragma unroll
      for (int i = 4 * j; i < 4 * j + 4; ++i) {
        const float pf = ex2(fmaf(s[i], c, -l2[i & 1]));
        s[i] = pf;
        dp[i] = (dp[i] - dd[i & 1]) * pf * p.scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_a(s, kk, pa[kk]);
      pack_a(dp, kk, la[kk]);
    }
  };
  for (int t = 0; t < T; t += 2) {
    step(t, pa0, la0, pa1, la1);
    if (t + 1 < T) step(t + 1, pa1, la1, pa0, la0);
  }
  const int sp = (T - 1) % kStages;
  if ((T - 1) % 2 == 0)
    issue_weights<PN, 1>(dv, dk, pa0, la0, Gs + sp * TB, Qs + sp * TB);
  else
    issue_weights<PN, 1>(dv, dk, pa1, la1, Gs + sp * TB, Qs + sp * TB);
  wgmma_wait<0>();
#pragma unroll
  for (int pn = 0; pn < PN; ++pn) {
    fence_regs(dv[pn]);
    fence_regs(dk[pn]);
  }
  store_tile<PN>(slice(p.dk, p.ldk, g, p.H), p.ldk.row, m0, p.M, p.d, rl, tq,
                 dk);
  store_tile<PN>(slice(p.dv, p.ldv, g, p.H), p.ldv.row, m0, p.M, p.d, rl, tq,
                 dv);
  cp_async_wait<0>();
}

// dq kernel: block (q tile, slice) keeps q and g of its 64 q rows staged,
// their lse and di in registers, and walks the kv tiles through a ring of
// kDqStages: S = q k^T and dP = g v^T, ds in registers as the A operand of
// dq += ds k, each product waited for. (Issuing dq += ds k one step late, as
// the dk/dv kernel does, or the next tile's logits one step early, measured
// slower here: PERF.md section 6.)
template <int PN>
__global__ void __launch_bounds__(kWgThreads, 2)
    flash_bwd_dq(const TcBwd p) {
  constexpr int TB = PN * kTileBytes;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t Qs = base, Gs = Qs + TB, Ks = Gs + TB;
  const uint32_t Vs = Ks + kDqStages * TB;
  const int tid = threadIdx.x;
  const int tq = tid % 4;
  const int rl = 16 * (tid / 32) + (tid % 32) / 4;
  const int g = blockIdx.y;
  const int n0 = blockIdx.x * 64;
  const int T = (p.M + 63) / 64;
  const float c = p.scale * kLog2e;
  const bf16* kg = slice(p.k, p.lk, g, p.H);
  const bf16* vg = slice(p.v, p.lv, g, p.H);

  auto issue = [&](int t) {
    const int st = t % kDqStages;
    stage_rows_async(Ks + st * TB, kg, p.lk.row, t * 64, p.M, p.d, 64, PN,
                     tid, kWgThreads);
    stage_rows_async(Vs + st * TB, vg, p.lv.row, t * 64, p.M, p.d, 64, PN,
                     tid, kWgThreads);
  };
  stage_rows_async(Qs, slice(p.q, p.lq, g, p.H), p.lq.row, n0, p.N, p.d, 64,
                   PN, tid, kWgThreads);
  stage_rows_async(Gs, slice(p.g, p.lg, g, p.H), p.lg.row, n0, p.N, p.d, 64,
                   PN, tid, kWgThreads);
#pragma unroll
  for (int t = 0; t < kDqStages - 1; ++t) {
    if (t < T) issue(t);
    cp_async_commit();
  }
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = n0 + rl + 8 * h;
    l2[h] = row < p.N ? p.lse[(long long)g * p.N + row] * kLog2e : 0.f;
    dd[h] = row < p.N ? p.di[(long long)g * p.N + row] : 0.f;
  }
  float acc[PN][32];
#pragma unroll
  for (int pn = 0; pn < PN; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;

  for (int t = 0; t < T; ++t) {
    const uint32_t kt = Ks + (t % kDqStages) * TB;
    const uint32_t vt = Vs + (t % kDqStages) * TB;
    cp_async_wait<kDqStages - 2>();  // kv tile t has landed
    fence_async_smem();
    __syncthreads();  // ... and tile t - 1's buffers are free
    if (t + kDqStages - 1 < T) issue(t + kDqStages - 1);
    cp_async_commit();
    float s[32], dp[32];
    issue_logits<PN>(s, dp, Qs, kt, Gs, vt);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 64 * t + 8 * (i / 4) + 2 * tq + (i & 1);
      const int h = (i >> 1) & 1;
      const float pf = col < p.M ? ex2(fmaf(s[i], c, -l2[h])) : 0.f;
      s[i] = (dp[i] - dd[h]) * pf * p.scale;
    }
    uint32_t la[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(s, kk, la[kk]);
    issue_weights<PN, 0>(acc, acc, la, la, kt, 0);
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < PN; ++pn) fence_regs(acc[pn]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) fence_regs(la[ks]);
  }
  store_tile<PN>(slice(p.dq, p.ldq, g, p.H), p.ldq.row, n0, p.N, p.d, rl, tq,
                 acc);
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// fp32, scalar.
// ---------------------------------------------------------------------------

// Operands of either scalar kernel; the dk/dv kernel leaves dq unused and
// the dq kernel dk and dv.
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

// Shared-memory opt-in flags of the two scalar kernels.
enum ScalarKernel { kDkvScalar, kDqScalar, kNumScalarKernels };
std::atomic<bool> g_opted_in[kMaxDevices][kNumScalarKernels];

// The operands every scalar entry shares; the entry fills in its outputs.
void fill(BwdParams& p, const void* q, const void* k, const void* v,
          const void* g, const void* lse, const void* di, int H, int N, int M,
          int d, const long long* strides, float scale) {
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

// The tensor-core problem: bf16 operands whose rows the 16-byte copies may
// read (base and strides); `strides` as for the entries.
int fill_tc(TcBwd& p, const void* q, const void* k, const void* v,
            const void* g, const void* lse, const void* di, int H, int N,
            int M, int d, const long long* strides, float scale) {
  const void* loaded[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i)
    if (!aligned16(loaded[i], layout_at(strides, i)))
      return (int)cudaErrorMisalignedAddress;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.g = static_cast<const bf16*>(g);
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
  return 0;
}

// One (64-row tile, slice) block of one warpgroup each; the shared-memory
// opt-in once per device and kernel.
template <typename Kernel>
int launch_tc(Kernel kernel, std::atomic<bool>* opted, size_t smem, int rows,
              int G, const TcBwd& p, cudaStream_t stream) {
  DeviceState* st = nullptr;
  int rc = current_device(&st);
  if (rc != 0) return rc;
  if (smem > (size_t)st->smem_optin) return (int)cudaErrorInvalidValue;
  rc = opt_in_smem(st, &opted[device_index(st)], kernel);
  if (rc != 0) return rc;
  kernel<<<dim3((rows + 63) / 64, G), kWgThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int PN>
int launch_dkv(const TcBwd& p, int G, cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  return launch_tc(flash_bwd_dkv<PN>, opted, dkv_smem_bytes<PN>(), p.M, G, p,
                   stream);
}

template <int PN>
int launch_dq(const TcBwd& p, int G, cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  return launch_tc(flash_bwd_dq<PN>, opted, dq_smem_bytes<PN>(), p.N, G, p,
                   stream);
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
  if (!flash_sizes_ok(B, H, N, M, d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear an earlier non-sticky error: report our own
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    BwdParams p;
    fill(p, q, k, v, g, lse, di, H, N, M, d, strides, scale);
    p.dk = dk;
    p.dv = dv;
    p.ldk = layout_at(strides, 4);
    p.ldv = layout_at(strides, 5);
    return launch_scalar(flash_attention_bwd_dkv_scalar_kernel, kDkvScalar, p,
                         M, B * H, 2, s);
  }
  TcBwd p;
  const int rc = fill_tc(p, q, k, v, g, lse, di, H, N, M, d, strides, scale);
  if (rc != 0) return rc;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.ldk = layout_at(strides, 4);
  p.ldv = layout_at(strides, 5);
  if (!aligned16(dk, p.ldk) || !aligned16(dv, p.ldv))
    return (int)cudaErrorMisalignedAddress;
  return d <= 64 ? launch_dkv<1>(p, B * H, s) : launch_dkv<2>(p, B * H, s);
}

// As above; `strides` holds 15 element strides: (batch, head, row) of q, k,
// v, g, dq. dq: (B, H, N, d).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* di,
                                      void* dq, int B, int H, int N, int M,
                                      int d, const long long* strides,
                                      float scale, int dtype, void* stream) {
  if (!flash_sizes_ok(B, H, N, M, d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    BwdParams p;
    fill(p, q, k, v, g, lse, di, H, N, M, d, strides, scale);
    p.dq = dq;
    p.ldq = layout_at(strides, 4);
    return launch_scalar(flash_attention_bwd_dq_scalar_kernel, kDqScalar, p, N,
                         B * H, 1, s);
  }
  TcBwd p;
  const int rc = fill_tc(p, q, k, v, g, lse, di, H, N, M, d, strides, scale);
  if (rc != 0) return rc;
  p.dq = static_cast<bf16*>(dq);
  p.ldq = layout_at(strides, 4);
  if (!aligned16(dq, p.ldq)) return (int)cudaErrorMisalignedAddress;
  return d <= 64 ? launch_dq<1>(p, B * H, s) : launch_dq<2>(p, B * H, s);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
