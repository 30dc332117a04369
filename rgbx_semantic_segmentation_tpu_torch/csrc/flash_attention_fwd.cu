// Long-kv flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel the JAX package reaches through
// rgbx_semantic_segmentation_tpu/ops/attention.py `_flash_attention`: the
// forward `pallas_call` of jax.experimental.pallas.ops.tpu.flash_attention
// (`_flash_attention_kernel`). For every (batch*head) slice g:
//
//     out[g] = softmax(q[g] @ k[g]^T * scale) @ v[g]
//     lse[g] = log(sum(exp(q[g] @ k[g]^T * scale)))     per q row, fp32
//
// with kv streamed in tiles and an online softmax, and the TPU kernel's
// rounding points: logits accumulated in fp32 and multiplied by `scale`; the
// running max m and sum l in fp32; p = exp(s - m) rounded to the input dtype
// BEFORE the fp32-accumulated p @ v (l sums the unrounded p); the output
// divided by l after the product and rounded to the input dtype. The row
// statistics leave as one number, lse = m + log(l): the backward recomputes
// p = exp(s - lse).
//
// What bounds it on the H100: operations, and exponentials as much as
// products. N = M = 19200, d = 64 moves 20 MB per 8 slices and does
// 4*G*N*M*d = 7.5e11 operations: 0.76 ms at the dense bf16 rate against
// 0.03 ms of bytes; its G*N*M = 2.9e9 exps take about as long again at 16 a
// clock an SM. The (N, M) logits never reach device memory; k and v are
// re-read from L2 by every block of a slice.
//
// What the design does about it (bf16: `flash_fwd_tc`):
//   * wgmma with fp32 accumulators. A block is three warpgroups, each owning
//     64 q rows of one slice (grid.x: 192 rows, grid.y: the slice): every k
//     and v tile staged in shared memory feeds 192 q rows, a third of the L2
//     reads of one warpgroup a block (9 GB a mit_b2pp step, not 27).
//   * Staging by TMA (cp.async.bulk.tensor) into the 128-byte swizzle that
//     wgmma reads (wgmma_common.cuh): q once, k and v through a ring of 4
//     stages of 128 rows, each tile's arrival counted on an mbarrier. Thread
//     0 refills a stage once every warp of the block has released it (a
//     second mbarrier), two tiles behind its own warpgroup, so no thread
//     waits at a block-wide barrier inside the walk. The tensor maps read
//     q, k, v through their (batch, head, row) strides; rows past N or M and
//     columns past d arrive as zeros.
//   * Per kv tile t a warpgroup issues S = q k_t^T (m64n128k16, both
//     operands in shared memory) and, in the same turn, o += p_{t-1} v_{t-1}
//     (m64n64k16, p from registers, v MN-major), then waits for S only: the
//     softmax of tile t (one ex2.approx a logit, fmaf(s, scale * log2(e),
//     -m * scale * log2(e))) runs while the tensor cores finish p v and serve
//     the other warpgroups. The warpgroups take turns at issuing (named
//     barriers, warpgroup 0 first), so one's exps run under another's
//     products.
//   * p of a tile, rounded to bf16, is the A operand of its p v product; o
//     stays in fp32 registers for the whole walk, rescaled by
//     alpha = exp(m_old - m_new) after the previous product is done, and
//     not at all where alpha is exactly 1 (exact; 2% faster at stage 1 on
//     an H100). No partial sums, no atomics: two runs give the same bits.
//   * Ragged edges: kv columns >= M (the last tile only) get a -inf logit,
//     probability exactly 0, beside their zero-filled rows; q rows >= N are
//     computed on zeros and not written. Nothing is padded in device memory.
//   * out is written through its (batch, head, row) strides, so the
//     output's (B, N, h, d) buffer makes the head merge a view.
//   * One block an SM: the blocks past the last whole wave (stage 1: 800
//     blocks, 8 past 6 waves of 132) would run alone on a few SMs for a
//     whole block's time. They run last, each as a cluster of up to 8
//     blocks that walk a share of its kv tiles each and sum their o, m and
//     l through distributed shared memory in share order: the same bits
//     every run, no workspace.
//   * Any scale: m is the running max of the unscaled logits, or their
//     running min where the scale is negative (NEG), so that m * scale is
//     always the max of the scaled ones.
//   * The configurations measured against this one (warpgroups a block, kv
//     tile rows, ring stages, the refill's lag, turns, the skipped rescale,
//     the tail clusters) are in PERF.md section 6. d > 64 takes two
//     warpgroups and 64-row kv tiles.
// fp32 (`flash_attention_fwd_scalar_kernel`): the same walk in scalar fp32
// FMAs; a warp owns 4 q rows, a lane a kv row of a 32-row tile, then a set
// of head dims for p @ v. See flash_attention_common.cuh.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime

#include "flash_attention_common.cuh"
#include "wgmma_common.cuh"

#include <algorithm>
#include <type_traits>

namespace {

struct FwdParams {
  const void* q;  // (B, H, N, d)
  const void* k;  // (B, H, M, d)
  const void* v;  // (B, H, M, d)
  void* out;      // (B, H, N, d)
  float* lse;     // (B * H, N) fp32, contiguous
  Layout lq, lk, lv, lo;
  int H, N, M, d;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: TMA, mbarriers, wgmma.
// ---------------------------------------------------------------------------

// Which of a tensor map's dims 1-3 hold an operand's rows, heads and batches
// (dim 0 is the head dim; the host orders 1-3 by stride); 0 for an axis
// broadcast with stride 0, which is read at coordinate 0.
struct TmaAxes {
  int row, head, batch;
};

struct TcFwd {
  bf16* out;
  float* lse;  // (G, N) fp32
  Layout lo;
  TmaAxes aq, ak, av;
  int H, N, M, d;
  float scale;
  int qblocks;  // blocks of q rows a slice
  int first;    // flat index (slice * qblocks + q block) of block 0
  int splits;   // blocks (a cluster) that share one block's kv tiles
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Rows [row, row + box rows) of head h, batch b of an operand, columns
// [col, col + 64), into shared memory at `dst` (128-byte swizzle), counted
// on the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         const TmaAxes& ax, uint32_t bar,
                                         int col, int row, int h, int b) {
  auto at = [&](int dim) {
    return (ax.row == dim ? row : 0) + (ax.head == dim ? h : 0) +
           (ax.batch == dim ? b : 0);
  };
  const int c1 = at(1), c2 = at(2), c3 = at(3);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Named barriers of the warpgroups' turns (ids 1.., 0 is __syncthreads):
// two warpgroups meet at each.
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * kWgThreads) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * kWgThreads)
               : "memory");
}

// One wgmma group, not waited for: s = q k^T over a (64, d) q tile and a
// (BN, d) k tile, both K-major.
template <int PN, int BN>
__device__ __forceinline__ void issue_logits(float (&s)[BN / 2], uint32_t qt,
                                             uint32_t kt) {
  static_assert(BN == 64 || BN == 128, "kv tiles of 64 or 128 rows");
  if constexpr (BN == 64) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
  }
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4 * PN; ++ks) {
    if constexpr (BN == 128)
      wgmma_ss_n128(s, kmajor_desc(qt, 64, ks), kmajor_desc(kt, BN, ks),
                    ks > 0);
    else
      wgmma_ss(s, kmajor_desc(qt, 64, ks), kmajor_desc(kt, BN, ks));
  }
  wgmma_commit();
}

// One wgmma group, not waited for: o += p v, p (64, BN) bf16 in registers,
// v a (BN, d) tile, MN-major.
template <int PN, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[PN][32],
                                         uint32_t (&pa)[BN / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int pn = 0; pn < PN; ++pn) fence_regs(o[pn]);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int pn = 0; pn < PN; ++pn)
      wgmma_rs(o[pn], pa[kk], mnmajor_desc(vt, BN, pn, kk));
  wgmma_commit();
}

// The larger of two unscaled logits in the order of the scaled ones: the
// smaller where the scale is negative (NEG).
template <bool NEG>
__device__ __forceinline__ float top(float a, float b) {
  return NEG ? fminf(a, b) : fmaxf(a, b);
}

// The online softmax of one tile of logits s (this thread: rows rl and
// rl + 8, columns 8j + 2tq + e). Columns >= valid (MASK) take no part in m
// and get p = 0; m is the running top of the unscaled logits, so m * scale
// is the max of the scaled ones; c = scale * log2(e); s becomes
// p = exp(s * scale - m * scale), unrounded; l (this thread's share of the
// row sum) and alpha = exp(m_old * scale - m * scale), 0 at the first tile
// (FIRST), are updated.
template <int BN, bool NEG, bool MASK, bool FIRST>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float c,
                                               int valid, int tq) {
  constexpr float kNone = NEG ? INFINITY : -INFINITY;  // loses every top()
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (MASK) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * tq + e >= valid) s[4 * j + 2 * h + e] = kNone;
    }
    // Two chains for the max and four for the sum: shorter dependences.
    float mx0 = FIRST ? kNone : m[h], mx1 = mx0;
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      mx0 = top<NEG>(mx0, top<NEG>(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx1 = top<NEG>(mx1, top<NEG>(s[4 * j + 4 + 2 * h], s[4 * j + 5 + 2 * h]));
    }
    // A tile always holds a column < M: the top is finite.
    float mx = top<NEG>(mx0, mx1);
    mx = top<NEG>(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = top<NEG>(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[h] = FIRST ? 0.f : ex2((m[h] - mx) * c);
    m[h] = mx;
    const float mc = mx * c;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        // A masked column's logit is infinite, so its p is exactly 0,
        // except at scale 0, where infinity times 0 is NaN: max(NaN, 0) is
        // 0 (a select on the column instead spills a register).
        const float pe = ex2(fmaf(s[i], c, -mc));
        s[i] = MASK ? fmaxf(pe, 0.f) : pe;
        sum[(j & 1) * 2 + e] += s[i];
      }
    const float tile = (sum[0] + sum[1]) + (sum[2] + sum[3]);
    l[h] = FIRST ? tile : l[h] * alpha[h] + tile;
  }
}

// Bytes of dynamic shared memory: the 1024-byte alignment slack, the
// warpgroups' q tiles, the k and v rings and the mbarriers (a full and an
// empty one a stage, one for q). No static shared memory: the opt-in
// covers the whole of it.
template <int PN, int WGS, int BN, int STAGES>
constexpr size_t tc_smem_bytes() {
  return 1024 + (size_t)PN * kPanelRowBytes * (WGS * 64 + 2 * STAGES * BN) +
         8 * (2 * STAGES + 1);
}

// The end of a split block: every share (a block of the cluster) writes its
// unnormalised o, its row top m (of the unscaled logits) and its row sum l
// to its own shared memory at `red` (o: (64 * WGS, PN * 64 + 4) fp32, then
// m and l, 64 * WGS each; the k and v rings hold them); then share r reads
// every share's rows [r, r + 1) * 64 * WGS / splits from the cluster, in
// share order (the same bits every run): with M the top of the m and w_s =
// exp(m_s * scale - M * scale), out = sum_s w_s o_s / sum_s w_s l_s and
// lse = M * scale + log(sum_s w_s l_s).
template <int PN, int WGS, bool NEG>
__device__ __forceinline__ void combine_splits(
    float* red, const TcFwd& p, const float (&o)[PN][32],
    const float (&m)[2], const float (&sum)[2], int g, int q0, int split,
    int wg, int rl, int tq) {
  namespace cg = cooperative_groups;
  constexpr int R = 64 * WGS, DP = PN * kPanel, LD = DP + 4;
  float* stat = red + R * LD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * wg + rl + 8 * h;
#pragma unroll
    for (int pn = 0; pn < PN; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(red + row * LD + pn * kPanel + 8 * j +
                                   2 * tq) =
            make_float2(o[pn][4 * j + 2 * h], o[pn][4 * j + 2 * h + 1]);
    if (tq == 0) {
      stat[row] = m[h];
      stat[R + row] = sum[h];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float c = p.scale * kLog2e;
  const int r0 = split * R / p.splits, r1 = (split + 1) * R / p.splits;
  bf16* og = slice(p.out, p.lo, g, p.H);
  for (int i = threadIdx.x; i < (r1 - r0) * DP; i += WGS * kWgThreads) {
    const int row = r0 + i / DP, col = i % DP;
    float mx = stat[row];
    for (int s = 0; s < p.splits; ++s)
      mx = top<NEG>(mx, cluster.map_shared_rank(stat, s)[row]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const float w = ex2((cluster.map_shared_rank(stat, s)[row] - mx) * c);
      l += cluster.map_shared_rank(stat, s)[R + row] * w;
      acc += cluster.map_shared_rank(red, s)[row * LD + col] * w;
    }
    const int q = q0 + row;
    if (q < p.N && col < p.d)
      og[(long long)q * p.lo.row + col] = __float2bfloat16_rn(acc * (1.f / l));
    if (q < p.N && col == 0)
      p.lse[(long long)g * p.N + q] = mx * p.scale + logf(l);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// Block b of a launch: slice g = (p.first + b / p.splits) / p.qblocks, q
// rows [64 * WGS * qb, 64 * WGS * (qb + 1)) of it, qb the remainder; WGS
// warpgroups of 64 q rows, issuing in turn; kv tiles of BN rows through a
// ring of STAGES, a stage refilled kLag tiles after its release. With
// p.splits > 1 the blocks are clusters of p.splits: each walks its share of
// the kv tiles and the cluster sums the shares through distributed shared
// memory (combine_splits). NEG: scale < 0.
template <int PN, int WGS, int BN, int STAGES, bool NEG>
__global__ void __launch_bounds__(WGS * kWgThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const TcFwd p) {
  constexpr int QB = PN * 64 * kPanelRowBytes;  // one warpgroup's q tile
  constexpr int KB = PN * BN * kPanelRowBytes;  // one k (or v) tile
  constexpr int kLag = 2;
  static_assert(STAGES > kLag, "the refill needs a stage ahead");
  static_assert(WGS >= 2, "turns need two warpgroups");
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t Qs = base, Ks = Qs + WGS * QB, Vs = Ks + STAGES * KB;
  const uint32_t full = Vs + STAGES * KB, empty = full + 8 * STAGES;
  const uint32_t qbar = full + 16 * STAGES;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int tq = tid % 4;
  const int rl = 16 * ((tid % kWgThreads) / 32) + (tid % 32) / 4;
  const int blk = p.first + blockIdx.x / p.splits;
  const int split = blockIdx.x % p.splits;
  const int g = blk / p.qblocks, hb = g % p.H, bb = g / p.H;
  const int q0 = (blk % p.qblocks) * 64 * WGS;  // the block's first q row
  const int n0 = q0 + 64 * wg;                  // this warpgroup's
  // This block's kv tiles [t0, t0 + T) of the slice's (every one of them
  // unless the block is one share of a split).
  const int tiles = (p.M + BN - 1) / BN;
  const int t0 = split * tiles / p.splits;
  const int T = (split + 1) * tiles / p.splits - t0;
  const float c = p.scale * kLog2e;

  auto load_kv = [&](int t) {  // thread 0; local tile t
    const int st = t % STAGES;
    mbar_expect_tx(full + 8 * st, 2 * KB);
#pragma unroll
    for (int pn = 0; pn < PN; ++pn) {
      const uint32_t off = st * KB + pn * BN * kPanelRowBytes;
      tma_load(Ks + off, kmap, p.ak, full + 8 * st, pn * kPanel,
               (t0 + t) * BN, hb, bb);
      tma_load(Vs + off, vmap, p.av, full + 8 * st, pn * kPanel,
               (t0 + t) * BN, hb, bb);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * WGS);  // one arrival a warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, WGS * QB);
    for (int w = 0; w < WGS; ++w)
#pragma unroll
      for (int pn = 0; pn < PN; ++pn)
        tma_load(Qs + w * QB + pn * 64 * kPanelRowBytes, qmap, p.aq, qbar,
                 pn * kPanel, q0 + 64 * w, hb, bb);
    for (int t = 0; t < STAGES && t < T; ++t) load_kv(t);
  }

  // Turns: warpgroup w issues after w - 1 and signals w + 1; warpgroup 0
  // starts. Each waits T + 1 times; the last skips its final signal, so
  // every barrier sees as many arrivals as waits.
  const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % WGS;
  if (wg == WGS - 1) turn_arrive(1);

  const uint32_t qt = Qs + wg * QB;
  float o[PN][32];
#pragma unroll
  for (int pn = 0; pn < PN; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pn][i] = 0.f;
  float m[2], l[2], alpha[2];
  float s[BN / 2];
  uint32_t pa[BN / 16][4];

  // Columns of local tile t that exist (only the slice's last tile has
  // fewer than BN).
  auto valid = [&](int t) { return p.M - (t0 + t) * BN; };
  mbar_wait(qbar, 0);
  mbar_wait(full, 0);
  turn_sync(my_turn);
  issue_logits<PN, BN>(s, qt, Ks);
  turn_arrive(next_turn);
  wgmma_wait<0>();
  fence_regs(s);
  if (T == 1)
    online_softmax<BN, NEG, true, true>(s, m, l, alpha, c, valid(0), tq);
  else
    online_softmax<BN, NEG, false, true>(s, m, l, alpha, c, valid(0), tq);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) pack_a(s, kk, pa[kk]);

  // Tile t: S_t and the previous tile's p v in one turn, the softmax of
  // S_t under p v, then o rescaled and p_t packed.
  auto step = [&](int t, auto mask) {
    const int st = t % STAGES, prev = (t - 1) % STAGES;
    mbar_wait(full + 8 * st, (t / STAGES) & 1);
    turn_sync(my_turn);
    issue_logits<PN, BN>(s, qt, Ks + st * KB);
    issue_pv<PN, BN>(o, pa, Vs + prev * KB);
    turn_arrive(next_turn);
    wgmma_wait<1>();  // S_t; p v may still run
    fence_regs(s);
    online_softmax<BN, NEG, decltype(mask)::value, false>(s, m, l, alpha, c,
                                                          valid(t), tq);
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < PN; ++pn) fence_regs(o[pn]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
    if (tid % 32 == 0) mbar_arrive(empty + 8 * prev);  // tile t - 1 is read
    if (tid == 0 && t >= kLag && t - kLag + STAGES < T) {
      const int u = t - kLag;  // every warp has released tile u
      mbar_wait(empty + 8 * (u % STAGES), (u / STAGES) & 1);
      load_kv(u + STAGES);
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // skipped: exact
#pragma unroll
      for (int pn = 0; pn < PN; ++pn)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[pn][i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) pack_a(s, kk, pa[kk]);
  };
  for (int t = 1; t < T - 1; ++t) step(t, std::false_type());
  if (T > 1) step(T - 1, std::true_type());

  turn_sync(my_turn);
  issue_pv<PN, BN>(o, pa, Vs + ((T - 1) % STAGES) * KB);
  if (wg != WGS - 1) turn_arrive(next_turn);
  wgmma_wait<0>();
#pragma unroll
  for (int pn = 0; pn < PN; ++pn) fence_regs(o[pn]);

  float sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) sum[h] = quad_sum(l[h]);
  if (p.splits > 1) {
    // The rings are read (every warpgroup has waited for its last
    // product): they take this share's partials.
    __syncthreads();
    unsigned char* gbase = smem + (base - smem_u32(smem));
    static_assert((64 * WGS * (PN * kPanel + 6)) * 4 <= 2 * STAGES * KB,
                  "the partials fit in the rings");
    combine_splits<PN, WGS, NEG>(
        reinterpret_cast<float*>(gbase + (Ks - base)), p, o, m, sum, g, q0,
        split, wg, rl, tq);
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = n0 + rl + 8 * h;
    if (tq == 0 && row < p.N)
      p.lse[(long long)g * p.N + row] = m[h] * p.scale + logf(sum[h]);
  }
  bf16* og = slice(p.out, p.lo, g, p.H);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = n0 + rl + 8 * h;
    if (row >= p.N) continue;
    const float inv = 1.f / sum[h];
    bf16* dst = og + (long long)row * p.lo.row;
#pragma unroll
    for (int pn = 0; pn < PN; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = pn * kPanel + 8 * j + 2 * tq;
        if (col < p.d)
          *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(
              o[pn][4 * j + 2 * h] * inv, o[pn][4 * j + 2 * h + 1] * inv);
      }
  }
}

// fp32: scalar FMAs. Shared memory: the warps' q rows, a k tile, a v tile,
// the warps' p of the current tile.
__global__ void __launch_bounds__(kScalarWarps * 32)
    flash_attention_fwd_scalar_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = p.d;
  float* X_s = reinterpret_cast<float*>(smem);     // (warps, d, kOwn)
  float* K_s = X_s + kScalarRows * d;              // (kScalarTile, d + 1)
  float* V_s = K_s + kScalarTile * (d + 1);        // (kScalarTile, d + 1)
  float* W_s = V_s + kScalarTile * (d + 1);        // (warps, kScalarTile, kOwn)

  const int g = blockIdx.y;
  const float* qg = slice(static_cast<const float*>(p.q), p.lq, g, p.H);
  const float* kg = slice(static_cast<const float*>(p.k), p.lk, g, p.H);
  const float* vg = slice(static_cast<const float*>(p.v), p.lv, g, p.H);
  float* og = slice(static_cast<float*>(p.out), p.lo, g, p.H);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kScalarRows + warp * kOwn;
  float* xw = X_s + warp * d * kOwn;
  float* ww = W_s + warp * kScalarTile * kOwn;
  stage_own(xw, qg, p.lq.row, r0, p.N, d, lane);

  float m[kOwn], l[kOwn], o[kOwn][kFlashDimTiles];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < kFlashDimTiles; ++u) o[r][u] = 0.f;
  }

  for (int c0 = 0; c0 < p.M; c0 += kScalarTile) {
    __syncthreads();  // the previous tile and its p are consumed
    stage_scalar_tile(K_s, kg, p.lk.row, c0, p.M, d);
    stage_scalar_tile(V_s, vg, p.lv.row, c0, p.M, d);
    __syncthreads();
    float s[kOwn];
    dots_own(xw, K_s + lane * (d + 1), d, s);
    const bool valid = c0 + lane < p.M;
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const float sv = valid ? s[r] * p.scale : -INFINITY;
      const float mx = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - mx);
      const float e = expf(sv - mx);
      l[r] = l[r] * alpha + warp_sum(e);
      m[r] = mx;
#pragma unroll
      for (int u = 0; u < kFlashDimTiles; ++u) o[r][u] *= alpha;
      ww[lane * kOwn + r] = e;
    }
    __syncwarp();
    weights_times_scalar_tile(ww, V_s, d, lane, o);
  }

#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int row = r0 + r;
    if (row >= p.N) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int u = 0; u < kFlashDimTiles; ++u) {
      const int e = lane + 32 * u;
      if (e < d) og[(long long)row * p.lo.row + e] = o[r][u] * inv;
    }
    if (lane == 0) p.lse[(size_t)g * p.N + row] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

std::atomic<bool> g_opted_in[kMaxDevices];

int launch_scalar(const FwdParams& p, int G, cudaStream_t stream) {
  DeviceState* st = nullptr;
  int rc = current_device(&st);
  if (rc != 0) return rc;
  rc = opt_in_smem(st, &g_opted_in[device_index(st)],
                   flash_attention_fwd_scalar_kernel);
  if (rc != 0) return rc;
  const size_t smem = scalar_smem_bytes(p.d, 1, 1);
  if (smem > (size_t)st->smem_optin) return (int)cudaErrorInvalidValue;
  const dim3 grid((p.N + kScalarRows - 1) / kScalarRows, G);
  flash_attention_fwd_scalar_kernel<<<grid, kScalarWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, fetched through the runtime (no link to libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 4-D tensor map of a (B, H, rows, d) bf16 operand with element strides
// `l` (unit stride along d): dim 0 the head dim, dims 1-3 rows, heads and
// batches in the order of their strides (the encoder also takes rows that
// overlap or repeat with stride 0). A head or batch axis that is never stepped over (extent 1, or
// broadcast with stride 0) goes last as a dim of extent 1 with the stride
// of a packed layout, and is read at coordinate 0. Boxes of 64 columns x
// box_rows rows, 128-byte swizzle, zeros outside the operand. `ax`
// receives the order.
int make_map(CUtensorMap* map, TmaAxes* ax, const void* ptr, const Layout& l,
             int B, int H, int rows, int d, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  struct Axis {
    long long stride;
    int extent, box, which;
  } axes[3] = {{l.row, rows, box_rows, 0}, {l.h, H, 1, 1}, {l.b, B, 1, 2}};
  auto fixed = [](const Axis& a) {
    return a.which != 0 && (a.extent == 1 || a.stride == 0);
  };
  auto key = [&](const Axis& a) {
    return fixed(a) ? (long long)1 << 62 : a.stride;
  };
  for (int i = 1; i < 3; ++i)  // insertion sort, stable
    for (int j = i; j > 0 && key(axes[j]) < key(axes[j - 1]); --j) {
      const Axis t = axes[j];
      axes[j] = axes[j - 1];
      axes[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)d, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)kPanel, 0, 0, 0};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int* slot[3] = {&ax->row, &ax->head, &ax->batch};
  cuuint64_t below = (cuuint64_t)d * sizeof(bf16);  // bytes the lower dims span
  for (int i = 0; i < 3; ++i) {
    const bool f = fixed(axes[i]);
    dims[i + 1] = f ? 1 : (cuuint64_t)axes[i].extent;
    strides[i] = f ? below : (cuuint64_t)axes[i].stride * sizeof(bf16);
    below = std::max(below, strides[i] * dims[i + 1]);
    box[i + 1] = (cuuint32_t)axes[i].box;
    *slot[axes[i].which] = f ? 0 : i + 1;
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Blocks a cluster may hold: the portable limit.
constexpr int kMaxSplits = 8;
// kv tiles a block must walk for its tail to be split: the second launch
// and the combine cost about a 10-tile walk (mit_b2pp stage 3, 10 tiles:
// 0.061 ms a call unsplit, 0.068 split; H100, PERF.md section 6).
constexpr int kMinSplitTiles = 32;
static_assert(kMinSplitTiles >= kMaxSplits, "every share has a tile");

template <int PN, int WGS, int BN, int STAGES, bool NEG>
int launch_tc(const FwdParams& f, int B, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<PN, WGS, BN, STAGES>();
  static std::atomic<bool> opted[kMaxDevices];
  // Whether the card places a cluster of s blocks: 0 not asked yet, 1 yes,
  // 2 no. The answer never changes, so it is asked once a device.
  static std::atomic<int> placed[kMaxDevices][kMaxSplits + 1];
  DeviceState* st = nullptr;
  int rc = current_device(&st);
  if (rc != 0) return rc;
  if (smem > (size_t)st->smem_optin) return (int)cudaErrorInvalidValue;
  const auto kernel = flash_fwd_tc<PN, WGS, BN, STAGES, NEG>;
  rc = opt_in_smem(st, &opted[device_index(st)], kernel);
  if (rc != 0) return rc;
  TcFwd p;
  p.out = static_cast<bf16*>(f.out);
  p.lse = f.lse;
  p.lo = f.lo;
  p.H = f.H;
  p.N = f.N;
  p.M = f.M;
  p.d = f.d;
  p.scale = f.scale;
  p.qblocks = (f.N + 64 * WGS - 1) / (64 * WGS);
  CUtensorMap qmap, kmap, vmap;
  rc = make_map(&qmap, &p.aq, f.q, f.lq, B, f.H, f.N, f.d, 64);
  if (rc == 0) rc = make_map(&kmap, &p.ak, f.k, f.lk, B, f.H, f.M, f.d, BN);
  if (rc == 0) rc = make_map(&vmap, &p.av, f.v, f.lv, B, f.H, f.M, f.d, BN);
  if (rc != 0) return rc;

  // One block an SM. The blocks past the last whole wave (the tail) would
  // leave most SMs idle while they run: where their kv walk is long, each
  // becomes a cluster of `splits` blocks that share its kv tiles, launched
  // after the whole waves.
  const int blocks = B * f.H * p.qblocks;
  const int tail = blocks % st->sms;
  const int tiles = (f.M + BN - 1) / BN;
  int splits = tail > 0 && tiles >= kMinSplitTiles ? st->sms / tail : 1;
  if (splits > kMaxSplits) splits = kMaxSplits;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(WGS * kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (; splits > 1; splits /= 2) {  // a cluster size the card can place
    std::atomic<int>& known = placed[device_index(st)][splits];
    attr[0].val.clusterDim.x = splits;
    cfg.gridDim = dim3(tail * splits);
    if (known.load(std::memory_order_relaxed) == 0) {
      int clusters = 0;
      const bool fits =
          cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) ==
              cudaSuccess &&
          clusters > 0;
      if (!fits) cudaGetLastError();
      known.store(fits ? 1 : 2, std::memory_order_relaxed);
    }
    if (known.load(std::memory_order_relaxed) == 1) break;
  }
  const int whole = splits > 1 ? blocks - tail : blocks;
  if (whole > 0) {
    p.first = 0;
    p.splits = 1;
    kernel<<<whole, WGS * kWgThreads, smem, stream>>>(qmap, kmap, vmap, p);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (splits > 1) {
    p.first = whole;
    p.splits = splits;
    rc = (int)cudaLaunchKernelEx(&cfg, kernel, qmap, kmap, vmap, p);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}

// The configurations of the bf16 route (PERF.md section 6 has the ones
// measured): d <= 64, three warpgroups (192 q rows) a block and kv
// tiles of 128 rows in a ring of 4 (168 registers, no spills); d > 64, two
// panels a row, two warpgroups and kv tiles of 64 rows (not on the models'
// path; the registers of a 64 x 128 o tile leave no room for more). Each
// in a second form for a negative scale.
int launch_bf16(const FwdParams& f, int B, cudaStream_t stream) {
  const bool neg = f.scale < 0.f;
  if (f.d <= 64)
    return neg ? launch_tc<1, 3, 128, 4, true>(f, B, stream)
               : launch_tc<1, 3, 128, 4, false>(f, B, stream);
  return neg ? launch_tc<2, 2, 64, 4, true>(f, B, stream)
             : launch_tc<2, 2, 64, 4, false>(f, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out: (B, H, N, d); k/v: (B, H, M, d),
// on the current device, each with unit stride along d; d a multiple of 8,
// at most 128. `strides` holds 12 element strides: (batch, head, row) of q,
// k, v and out, in that order. lse: (B * H, N) fp32, contiguous. bf16
// operands start on 16-byte boundaries and have strides that are multiples
// of 8. Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int H, int N,
                                   int M, int d, const long long* strides,
                                   float scale, int dtype, void* stream) {
  if (!flash_sizes_ok(B, H, N, M, d)) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear an earlier non-sticky error: report our own
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.lq = layout_at(strides, 0);
  p.lk = layout_at(strides, 1);
  p.lv = layout_at(strides, 2);
  p.lo = layout_at(strides, 3);
  p.H = H;
  p.N = N;
  p.M = M;
  p.d = d;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_scalar(p, B * H, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(q, p.lq) || !aligned16(k, p.lk) || !aligned16(v, p.lv) ||
      !aligned16(out, p.lo))
    return (int)cudaErrorMisalignedAddress;
  return launch_bf16(p, B, s);
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
