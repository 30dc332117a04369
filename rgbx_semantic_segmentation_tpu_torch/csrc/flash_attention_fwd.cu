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
// What bounds it on the H100: operations. N = M = 19200, d = 64 moves 20 MB
// per 8 slices and does 4*G*N*M*d = 7.5e11 operations: 0.76 ms at the dense
// bf16 rate against 0.03 ms of bytes. The (N, M) logits never reach device
// memory; k and v are re-read from L2 by every block of a slice.
//
// What the design does about it (bf16: `flash_attention_fwd_mma_kernel`):
//   * One block of 4 warps per 64 q rows of a slice (grid.x) and slice
//     (grid.y). A warp owns 16 q rows with its q fragments, its fp32 output
//     accumulator and its row statistics in registers for the whole kv
//     walk. (Two 16-row tiles a warp, so that one shared-memory read of a k
//     or v fragment feeds two mma, measured 5% SLOWER: 235 registers leave
//     two blocks an SM. The kernel waits on latency, not on shared memory.)
//   * k and v arrive in tiles of 64 rows, staged row-major in shared memory
//     with 16-byte loads; the next tile's loads are in flight, in
//     registers, while the current tile is computed on. q k^T reads k
//     fragments as 32-bit pairs; p @ v reads v fragments transposed through
//     ldmatrix, so v is never transposed in memory.
//     (A second shared buffer, with one barrier a tile instead of two,
//     measured within 5% either way at twice the shared memory: not kept.)
//   * The logits of a tile are mma accumulators; scaled, masked, turned
//     into p and rounded to bf16 they are already the A fragments of p @ v.
//     exp is `__expf` (one ex2.approx): the accurate expf's range reduction
//     took a fifth of the kernel's time, and its error (2^-21 relative) is
//     far below the bf16 rounding of p. The fp32 kernel keeps expf.
//   * Ragged edges: kv columns >= M get -inf (probability exactly 0) and
//     their rows of the staged tiles are zero; q rows >= N are computed on
//     zeros and not written. Nothing is padded in device memory.
//   * q, k, v are read and out is written through (batch, head, row)
//     strides: the model's head-split views go in, and the output's
//     (B, N, h, d) buffer makes the head merge a view.
// fp32 (`flash_attention_fwd_scalar_kernel`): the same walk in scalar fp32
// FMAs; a warp owns 4 q rows, a lane a kv row of a 32-row tile, then a set
// of head dims for p @ v. See flash_attention_common.cuh.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.

#include "flash_attention_common.cuh"

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

template <int KS>  // KS = padded head dim / 16
__global__ void __launch_bounds__(kFlashWarps * 32)
    flash_attention_fwd_mma_kernel(const FwdParams p) {
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
  bf16* og = slice(static_cast<bf16*>(p.out), p.lo, g, p.H);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int r0 = (blockIdx.x * kFlashWarps + warp) * 16;  // this warp's q rows

  uint32_t qa[KS][4];
  load_a_fragments<KS>(qa, qg, p.lq.row, r0, p.N, p.d, gq, tq);
  float o[DT][4];
#pragma unroll
  for (int u = 0; u < DT; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows gq, gq + 8
  float l[2] = {0.f, 0.f};              // this thread's share of their sums

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

    float s[NT][4];
    xyT_tile<KS>(qa, K_s, LD, gq, tq, s);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = c0 + t * 8 + 2 * tq;
      s[t][0] = c < p.M ? s[t][0] * p.scale : -INFINITY;
      s[t][1] = c + 1 < p.M ? s[t][1] * p.scale : -INFINITY;
      s[t][2] = c < p.M ? s[t][2] * p.scale : -INFINITY;
      s[t][3] = c + 1 < p.M ? s[t][3] * p.scale : -INFINITY;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // A tile always holds a column < M, so the new max is finite.
      float mx = m[half];
#pragma unroll
      for (int t = 0; t < NT; ++t)
        mx = fmaxf(mx, fmaxf(s[t][2 * half], s[t][2 * half + 1]));
      mx = quad_max(mx);
      const float alpha = __expf(m[half] - mx);  // 0 at the first tile
      m[half] = mx;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float e0 = __expf(s[t][2 * half] - mx);
        const float e1 = __expf(s[t][2 * half + 1] - mx);
        sum += e0 + e1;
        s[t][2 * half] = e0;
        s[t][2 * half + 1] = e1;
      }
      l[half] = l[half] * alpha + sum;
#pragma unroll
      for (int u = 0; u < DT; ++u) {
        o[u][2 * half] *= alpha;
        o[u][2 * half + 1] *= alpha;
      }
    }
    uint32_t pa[kTile / 16][4];
    pack_weights(s, pa);  // p rounded to bf16 here
    weights_times_tile<DT>(pa, V_s, LD, lane, o);
  }

  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float sum = quad_sum(l[half]);
    inv[half] = 1.f / sum;
    const int row = r0 + gq + 8 * half;
    if (tq == 0 && row < p.N)
      p.lse[(size_t)g * p.N + row] = m[half] + logf(sum);
  }
  store_rows<DT>(og, p.lo.row, r0, p.N, p.d, gq, tq, o, inv);
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

template <int KS>
int launch_mma(const FwdParams& p, int G, cudaStream_t stream) {
  constexpr int rows = kFlashWarps * 16;
  constexpr size_t smem = 2 * (size_t)kTile * (KS * 16 + 8) * sizeof(bf16);
  static_assert(smem <= 48 * 1024, "fits without the opt-in");
  const dim3 grid((p.N + rows - 1) / rows, G);
  flash_attention_fwd_mma_kernel<KS>
      <<<grid, kFlashWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

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
  switch (flash_ks(d)) {
    case 2: return launch_mma<2>(p, B * H, s);
    case 4: return launch_mma<4>(p, B * H, s);
    default: return launch_mma<8>(p, B * H, s);
  }
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
