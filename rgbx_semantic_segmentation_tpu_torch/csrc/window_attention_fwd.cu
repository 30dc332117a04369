// Window attention forward (Swin W-MSA / SW-MSA) for Hopper (sm_90a).
//
// Replaces the TPU kernel rgbx_semantic_segmentation_tpu/ops/
// window_attention.py `_fwd_kernel` (launched by `_wfwd_call`). For every
// (image b, window w, head i), with N = ws * ws tokens and head dim d:
//
//     l   = (q k^T) * scale + bias[w, i]        fp32; scale on the fp32 logits
//     pf  = softmax(l)                          fp32, one exact pass
//     p   = T(pf)                               rounded to the input type
//     pd  = keep ? T(p / (1 - rate)) : 0        only with dropout
//     out = pd v                                fp32 accumulation, cast to T
//
// The keep mask comes from Philox4x32-10 inside the kernel (attention_common.
// cuh `Dropout`), keyed by a seed read from device memory; the backward
// regenerates it, so neither probabilities nor mask reach device memory.
//
// What bounds it on the H100: bytes. A unit is 2 * 2 * N * N * d operations
// (0.3 MFLOP at N = 49, d = 32) on 4 * N * d elements, far under the card's
// 295 operations per byte; the least traffic is qkv read once, out written
// once and the bias read once.
//
// What the design does about it. The TPU kernel packs several windows into
// one block-diagonal unit to fill its 128-wide matrix unit and needs a pack
// transpose around it. Here the kernel takes the WHOLE padded, rolled image
// qkv (B, Hp, Wp, 3C) and addresses a window's tokens through the image's
// strides (ws runs of ws pixels), writing out (B, Hp, Wp, C): no partition,
// pack or reverse copies exist, and no off-diagonal work.
//   * bf16, d a multiple of 8 up to 64, N <= 144 (both Swin variants):
//     `window_attention_fwd_mma_kernel`. One block of 4 warps per
//     (b, w, i); the image index runs fastest over the grid, so the blocks
//     that share a bias block run together and it is read from L2. q, k, v
//     of the unit are staged in shared memory with 16-byte loads (each
//     token's d channels are one 2*d-byte run). A warp owns 16 query rows:
//     the logits of all N keys are mma.sync m16n8k16 accumulators and stay
//     in registers (28 at N = 49), so the softmax is a single exact pass, p
//     in accumulator layout is already the A operand of p @ v, and v's B
//     fragments come transposed out of ldmatrix. The bias block of a 7x7
//     window is staged with q, k, v (coalesced, its latency hidden behind
//     theirs) instead of being read element by element after the product.
//     The output tile goes back through the warp's own q rows in shared
//     memory and leaves in 16-byte stores.
//   * fp32 and every other shape up to N = 256, d = 128:
//     `window_attention_fwd_scalar_kernel`, a warp per query row with fp32
//     FMAs, reading k and v through the caches.
//
// Interface: plain C, loaded with ctypes; the launch goes on the caller's
// stream and the function returns cudaGetLastError() after it.

#include "window_attention_common.cuh"

namespace {

constexpr int kMmaWarps = 4;

template <int KS, int NT>  // padded head dim / 16; 8-wide key tiles
__global__ void __launch_bounds__(kMmaWarps * 32)
    window_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                    const float* __restrict__ bias,
                                    __nv_bfloat16* __restrict__ out,
                                    const long long* __restrict__ seed,
                                    const Window g, Dropout dr) {
  constexpr int DP = KS * 16;
  constexpr int DT = DP / 8;
  constexpr int RT = (NT * 8 + 15) / 16;  // 16-row tiles
  constexpr int ROWS = RT * 16;
  constexpr int LD = DP + 8;  // 16-byte aligned rows, conflict-free fragments
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + ROWS * LD;
  __nv_bfloat16* Vs = Ks + ROWS * LD;
  float* Bs = reinterpret_cast<float*>(Vs + ROWS * LD);  // if kStageBias<NT>

  const int b = blockIdx.x % g.B;
  const int unit = blockIdx.x / g.B;
  const int w = unit / g.h;
  const int head = unit - w * g.h;
  const int C = g.h * g.d;
  load_seed(dr, seed);

  const __nv_bfloat16* src = qkv + head * g.d;
  stage_tile<DP>(Qs, LD, src, 3 * C, g, b, w, ROWS);
  stage_tile<DP>(Ks, LD, src + C, 3 * C, g, b, w, ROWS);
  stage_tile<DP>(Vs, LD, src + 2 * C, 3 * C, g, b, w, ROWS);
  // A small window's bias block rides along with coalesced loads, so the
  // softmax reads it from shared memory; a large one stays in global memory.
  const float* bb = bias_block(bias, g, w, head);
  if constexpr (kStageBias<NT>) {
    for (int i = threadIdx.x; i < g.N * g.N; i += blockDim.x) Bs[i] = bb[i];
    bb = Bs;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  for (int rt = warp; rt < RT; rt += kMmaWarps) {
    float s[NT][4];
    probs_tile<KS, NT>(Qs, Ks, LD, bb, g, rt, gq, tq, s);
    uint32_t pk[NT][2];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      uint32_t bits[4] = {0u, 0u, 0u, 0u};
      if (dr.on) dropout_bits(dr, t * 4 + tq, rt * 8 + gq, unit, b, bits);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = dropped_prob<__nv_bfloat16>(s[t][e], bits[e] >= dr.thr, dr);
      pk[t][0] = pack_bf16(p[0], p[1]);
      pk[t][1] = pack_bf16(p[2], p[3]);
    }
    float o[DT][4];
#pragma unroll
    for (int u = 0; u < DT; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
    acc_tile_times<NT, DT>(pk, Vs, LD, lane, o);
    // Only this warp reads q rows [rt*16, rt*16 + 16): they carry the
    // output tile to the coalesced store.
    __syncwarp();
    store_acc<DT>(Qs, LD, rt * 16, gq, tq, o);
    __syncwarp();
    unstage_rows<DP>(out + head * g.d, C, Qs, LD, g, b, w, rt * 16, lane);
  }
}

// ---------------------------------------------------------------------------
// Scalar kernel: any T, N <= 256, d <= 128. One block per (b, w, i), a warp
// per query row; lane j owns key columns j, j + 32, ... for the logits and
// head dims j, j + 32, ... for p @ v. The backward's scalar kernel repeats
// the logits expression below term for term.
// ---------------------------------------------------------------------------

constexpr int kScalarWarps = 8;
constexpr int kColsPerLane = kWinMaxN / 32;
constexpr int kDimsPerLane = kWinMaxD / 32;

template <typename T>
__global__ void __launch_bounds__(kScalarWarps * 32)
    window_attention_fwd_scalar_kernel(const T* __restrict__ qkv,
                                       const float* __restrict__ bias,
                                       T* __restrict__ out,
                                       const long long* __restrict__ seed,
                                       const Window g, Dropout dr) {
  __shared__ long long pix[kWinMaxN];
  __shared__ float q_s[kScalarWarps][kWinMaxD];
  __shared__ float p_s[kScalarWarps][kWinMaxN];

  const int b = blockIdx.x % g.B;
  const int unit = blockIdx.x / g.B;
  const int w = unit / g.h;
  const int head = unit - w * g.h;
  const int C = g.h * g.d;
  const int N = g.N, d = g.d;
  load_seed(dr, seed);
  for (int t = threadIdx.x; t < N; t += blockDim.x)
    pix[t] = token_pixel(g, b, w, t);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* qh = qkv + head * d;
  const T* kh = qh + C;
  const T* vh = qh + 2 * C;
  const float* bb = bias_block(bias, g, w, head);

  for (int row = warp; row < N; row += kScalarWarps) {
    for (int e = lane; e < d; e += 32)
      q_s[warp][e] = to_float(qh[pix[row] * 3 * C + e]);
    __syncwarp();
    float l[kColsPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int col = lane + 32 * j;
      l[j] = -INFINITY;
      if (col < N) {
        const T* kr = kh + pix[col] * 3 * C;
        float acc = 0.f;
        for (int e = 0; e < d; ++e)
          acc = fmaf(q_s[warp][e], to_float(kr[e]), acc);
        l[j] = acc * g.scale + bb[row * N + col];
      }
      mx = fmaxf(mx, l[j]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      l[j] = lane + 32 * j < N ? expf(l[j] - mx) : 0.f;
      sum += l[j];
    }
    // One division a row (see probs_tile); the backward does the same.
    const float inv = 1.f / warp_sum(sum);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int col = lane + 32 * j;
      if (col < N) {
        const bool keep =
            !dr.on || dropout_bits_at(dr, row, col, unit, b) >= dr.thr;
        p_s[warp][col] = dropped_prob<T>(l[j] * inv, keep, dr);
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kDimsPerLane; ++u) {
      const int e = lane + 32 * u;
      if (e < d) {
        float acc = 0.f;
        for (int col = 0; col < N; ++col)
          acc = fmaf(p_s[warp][col], to_float(vh[pix[col] * 3 * C + e]), acc);
        out[pix[row] * C + head * d + e] = from_float<T>(acc);
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum KernelId { kMma2x7, kMma4x7, kMma2x18, kMma4x18, kNumKernels };
std::atomic<bool> g_opted_in[kMaxDevices][kNumKernels];

template <int KS, int NT>
int launch_mma(KernelId id, const void* qkv, const float* bias, void* out,
               const long long* seed, const Window& g, const Dropout& dr,
               long long blocks, DeviceState* st, cudaStream_t stream) {
  constexpr int ROWS = (NT * 8 + 15) / 16 * 16;
  constexpr size_t smem =
      (size_t)3 * ROWS * (KS * 16 + 8) * sizeof(__nv_bfloat16) +
      (kStageBias<NT> ? (size_t)NT * 8 * NT * 8 * sizeof(float) : 0);
  const int rc = opt_in_smem(st, &g_opted_in[device_index(st)][id],
                             window_attention_fwd_mma_kernel<KS, NT>);
  if (rc != 0) return rc;
  window_attention_fwd_mma_kernel<KS, NT>
      <<<(unsigned)blocks, kMmaWarps * 32, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(qkv), bias,
          static_cast<__nv_bfloat16*>(out), seed, g, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scalar(const void* qkv, const float* bias, void* out,
                  const long long* seed, const Window& g, const Dropout& dr,
                  long long blocks, cudaStream_t stream) {
  window_attention_fwd_scalar_kernel<T>
      <<<(unsigned)blocks, kScalarWarps * 32, 0, stream>>>(
          static_cast<const T*>(qkv), bias, static_cast<T*>(out), seed, g, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qkv: (B, Hp, Wp, 3 * h * d) contiguous,
// channels in (3, h, d) order; bias: fp32 (h, ws^2, ws^2) blocks,
// `bias_w_stride` elements apart from window to window (0: one block shared
// by all windows); out: (B, Hp, Wp, h * d) contiguous; seed: one int64 in
// device memory, read only when `dropout` is set; thr and inv_keep: see
// attention_common.cuh `Dropout`. All on the current device. Returns a
// cudaError_t code (0 = launched).
extern "C" int window_attention_fwd(const void* qkv, const float* bias,
                                    void* out, const long long* seed, int B,
                                    int Hp, int Wp, int h, int d, int ws,
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
  Window g;
  g.B = B;
  g.Hp = Hp;
  g.Wp = Wp;
  g.h = h;
  g.d = d;
  g.ws = ws;
  g.N = ws * ws;
  g.nWj = Wp / ws;
  g.nW = (Hp / ws) * g.nWj;
  g.bias_w = bias_w_stride;
  g.scale = scale;
  Dropout dr;
  dr.k0 = dr.k1 = 0u;
  dr.thr = thr;
  dr.inv_keep = inv_keep;
  dr.on = dropout;
  const long long blocks = (long long)B * g.nW * h;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d % 8 == 0 && d <= 64 && g.N <= 144) {
    const bool small = g.N <= 56;
    if (d <= 32)
      return small ? launch_mma<2, 7>(kMma2x7, qkv, bias, out, seed, g, dr,
                                      blocks, st, s)
                   : launch_mma<2, 18>(kMma2x18, qkv, bias, out, seed, g, dr,
                                       blocks, st, s);
    return small ? launch_mma<4, 7>(kMma4x7, qkv, bias, out, seed, g, dr,
                                    blocks, st, s)
                 : launch_mma<4, 18>(kMma4x18, qkv, bias, out, seed, g, dr,
                                     blocks, st, s);
  }
  if (dtype == 1)
    return launch_scalar<__nv_bfloat16>(qkv, bias, out, seed, g, dr, blocks, s);
  if (dtype == 0)
    return launch_scalar<float>(qkv, bias, out, seed, g, dr, blocks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* window_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
