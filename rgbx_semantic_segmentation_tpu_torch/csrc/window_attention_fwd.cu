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
//     `window_attention_fwd_tc`, 4 warps. The kernel is bound by issue
//     slots more than by bytes (per (unit, image) and thread: 7 Philox
//     calls, 28 exps, the softmax's index math), so the design keeps copies
//     in flight and instructions few rather than moving products to wgmma.
//     A 7x7 window's block owns one (window, head) unit and walks all B of
//     its images: the unit's bias block is staged once, with the first
//     image (4-byte cp.async), as N rows of 56 columns with -inf past N, so
//     the logits need no masks, and q, k, v of image i + 1 arrive by 16-byte
//     cp.async in a two-stage ring while image i is computed (one barrier
//     an image), padding rows zero-filled. (Splitting a unit's images over
//     2-8 blocks measured no faster a swin_s step at batch 8, PERF.md
//     section 6.) A 12x12 window's bias block stays in device memory, so a
//     group of images would save no bias reads: there a block takes one
//     image of a unit and a single stage, with half the ring's shared
//     memory, and the blocks of a unit are neighbours in the grid, so a
//     shifted call reads each bias block from device memory once. The
//     window's pixel offsets are computed once a block. A warp owns 16 query
//     rows: the logits of all N keys are mma.sync m16n8k16 accumulators and
//     stay in registers (28 at N = 49), so the softmax is a single exact
//     pass, p in accumulator layout is already the A operand of p @ v, and
//     v's B fragments come transposed out of ldmatrix. The output tile goes
//     back through the warp's own q rows in shared memory and leaves in
//     16-byte stores.
//   * fp32 and every other shape up to N = 256, d = 128:
//     `window_attention_fwd_scalar_kernel`, a warp per query row with fp32
//     FMAs, reading k and v through the caches.
//
// Interface: plain C, loaded with ctypes; the launch goes on the caller's
// stream and the function returns cudaGetLastError() after it.

#include "window_attention_common.cuh"

namespace {

constexpr int kMmaWarps = 4;

template <int NT>
constexpr int kRows = (NT * 8 + 15) / 16 * 16;  // 16-row tiles of the window
template <int KS>
constexpr int kLd = KS * 16 + 8;  // 16-byte aligned rows, conflict-free

// (q, k, v) stages a block: a ring of two where it walks all of a unit's
// images (the bias block staged, kStageBias<NT>), else one.
template <int NT>
constexpr int kStages = kStageBias<NT> ? 2 : 1;

// Dynamic shared memory of the tensor-core kernel: the window's pixels, the
// staged bias block (kStageBias<NT>) and the (q, k, v) stages.
template <int KS, int NT>
constexpr size_t kFwdSmem =
    (size_t)kRows<NT> * sizeof(int) + kBiasBytes<NT> +
    (size_t)kStages<NT> * 3 * kRows<NT> * kLd<KS> * sizeof(__nv_bfloat16);

// A block owns one (window, head) unit: all of its B images with the bias
// staged (blockIdx.x = unit), else image blockIdx.x % B (blockIdx.x = unit
// * B + image, so the blocks of a unit run together and its bias block is
// read from L2).
template <int KS, int NT>  // padded head dim / 16; 8-wide key tiles
__global__ void __launch_bounds__(kMmaWarps * 32)
    window_attention_fwd_tc(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out,
                            const long long* __restrict__ seed, const Window g,
                            Dropout dr) {
  constexpr int DP = KS * 16;
  constexpr int DT = DP / 8;
  constexpr int ROWS = kRows<NT>;
  constexpr int RT = ROWS / 16;
  constexpr int LD = kLd<KS>;
  constexpr int TILE = ROWS * LD;  // elements of one staged tile
  extern __shared__ __align__(16) unsigned char smem[];
  int* pix = reinterpret_cast<int*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + ROWS * sizeof(int));
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(
      smem + ROWS * sizeof(int) + kBiasBytes<NT>);

  constexpr int STAGES = kStages<NT>;
  const int blocks_a_unit = STAGES == 2 ? 1 : g.B;
  const int unit = blockIdx.x / blocks_a_unit;
  const int b0 = blockIdx.x - unit * blocks_a_unit;
  const int nb = STAGES == 2 ? g.B : 1;  // images of this block
  const int w = unit / g.h;
  const int head = unit - w * g.h;
  const int C = g.h * g.d;
  const long long image = (long long)g.Hp * g.Wp;  // pixels an image
  load_seed(dr, seed);
  window_pixels(pix, g, w, ROWS);
  const float* bb = bias_block(bias, g, w, head);
  if constexpr (kStageBias<NT>) {
    stage_bias_async<kBiasLd<NT>>(Bs, bb, g.N);
    bb = Bs;
  }
  __syncthreads();  // pix

  // Image b0 + i's q, k, v into stage i % STAGES, one commit group.
  auto stage = [&](int i) {
    const __nv_bfloat16* src = qkv + (b0 + i) * image * 3 * C + head * g.d;
    const uint32_t dst = smem_u32(ring + (i % STAGES) * 3 * TILE);
    stage_tile_async<DP>(dst, LD, src, 3 * C, pix, g.d, ROWS);
    stage_tile_async<DP>(dst + TILE * 2, LD, src + C, 3 * C, pix, g.d, ROWS);
    stage_tile_async<DP>(dst + TILE * 4, LD, src + 2 * C, 3 * C, pix, g.d,
                         ROWS);
    cp_async_commit();
  };
  stage(0);  // with the bias block

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  for (int i = 0; i < nb; ++i) {
    // Image i has landed, and every thread is done with image i - 1, whose
    // stage the copy of image i + 1 now refills under image i's compute.
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < nb) stage(i + 1);
    const int b = b0 + i;
    __nv_bfloat16* Qs = ring + (i % STAGES) * 3 * TILE;
    const __nv_bfloat16* Ks = Qs + TILE;
    const __nv_bfloat16* Vs = Ks + TILE;
    for (int rt = warp; rt < RT; rt += kMmaWarps) {
      float s[NT][4];
      probs_tile<KS, NT>(Qs, Ks, LD, bb, g, rt, gq, tq, s);
      uint32_t pk[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bits[4] = {0u, 0u, 0u, 0u};
        if (dr.on) dropout_bits(dr, t * 4 + tq, rt * 8 + gq, unit, b, bits);
        pk[t][0] = dropped_pair(s[t][0], s[t][1], bits[0] >= dr.thr,
                                bits[1] >= dr.thr, dr);
        pk[t][1] = dropped_pair(s[t][2], s[t][3], bits[2] >= dr.thr,
                                bits[3] >= dr.thr, dr);
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
      unstage_rows<DP>(out + b * image * C + head * g.d, C, Qs, LD, pix, g.d,
                       rt * 16, lane);
    }
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

enum KernelId { kTc2x7, kTc4x7, kTc2x18, kTc4x18, kNumKernels };
std::atomic<bool> g_opted_in[kMaxDevices][kNumKernels];

// The tensor-core route: a block a unit, or a block a (unit, image) where
// the bias block is not staged.
template <int KS, int NT>
int launch_tc(KernelId id, const void* qkv, const float* bias, void* out,
              const long long* seed, const Window& g, const Dropout& dr,
              DeviceState* st, cudaStream_t stream) {
  constexpr size_t smem = kFwdSmem<KS, NT>;
  const int rc = opt_in_smem(st, &g_opted_in[device_index(st)][id],
                             window_attention_fwd_tc<KS, NT>);
  if (rc != 0) return rc;
  const long long blocks =
      (long long)g.nW * g.h * (kStages<NT> == 2 ? 1 : g.B);
  window_attention_fwd_tc<KS, NT>
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
// attention_common.cuh `Dropout`; window0: the image's index of the first
// window (the masks' counter; 0 unless qkv is a slab of window rows). All on
// the current device. Returns a cudaError_t code (0 = launched).
extern "C" int window_attention_fwd(const void* qkv, const float* bias,
                                    void* out, const long long* seed, int B,
                                    int Hp, int Wp, int h, int d, int ws,
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
  dr.unit0 = window0 * h;
  const long long blocks = (long long)B * g.nW * h;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d % 8 == 0 && d <= 64 && g.N <= 144) {
    const bool small = g.N <= 56;
    if (d <= 32)
      return small ? launch_tc<2, 7>(kTc2x7, qkv, bias, out, seed, g, dr, st, s)
                   : launch_tc<2, 18>(kTc2x18, qkv, bias, out, seed, g, dr, st,
                                      s);
    return small ? launch_tc<4, 7>(kTc4x7, qkv, bias, out, seed, g, dr, st, s)
                 : launch_tc<4, 18>(kTc4x18, qkv, bias, out, seed, g, dr, st,
                                    s);
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
