// Helpers shared by the attention kernels (sr_attention_fwd.cu,
// sr_attention_bwd.cu, window_attention_fwd.cu, window_attention_bwd.cu):
// operand layouts, dtype conversion, warp reductions, the bf16 mma.sync
// m16n8k16 fragment helpers, the Philox4x32-10 generator of the in-kernel
// dropout and the per-device state of the host side. Each .cu that includes
// this file is built into its own shared library; everything here has
// internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <math.h>
#include <mutex>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;   // ops/sr_attention.supported()
constexpr int kMaxM = 1024;

// Element strides of one (B, H, rows, d) operand; the head dim has stride 1.
struct Layout {
  long long b, h, row;
};

// The (batch, head) slice g = b * H + h of an operand.
template <typename T>
__device__ __forceinline__ T* slice(T* base, const Layout& l, int g, int H) {
  return base + (long long)(g / H) * l.b + (long long)(g % H) * l.h;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value to T and back: the cast of p to the input dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Elements (row, col) and (row, col + 1) of a (rows, d) bf16 matrix with
// row stride ld as one A-fragment register; zero outside (n_rows, d).
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              long long ld, int row, int col,
                                              int n_rows, int d) {
  uint32_t lo = 0, hi = 0;
  if (row < n_rows) {
    const unsigned short* r =
        reinterpret_cast<const unsigned short*>(base) + row * ld;
    if (col < d) lo = r[col];
    if (col + 1 < d) hi = r[col + 1];
  }
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Four 8x8 bf16 matrices from shared memory, transposed on the way: lane l
// gives the address of row l % 8 of matrix l / 8 (16 bytes, 16-byte
// aligned); r[m] then holds elements (2 * (lane % 4), lane / 4) and
// (2 * (lane % 4) + 1, lane / 4) of matrix m. From a row-major [k][n] tile
// this yields the B fragments (k-major pairs) of mma16816, from a row-major
// [k][m] tile the A fragments of the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011): 128 counter bits and 64 key bits to 128 random bits.
// ops/window_attention.philox4x32 is the same function in PyTorch integer
// ops; the tests hold it to the published known-answer vectors.
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t (&out)[4]) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// The dropout stream of the window attention. One Philox call serves the
// four probabilities that one thread holds of an mma accumulator tile: rows
// r and r + 8 of a 16-row tile, columns c and c + 1 (c even). Counter:
// (c / 2, 8 * (r / 16) + r % 8, unit0 + unit, batch); key: the 64-bit seed.
// unit = window * h + head counts the launch's windows; unit0 = window0 * h
// places them in the whole image (window0 > 0: a slab of window rows on a
// spatial rank, which then draws the whole image's masks). Element
// (r, c) keeps its probability iff its 32 bits are >= thr:
// bits[2 * ((r % 16) / 8) + c % 2]. ops/window_attention.keep_mask draws the
// same mask in PyTorch.
struct Dropout {
  uint32_t k0, k1;  // the seed's low and high word
  uint32_t thr;     // min(rate * 2^32, 2^32 - 1)
  float inv_keep;   // 1 / (1 - rate)
  int on;
  int unit0;        // window0 * h: the first window's unit in the image
};

__device__ __forceinline__ void dropout_bits(const Dropout& dr, int col_pair,
                                             int row_group, int unit, int b,
                                             uint32_t (&bits)[4]) {
  philox4x32_10((uint32_t)col_pair, (uint32_t)row_group,
                (uint32_t)(dr.unit0 + unit), (uint32_t)b, dr.k0, dr.k1, bits);
}

// The bits of the single element (row, col), for the scalar kernels.
__device__ __forceinline__ uint32_t dropout_bits_at(const Dropout& dr, int row,
                                                    int col, int unit, int b) {
  uint32_t bits[4];
  dropout_bits(dr, col >> 1, 8 * (row >> 4) + (row & 7), unit, b, bits);
  return bits[2 * ((row & 15) >> 3) + (col & 1)];
}

constexpr int kMaxDevices = 64;

// What a launch needs to know of a device, read once per device.
struct DeviceState {
  std::atomic<bool> ready;
  int smem_optin;  // dynamic shared memory a block may opt in to
  int sms;
};

DeviceState g_devices[kMaxDevices];
std::mutex g_mutex;

int current_device(DeviceState** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  DeviceState& st = g_devices[dev];
  if (!st.ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!st.ready.load(std::memory_order_relaxed)) {
      err = cudaDeviceGetAttribute(&st.smem_optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return (int)err;
      st.ready.store(true, std::memory_order_release);
    }
  }
  *out = &st;
  return 0;
}

// Lets `kernel` take up to the device's opt-in shared memory; once per
// kernel and device (the attribute is a bound, not the launch's size).
// `done` is the caller's flag for this (kernel, device).
template <typename Kernel>
int opt_in_smem(const DeviceState* st, std::atomic<bool>* done, Kernel kernel) {
  if (done->load(std::memory_order_acquire)) return 0;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!done->load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, st->smem_optin);
    if (err != cudaSuccess) return (int)err;
    done->store(true, std::memory_order_release);
  }
  return 0;
}

// The current device's index, for the callers' per-device flags.
inline int device_index(const DeviceState* st) { return (int)(st - g_devices); }

}  // namespace
