// Helpers shared by the short-kv SR-attention kernels (sr_attention_fwd.cu,
// sr_attention_bwd.cu): operand layouts, dtype conversion, warp reductions,
// the bf16 mma.sync m16n8k16 fragment helpers and the per-device state of
// the host side. Each .cu that includes this file is built into its own
// shared library; everything here has internal linkage.
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
