// Native host-side image ops of the port's data pipeline: an identical copy
// of the code of rgbx_semantic_segmentation_tpu/native/cv_ops.cpp (only this
// comment differs; tests/test_torch_data.py holds the two equal).
//
// OpenMP-parallel implementations with the exact cv2 conventions
// (INTER_LINEAR half-pixel mapping with border clamp, INTER_NEAREST
// truncation, uint8 HSV, 5x5 Gaussian with BORDER_REFLECT_101), exposed to
// Python via ctypes (native/cv_ops.py). data/cv_ops.py holds the numpy
// versions, which define the semantics.
//
// Built with g++ at first use into _build/ (native/build.py build_host).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Bilinear resize, cv2.INTER_LINEAR semantics: src = (dst + 0.5) * scale - 0.5,
// coordinates and weights clamped together at the borders.
// ---------------------------------------------------------------------------
static inline void linear_coeffs(int out_len, int in_len, int* lo, float* w) {
  const double scale = static_cast<double>(in_len) / out_len;
  for (int i = 0; i < out_len; ++i) {
    double s = (i + 0.5) * scale - 0.5;
    int l = static_cast<int>(std::floor(s));
    float ww = static_cast<float>(s - l);
    if (l < 0) { l = 0; ww = 0.f; }
    if (l >= in_len - 1) { l = in_len - 1; ww = 0.f; }
    lo[i] = l;
    w[i] = ww;
  }
}

void resize_linear_u8(const uint8_t* src, int in_h, int in_w, int ch,
                      uint8_t* dst, int out_h, int out_w) {
  int* ylo = new int[out_h];
  float* yw = new float[out_h];
  int* xlo = new int[out_w];
  float* xw = new float[out_w];
  linear_coeffs(out_h, in_h, ylo, yw);
  linear_coeffs(out_w, in_w, xlo, xw);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    const int y0 = ylo[y];
    const int y1 = std::min(y0 + 1, in_h - 1);
    const float wy = yw[y];
    const uint8_t* row0 = src + static_cast<int64_t>(y0) * in_w * ch;
    const uint8_t* row1 = src + static_cast<int64_t>(y1) * in_w * ch;
    uint8_t* out_row = dst + static_cast<int64_t>(y) * out_w * ch;
    for (int x = 0; x < out_w; ++x) {
      const int x0 = xlo[x];
      const int x1 = std::min(x0 + 1, in_w - 1);
      const float wx = xw[x];
      for (int c = 0; c < ch; ++c) {
        const float tl = row0[x0 * ch + c], tr = row0[x1 * ch + c];
        const float bl = row1[x0 * ch + c], br = row1[x1 * ch + c];
        const float top = tl + (tr - tl) * wx;
        const float bot = bl + (br - bl) * wx;
        const float v = top + (bot - top) * wy;
        out_row[x * ch + c] =
            static_cast<uint8_t>(std::min(255.f, std::max(0.f, std::nearbyint(v))));
      }
    }
  }
  delete[] ylo; delete[] yw; delete[] xlo; delete[] xw;
}

void resize_linear_f32(const float* src, int in_h, int in_w, int ch,
                       float* dst, int out_h, int out_w) {
  int* ylo = new int[out_h];
  float* yw = new float[out_h];
  int* xlo = new int[out_w];
  float* xw = new float[out_w];
  linear_coeffs(out_h, in_h, ylo, yw);
  linear_coeffs(out_w, in_w, xlo, xw);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    const int y0 = ylo[y];
    const int y1 = std::min(y0 + 1, in_h - 1);
    const float wy = yw[y];
    const float* row0 = src + static_cast<int64_t>(y0) * in_w * ch;
    const float* row1 = src + static_cast<int64_t>(y1) * in_w * ch;
    float* out_row = dst + static_cast<int64_t>(y) * out_w * ch;
    for (int x = 0; x < out_w; ++x) {
      const int x0 = xlo[x];
      const int x1 = std::min(x0 + 1, in_w - 1);
      const float wx = xw[x];
      for (int c = 0; c < ch; ++c) {
        const float tl = row0[x0 * ch + c], tr = row0[x1 * ch + c];
        const float bl = row1[x0 * ch + c], br = row1[x1 * ch + c];
        const float top = tl + (tr - tl) * wx;
        const float bot = bl + (br - bl) * wx;
        out_row[x * ch + c] = top + (bot - top) * wy;
      }
    }
  }
  delete[] ylo; delete[] yw; delete[] xlo; delete[] xw;
}

// cv2.INTER_NEAREST: src = floor(dst * scale), clamped.
void resize_nearest_u8(const uint8_t* src, int in_h, int in_w, int ch,
                       uint8_t* dst, int out_h, int out_w) {
  const double sy = static_cast<double>(in_h) / out_h;
  const double sx = static_cast<double>(in_w) / out_w;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    const int ys = std::min(static_cast<int>(y * sy), in_h - 1);
    const uint8_t* row = src + static_cast<int64_t>(ys) * in_w * ch;
    uint8_t* out_row = dst + static_cast<int64_t>(y) * out_w * ch;
    for (int x = 0; x < out_w; ++x) {
      const int xs = std::min(static_cast<int>(x * sx), in_w - 1);
      std::memcpy(out_row + x * ch, row + xs * ch, ch);
    }
  }
}

// ---------------------------------------------------------------------------
// Fused normalize: (x / 255 - mean) / std, HWC uint8 -> float32.
// Replaces two numpy passes (transforms.normalize) with one.
// ---------------------------------------------------------------------------
void normalize_u8(const uint8_t* src, int h, int w, int ch,
                  const float* mean, const float* stdinv, float* dst) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<int64_t>(y) * w * ch;
    float* out = dst + static_cast<int64_t>(y) * w * ch;
    for (int i = 0; i < w * ch; ++i) {
      const int c = i % ch;
      out[i] = (row[i] * (1.0f / 255.0f) - mean[c]) * stdinv[c];
    }
  }
}

// ---------------------------------------------------------------------------
// Separable gaussian blur, BORDER_REFLECT_101 (cv2.GaussianBlur default).
// ---------------------------------------------------------------------------
static inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
  }
  return i;
}

void gaussian_blur_u8(const uint8_t* src, int h, int w, int ch,
                      const float* kernel, int ksize, uint8_t* dst) {
  const int r = ksize / 2;
  float* tmp = new float[static_cast<int64_t>(h) * w * ch];
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<int64_t>(y) * w * ch;
    float* out = tmp + static_cast<int64_t>(y) * w * ch;
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < ch; ++c) {
        float acc = 0.f;
        for (int k = -r; k <= r; ++k) {
          acc += kernel[k + r] * row[reflect101(x + k, w) * ch + c];
        }
        out[x * ch + c] = acc;
      }
    }
  }
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    uint8_t* out = dst + static_cast<int64_t>(y) * w * ch;
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < ch; ++c) {
        float acc = 0.f;
        for (int k = -r; k <= r; ++k) {
          acc += kernel[k + r] *
                 tmp[static_cast<int64_t>(reflect101(y + k, h)) * w * ch +
                     x * ch + c];
        }
        out[x * ch + c] = static_cast<uint8_t>(
            std::min(255.f, std::max(0.f, std::nearbyint(acc))));
      }
    }
  }
  delete[] tmp;
}

// ---------------------------------------------------------------------------
// Fused HSV color jitter: BGR -> HSV (cv2 uint8 conventions, H in [0,180)),
// V *= bf, S *= sf, H += hue_shift, clip, HSV -> BGR — one pass per pixel
// (replaces two full-image conversions + intermediates,
// reference dataloader.py:33-54).
// ---------------------------------------------------------------------------
void hsv_jitter_u8(const uint8_t* src, int h, int w,
                   float bf, float sf, float hue_shift, uint8_t* dst) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<int64_t>(y) * w * 3;
    uint8_t* out = dst + static_cast<int64_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const float b = row[x * 3 + 0];
      const float g = row[x * 3 + 1];
      const float r = row[x * 3 + 2];
      const float v = std::max(b, std::max(g, r));
      const float mn = std::min(b, std::min(g, r));
      const float diff = v - mn;
      float s = v > 0.f ? diff / v * 255.f : 0.f;
      float hdeg = 0.f;
      if (diff > 0.f) {
        if (v == r) hdeg = 60.f * (g - b) / diff;
        else if (v == g) hdeg = 120.f + 60.f * (b - r) / diff;
        else hdeg = 240.f + 60.f * (r - g) / diff;
        if (hdeg < 0.f) hdeg += 360.f;
      }
      float hh = hdeg / 2.f;
      // jitter + clip to the cv2 uint8 HSV ranges (then uint8 round like the
      // numpy path's astype(np.uint8) after clip)
      float vj = std::min(255.f, std::max(0.f, v * bf));
      float sj = std::min(255.f, std::max(0.f, s * sf));
      float hj = std::min(255.f, std::max(0.f, hh + hue_shift));
      // match numpy: hsv cast to uint8 (truncation) before converting back
      vj = static_cast<float>(static_cast<uint8_t>(vj));
      sj = static_cast<float>(static_cast<uint8_t>(sj));
      hj = static_cast<float>(static_cast<uint8_t>(hj));
      // HSV -> BGR (cv2 conventions)
      const float hd = hj * 2.f;
      const float sn = sj / 255.f;
      const int hi = static_cast<int>(std::floor(hd / 60.f)) % 6;
      const float f = hd / 60.f - std::floor(hd / 60.f);
      const float p = vj * (1.f - sn);
      const float q = vj * (1.f - f * sn);
      const float t = vj * (1.f - (1.f - f) * sn);
      float rb = 0, gb = 0, bb = 0;
      switch (hi) {
        case 0: rb = vj; gb = t; bb = p; break;
        case 1: rb = q; gb = vj; bb = p; break;
        case 2: rb = p; gb = vj; bb = t; break;
        case 3: rb = p; gb = q; bb = vj; break;
        case 4: rb = t; gb = p; bb = vj; break;
        default: rb = vj; gb = p; bb = q; break;
      }
      out[x * 3 + 0] = static_cast<uint8_t>(
          std::min(255.f, std::max(0.f, std::nearbyint(bb))));
      out[x * 3 + 1] = static_cast<uint8_t>(
          std::min(255.f, std::max(0.f, std::nearbyint(gb))));
      out[x * 3 + 2] = static_cast<uint8_t>(
          std::min(255.f, std::max(0.f, std::nearbyint(rb))));
    }
  }
}

}  // extern "C"
