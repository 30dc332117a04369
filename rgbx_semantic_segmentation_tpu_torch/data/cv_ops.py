"""Host-side image ops with OpenCV semantics, in numpy (the port's own copy
of the numpy paths of rgbx_semantic_segmentation_tpu/data/cv_ops.py).

These are the plain versions and define the semantics. The training input
pipeline runs the same ops through the native C++ library
(native/cv_ops.py), which agrees with them to 1 LSB on uint8 images.

  - resize_linear: cv2.INTER_LINEAR mapping src = (dst + 0.5) * scale - 0.5
    with edge clamping and no antialiasing.
  - resize_nearest: cv2.INTER_NEAREST truncation mapping src = floor(dst *
    scale).
  - bgr<->hsv: cv2 uint8 conventions, H in [0, 180).
  - gaussian_blur: separable kernel, BORDER_REFLECT_101.
  - pad_to_shape: center pad + margin bookkeeping.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def resize_linear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.INTER_LINEAR resize for HW or HWC arrays; returns the same dtype
    (integers rounded to nearest)."""
    in_h, in_w = img.shape[:2]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return img.copy()
    scale_y = in_h / out_h
    scale_x = in_w / out_w
    sy = (np.arange(out_h, dtype=np.float64) + 0.5) * scale_y - 0.5
    sx = (np.arange(out_w, dtype=np.float64) + 0.5) * scale_x - 0.5
    y0 = np.floor(sy).astype(np.int64)
    x0 = np.floor(sx).astype(np.int64)
    wy = (sy - y0).astype(np.float32)
    wx = (sx - x0).astype(np.float32)
    y0c = np.clip(y0, 0, in_h - 1)
    y1c = np.clip(y0 + 1, 0, in_h - 1)
    x0c = np.clip(x0, 0, in_w - 1)
    x1c = np.clip(x0 + 1, 0, in_w - 1)
    # cv2 clamps the weight together with the coordinate at the borders.
    wy = np.where(y0 < 0, 0.0, np.where(y0 >= in_h - 1, 0.0, wy))[:, None]
    wx = np.where(x0 < 0, 0.0, np.where(x0 >= in_w - 1, 0.0, wx))[None, :]
    im = img.astype(np.float32)
    tl = im[y0c[:, None], x0c[None, :]]
    tr = im[y0c[:, None], x1c[None, :]]
    bl = im[y1c[:, None], x0c[None, :]]
    br = im[y1c[:, None], x1c[None, :]]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    top = tl * (1 - wx) + tr * wx
    bot = bl * (1 - wx) + br * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), np.iinfo(img.dtype).min,
                       np.iinfo(img.dtype).max).astype(img.dtype)
    return out.astype(img.dtype)


def resize_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.INTER_NEAREST resize: src index = floor(dst * scale), clamped."""
    in_h, in_w = img.shape[:2]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return img.copy()
    ys = np.minimum((np.arange(out_h) * (in_h / out_h)).astype(np.int64),
                    in_h - 1)
    xs = np.minimum((np.arange(out_w) * (in_w / out_w)).astype(np.int64),
                    in_w - 1)
    return img[ys[:, None], xs[None, :]]


def resize_by_factor(img: np.ndarray, fx: float, fy: float,
                     nearest: bool = False) -> np.ndarray:
    """cv2.resize(None, fx=, fy=) sizing: out = round(in * f)."""
    out_h = int(round(img.shape[0] * fy))
    out_w = int(round(img.shape[1] * fx))
    fn = resize_nearest if nearest else resize_linear
    return fn(img, (out_h, out_w))


def bgr_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(BGR2HSV) for uint8: H in [0,180), S,V in [0,255]."""
    b = img[..., 0].astype(np.float32)
    g = img[..., 1].astype(np.float32)
    r = img[..., 2].astype(np.float32)
    v = np.maximum(np.maximum(b, g), r)
    mn = np.minimum(np.minimum(b, g), r)
    diff = v - mn
    s = np.where(v > 0, diff / np.maximum(v, 1e-12) * 255.0, 0.0)
    h = np.zeros_like(v)
    mask = diff > 0
    rmax = mask & (v == r)
    gmax = mask & (v == g) & ~rmax
    bmax = mask & ~rmax & ~gmax
    safe = np.maximum(diff, 1e-12)
    h[rmax] = (60.0 * (g - b) / safe)[rmax]
    h[gmax] = (120.0 + 60.0 * (b - r) / safe)[gmax]
    h[bmax] = (240.0 + 60.0 * (r - g) / safe)[bmax]
    h = np.where(h < 0, h + 360.0, h) / 2.0
    return np.stack([h, s, v], axis=-1)


def hsv_to_bgr_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(HSV2BGR) for uint8 hsv (H in [0,180))."""
    h = hsv[..., 0].astype(np.float32) * 2.0  # degrees
    s = hsv[..., 1].astype(np.float32) / 255.0
    v = hsv[..., 2].astype(np.float32)
    hi = np.floor(h / 60.0) % 6
    f = h / 60.0 - np.floor(h / 60.0)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.select([hi == 0, hi == 1, hi == 2, hi == 3, hi == 4, hi == 5],
                  [v, q, p, p, t, v])
    g = np.select([hi == 0, hi == 1, hi == 2, hi == 3, hi == 4, hi == 5],
                  [t, v, v, q, p, p])
    b = np.select([hi == 0, hi == 1, hi == 2, hi == 3, hi == 4, hi == 5],
                  [p, p, t, v, v, q])
    out = np.stack([b, g, r], axis=-1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def hsv_jitter(bgr: np.ndarray, bf: float, sf: float,
               hue_shift: float) -> np.ndarray:
    """BGR->HSV, V*=bf, S*=sf, H+=hue_shift, ->BGR (cv2 uint8 conventions)."""
    hsv = bgr_to_hsv_u8(bgr).astype(np.float32)
    hsv[:, :, 2] *= bf
    hsv[:, :, 1] *= sf
    hsv[:, :, 0] += hue_shift
    hsv = np.clip(hsv, 0, 255)
    return hsv_to_bgr_u8(hsv.astype(np.uint8))


def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel: normalised exp(-(i-c)^2 / (2 sigma^2))."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) / 2.0
    k = np.exp(-((np.arange(ksize) - c) ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: np.ndarray, ksize: Tuple[int, int] = (5, 5),
                  sigma: float = 1.0) -> np.ndarray:
    """cv2.GaussianBlur with BORDER_REFLECT_101 (separable)."""
    from scipy.ndimage import convolve1d

    ky = _gaussian_kernel_1d(ksize[1], sigma)
    kx = _gaussian_kernel_1d(ksize[0], sigma)
    out = img.astype(np.float32)
    out = convolve1d(out, ky, axis=0, mode="mirror")
    out = convolve1d(out, kx, axis=1, mode="mirror")
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), np.iinfo(img.dtype).min,
                       np.iinfo(img.dtype).max).astype(img.dtype)
    return out.astype(img.dtype)


def pad_to_shape(img: np.ndarray, shape: Tuple[int, int], value=0):
    """Center-pad to at least `shape`, constant border; returns (img, margin)
    with margin = [top, bottom, left, right] (utils/transforms.py:61-75)."""
    margin = np.zeros(4, np.int64)
    pad_h = max(shape[0] - img.shape[0], 0)
    pad_w = max(shape[1] - img.shape[1], 0)
    margin[0] = pad_h // 2
    margin[1] = pad_h // 2 + pad_h % 2
    margin[2] = pad_w // 2
    margin[3] = pad_w // 2 + pad_w % 2
    pads = [(int(margin[0]), int(margin[1])), (int(margin[2]), int(margin[3]))]
    if img.ndim == 3:
        pads.append((0, 0))
    out = np.pad(img, pads, mode="constant", constant_values=value)
    return out, margin


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """x/255 then (x - mean) / std (utils/transforms.py:182-187). float32
    output."""
    img = img.astype(np.float32) / 255.0
    return ((img - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32)).astype(np.float32)
