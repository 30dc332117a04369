"""The data pipeline's image ops through the native C++ library
(native/cv_ops.cpp, built with g++ at first use; see build.build_host).

Same names and signatures as the numpy versions in data/cv_ops.py, which
define the semantics: uint8 results agree with them to 1 LSB (exact .5
roundings of resize_linear, hsv_jitter and gaussian_blur may go the other
way). An input the library does not take (another dtype or layout) goes to
the numpy version, as in the JAX package's dispatch. `lib()` raises with
the compiler's message when the library cannot be built: there is no quiet
fall back to numpy.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from rgbx_semantic_segmentation_tpu_torch.data import cv_ops as _np_ops
from rgbx_semantic_segmentation_tpu_torch.native import build


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """Build (at first use) and load the library; one handle per process."""
    cdll = ctypes.CDLL(build.build_host())
    u8 = ctypes.POINTER(ctypes.c_uint8)
    f32 = ctypes.POINTER(ctypes.c_float)
    i = ctypes.c_int
    f = ctypes.c_float
    cdll.resize_linear_u8.argtypes = [u8, i, i, i, u8, i, i]
    cdll.resize_linear_f32.argtypes = [f32, i, i, i, f32, i, i]
    cdll.resize_nearest_u8.argtypes = [u8, i, i, i, u8, i, i]
    cdll.normalize_u8.argtypes = [u8, i, i, i, f32, f32, f32]
    cdll.gaussian_blur_u8.argtypes = [u8, i, i, i, f32, i, u8]
    cdll.hsv_jitter_u8.argtypes = [u8, i, i, f, f, f, u8]
    for name in ("resize_linear_u8", "resize_linear_f32", "resize_nearest_u8",
                 "normalize_u8", "gaussian_blur_u8", "hsv_jitter_u8"):
        getattr(cdll, name).restype = None
    return cdll


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _channels(img: np.ndarray) -> int:
    return 1 if img.ndim == 2 else img.shape[2]


def resize_linear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.INTER_LINEAR resize (uint8 or fp32, HW or HWC)."""
    in_h, in_w = img.shape[:2]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return img.copy()
    if img.dtype not in (np.uint8, np.float32) or img.ndim not in (2, 3):
        return _np_ops.resize_linear(img, out_hw)
    src = np.ascontiguousarray(img)
    dst = np.empty((out_h, out_w) + img.shape[2:], img.dtype)
    if img.dtype == np.uint8:
        lib().resize_linear_u8(_ptr(src, ctypes.c_uint8), in_h, in_w,
                               _channels(img), _ptr(dst, ctypes.c_uint8),
                               out_h, out_w)
    else:
        lib().resize_linear_f32(_ptr(src, ctypes.c_float), in_h, in_w,
                                _channels(img), _ptr(dst, ctypes.c_float),
                                out_h, out_w)
    return dst


def resize_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.INTER_NEAREST resize (uint8, HW or HWC)."""
    in_h, in_w = img.shape[:2]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return img.copy()
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        return _np_ops.resize_nearest(img, out_hw)
    src = np.ascontiguousarray(img)
    dst = np.empty((out_h, out_w) + img.shape[2:], np.uint8)
    lib().resize_nearest_u8(_ptr(src, ctypes.c_uint8), in_h, in_w,
                            _channels(img), _ptr(dst, ctypes.c_uint8),
                            out_h, out_w)
    return dst


def hsv_jitter(bgr: np.ndarray, bf: float, sf: float,
               hue_shift: float) -> np.ndarray:
    """Fused BGR->HSV jitter->BGR in one pass (uint8 HWC, 3 channels)."""
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        return _np_ops.hsv_jitter(bgr, bf, sf, hue_shift)
    src = np.ascontiguousarray(bgr)
    dst = np.empty_like(src)
    lib().hsv_jitter_u8(_ptr(src, ctypes.c_uint8), bgr.shape[0], bgr.shape[1],
                        bf, sf, hue_shift, _ptr(dst, ctypes.c_uint8))
    return dst


def gaussian_blur(img: np.ndarray, ksize: Tuple[int, int] = (5, 5),
                  sigma: float = 1.0) -> np.ndarray:
    """cv2.GaussianBlur with BORDER_REFLECT_101 (uint8, square kernel)."""
    if (img.dtype != np.uint8 or ksize[0] != ksize[1]
            or img.ndim not in (2, 3)):
        return _np_ops.gaussian_blur(img, ksize, sigma)
    src = np.ascontiguousarray(img)
    dst = np.empty_like(src)
    kern = np.ascontiguousarray(_np_ops._gaussian_kernel_1d(ksize[1], sigma))
    lib().gaussian_blur_u8(_ptr(src, ctypes.c_uint8), img.shape[0],
                           img.shape[1], _channels(img),
                           _ptr(kern, ctypes.c_float), ksize[0],
                           _ptr(dst, ctypes.c_uint8))
    return dst


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """x/255 then (x - mean) / std, float32 (uint8 HWC)."""
    if img.dtype != np.uint8 or img.ndim != 3:
        return _np_ops.normalize(img, mean, std)
    ch = img.shape[2]
    src = np.ascontiguousarray(img)
    m = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32),
                                             (ch,)))
    sinv = np.ascontiguousarray(
        1.0 / np.broadcast_to(np.asarray(std, np.float32), (ch,)))
    dst = np.empty(img.shape, np.float32)
    lib().normalize_u8(_ptr(src, ctypes.c_uint8), img.shape[0], img.shape[1],
                       ch, _ptr(m, ctypes.c_float), _ptr(sinv, ctypes.c_float),
                       _ptr(dst, ctypes.c_float))
    return dst
