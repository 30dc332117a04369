"""Device-side resize (counterpart of rgbx_semantic_segmentation_tpu/ops/
resize.py) on NCHW maps: the bilinear upsample of every head and the
align_corners=True resize of the DeepLabV3+ head. The JAX package re-creates
torch's semantics (its `adaptive_avg_pool` is torch's AdaptiveAvgPool2d,
which the heads use as it is), so the bilinear resize is torch's own op; the
align-corners resize is the JAX version's arithmetic. Both compute as the
JAX versions do (in the input dtype; the align-corners one in fp32, cast
back): CUDA autocast would run the upsample in fp32, so it is switched off
around them."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear-resize NCHW maps to (H, W): half-pixel centres,
    align_corners=False, no antialiasing — the convention of the JAX
    `resize_bilinear` (jax.image.resize, antialias=False)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True (src = dst * (in - 1) /
    (out - 1)), the DeepLabV3+ head's convention, as the JAX version
    computes it: static taps with weights from float64 coordinates, two
    weighted gathers in fp32, cast back to the input dtype. (F.interpolate
    forms the coordinate in fp32 and lands ~1 fp32 ulp of the coordinate
    away.)"""
    oh, ow = size
    if tuple(x.shape[2:]) == (oh, ow):
        return x

    def taps(n_in, n_out):
        if n_out == 1:
            lo = hi = np.zeros(1, np.int64)
            w = np.zeros(1, np.float32)
        else:
            src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
            lo = np.floor(src).astype(np.int64)
            hi = np.minimum(lo + 1, n_in - 1)
            w = (src - lo).astype(np.float32)
        return (torch.from_numpy(a).to(x.device) for a in (lo, hi, w))

    y0, y1, wy = taps(x.shape[2], oh)
    x0, x1, wx = taps(x.shape[3], ow)
    wy = wy[:, None]
    with torch.autocast(x.device.type, enabled=False):
        xf = x.float()
        top = xf[:, :, y0] * (1.0 - wy) + xf[:, :, y1] * wy
        out = top[:, :, :, x0] * (1.0 - wx) + top[:, :, :, x1] * wx
    return out.to(x.dtype)

