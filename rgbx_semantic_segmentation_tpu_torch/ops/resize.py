"""Device-side resize (counterpart of rgbx_semantic_segmentation_tpu/ops/
resize.py) on NCHW maps: the bilinear upsample of every head, the
align_corners=True resize of the DeepLabV3+ head and the bicubic resize of
the Swin absolute position embedding. The JAX package re-creates
torch's semantics (its `adaptive_avg_pool` is torch's AdaptiveAvgPool2d,
which the heads use as it is), so the bilinear resize is torch's own op; the
align-corners resize is the JAX version's arithmetic. Both compute as the
JAX versions do (in the input dtype; the align-corners one in fp32, cast
back): CUDA autocast would run the upsample in fp32, so it is switched off
around them. `resize_nearest` is the label-map resize of the JAX package
(jax.image.resize, method "nearest"), channels-last as there."""
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



def resize_bicubic_torch(x: torch.Tensor, size: Tuple[int, int]
                         ) -> torch.Tensor:
    """Bicubic-resize NCHW maps to (H, W) with F.interpolate(mode="bicubic",
    align_corners=False): cubic convolution with a = -0.75, half-pixel
    centres, border taps clamped — the semantics the JAX
    `resize_bicubic_torch` re-creates (in its matrix form) for the Swin
    absolute position embedding. Computed in float64 (autocast off) and
    cast back to the input dtype: in fp32 F.interpolate forms its taps'
    weights in fp32 and lands up to 3.5e-5 from the exact resize of O(1)
    values, where the JAX version (fp32 matrices built in float64) lies
    within 1e-6. The embedding grid is small (at most (1, C, 96, 96) in,
    the token grid out), so the float64 costs nothing that shows."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x.double(), size=tuple(size), mode="bicubic",
                             align_corners=False).to(x.dtype)


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each of `n_out` outputs along an axis of `n_in`:
    floor((i + 0.5) * scale) with half-pixel centres, in float32 as the
    compiled jax.image.resize(method="nearest") computes it. It writes
    (i + 0.5) * n_in / n_out; XLA turns the division by the constant into
    a product with its reciprocal and folds the two constants, so scale =
    f32(n_in * f32(1 / n_out)) (dividing instead misses JAX by one index on
    a few percent of size pairs). Clamped to n_in - 1 as its gather clamps."""
    f32 = np.float32
    scale = f32(n_in) * (f32(1) / f32(n_out))
    src = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale
    return np.minimum(np.floor(src).astype(np.int64), n_in - 1)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of label maps (B, H, W, ...) to (B, h, w,
    ...), any trailing dims and any dtype kept: the counterpart of the JAX
    `resize_nearest`, equal to it bit for bit (an index gather; the indices
    are `nearest_indices`'). Returns `x` itself when the size is equal."""
    H, W = x.shape[1:3]
    if (H, W) == tuple(size):
        return x
    rows = torch.from_numpy(nearest_indices(H, size[0])).to(x.device)
    cols = torch.from_numpy(nearest_indices(W, size[1])).to(x.device)
    return x.index_select(1, rows).index_select(2, cols)
