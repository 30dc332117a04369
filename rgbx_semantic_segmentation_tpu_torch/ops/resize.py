"""Device-side resize (counterpart of rgbx_semantic_segmentation_tpu/ops/
resize.py; this slice needs only the bilinear upsample)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear-resize NCHW maps to (H, W): half-pixel centres,
    align_corners=False, no antialiasing — the convention of the JAX
    `resize_bilinear` (jax.image.resize, antialias=False). Computes in the
    input dtype, as the JAX version does: CUDA autocast would run the
    upsample in fp32, so it is switched off here."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False)
