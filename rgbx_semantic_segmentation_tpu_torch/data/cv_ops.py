"""Host-side image ops with OpenCV semantics, in numpy (the port's own copy
of the numpy paths of rgbx_semantic_segmentation_tpu/data/cv_ops.py; only
what the port calls: `pad_to_shape` and `normalize`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
