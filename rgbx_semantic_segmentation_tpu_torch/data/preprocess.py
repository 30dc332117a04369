"""Train/val preprocessing pipelines (the port's own copy of
rgbx_semantic_segmentation_tpu/data/preprocess.py).

Parity target: reference `dataloader/dataloader.py:9-127` (TrainPre/ValPre):
gt clip -> random mirror -> random scale -> HSV color jitter -> gaussian blur ->
cutout (gt filled with ignore) -> resize to fixed HxW -> normalize. Output stays
HWC (the model takes NHWC batches).

Randomness is an explicit numpy RandomState per sample (reference relies on
the global `random` module seeded per worker).

TrainPre's `ops` is where its image ops come from: the numpy versions
(data/cv_ops.py) or the native library (native/cv_ops.py). Both have the
same functions. The TrainLoader chooses and passes them; TrainPre has no
default of its own. ValPre runs the numpy versions.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from rgbx_semantic_segmentation_tpu_torch.data import cv_ops


class TrainPre:
    """Training augmentation (reference dataloader.py:85-112)."""

    accepts_rng = True

    # When normalize=False the pipeline emits post-augmentation uint8 images
    # (and uint8 labels); the train step normalises them on the device
    # (train.py), 4x less host->device traffic than fp32.

    def __init__(self, norm_mean, norm_std, image_hw: Tuple[int, int],
                 num_classes: int, background: int = 255,
                 train_scale_array: Optional[Sequence[float]] = None,
                 rng: Optional[np.random.RandomState] = None,
                 color_jitter: bool = True, blur: bool = True,
                 cutout_p: float = 0.5, normalize: bool = True, *, ops):
        self.norm_mean = norm_mean
        self.norm_std = norm_std
        self.image_hw = image_hw
        self.num_classes = num_classes
        self.background = background
        self.scales = train_scale_array
        self.rng = rng or np.random.RandomState()
        self.color_jitter = color_jitter
        self.blur = blur
        self.cutout_p = cutout_p
        self.normalize = normalize
        self.ops = ops

    def __call__(self, rgb, gt, modal_x, rng=None):
        # A per-sample rng (seeded from (epoch, index) by the dataset) makes
        # augmentation deterministic AND thread-safe; the shared fallback
        # rng exists for single-threaded ad-hoc use.
        r = rng if rng is not None else self.rng
        ops = self.ops
        # Clip gt into [0, C-1] *before* augmentation — reference quirk
        # (dataloader.py:92) that erases the 255 ignore label at train time;
        # cutout re-introduces it below.
        gt = np.clip(gt, 0, self.num_classes - 1).astype(gt.dtype)

        # random mirror (dataloader.py:9-14)
        if r.rand() >= 0.5:
            rgb = rgb[:, ::-1]
            gt = gt[:, ::-1]
            modal_x = modal_x[:, ::-1]

        # random scale (dataloader.py:16-23)
        if self.scales is not None:
            scale = self.scales[r.randint(len(self.scales))]
            sh = int(rgb.shape[0] * scale)
            sw = int(rgb.shape[1] * scale)
            rgb = ops.resize_linear(rgb, (sh, sw))
            gt = ops.resize_nearest(gt, (sh, sw))
            modal_x = ops.resize_linear(modal_x, (sh, sw))

        # HSV color jitter (dataloader.py:33-54)
        if self.color_jitter:
            rgb = self._color_jitter(rgb, r)

        # gaussian blur (dataloader.py:56-59)
        if self.blur and r.rand() >= 0.5:
            rgb = ops.gaussian_blur(rgb, (5, 5), 1.0)

        # cutout (dataloader.py:61-83)
        rgb, gt, modal_x = self._cutout(rgb, gt, modal_x, r)

        # fixed-size resize for batching (dataloader.py:25-31)
        h, w = self.image_hw
        if rgb.shape[0] != h or rgb.shape[1] != w:
            rgb = ops.resize_linear(rgb, (h, w))
            gt = ops.resize_nearest(gt, (h, w))
            modal_x = ops.resize_linear(modal_x, (h, w))

        if self.normalize:
            rgb = ops.normalize(rgb, self.norm_mean, self.norm_std)
            modal_x = ops.normalize(modal_x, self.norm_mean, self.norm_std)
            return (np.ascontiguousarray(rgb),
                    np.ascontiguousarray(gt.astype(np.int32)),
                    np.ascontiguousarray(modal_x))
        return (np.ascontiguousarray(rgb.astype(np.uint8)),
                np.ascontiguousarray(gt.astype(np.uint8)),
                np.ascontiguousarray(modal_x.astype(np.uint8)))

    def _color_jitter(self, rgb, r, brightness=0.2, contrast=0.2,
                      saturation=0.2, hue=0.1):
        bf = 1.0 + r.uniform(-brightness, brightness)
        sf = 1.0 + r.uniform(-saturation, saturation)
        hs = r.uniform(-hue, hue) * 180.0
        return self.ops.hsv_jitter(rgb, bf, sf, hs)

    def _cutout(self, rgb, gt, modal_x, r, mask_size=25):
        if r.rand() > self.cutout_p:
            return rgb, gt, modal_x
        h, w = rgb.shape[:2]
        half = mask_size // 2
        if w - half <= half or h - half <= half:
            return rgb, gt, modal_x
        cx = r.randint(half, w - half + 1)
        cy = r.randint(half, h - half + 1)
        x1, y1 = max(0, cx - half), max(0, cy - half)
        x2, y2 = min(w, cx + half), min(h, cy + half)
        rgb = rgb.copy()
        gt = gt.copy()
        modal_x = modal_x.copy()
        rgb[y1:y2, x1:x2] = 0
        gt[y1:y2, x1:x2] = self.background  # ignore-filled (dataloader.py:80)
        modal_x[y1:y2, x1:x2] = 0
        return rgb, gt, modal_x


class ValPre:
    """Eval preprocessing: fixed-size resize + normalize (dataloader.py:114-127)."""

    def __init__(self, norm_mean, norm_std, image_hw: Tuple[int, int]):
        self.norm_mean = norm_mean
        self.norm_std = norm_std
        self.image_hw = image_hw

    def __call__(self, rgb, gt, modal_x):
        h, w = self.image_hw
        if rgb.shape[0] != h or rgb.shape[1] != w:
            rgb = cv_ops.resize_linear(rgb, (h, w))
            gt = cv_ops.resize_nearest(gt, (h, w))
            modal_x = cv_ops.resize_linear(modal_x, (h, w))
        rgb = cv_ops.normalize(rgb, self.norm_mean, self.norm_std)
        modal_x = cv_ops.normalize(modal_x, self.norm_mean, self.norm_std)
        return (np.ascontiguousarray(rgb),
                np.ascontiguousarray(gt.astype(np.int32)),
                np.ascontiguousarray(modal_x))
