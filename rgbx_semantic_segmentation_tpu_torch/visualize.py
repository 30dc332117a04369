"""Prediction visualisation helpers (the port's own copy of
rgbx_semantic_segmentation_tpu/visualize.py).

Parity target: reference `utils/visualize.py` — class-color overlays and
side-by-side pred/gt composites for `--show_image` / prediction dumps
(reference visualize.py:5-51), plus the formatted IoU table re-exported from
metrics (print_iou, visualize.py:54-74).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from rgbx_semantic_segmentation_tpu_torch.metrics import print_iou  # noqa: F401


def set_img_color(colors: Sequence[Sequence[int]], background: int,
                  img: np.ndarray, pred: np.ndarray,
                  gt: np.ndarray, show255: bool = False) -> np.ndarray:
    """Paint class colors onto an image in-place (reference visualize.py:5-15)."""
    for i in range(len(colors)):
        img[pred == i] = colors[i]
    if show255:
        img[gt == background] = 255
    return img


def show_prediction(colors, background, img, pred, gt) -> np.ndarray:
    """Overlay prediction colors on a copy of the image
    (reference visualize.py:18-23)."""
    im = np.asarray(img, np.uint8).copy()
    set_img_color(colors, background, im, pred, gt)
    return im


def show_img(colors, background, img, clean, gt,
             *pds) -> np.ndarray:
    """Horizontal composite [img | gt | preds...] with white separators
    (reference visualize.py:26-51)."""
    im1 = np.asarray(img, np.uint8).copy()
    final = np.array(im1)
    pivot = np.zeros((im1.shape[0], 15, 3), dtype=np.uint8) + 255
    for pd in pds:
        im = np.array(img, np.uint8).copy()
        set_img_color(colors, background, im, pd, gt)
        final = np.column_stack((final, pivot, im))
    im = np.array(img, np.uint8).copy()
    set_img_color(colors, background, im, gt, gt, show255=True)
    final = np.column_stack((final, pivot, im))
    return final


def get_colors(class_num: int) -> list:
    """Random distinct colors (reference visualize.py:77-83 semantics)."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, 255, 3).tolist() for _ in range(class_num)]


def save_palette_png(pred: np.ndarray, colors, path: str) -> None:
    """Palettised PNG dump (reference eval.py:44-51)."""
    from PIL import Image

    img = Image.fromarray(pred.astype(np.uint8), mode="P")
    palette = list(np.array(colors).flat)
    palette += [0] * (768 - len(palette))
    img.putpalette(palette)
    img.save(path)
