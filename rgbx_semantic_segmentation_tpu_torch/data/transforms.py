"""Geometric transform library (host-side, numpy): the port's own copy of
rgbx_semantic_segmentation_tpu/data/transforms.py.

Parity target: reference `utils/transforms.py:12-188` — crop/pad/scale/rotate
primitives beyond what TrainPre/ValPre use directly. Kept as free functions so
custom pipelines can compose them like the reference's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from rgbx_semantic_segmentation_tpu_torch.data import cv_ops
from rgbx_semantic_segmentation_tpu_torch.data.cv_ops import (  # noqa: F401
    gaussian_blur, normalize, pad_to_shape as pad_image_to_shape,
    resize_linear, resize_nearest)


def get_2dshape(shape, *, zero: bool = True) -> Tuple[int, int]:
    """int -> (int, int) (reference transforms.py:12-25)."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape), int(shape))
    else:
        h, w = map(int, shape)
        shape = (h, w)
    minv = 0 if zero else 1
    assert min(shape) >= minv, f"invalid shape: {shape}"
    return shape


def generate_random_crop_pos(ori_size, crop_size,
                             rng: Optional[np.random.RandomState] = None):
    """Random top-left for a crop (reference transforms.py:44-59)."""
    rng = rng or np.random
    h, w = get_2dshape(ori_size)
    crop_h, crop_w = get_2dshape(crop_size)
    pos_h = rng.randint(0, h - crop_h + 1) if h > crop_h else 0
    pos_w = rng.randint(0, w - crop_w + 1) if w > crop_w else 0
    return pos_h, pos_w


def random_crop_pad_to_shape(img, crop_pos, crop_size, pad_value):
    """Crop at pos then center-pad back to crop_size
    (reference transforms.py:27-42)."""
    h, w = img.shape[:2]
    sh, sw = crop_pos
    assert 0 <= sh < h and 0 <= sw < w
    crop_h, crop_w = get_2dshape(crop_size)
    crop = img[sh:sh + crop_h, sw:sw + crop_w, ...]
    return cv_ops.pad_to_shape(crop, (crop_h, crop_w), value=pad_value)


def pad_image_size_to_multiples_of(img, multiple: int, pad_value):
    """Pad H/W up to the next multiple (reference transforms.py:77-87)."""
    h, w = img.shape[:2]

    def canon(s):
        v = s // multiple
        return (v + (v * multiple != s)) * multiple

    return cv_ops.pad_to_shape(img, (canon(h), canon(w)), value=pad_value)


def resize_ensure_shortest_edge(img, edge_length: int,
                                nearest: bool = False):
    """Scale so the short side equals edge_length (reference :89-101)."""
    assert isinstance(edge_length, int) and edge_length > 0
    h, w = img.shape[:2]
    if h < w:
        th, tw = edge_length, max(1, int(edge_length / h * w))
    else:
        th, tw = max(1, int(edge_length / w * h)), edge_length
    fn = cv_ops.resize_nearest if nearest else cv_ops.resize_linear
    return fn(img, (th, tw))


def random_scale(img, gt, scales: Sequence[float],
                 rng: Optional[np.random.RandomState] = None):
    """reference transforms.py:103-110."""
    rng = rng or np.random
    scale = scales[rng.randint(len(scales))]
    sh = int(img.shape[0] * scale)
    sw = int(img.shape[1] * scale)
    return (cv_ops.resize_linear(img, (sh, sw)),
            cv_ops.resize_nearest(gt, (sh, sw)), scale)


def random_scale_rgbx(img, gt, modal_x, scales: Sequence[float],
                      rng: Optional[np.random.RandomState] = None):
    """reference transforms.py:112-120."""
    rng = rng or np.random
    scale = scales[rng.randint(len(scales))]
    sh = int(img.shape[0] * scale)
    sw = int(img.shape[1] * scale)
    return (cv_ops.resize_linear(img, (sh, sw)),
            cv_ops.resize_nearest(gt, (sh, sw)),
            cv_ops.resize_linear(modal_x, (sh, sw)), scale)


def random_scale_with_length(img, gt, lengths: Sequence[int],
                             rng: Optional[np.random.RandomState] = None):
    """reference transforms.py:122-129."""
    rng = rng or np.random
    size = lengths[rng.randint(len(lengths))]
    return (cv_ops.resize_linear(img, (size, size)),
            cv_ops.resize_nearest(gt, (size, size)), size)


def random_mirror(img, gt, rng: Optional[np.random.RandomState] = None):
    """reference transforms.py:131-136."""
    rng = rng or np.random
    if rng.rand() >= 0.5:
        img = img[:, ::-1].copy()
        gt = gt[:, ::-1].copy()
    return img, gt


def random_rotation(img, gt, rng: Optional[np.random.RandomState] = None,
                    max_deg: float = 10.0):
    """Rotate by U(-10, 10) degrees about the centre; linear for img, nearest
    for gt (reference transforms.py:138-145, cv2.warpAffine semantics)."""
    rng = rng or np.random
    angle = rng.rand() * 2 * max_deg - max_deg
    return (_rotate(img, angle, nearest=False),
            _rotate(gt, angle, nearest=True))


def _rotate(img: np.ndarray, angle_deg: float, nearest: bool) -> np.ndarray:
    h, w = img.shape[:2]
    cy, cx = (h - 1) * 0.0 + h / 2.0, w / 2.0
    theta = np.deg2rad(angle_deg)
    cos, sin = np.cos(theta), np.sin(theta)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    # inverse mapping dst -> src (cv2 getRotationMatrix2D convention)
    sx = cos * (xs - cx) - sin * (ys - cy) + cx
    sy = sin * (xs - cx) + cos * (ys - cy) + cy
    if nearest:
        ix = np.clip(np.rint(sx), 0, w - 1).astype(np.int64)
        iy = np.clip(np.rint(sy), 0, h - 1).astype(np.int64)
        out = img[iy, ix]
        mask = (sx < -0.5) | (sx > w - 0.5) | (sy < -0.5) | (sy > h - 0.5)
        out = np.where(mask if out.ndim == 2 else mask[..., None], 0, out)
        return out.astype(img.dtype)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = (sx - x0).astype(np.float32)
    wy = (sy - y0).astype(np.float32)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    im = img.astype(np.float32)
    if im.ndim == 3:
        wx = wx[..., None]
        wy = wy[..., None]
    top = im[y0c, x0c] * (1 - wx) + im[y0c, x1c] * wx
    bot = im[y1c, x0c] * (1 - wx) + im[y1c, x1c] * wx
    out = top * (1 - wy) + bot * wy
    mask = (sx < 0) | (sx > w - 1) | (sy < 0) | (sy > h - 1)
    out = np.where(mask if out.ndim == 2 else mask[..., None], 0, out)
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), 0, 255).astype(img.dtype)
    return out.astype(img.dtype)


def center_crop(img, shape):
    """reference transforms.py:155-159."""
    h, w = get_2dshape(shape)
    y = (img.shape[0] - h) // 2
    x = (img.shape[1] - w) // 2
    return img[y:y + h, x:x + w]


def random_crop(img, gt, size, rng: Optional[np.random.RandomState] = None):
    """Independent random h/w crops (reference transforms.py:161-180)."""
    rng = rng or np.random
    crop_h, crop_w = get_2dshape(size)
    h, w = img.shape[:2]
    if h > crop_h:
        y = rng.randint(0, h - crop_h + 1)
        img = img[y:y + crop_h]
        gt = gt[y:y + crop_h]
    if w > crop_w:
        x = rng.randint(0, w - crop_w + 1)
        img = img[:, x:x + crop_w]
        gt = gt[:, x:x + crop_w]
    return img, gt
