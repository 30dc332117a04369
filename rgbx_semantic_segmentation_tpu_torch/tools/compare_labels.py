"""Detect zero-padding / size mismatches between RGB, modal-X and Label
images (the port's counterpart of
rgbx_semantic_segmentation_tpu/tools/compare_labels.py).

Parity target: reference `utils/compare_labels.py:7-238` (padding detection
and cross-folder size consistency checks).

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.tools.compare_labels \
        --dataset_dir datasets/PST900
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _load(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def detect_border_padding(arr: np.ndarray, thresh: float = 1.0):
    """(top, bottom, left, right): the rows/cols at each border that are
    entirely (near) zero (channel mean <= thresh)."""
    if arr.ndim == 3:
        flat = arr.mean(axis=2)
    else:
        flat = arr.astype(np.float64)
    top = 0
    while top < flat.shape[0] and flat[top].max() <= thresh:
        top += 1
    bottom = 0
    while bottom < flat.shape[0] and flat[-1 - bottom].max() <= thresh:
        bottom += 1
    left = 0
    while left < flat.shape[1] and flat[:, left].max() <= thresh:
        left += 1
    right = 0
    while right < flat.shape[1] and flat[:, -1 - right].max() <= thresh:
        right += 1
    return top, bottom, left, right


def compare(dataset_dir: str, rgb="RGB", x="Thermal", label="Label"):
    """[(name, kind, detail)] for every RGB image whose X or label is
    missing ("missing pair"), differs in size ("size mismatch"), or whose
    RGB and X disagree on having a border of more than 5 zero lines
    ("padding mismatch")."""
    issues = []
    rgb_dir = os.path.join(dataset_dir, rgb)
    names = [n for n in sorted(os.listdir(rgb_dir))
             if n.lower().endswith((".png", ".jpg"))]
    for name in names:
        stem = os.path.splitext(name)[0]
        arrs = {}
        for sub in (rgb, x, label):
            folder = os.path.join(dataset_dir, sub)
            for ext in (".png", ".jpg"):
                path = os.path.join(folder, stem + ext)
                if os.path.exists(path):
                    arrs[sub] = _load(path)
                    break
        if len(arrs) < 3:
            issues.append((name, "missing pair",
                           sorted(set((rgb, x, label)) - set(arrs))))
            continue
        shapes = {k: v.shape[:2] for k, v in arrs.items()}
        if len(set(shapes.values())) > 1:
            issues.append((name, "size mismatch", shapes))
            continue
        pad_rgb = detect_border_padding(arrs[rgb])
        pad_x = detect_border_padding(arrs[x])
        if any(p > 5 for p in pad_rgb) != any(p > 5 for p in pad_x):
            issues.append((name, "padding mismatch",
                           {"rgb": pad_rgb, "x": pad_x}))
    return issues


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--rgb_folder", default="RGB")
    p.add_argument("--x_folder", default="Thermal")
    p.add_argument("--label_folder", default="Label")
    args = p.parse_args(argv)
    issues = compare(args.dataset_dir, args.rgb_folder, args.x_folder,
                     args.label_folder)
    if not issues:
        print("no mismatches found")
    for name, kind, detail in issues:
        print(f"{name}: {kind}: {detail}")
    raise SystemExit(1 if issues else 0)


if __name__ == "__main__":
    main()
