"""Scan label PNGs for out-of-range class ids (the port's counterpart of
rgbx_semantic_segmentation_tpu/tools/check_labels.py).

Parity target: reference `utils/check_labels.py:1-37`.

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.tools.check_labels \
        --label_dir datasets/MFNet/Label --num_classes 9 [--ignore 255]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def check_labels(label_dir: str, num_classes: int, ignore: int = 255):
    """[(file name, sorted invalid ids)] of the PNG/BMP labels in
    `label_dir` holding ids >= num_classes other than `ignore`."""
    from PIL import Image

    bad = []
    for name in sorted(os.listdir(label_dir)):
        if not name.lower().endswith((".png", ".bmp")):
            continue
        with Image.open(os.path.join(label_dir, name)) as im:
            arr = np.asarray(im)
        values = np.unique(arr)
        invalid = values[(values >= num_classes) & (values != ignore)]
        if invalid.size:
            bad.append((name, invalid.tolist()))
    return bad


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--label_dir", required=True)
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument("--ignore", type=int, default=255)
    args = p.parse_args(argv)
    bad = check_labels(args.label_dir, args.num_classes, args.ignore)
    if not bad:
        print("all labels in range")
    for name, vals in bad:
        print(f"{name}: invalid class ids {vals}")
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
