"""Batch-resize dataset images: RGB and thermal bilinear, labels nearest
(the port's counterpart of
rgbx_semantic_segmentation_tpu/tools/resize_images.py).

Parity target: reference `utils/resize_images.py:6-61`: resize
PST900-style RGB/Thermal/Label folders to a target size (default 640x480).
RGB is resized bilinear, thermal as grayscale bilinear, and labels nearest,
so that no class id is invented (the reference resizes them as grayscale).
The resizes are the numpy versions of data/cv_ops (OpenCV's INTER_LINEAR
and INTER_NEAREST conventions).

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.tools.resize_images \
        --input_dir datasets/PST900 --width 640 --height 480
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from rgbx_semantic_segmentation_tpu_torch.data import cv_ops


def resize_folder(folder: str, out_folder: str, hw, mode: str) -> int:
    """Resize every image of `folder` into `out_folder` (same names) to
    hw = (H, W); mode "rgb", "gray" or "label". Returns the count."""
    from PIL import Image

    os.makedirs(out_folder, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(folder)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
            continue
        with Image.open(os.path.join(folder, name)) as im:
            if mode == "rgb":
                arr = np.asarray(im.convert("RGB"))
                out = cv_ops.resize_linear(arr, hw)
            elif mode == "gray":
                arr = np.asarray(im.convert("L"))
                out = cv_ops.resize_linear(arr, hw)
            else:  # label
                arr = np.asarray(im if im.mode in ("L", "P")
                                 else im.convert("L"))
                out = cv_ops.resize_nearest(arr, hw)
        Image.fromarray(out).save(os.path.join(out_folder, name))
        count += 1
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", default=None,
                   help="default: <input_dir>_resized")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--rgb_folder", default="RGB")
    p.add_argument("--x_folder", default="Thermal")
    p.add_argument("--label_folder", default="Label")
    args = p.parse_args(argv)

    out_root = args.output_dir or args.input_dir.rstrip("/") + "_resized"
    hw = (args.height, args.width)
    for sub, mode in ((args.rgb_folder, "rgb"), (args.x_folder, "gray"),
                      (args.label_folder, "label")):
        src = os.path.join(args.input_dir, sub)
        if not os.path.isdir(src):
            print(f"skip missing {src}")
            continue
        n = resize_folder(src, os.path.join(out_root, sub), hw, mode)
        print(f"{sub}: resized {n} images -> {out_root}/{sub}")


if __name__ == "__main__":
    main()
