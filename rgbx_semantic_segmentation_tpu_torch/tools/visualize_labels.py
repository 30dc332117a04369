"""Colour previews of label maps (the port's counterpart of
rgbx_semantic_segmentation_tpu/tools/visualize_labels.py).

Parity target: reference `utils/visualize_labels.py:1-45` (matplotlib
previews): writes palettised PNG previews instead of interactive matplotlib
windows.

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.tools.visualize_labels \
        --label_dir datasets/MFNet/Label --out_dir previews [--limit 10]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
from rgbx_semantic_segmentation_tpu_torch.visualize import save_palette_png


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--label_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--dataset_name", default=None)
    p.add_argument("--limit", type=int, default=0)
    args = p.parse_args(argv)

    from PIL import Image

    os.makedirs(args.out_dir, exist_ok=True)
    colors = RGBXDataset.get_class_colors(args.dataset_name)
    names = [n for n in sorted(os.listdir(args.label_dir))
             if n.lower().endswith(".png")]
    if args.limit:
        names = names[: args.limit]
    for name in names:
        with Image.open(os.path.join(args.label_dir, name)) as im:
            arr = np.asarray(im)
        save_palette_png(arr, colors, os.path.join(args.out_dir, name))
        print(f"{name}: classes {np.unique(arr).tolist()}")


if __name__ == "__main__":
    main()
