"""Split fused 4-channel RGB-T images into RGB and Thermal folders (the
port's counterpart of rgbx_semantic_segmentation_tpu/tools/split_rgbt.py).

Parity target: reference `data_preprocess.ipynb` (3 cells: split
MFNet-style 4-channel / fused images into RGB + Thermal). A 3-channel image
gives its RGB and, as thermal, the truncated mean of its channels.

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.tools.split_rgbt \
        --input_dir datasets/MFNet/images --output_dir datasets/MFNet
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True,
                   help="folder of 4-channel RGBT PNGs")
    p.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)

    from PIL import Image

    rgb_dir = os.path.join(args.output_dir, "RGB")
    th_dir = os.path.join(args.output_dir, "Thermal")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(th_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(args.input_dir)):
        if not name.lower().endswith(".png"):
            continue
        with Image.open(os.path.join(args.input_dir, name)) as im:
            arr = np.asarray(im)
        if arr.ndim == 3 and arr.shape[2] == 4:
            rgb, thermal = arr[..., :3], arr[..., 3]
        elif arr.ndim == 3 and arr.shape[2] == 3:
            rgb, thermal = arr, arr.mean(axis=2).astype(np.uint8)
        else:
            print(f"skip {name}: unexpected shape {arr.shape}")
            continue
        Image.fromarray(rgb).save(os.path.join(rgb_dir, name))
        Image.fromarray(thermal).save(os.path.join(th_dir, name))
        count += 1
    print(f"split {count} images -> {rgb_dir}, {th_dir}")


if __name__ == "__main__":
    main()
