"""MFNet conversion into the ready-to-train layout (the port's counterpart
of rgbx_semantic_segmentation_tpu/tools/fetch_mfnet.py).

Turns the raw MFNet distribution (`ir_seg_dataset`: 4-channel RGB+Thermal
PNGs in images/, labels/, and train/val/test split files; the dataset
behind the reference's published 58.2 mIoU MiT-B2 result, reference
README.md:153-156) into the layout the port and the reference both expect
(reference README.md:78-95):

    <out_dir>/
      RGB/      <name>.png   (3-channel; channels stay in FILE order: the
                              pipeline reads them as BGR, see PARITY.md)
      Thermal/  <name>.png   (single-channel)
      Label/    <name>.png   (uint8 class ids, 255 = ignore)
      train_val.txt          (train.txt + val.txt, 1176 names: the split the
                              reference trains its published MFNet weights on)
      test.txt               (393 names)

The module converts a copy that is already downloaded and unpacked; it
fetches nothing. The dataset is distributed by the MFNet authors (Ha et
al., "MFNet: Towards Real-Time Semantic Segmentation for Autonomous
Vehicles with Multi-Spectral Scenes", IROS 2017) as `ir_seg_dataset`; the
reference points at https://github.com/haqishen/MFNet-pytorch for the
download (reference README.md:113). Unpack it, then:

    python -m rgbx_semantic_segmentation_tpu_torch.tools.fetch_mfnet \
        --source_dir /path/to/ir_seg_dataset --out_dir datasets/MFNet
"""
from __future__ import annotations

import argparse
import os
import sys


def convert(source_dir: str, out_dir: str) -> dict:
    """Split the fused 4-channel images, copy the labels, assemble the split
    files. Returns a summary dict (counts); raises SystemExit on a source
    that is not an ir_seg_dataset layout or lacks a split file."""
    import numpy as np
    from PIL import Image

    images = os.path.join(source_dir, "images")
    labels = os.path.join(source_dir, "labels")
    if not os.path.isdir(images) or not os.path.isdir(labels):
        raise SystemExit(
            f"error: {source_dir} does not look like ir_seg_dataset "
            f"(need images/ and labels/). Download and unpack it first; see "
            f"the module docstring.")

    rgb_dir = os.path.join(out_dir, "RGB")
    th_dir = os.path.join(out_dir, "Thermal")
    gt_dir = os.path.join(out_dir, "Label")
    for d in (rgb_dir, th_dir, gt_dir):
        os.makedirs(d, exist_ok=True)

    n_img = 0
    for name in sorted(os.listdir(images)):
        if not name.lower().endswith(".png"):
            continue
        with Image.open(os.path.join(images, name)) as im:
            arr = np.asarray(im)
        if arr.ndim != 3 or arr.shape[2] != 4:
            print(f"skip {name}: expected 4-channel RGBT, got {arr.shape}")
            continue
        # Channel split per the reference's data_preprocess.ipynb: the
        # first 3 file channels -> RGB/ (no reordering: the training
        # pipeline reads them in cv2/BGR byte order, the reference's BGR
        # quirk, PARITY.md), the 4th -> Thermal/.
        Image.fromarray(arr[..., :3]).save(os.path.join(rgb_dir, name))
        Image.fromarray(arr[..., 3]).save(os.path.join(th_dir, name))
        n_img += 1

    n_gt = 0
    for name in sorted(os.listdir(labels)):
        if not name.lower().endswith(".png"):
            continue
        with Image.open(os.path.join(labels, name)) as im:
            arr = np.asarray(im)
        if arr.ndim == 3:  # an RGB-encoded variant: its first channel
            arr = arr[..., 0]
        Image.fromarray(arr.astype(np.uint8)).save(
            os.path.join(gt_dir, name))
        n_gt += 1

    def read_split(fname):
        path = os.path.join(source_dir, fname)
        if not os.path.isfile(path):
            raise SystemExit(f"error: missing split file {path}")
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    # The reference trains on train+val (config train_source=train_val.txt,
    # num_train_imgs=1176) and evaluates on test.txt (393).
    train_val = read_split("train.txt") + read_split("val.txt")
    test = read_split("test.txt")
    with open(os.path.join(out_dir, "train_val.txt"), "w") as f:
        f.write("\n".join(train_val) + "\n")
    with open(os.path.join(out_dir, "test.txt"), "w") as f:
        f.write("\n".join(test) + "\n")

    summary = {"images": n_img, "labels": n_gt,
               "train_val": len(train_val), "test": len(test)}
    expect = {"train_val": 1176, "test": 393}
    for k, v in expect.items():
        if summary[k] != v:
            print(f"WARNING: {k} has {summary[k]} names, reference protocol "
                  f"expects {v}")
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source_dir", required=True,
                   help="unpacked ir_seg_dataset directory (downloaded "
                        "separately; see the module docstring)")
    p.add_argument("--out_dir", default="datasets/MFNet")
    args = p.parse_args(argv)
    summary = convert(args.source_dir, args.out_dir)
    print(f"MFNet ready at {args.out_dir}: {summary}")
    print("Parity run (PARITY.md 'MFNet parity recipe'), on the card:")
    print(f"  python -m rgbx_semantic_segmentation_tpu_torch.train_cli "
          f"--config mfnet --dataset_root {args.out_dir}")
    print(f"  python -m rgbx_semantic_segmentation_tpu_torch.eval_cli "
          f"--config mfnet --dataset_root {args.out_dir} -e last"
          f"   # expect ~58.2 mIoU (reference README.md:153-156)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
