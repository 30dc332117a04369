"""Copy the files of a dataset split into another folder (the port's
counterpart of rgbx_semantic_segmentation_tpu/tools/copy_split.py).

Parity target: reference `utils/correct_data.py:1-17` (copies the train
split's thermal files into ssl_Thermal/train), generalised to any
split/folder pair.

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.tools.copy_split \
        --dataset_dir datasets/PST900 --split train.txt \
        --src_folder Thermal --dst_folder ssl_Thermal/train [--ext .png]
"""
from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--split", required=True,
                   help="split file with one name/line")
    p.add_argument("--src_folder", required=True)
    p.add_argument("--dst_folder", required=True)
    p.add_argument("--ext", default=".png")
    args = p.parse_args(argv)

    split_path = (args.split if os.path.isabs(args.split)
                  else os.path.join(args.dataset_dir, args.split))
    with open(split_path) as f:
        names = [line.strip() for line in f if line.strip()]
    src = os.path.join(args.dataset_dir, args.src_folder)
    dst = os.path.join(args.dataset_dir, args.dst_folder)
    os.makedirs(dst, exist_ok=True)
    copied = 0
    for name in names:
        s = os.path.join(src, name + args.ext)
        if not os.path.exists(s):
            print(f"missing {s}")
            continue
        shutil.copy2(s, os.path.join(dst, name + args.ext))
        copied += 1
    print(f"copied {copied}/{len(names)} files -> {dst}")


if __name__ == "__main__":
    main()
