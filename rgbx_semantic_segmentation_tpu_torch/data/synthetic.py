"""Synthetic on-disk RGB-X dataset for end-to-end tests and benchmarks (the
port's own copy of rgbx_semantic_segmentation_tpu/data/synthetic.py).

Generates a tiny MFNet-shaped dataset (RGB/Thermal/Label PNG triples + split
files) so train -> checkpoint -> resume -> eval smoke tests run hermetically
(SURVEY.md §4 test-strategy gap).
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from rgbx_semantic_segmentation_tpu_torch.config import DatasetConfig


def make_synthetic_dataset(root: str, num_train: int = 8, num_val: int = 4,
                           hw: Tuple[int, int] = (64, 80), num_classes: int = 5,
                           seed: int = 0) -> DatasetConfig:
    """Write a synthetic dataset under `root` and return a matching DatasetConfig.

    Labels are structured (blocks per class) so a model can actually learn them,
    with a sprinkle of 255 ignore pixels.
    """
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = hw
    for sub in ("RGB", "Thermal", "Label"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def write(split, count, offset):
        names = []
        for i in range(count):
            name = f"{split}_{i:04d}"
            names.append(name)
            label = np.zeros((h, w), np.uint8)
            # horizontal class bands + noise
            band = max(h // num_classes, 1)
            for c in range(num_classes):
                label[c * band:(c + 1) * band] = c
            shift = rng.randint(0, h)
            label = np.roll(label, shift, axis=0)
            label[rng.rand(h, w) < 0.02] = 255
            rgb = np.zeros((h, w, 3), np.uint8)
            for c in range(num_classes):
                mask = label == c
                rgb[mask] = np.array([(40 * c + 20) % 256,
                                      (255 - 40 * c) % 256,
                                      (70 * c + 30) % 256], np.uint8)
            rgb = np.clip(rgb.astype(np.int32)
                          + rng.randint(-20, 20, rgb.shape), 0, 255).astype(
                np.uint8)
            thermal = np.clip(label.astype(np.int32) * (255 // num_classes)
                              + rng.randint(-15, 15, (h, w)), 0, 255).astype(
                np.uint8)
            Image.fromarray(rgb).save(os.path.join(root, "RGB", name + ".png"))
            Image.fromarray(thermal).save(
                os.path.join(root, "Thermal", name + ".png"))
            Image.fromarray(label).save(
                os.path.join(root, "Label", name + ".png"))
        return names

    train_names = write("train", num_train, 0)
    val_names = write("val", num_val, num_train)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(train_names) + "\n")
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(val_names) + "\n")

    return DatasetConfig(
        dataset_name="Synthetic",
        dataset_path=root,
        rgb_folder="RGB", rgb_format=".png",
        gt_folder="Label", gt_format=".png",
        x_folder="Thermal", x_format=".png",
        x_is_single_channel=True,
        train_source="train.txt", eval_source="test.txt",
        num_train_imgs=num_train, num_eval_imgs=num_val,
        num_classes=num_classes,
        class_names=tuple(f"c{i}" for i in range(num_classes)),
        image_height=h, image_width=w,
    )
