"""RGB-X paired dataset (the port's own copy of
rgbx_semantic_segmentation_tpu/data/dataset.py; numpy and PIL only).

Parity target: reference `dataloader/RGBXDataset.py` — file-list driven loading of
(RGB, modal_x, label) triples with:
  - the BGR quirk kept byte-for-byte: the reference passes cv2.COLOR_BGR2RGB (=4,
    which cv2.imread reads as IMREAD_ANYCOLOR) so NO channel swap ever happens and
    the pipeline trains on BGR pixels with RGB-ordered ImageNet stats
    (RGBXDataset.py:47,106-109; SURVEY.md §7). PIL decodes RGB, so we reverse.
  - optional `gt - 1` label transform (RGBXDataset.py:111-113)
  - single-channel modal_x replicated to 3 channels (RGBXDataset.py:57-59)
  - epoch-length oversampling via _construct_new_file_names (RGBXDataset.py:91-101)
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from rgbx_semantic_segmentation_tpu_torch.config import DatasetConfig


def _imread(path: str, grayscale: bool = False) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        if grayscale:
            if im.mode not in ("L", "I", "I;16"):
                im = im.convert("L")
            return np.asarray(im)
        if im.mode != "RGB":
            im = im.convert("RGB")
        arr = np.asarray(im)
        return arr[:, :, ::-1]  # RGB -> BGR (cv2.imread convention)


def load_modal_image(ds_cfg: DatasetConfig, path: str) -> np.ndarray:
    """Read a modal (thermal/HHA/...) image with the training conventions:
    grayscale read + 1ch→3ch replication when the config says single-channel
    (reference RGBXDataset.py:57-59), BGR otherwise."""
    if ds_cfg.x_is_single_channel:
        x = _imread(path, grayscale=True)
        return np.stack([x, x, x], axis=-1)
    return _imread(path)


def load_rgbx_pair(ds_cfg: DatasetConfig, root: str, name: str):
    """Load one (rgb, modal_x) image pair without a label — the
    prediction-time subset of __getitem__ (reference RGBXDataset.py:41-59
    minus gt; the reference has no label-free path at all). BGR quirk and
    1ch→3ch modal replication match training."""
    rgb = _imread(os.path.join(root, ds_cfg.rgb_folder, name + ds_cfg.rgb_format))
    x = load_modal_image(ds_cfg, os.path.join(root, ds_cfg.x_folder,
                                              name + ds_cfg.x_format))
    return rgb, x


class RGBXDataset:
    """Map-style dataset over (rgb, modal_x, gt) file triples."""

    def __init__(self, ds_cfg: DatasetConfig, split: str,
                 preprocess=None, file_length: Optional[int] = None,
                 root: Optional[str] = None, rng: Optional[np.random.RandomState] = None):
        assert split in ("train", "val")
        self.cfg = ds_cfg
        self.split = split
        self.preprocess = preprocess
        root = root if root is not None else ds_cfg.dataset_path
        self._root = root
        self._gt_path = os.path.join(root, ds_cfg.gt_folder)
        source = ds_cfg.train_source if split == "train" else ds_cfg.eval_source
        source = source if os.path.isabs(source) else os.path.join(root, source)
        with open(source) as f:
            self._file_names = [line.strip() for line in f if line.strip()]
        self._file_length = file_length
        self._rng = rng or np.random.RandomState(0)
        self._epoch_names: Optional[List[str]] = None
        self._epoch = 0

    def __len__(self) -> int:
        return self._file_length or len(self._file_names)

    def set_epoch(self, epoch: int) -> None:
        """Regenerate the oversampled name list deterministically per epoch
        (the reference regenerates per __getitem__ with global torch RNG,
        RGBXDataset.py:39 — a perf bug; we build it once per epoch)."""
        self._epoch = epoch
        if self._file_length is None:
            self._epoch_names = None
            return
        rng = np.random.RandomState((1000003 * (epoch + 1) + 12345) % (2 ** 31))
        self._epoch_names = self._construct_new_file_names(
            self._file_length, rng)

    def _construct_new_file_names(self, length: int, rng) -> List[str]:
        files_len = len(self._file_names)
        names = self._file_names * (length // files_len)
        extra_idx = rng.permutation(files_len)[: length % files_len]
        names += [self._file_names[i] for i in extra_idx]
        return names

    def _names(self) -> Sequence[str]:
        if self._file_length is not None:
            if self._epoch_names is None:
                self.set_epoch(0)
            return self._epoch_names
        return self._file_names

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        name = self._names()[index]
        c = self.cfg
        rgb, x = load_rgbx_pair(c, self._root, name)
        gt = _imread(os.path.join(self._gt_path, name + c.gt_format),
                     grayscale=True).astype(np.uint8)
        if c.gt_transform:
            gt = (gt.astype(np.int32) - 1).astype(np.uint8)  # RGBXDataset.py:113
        if self.preprocess is not None:
            if getattr(self.preprocess, "accepts_rng", False):
                # Deterministic, thread-safe per-sample augmentation rng keyed
                # by (epoch, index).
                rng = np.random.RandomState(
                    (1000003 * (self._epoch + 1) + 9176 * index + 7) % (2 ** 31))
                rgb, gt, x = self.preprocess(rgb, gt, x, rng=rng)
            else:
                rgb, gt, x = self.preprocess(rgb, gt, x)
        return {"rgb": rgb, "label": gt, "modal_x": x, "fn": name,
                "n": len(self._file_names)}

    @staticmethod
    def get_class_colors(dataset_name: Optional[str] = None):
        """Palette for prediction dumps (reference RGBXDataset.py:115-147)."""
        if dataset_name == "PST900":
            return [[0, 0, 0], [0, 0, 255], [0, 255, 0], [255, 165, 0],
                    [255, 0, 0]]

        def uint82bin(n, count=8):
            return "".join(str((n >> y) & 1) for y in range(count - 1, -1, -1))

        N = 41
        cmap = np.zeros((N, 3), dtype=np.uint8)
        for i in range(N):
            r, g, b = 0, 0, 0
            cid = i
            for j in range(7):
                str_id = uint82bin(cid)
                r = r ^ (np.uint8(str_id[-1]) << (7 - j))
                g = g ^ (np.uint8(str_id[-2]) << (7 - j))
                b = b ^ (np.uint8(str_id[-3]) << (7 - j))
                cid = cid >> 3
            cmap[i] = (r, g, b)
        return cmap.tolist()
