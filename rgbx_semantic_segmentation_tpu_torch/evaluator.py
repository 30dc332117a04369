"""Whole-image evaluation (counterpart of
rgbx_semantic_segmentation_tpu/evaluator.py, first slice).

Ported: the single-scale protocol where every image fits in one crop — the
MFNet preset (one scale, image == crop 480x640). Images are normalised on
the host exactly as the JAX evaluator does, stacked into batches of
`eval_batch`, run through ONE forward per batch, exponentiated and
argmax'd on the device; the confusion matrix is accumulated on the device
too (metrics.hist_info). Images larger than the crop (the sliding grid),
multi-scale and flip raise NotImplementedError (ROADMAP M6).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch import metrics as metrics_lib
from rgbx_semantic_segmentation_tpu_torch.config import Config
from rgbx_semantic_segmentation_tpu_torch.data import cv_ops
from rgbx_semantic_segmentation_tpu_torch.device import resolve_device

_M6 = "ROADMAP M6 (sliding window, multi-scale, flip)"


class SegEvaluator:
    """Dataset evaluator over a port model (EncoderDecoder) on `device`
    (None: the card; see device.resolve_device)."""

    def __init__(self, cfg: Config, model: nn.Module, device=None,
                 class_names: Optional[Sequence[str]] = None):
        self.cfg = cfg
        self.crop = tuple(cfg.eval.eval_crop_size)
        self.scales = tuple(cfg.eval.eval_scale_array)
        if self.scales != (1.0,) or cfg.eval.eval_flip:
            raise NotImplementedError(
                f"eval scales {self.scales} / flip {cfg.eval.eval_flip}: only "
                f"single-scale (1.0) without flip is ported; {_M6}")
        self.num_classes = cfg.dataset.num_classes
        self.norm_mean = cfg.dataset.norm_mean
        self.norm_std = cfg.dataset.norm_std
        self.class_names = class_names or list(cfg.dataset.class_names)
        self.model = model
        self.device = resolve_device(device)

    # ---------------------------------------------------------------- core --

    def prepare(self, img: np.ndarray, modal_x: np.ndarray):
        """One raw pair as the model takes it: modal_x replicated to three
        channels when it has one, both normalised to fp32 on the host."""
        if modal_x.ndim == 2:
            modal_x = np.stack([modal_x] * 3, axis=-1)
        return (cv_ops.normalize(img, self.norm_mean, self.norm_std),
                cv_ops.normalize(modal_x, self.norm_mean, self.norm_std))

    @torch.no_grad()
    def _fwd(self, rgb: np.ndarray, modal_x: np.ndarray) -> torch.Tensor:
        """Stacked normalised (B, H, W, 3) pairs -> exp-scores (B, H, W, C)
        fp32 on the device. exp is kept (the JAX/original evaluator sums
        exp-scores), so argmax ties resolve as they do there."""
        r = torch.from_numpy(rgb).to(self.device, non_blocking=True)
        m = torch.from_numpy(modal_x).to(self.device, non_blocking=True)
        return torch.exp(self.model(r, m).float())

    def _one_shot(self, item) -> bool:
        h, w = item["rgb"].shape[:2]
        ch, cw = self.crop
        return h <= ch or w <= cw

    def _batched_whole_image(self, group) -> torch.Tensor:
        """A group of same-size one-shot images, each padded to the crop, in
        ONE forward; margins cropped, argmax on the device: (B, H, W) maps.
        At exact fit (the MFNet case) nothing is padded or cropped."""
        rgbs, mxs, margin = [], [], None
        for item in group:
            img_n, mx_n = self.prepare(item["rgb"], item["modal_x"])
            img_p, margin = cv_ops.pad_to_shape(img_n, self.crop, value=0)
            mx_p, _ = cv_ops.pad_to_shape(mx_n, self.crop, value=0)
            rgbs.append(img_p)
            mxs.append(mx_p)
        score = self._fwd(np.stack(rgbs), np.stack(mxs))
        H, W = score.shape[1:3]
        score = score[:, margin[0]:H - margin[1], margin[2]:W - margin[3]]
        return torch.argmax(score, dim=-1)

    def sliding_eval_rgbx(self, img: np.ndarray,
                          modal_x: np.ndarray) -> torch.Tensor:
        """Prediction for one raw image pair; only the one-shot case
        (image <= crop) is ported."""
        if not self._one_shot({"rgb": img}):
            raise NotImplementedError(
                f"image {img.shape[:2]} exceeds crop {self.crop}: the sliding "
                f"window is {_M6}")
        return self._batched_whole_image([{"rgb": img, "modal_x": modal_x}])[0]

    # ----------------------------------------------------------------- run --

    def evaluate(self, dataset, logger=None, eval_batch: int = 1
                 ) -> Tuple[metrics_lib.Scores, str]:
        """Evaluate a dataset (a sequence of {rgb, modal_x, label, fn}
        dicts); returns (scores, formatted result line)."""
        n_cl = self.num_classes
        hist = torch.zeros((n_cl, n_cl), dtype=torch.long, device=self.device)
        labeled = torch.zeros((), dtype=torch.long, device=self.device)
        correct = torch.zeros((), dtype=torch.long, device=self.device)
        t0 = time.time()
        done = 0

        def account(preds: torch.Tensor, items: List[dict]):
            nonlocal hist, labeled, correct, done
            gt = torch.from_numpy(np.stack([np.asarray(it["label"])
                                            for it in items]))
            h, l, c = metrics_lib.hist_info(n_cl, preds,
                                            gt.to(self.device, non_blocking=True))
            hist += h
            labeled += l
            correct += c
            done += len(items)

        buf: List[dict] = []

        def flush():
            nonlocal buf
            if buf:
                account(self._batched_whole_image(buf), buf)
                buf = []

        for i in range(len(dataset)):
            item = dataset[i]
            if eval_batch > 1 and self._one_shot(item):
                if buf and buf[0]["rgb"].shape != item["rgb"].shape:
                    flush()
                buf.append(item)
                if len(buf) == eval_batch:
                    flush()
            else:
                flush()
                pred = self.sliding_eval_rgbx(item["rgb"], item["modal_x"])
                account(pred[None], [item])
        flush()
        if logger is not None:
            logger.info("eval %d/%d done (%.2f img/s)", done, len(dataset),
                        done / max(time.time() - t0, 1e-9))
        scores = metrics_lib.compute_score(hist.cpu().numpy(), correct.item(),
                                           labeled.item())
        return scores, metrics_lib.print_iou(scores, self.class_names)
