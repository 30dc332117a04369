"""Whole-image evaluation (counterpart of
rgbx_semantic_segmentation_tpu/evaluator.py, first slice).

Ported: the single-scale protocol where every image fits in one crop — the
MFNet preset (one scale, image == crop 480x640). Images are normalised on
the host exactly as the JAX evaluator does, stacked into batches of
`eval_batch`, run through ONE forward per batch, exponentiated and
argmax'd on the device; the confusion matrix is accumulated on the device
too (metrics.hist_info). Images larger than the crop (the sliding grid),
multi-scale and flip raise NotImplementedError (ROADMAP M6).

The output side: palettised and raw prediction PNGs (`save_path`),
[image | prediction | gt] composites (`show_image_dir`), the running
metric per image (`verbose`), sweeps over weights (`evaluate_weights`, which
eval_cli runs; `evaluate_checkpoints` over saved epochs) and the `-e` epoch
specs (`parse_epoch_spec`).
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

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

    def evaluate(self, dataset, logger=None, eval_batch: int = 1,
                 save_path: Optional[str] = None,
                 show_image_dir: Optional[str] = None, verbose: bool = False
                 ) -> Tuple[metrics_lib.Scores, str]:
        """Evaluate a dataset (a sequence of {rgb, modal_x, label, fn}
        dicts); returns (scores, formatted result line) and keeps the
        confusion matrix in `last_hist` (reference eval.py:23-83).

        save_path: raw and palettised prediction PNGs there (and in
        `<save_path>_color`); show_image_dir: [image | prediction | gt]
        composites there (the reference's interactive `-s` view as files);
        verbose: log the running mIoU after every image (reference -v)."""
        n_cl = self.num_classes
        hist = torch.zeros((n_cl, n_cl), dtype=torch.long, device=self.device)
        labeled = torch.zeros((), dtype=torch.long, device=self.device)
        correct = torch.zeros((), dtype=torch.long, device=self.device)
        t0 = time.time()
        n = len(dataset)
        done = last_log = 0

        def account(preds: torch.Tensor, items: List[dict]):
            nonlocal hist, labeled, correct, done, last_log
            # verbose: one image at a time, for the running metric
            groups = ([(preds[b:b + 1], items[b:b + 1])
                       for b in range(len(items))] if verbose
                      else [(preds, items)])
            for p, its in groups:
                gt = torch.from_numpy(np.stack([np.asarray(it["label"])
                                                for it in its]))
                h, l, c = metrics_lib.hist_info(
                    n_cl, p, gt.to(self.device, non_blocking=True))
                hist += h
                labeled += l
                correct += c
                done += len(its)
                if verbose and logger is not None:
                    s = metrics_lib.compute_score(hist.cpu().numpy(),
                                                  correct.item(),
                                                  labeled.item())
                    logger.info("  %s: running mIoU %.4f acc %.4f",
                                its[0].get("fn", done), s.mean_iou,
                                s.pixel_acc)
            if save_path is not None or show_image_dir is not None:
                for pred, item in zip(preds.cpu().numpy(), items):
                    if save_path is not None:
                        self._save_prediction(pred, item["fn"], save_path)
                    if show_image_dir is not None:
                        self._save_composite(pred, item, show_image_dir)
            if logger is not None and done - last_log >= 25:
                last_log = done
                logger.info("eval %d/%d (%.2f img/s)", done, n,
                            done / max(time.time() - t0, 1e-9))

        buf: List[dict] = []

        def flush():
            nonlocal buf
            if buf:
                account(self._batched_whole_image(buf), buf)
                buf = []

        for i in range(n):
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
            logger.info("eval %d/%d done (%.2f img/s)", done, n,
                        done / max(time.time() - t0, 1e-9))
        self.last_hist = hist.cpu().numpy()
        scores = metrics_lib.compute_score(self.last_hist, correct.item(),
                                           labeled.item())
        return scores, metrics_lib.print_iou(scores, self.class_names)

    # -------------------------------------------------------------- output --

    def _save_composite(self, pred: np.ndarray, item: dict, out_dir: str):
        """[raw image | prediction | gt] composite (the reference's
        `-s/--show_image` cv2.imshow view, eval.py:57-65, saved to disk)."""
        from PIL import Image

        from rgbx_semantic_segmentation_tpu_torch import visualize
        from rgbx_semantic_segmentation_tpu_torch.data.dataset import (
            RGBXDataset)

        colors = RGBXDataset.get_class_colors(self.cfg.dataset.dataset_name)
        # Photo to RGB order for the PIL save: the pipeline's images are BGR
        # (reference cv2 convention) while get_class_colors triples are RGB.
        rgb_view = np.asarray(item["rgb"])[:, :, ::-1]
        comp = visualize.show_img(colors, self.cfg.dataset.background,
                                  rgb_view, None, np.asarray(item["label"]),
                                  pred)
        os.makedirs(out_dir, exist_ok=True)
        Image.fromarray(comp.astype(np.uint8)).save(
            os.path.join(out_dir, str(item["fn"]) + ".png"))

    def _save_prediction(self, pred: np.ndarray, name: str, save_path: str):
        """Palettised + raw PNG dumps (reference eval.py:38-55)."""
        from PIL import Image

        from rgbx_semantic_segmentation_tpu_torch.data.dataset import (
            RGBXDataset)

        os.makedirs(save_path, exist_ok=True)
        os.makedirs(save_path + "_color", exist_ok=True)
        result = Image.fromarray(pred.astype(np.uint8), mode="P")
        colors = RGBXDataset.get_class_colors(self.cfg.dataset.dataset_name)
        palette = list(np.array(colors).flat)
        palette += [0] * (768 - len(palette))
        result.putpalette(palette)
        result.save(os.path.join(save_path + "_color", name + ".png"))
        Image.fromarray(pred.astype(np.uint8)).save(
            os.path.join(save_path, name + ".png"))


def evaluate_weights(cfg: Config, dataset, targets, val_log: Optional[str] = None,
                     logger=None, device=None, **eval_kw
                     ) -> Dict[str, Tuple[metrics_lib.Scores, np.ndarray]]:
    """The sweep (reference evaluator.py:42-98): one model on `device`; for
    each (label, load) of `targets` load(model) puts the weights in (a None
    load: the seed-0 init), the dataset is evaluated with `eval_kw`
    (SegEvaluator.evaluate's eval_batch, save_path, show_image_dir,
    verbose), and the table is printed and appended to `val_log`. Returns
    {label: (scores, confusion matrix)}."""
    from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model

    device = resolve_device(device)
    results = {}
    if not targets:
        return results
    model = build_model(cfg, device=device,
                        seed=0 if targets[0][1] is None else None)
    evaluator = SegEvaluator(cfg, model, device=device)
    for label, load in targets:
        if load is not None:
            load(model)
        scores, line = evaluator.evaluate(dataset, logger=logger, **eval_kw)
        results[label] = (scores, evaluator.last_hist)
        text = f"======= {label} =======\n{line}"
        print(text)
        if val_log:
            os.makedirs(os.path.dirname(os.path.abspath(val_log)),
                        exist_ok=True)
            with open(val_log, "a") as f:
                f.write(text + "\n")
    return results


def evaluate_checkpoints(cfg: Config, dataset, epochs: Sequence[int],
                         checkpoint_dir: str, val_log: Optional[str] = None,
                         logger=None, device=None, **eval_kw
                         ) -> Dict[int, metrics_lib.Scores]:
    """Epoch-range checkpoint sweep: evaluate_weights over the saved epochs
    of `checkpoint_dir`; returns {epoch: scores}."""
    from rgbx_semantic_segmentation_tpu_torch.checkpoint import (
        CheckpointManager)

    mgr = CheckpointManager(checkpoint_dir)
    results = evaluate_weights(
        cfg, dataset, [(f"epoch {e}", functools.partial(mgr.load_model, e))
                       for e in epochs],
        val_log=val_log, logger=logger, device=device, **eval_kw)
    return {e: results[f"epoch {e}"][0] for e in epochs}


def parse_epoch_spec(spec: str, available: Sequence[int]) -> List[int]:
    """'300' | '250-400' | '250-' | 'last' -> epoch list
    (reference evaluator.py:42-81 link/range logic)."""
    available = sorted(available)
    if not available:
        return []
    if spec in ("last", ""):
        return [available[-1]]
    if "-" in spec:
        lo, _, hi = spec.partition("-")
        lo = int(lo)
        hi = int(hi) if hi else available[-1]
        return [e for e in available if lo <= e <= hi]
    e = int(spec)
    return [e] if e in available else []
