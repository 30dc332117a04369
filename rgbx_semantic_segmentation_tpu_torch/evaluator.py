"""Sliding-window + multi-scale + flip evaluation (counterpart of
rgbx_semantic_segmentation_tpu/evaluator.py).

The JAX evaluator's protocol, step for step: per scale the raw pair is
resized on the host (`cv_ops.resize_by_factor`; nearest for a 1-channel X,
replicated to three channels), normalised once (twice with
`compat_double_normalize`), and either padded to the crop and run whole (an
image no larger than the crop on one side) or cut into the static sliding
grid (`_window_grid`, stride `eval_stride_rate` of the crop; the original
repo's swapped grid with `compat_stride_swap`), ALL windows of one scaled
image in ONE batched forward. A forward returns exp-scores,
exp(logits + the un-flipped logits of the W-flipped input) with flip; the
canvas sums the windows' exp-scores, is cropped of its centred margins,
resized back to the original size (cv2 INTER_LINEAR, `resize_linear`) and
summed over scales; the prediction is its argmax. All of it after the
host-side resize runs on the device, the confusion matrix too
(metrics.hist_info).

`evaluate` batches consecutive same-size images whose every scale fits one
crop: one forward of `eval_batch` images a scale (at exact fit and one
scale the argmax of the forward, the MFNet case); any other image goes
through `sliding_eval_rgbx` alone.

The output side: palettised and raw prediction PNGs (`save_path`),
[image | prediction | gt] composites (`show_image_dir`), the running
metric per image (`verbose`), sweeps over weights (`evaluate_weights`, which
eval_cli runs; `evaluate_checkpoints` over saved epochs) and the `-e` epoch
specs (`parse_epoch_spec`).
"""
from __future__ import annotations

import functools
import math
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
from rgbx_semantic_segmentation_tpu_torch.models.builder import main_logits


def _window_grid(pad_h: int, pad_w: int, crop: Tuple[int, int],
                 stride_rate: float) -> List[Tuple[int, int]]:
    """Static list of (y, x) window origins covering the padded canvas."""
    ch, cw = crop
    sy = int(math.ceil(ch * stride_rate))
    sx = int(math.ceil(cw * stride_rate))
    rows = int(math.ceil((pad_h - ch) / sy)) + 1
    cols = int(math.ceil((pad_w - cw) / sx)) + 1
    out = []
    for gy in range(rows):
        for gx in range(cols):
            ey = min(gy * sy + ch, pad_h)
            ex = min(gx * sx + cw, pad_w)
            out.append((ey - ch, ex - cw))
    return out


def _stride_swap_rects(pad_h: int, pad_w: int, crop: Tuple[int, int],
                       stride_rate: float) -> List[Tuple[int, int, int, int]]:
    """The original repo's window rectangles (ay, ey, ax, ex) on the padded
    canvas: its h/w stride AND crop-extent indices swapped, so windows are
    crop_h wide and crop_w tall, with possibly negative starts read as python
    slices do (from the end, clamped at 0). A no-op for square crops."""
    ch, cw = crop
    sy = int(math.ceil(ch * stride_rate))  # row stride
    sx = int(math.ceil(cw * stride_rate))  # col stride
    rows = int(math.ceil((pad_h - ch) / sy)) + 1
    cols = int(math.ceil((pad_w - cw) / sx)) + 1
    rects = []
    for gy in range(rows):
        for gx in range(cols):
            e_x = min(gx * sy + ch, pad_w)  # swapped: row stride, crop_h
            e_y = min(gy * sx + cw, pad_h)  # swapped: col stride, crop_w
            s_x, s_y = e_x - ch, e_y - cw
            a_y = max(pad_h + s_y, 0) if s_y < 0 else s_y
            a_x = max(pad_w + s_x, 0) if s_x < 0 else s_x
            rects.append((a_y, e_y, a_x, e_x))
    return rects


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv_ops.resize_linear (cv2 INTER_LINEAR: src = (dst + 0.5) * scale -
    0.5, edge clamping, no antialiasing) on fp32 (..., H, W, C) tensors on
    their device, with the numpy version's weights and order of operations."""
    in_h, in_w = x.shape[-3:-1]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return x

    def taps(n_in, n_out):
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(src).astype(np.int64)
        w = (src - i0).astype(np.float32)
        w = np.where(i0 < 0, 0.0, np.where(i0 >= n_in - 1, 0.0, w))
        lo, hi = np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1)
        return (torch.from_numpy(a).to(x.device) for a in
                (lo, hi, w.astype(np.float32)))

    y0, y1, wy = taps(in_h, out_h)
    x0, x1, wx = taps(in_w, out_w)
    wy, wx = wy[:, None, None], wx[:, None]
    rows0, rows1 = x.index_select(-3, y0), x.index_select(-3, y1)
    top = (rows0.index_select(-2, x0) * (1 - wx)
           + rows0.index_select(-2, x1) * wx)
    bot = (rows1.index_select(-2, x0) * (1 - wx)
           + rows1.index_select(-2, x1) * wx)
    return top * (1 - wy) + bot * wy


class SegEvaluator:
    """Dataset evaluator over a port model (EncoderDecoder) on `device`
    (None: the card; see device.resolve_device).

    compat_double_normalize: normalise twice, as the original fork's eval
    did (for checkpoint-parity debugging); compat_stride_swap: the original
    repo's swapped sliding grid (to score its checkpoints under the
    published protocol)."""

    def __init__(self, cfg: Config, model: nn.Module, device=None,
                 class_names: Optional[Sequence[str]] = None,
                 compat_double_normalize: bool = False,
                 compat_stride_swap: bool = False):
        self.cfg = cfg
        self.crop = tuple(cfg.eval.eval_crop_size)
        self.stride_rate = cfg.eval.eval_stride_rate
        self.scales = tuple(cfg.eval.eval_scale_array)
        self.flip = cfg.eval.eval_flip
        self.num_classes = cfg.dataset.num_classes
        self.norm_mean = cfg.dataset.norm_mean
        self.norm_std = cfg.dataset.norm_std
        self.class_names = class_names or list(cfg.dataset.class_names)
        self.compat_double_normalize = compat_double_normalize
        self.compat_stride_swap = compat_stride_swap
        self.model = model
        self.device = resolve_device(device)

    # ---------------------------------------------------------------- core --

    def _normalize_pair(self, img: np.ndarray, modal_x: np.ndarray):
        img_n = cv_ops.normalize(img, self.norm_mean, self.norm_std)
        modal_n = cv_ops.normalize(modal_x, self.norm_mean, self.norm_std)
        if self.compat_double_normalize:
            img_n = cv_ops.normalize(img_n * 255.0, self.norm_mean,
                                     self.norm_std)
            modal_n = cv_ops.normalize(modal_n * 255.0, self.norm_mean,
                                       self.norm_std)
        return img_n, modal_n

    def _scaled(self, img: np.ndarray, modal_x: np.ndarray, s: float):
        """One raw pair resized by `s` (nearest for a 1-channel X, then
        replicated to three channels) and normalised on the host."""
        img_s = cv_ops.resize_by_factor(img, s, s)
        if modal_x.ndim == 2:
            modal_s = cv_ops.resize_by_factor(modal_x, s, s, nearest=True)
            modal_s = np.stack([modal_s] * 3, axis=-1)
        else:
            modal_s = cv_ops.resize_by_factor(modal_x, s, s)
        return self._normalize_pair(img_s, modal_s)

    def prepare(self, img: np.ndarray, modal_x: np.ndarray):
        """One raw pair as the model takes it at scale 1: modal_x replicated
        to three channels when it has one, both normalised to fp32 on the
        host."""
        if modal_x.ndim == 2:
            modal_x = np.stack([modal_x] * 3, axis=-1)
        return self._normalize_pair(img, modal_x)

    @torch.no_grad()
    def _fwd(self, rgb: np.ndarray, modal_x: np.ndarray) -> torch.Tensor:
        """Stacked normalised (B, H, W, 3) pairs -> exp-scores (B, H, W, C)
        fp32 on the device; with flip, exp(logits + the un-flipped logits of
        the W-flipped input): one exp of the sum, as the JAX evaluator."""
        r = torch.from_numpy(rgb).to(self.device, non_blocking=True)
        m = torch.from_numpy(modal_x).to(self.device, non_blocking=True)
        score = main_logits(self.model(r, m)).float()
        if self.flip:
            flipped = main_logits(self.model(r.flip(2), m.flip(2))).float()
            score = score + flipped.flip(2)
        return torch.exp(score)

    def _windows_forward(self, img: np.ndarray,
                         modal_x: np.ndarray) -> torch.Tensor:
        """The exp-score canvas (h, w, C) of one scaled, normalised pair:
        padded and run whole when it fits the crop on one side, else every
        window of the grid in one batched forward, summed on the canvas."""
        ch, cw = self.crop
        h, w = img.shape[:2]
        img_p, margin = cv_ops.pad_to_shape(img, self.crop, value=0)
        modal_p, _ = cv_ops.pad_to_shape(modal_x, self.crop, value=0)
        ph, pw = img_p.shape[:2]
        if h <= ch or w <= cw:
            canvas = self._fwd(img_p[None], modal_p[None])[0]
        elif self.compat_stride_swap:
            canvas = self._windows_stride_swap(img_p, modal_p)
        else:
            grid = _window_grid(ph, pw, self.crop, self.stride_rate)
            scores = self._fwd(
                np.stack([img_p[y:y + ch, x:x + cw] for y, x in grid]),
                np.stack([modal_p[y:y + ch, x:x + cw] for y, x in grid]))
            canvas = torch.zeros((ph, pw, self.num_classes),
                                 dtype=torch.float32, device=self.device)
            for (y, x), s in zip(grid, scores):
                canvas[y:y + ch, x:x + cw] += s
        return canvas[margin[0]:ph - margin[1], margin[2]:pw - margin[3]]

    def _windows_stride_swap(self, img_p: np.ndarray,
                             modal_p: np.ndarray) -> torch.Tensor:
        """The canvas of the original repo's swapped grid (see
        _stride_swap_rects): each rectangle re-padded to the crop with
        centred margins, its scores cropped back and summed where it was
        read, replicated with the incomplete coverage it can give."""
        ph, pw = img_p.shape[:2]
        rects = _stride_swap_rects(ph, pw, self.crop, self.stride_rate)
        rgb_w, mx_w, margins = [], [], []
        for ay, ey, ax, ex in rects:
            sub, tm = cv_ops.pad_to_shape(img_p[ay:ey, ax:ex], self.crop,
                                          value=0)
            msub, _ = cv_ops.pad_to_shape(modal_p[ay:ey, ax:ex], self.crop,
                                          value=0)
            rgb_w.append(sub)
            mx_w.append(msub)
            margins.append(tm)
        scores = self._fwd(np.stack(rgb_w), np.stack(mx_w))
        canvas = torch.zeros((ph, pw, self.num_classes), dtype=torch.float32,
                             device=self.device)
        for (ay, ey, ax, ex), tm, s in zip(rects, margins, scores):
            canvas[ay:ey, ax:ex] += s[tm[0]:s.shape[0] - tm[1],
                                      tm[2]:s.shape[1] - tm[3]]
        return canvas

    def sliding_eval_rgbx(self, img: np.ndarray,
                          modal_x: np.ndarray) -> torch.Tensor:
        """Multi-scale sliding-window prediction for one raw (unnormalised)
        pair: the (H, W) argmax map at the original size, on the device."""
        size = img.shape[:2]
        total = None
        for s in self.scales:
            score = resize_linear(self._windows_forward(
                *self._scaled(img, modal_x, s)), size)
            total = score if total is None else total + score
        return torch.argmax(total, dim=-1)

    def _one_shot_all_scales(self, item) -> bool:
        h, w = item["rgb"].shape[:2]
        ch, cw = self.crop
        return all(round(h * s) <= ch or round(w * s) <= cw
                   for s in self.scales)

    def _batched_whole_image(self, group) -> torch.Tensor:
        """A group of same-size images, each one-shot at every scale: per
        scale ONE forward of the group padded to the crop, margins cropped,
        resized back and summed; (B, H, W) argmax maps on the device. At
        exact fit and one scale, the argmax of the forward."""
        size = group[0]["rgb"].shape[:2]
        if self.scales == (1.0,) and tuple(size) == self.crop:
            pairs = [self.prepare(it["rgb"], it["modal_x"]) for it in group]
            return torch.argmax(self._fwd(np.stack([p[0] for p in pairs]),
                                          np.stack([p[1] for p in pairs])),
                                dim=-1)
        total = None
        for s in self.scales:
            rgbs, mxs = [], []
            for item in group:
                img_n, mx_n = self._scaled(item["rgb"], item["modal_x"], s)
                img_p, m = cv_ops.pad_to_shape(img_n, self.crop, value=0)
                rgbs.append(img_p)
                mxs.append(cv_ops.pad_to_shape(mx_n, self.crop, value=0)[0])
            scores = self._fwd(np.stack(rgbs), np.stack(mxs))
            H, W = scores.shape[1:3]
            score = resize_linear(scores[:, m[0]:H - m[1], m[2]:W - m[3]],
                                  size)
            total = score if total is None else total + score
        return torch.argmax(total, dim=-1)

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
            if eval_batch > 1 and self._one_shot_all_scales(item):
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
                     logger=None, device=None,
                     compat_double_normalize: bool = False,
                     compat_stride_swap: bool = False, **eval_kw
                     ) -> Dict[str, Tuple[metrics_lib.Scores, np.ndarray]]:
    """The sweep (reference evaluator.py:42-98): one model on `device`; for
    each (label, load) of `targets` load(model) puts the weights in (a None
    load: the seed-0 init), the dataset is evaluated with `eval_kw`
    (SegEvaluator.evaluate's eval_batch, save_path, show_image_dir,
    verbose) by a SegEvaluator with the compat flags, and the table is
    printed and appended to `val_log`. Returns {label: (scores, confusion
    matrix)}."""
    from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model

    device = resolve_device(device)
    results = {}
    if not targets:
        return results
    model = build_model(cfg, device=device,
                        seed=0 if targets[0][1] is None else None)
    evaluator = SegEvaluator(cfg, model, device=device,
                             compat_double_normalize=compat_double_normalize,
                             compat_stride_swap=compat_stride_swap)
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
