"""Segmentation metrics: confusion matrix on the device, IoU family on the
host.

Same semantics as rgbx_semantic_segmentation_tpu/metrics.py (`hist_info`,
`compute_score`, `print_iou`), which cannot be imported here because it
imports jax at module top. `hist_info` runs on the predictions' device with
torch.bincount, so an evaluation ships no per-pixel data back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


def hist_info(n_cl: int, pred: torch.Tensor, gt: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Confusion matrix over valid pixels (0 <= gt < n_cl; the 255 ignore
    label falls out). Returns (hist[n_cl, n_cl] int64, labeled, correct) as
    tensors on pred's device; hist[g, p] counts class-g pixels predicted p."""
    if pred.shape != gt.shape:
        raise ValueError(f"pred {tuple(pred.shape)} vs gt {tuple(gt.shape)}")
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long()
    k = (gt >= 0) & (gt < n_cl)
    labeled = k.sum()
    correct = (pred[k] == gt[k]).sum()
    hist = torch.bincount(n_cl * gt[k] + pred[k],
                          minlength=n_cl ** 2).reshape(n_cl, n_cl)
    return hist, labeled, correct


class Scores(NamedTuple):
    iou: np.ndarray
    mean_iou: float
    mean_iou_no_back: float
    freq_iou: float
    mean_pixel_acc: float
    pixel_acc: float


def compute_score(hist, correct, labeled) -> Scores:
    """IoU family from an accumulated confusion matrix."""
    hist = np.asarray(hist, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))
        mean_iou = np.nanmean(iou)
        mean_iou_no_back = np.nanmean(iou[1:])
        freq = hist.sum(1) / hist.sum()
        freq_iou = (iou[freq > 0] * freq[freq > 0]).sum()
        class_acc = np.diag(hist) / hist.sum(axis=1)
        mean_pixel_acc = np.nanmean(class_acc)
    correct, labeled = int(correct), int(labeled)
    pixel_acc = correct / labeled if labeled else float("nan")
    return Scores(iou, float(mean_iou), float(mean_iou_no_back),
                  float(freq_iou), float(mean_pixel_acc), float(pixel_acc))


def print_iou(scores: Scores, class_names: Sequence[str] = None,
              show_no_back: bool = False) -> str:
    """Formatted per-class IoU table."""
    lines = []
    for i in range(len(scores.iou)):
        cls = f"{i + 1} {class_names[i]}" if class_names else f"Class {i + 1}"
        lines.append(f"{cls:8s}\t{scores.iou[i] * 100:.3f}%")
    summary = f"mean_IoU: {scores.mean_iou * 100:.3f}% "
    if show_no_back:
        summary += (f"|| mean_IoU_no_back: "
                    f"{scores.mean_iou_no_back * 100:.3f}% ")
    summary += (f"|| freq_IoU: {scores.freq_iou * 100:.3f}% "
                f"|| mean_pixel_acc: {scores.mean_pixel_acc * 100:.3f}% "
                f"|| pixel_acc: {scores.pixel_acc * 100:.3f}%")
    line = "-" * 24
    lines.append(f"{line}{summary}{line}")
    return "\n".join(lines)
