"""Segmentation losses (counterpart of rgbx_semantic_segmentation_tpu/
losses.py; this slice ports the cross-entropy the flagship trains with).

Functions take `logits` in NHWC layout (B, H, W, C), as the model returns
them, and integer `labels` (B, H, W), and respect `ignore_index`
(= config.background = 255).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

# Criterion names the JAX build_criterion accepts and this port does not yet.
_LATER_CRITERIA = ("SigmoidFocalLoss", "FocalLoss", "DiceLoss", "DiceCELoss",
                   "RCELoss", "BalanceLoss", "FocalLoss2d", "OhemCrossEntropy",
                   "berHuLoss", "CE_Focal", "TopologyAwareLoss",
                   "TopologyAwareCE")


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean",
                       denom_reduce: Optional[Callable[[torch.Tensor],
                                                       torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Softmax cross-entropy with ignore_index: fp32 log-softmax over the
    trailing class axis; matches nn.CrossEntropyLoss(ignore_index=...).

    With class weights the mean is normalised by the summed weights of the
    kept targets (torch's rule). When every pixel is ignored the mean is 0,
    where F.cross_entropy gives NaN. Out-of-range labels are clamped, as in
    the JAX version. reduction: "mean" | "sum" | anything else = per-pixel.
    `denom_reduce` maps the mean's normaliser (the kept targets' count or
    summed weights) to the one it divides by: a data-parallel rank passes
    the sum over the ranks, so that the ranks' losses add up to the mean
    over the global batch (see train.make_loss_fn).
    """
    logits = logits.float()
    num_classes = logits.shape[-1]
    valid = (labels != ignore_index).float()
    logp = torch.log_softmax(logits, dim=-1)
    target = labels.long().clamp(0, num_classes - 1)
    nll = -logp.gather(-1, target.unsqueeze(-1)).squeeze(-1)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32,
                            device=logits.device)[target]
        nll = nll * w
        denom = (w * valid).sum()
    else:
        denom = valid.sum()
    if denom_reduce is not None:
        denom = denom_reduce(denom)
    nll = nll * valid
    if reduction == "mean":
        # Guard only the empty case: the weighted mean divides by
        # sum(w * valid) even when it is < 1.
        return nll.sum() / torch.where(denom > 0, denom,
                                       torch.ones_like(denom))
    if reduction == "sum":
        return nll.sum()
    return nll


def build_criterion(cfg) -> Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor]:
    """loss_fn(logits, labels) -> scalar from a Config (criterion selection
    of the JAX build_criterion; only CrossEntropyLoss is ported)."""
    name = cfg.train.criterion
    if name == "CrossEntropyLoss":
        return functools.partial(cross_entropy_loss,
                                 ignore_index=cfg.dataset.background)
    if name in _LATER_CRITERIA:
        raise NotImplementedError(
            f"criterion {name!r} is not ported yet: ROADMAP M11")
    raise KeyError(f"unknown criterion {name!r}")
