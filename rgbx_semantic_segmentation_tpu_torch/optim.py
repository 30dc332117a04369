"""Optimizer construction (counterpart of rgbx_semantic_segmentation_tpu/
optim.py; this slice ports AdamW with the decay mask).

Weight decay applies only to Linear / Conv kernels (the original repo's
`group_weight`): biases, all norm parameters and bare scalar parameters are
exempt. The scheduled lr is written into the optimizer's param groups
before each update (see train.Trainer.step) and `applied_lr` reads it back.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.config import Config


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: decays}. True for the `.weight` of nn.Linear and
    nn.Conv2d (depthwise included) — the flax `kernel`s with ndim >= 2 of
    the JAX mask — and False for everything else."""
    kernels = {f"{prefix}.weight" if prefix else "weight"
               for prefix, m in model.named_modules()
               if isinstance(m, (nn.Linear, nn.Conv2d))}
    return {name: name in kernels and p.dim() >= 2
            for name, p in model.named_parameters()}


def build_optimizer(cfg: Config, model: nn.Module) -> torch.optim.Optimizer:
    """AdamW (betas .9/.999, eps 1e-8, decoupled decay on the masked group).
    The lr starts at the schedule's value for step 0."""
    tc = cfg.train
    if tc.optimizer in ("SGDM", "SGD", "LBFGS"):
        raise NotImplementedError(
            f"optimizer {tc.optimizer!r} is not ported yet: ROADMAP M11")
    if tc.optimizer != "AdamW":
        raise KeyError(f"unknown optimizer {tc.optimizer!r}")
    mask = weight_decay_mask(model)
    named = dict(model.named_parameters())
    decay = [p for n, p in named.items() if mask[n]]
    no_decay = [p for n, p in named.items() if not mask[n]]
    return torch.optim.AdamW(
        [{"params": decay, "weight_decay": tc.weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=tc.lr, betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def applied_lr(optimizer: torch.optim.Optimizer) -> Optional[float]:
    """The learning rate of the optimizer's last update, read from its
    param groups (what the log should print: the source of truth)."""
    groups = optimizer.param_groups
    return float(groups[0]["lr"]) if groups else None
