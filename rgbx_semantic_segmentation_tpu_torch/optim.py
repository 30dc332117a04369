"""Optimizer construction (counterpart of rgbx_semantic_segmentation_tpu/
optim.py): AdamW, SGD with momentum (SGDM and SGD), and L-BFGS with a zoom
line search (lbfgs.py); the weight-decay mask and the Swin frozen-stage
mask.

Weight decay applies only to Linear / Conv kernels (the original repo's
`group_weight`): biases, all norm parameters and bare scalar parameters are
exempt. The scheduled lr (and, for SGD under CyclicLR, the scheduled
momentum) is written into the optimizer's param groups before each update
(see train.make_train_step) and `applied_lr` reads it back. L-BFGS takes
no schedule: its step is cfg.train.lr times the line search's step size.

Parameters that the Swin `frozen_stages` knob freezes get
requires_grad_(False) and stay out of every param group: no gradient, no
update and no weight decay reach them (the JAX package's stop_gradient plus
its masked set_to_zero of their updates).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch import lr_schedules
from rgbx_semantic_segmentation_tpu_torch.config import Config
from rgbx_semantic_segmentation_tpu_torch.lbfgs import LBFGS


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: decays}. True for the `.weight` of nn.Linear and
    nn.Conv2d (depthwise included) — the flax `kernel`s with ndim >= 2 of
    the JAX mask — and False for everything else."""
    kernels = {f"{prefix}.weight" if prefix else "weight"
               for prefix, m in model.named_modules()
               if isinstance(m, (nn.Linear, nn.Conv2d))}
    return {name: name in kernels and p.dim() >= 2
            for name, p in model.named_parameters()}


def frozen_mask(cfg: Config, model: nn.Module) -> Optional[Dict[str, bool]]:
    """{parameter name: frozen} for the Swin `frozen_stages` knob, None when
    nothing is frozen. fs >= 0 freezes the patch embeds, fs >= 1 the
    absolute position embeddings, fs >= 2 stages 0..fs-2, each in BOTH
    towers (the JAX package's fix of the original's RGB-only freeze). The
    FRMs, FFMs, downsamples and output norms stay trainable."""
    fs = cfg.model.swin_frozen_stages
    if fs < 0 or not cfg.model.backbone.startswith("swin"):
        return None
    roots = {"patch_embed", "patch_embed_d"}
    if fs >= 1:
        roots |= {"absolute_pos_embed", "absolute_pos_embed_d"}
    for i in range(fs - 1):
        roots |= {f"layers.{i}", f"layers_d.{i}"}

    def frozen(name: str) -> bool:
        if not name.startswith("backbone."):
            return False
        rest = name[len("backbone."):]
        return any(rest == r or rest.startswith(r + ".") for r in roots)

    return {name: frozen(name) for name, _ in model.named_parameters()}


def build_optimizer(cfg: Config, model: nn.Module) -> torch.optim.Optimizer:
    """The optimizer of cfg.train.optimizer over the model's trainable
    parameters (frozen ones, see frozen_mask, get requires_grad_(False)):

    - AdamW: betas .9/.999, eps 1e-8, decoupled decay on the masked group;
    - SGDM / SGD: torch SGD with cfg.train.momentum (no dampening, no
      Nesterov) and L2 decay on the masked group, which is optax's
      add_decayed_weights(mask) followed by sgd's trace;
    - LBFGS: lbfgs.LBFGS at cfg.train.lr, no decay.

    The lr starts at cfg.train.lr; the train step writes the schedule's."""
    tc = cfg.train
    frozen = frozen_mask(cfg, model) or {}
    named = {}
    for n, p in model.named_parameters():
        if frozen.get(n, False):
            p.requires_grad_(False)
        else:
            named[n] = p
    if tc.optimizer == "LBFGS":
        return LBFGS(named.values(), lr=tc.lr)
    mask = weight_decay_mask(model)
    decay = [p for n, p in named.items() if mask[n]]
    no_decay = [p for n, p in named.items() if not mask[n]]
    groups = [{"params": decay, "weight_decay": tc.weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    if tc.optimizer == "AdamW":
        return torch.optim.AdamW(groups, lr=tc.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    if tc.optimizer in ("SGDM", "SGD"):
        return torch.optim.SGD(groups, lr=tc.lr, momentum=tc.momentum,
                               dampening=0.0, nesterov=False)
    raise KeyError(f"unknown optimizer {tc.optimizer!r}")


def build_schedules(cfg: Config) -> Tuple[Optional[lr_schedules.Schedule],
                                          Optional[lr_schedules.Schedule]]:
    """(lr schedule, momentum schedule) of the optimizer, each None where
    it takes none: LBFGS runs at the constant cfg.train.lr (its schedule is
    never built, so a config it ignores cannot raise), and only SGD under
    CyclicLR schedules its momentum."""
    tc = cfg.train
    if tc.optimizer == "LBFGS":
        return None, None
    if tc.optimizer in ("SGDM", "SGD") and tc.lr_policy == "CyclicLR":
        return lr_schedules.cyclic_schedules(tc)
    return lr_schedules.build_schedule(tc.lr_policy, tc), None


def set_lr(optimizer: torch.optim.Optimizer, lr: float,
           momentum: Optional[float] = None) -> None:
    """Write the step's lr (and momentum, where scheduled) into every param
    group, before the update."""
    for group in optimizer.param_groups:
        group["lr"] = lr
        if momentum is not None:
            group["momentum"] = momentum


def applied_lr(optimizer: torch.optim.Optimizer) -> Optional[float]:
    """The learning rate of the optimizer's last update, read from its
    param groups (what the log should print: the source of truth); None
    for LBFGS, whose step the line search sizes (as in the JAX package)."""
    groups = optimizer.param_groups
    if isinstance(optimizer, LBFGS) or not groups:
        return None
    return float(groups[0]["lr"])


def applied_momentum(optimizer: torch.optim.Optimizer) -> Optional[float]:
    """The momentum of SGD's last update (CyclicLR schedules it); None for
    the optimizers that have none."""
    groups = optimizer.param_groups
    if not isinstance(optimizer, torch.optim.SGD) or not groups:
        return None
    return float(groups[0]["momentum"])
