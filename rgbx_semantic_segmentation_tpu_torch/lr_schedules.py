"""Learning-rate schedules as plain functions `step -> float` (counterpart
of rgbx_semantic_segmentation_tpu/lr_schedules.py; this slice ports the two
poly schedules).

As in the JAX package, the lr is applied at the current step: the original
repo's one-step lag (it sets the lr after optimizer.step()) is not kept.
The arithmetic runs in fp32 like the JAX schedules, so both give the same
lr to the last bit or two.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_LATER_SCHEDULES = ("MultiStageLR", "LinearIncreaseLR", "CyclicLR", "StepLR")


def poly_lr(start_lr: float, lr_power: float, total_iters: int) -> Schedule:
    """lr * max(1 - step / total, 0) ** power."""
    f = np.float32

    def schedule(step: int) -> float:
        frac = np.maximum(f(1.0) - f(step) / f(total_iters), f(0.0))
        return float(f(start_lr) * frac ** f(lr_power))

    return schedule


def warmup_poly_lr(start_lr: float, lr_power: float, total_iters: int,
                   warmup_steps: int) -> Schedule:
    """Linear warm-up over `warmup_steps`, then the poly decay (the primary
    schedule: warm_up_epoch * niters_per_epoch steps of warm-up)."""
    f = np.float32
    decay = poly_lr(start_lr, lr_power, total_iters)

    def schedule(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return float(f(start_lr) * (f(step) / f(warmup_steps)))
        return decay(step)

    return schedule


def build_schedule(name: str, cfg) -> Schedule:
    """A schedule by its `TrainConfig.lr_policy` name, from a TrainConfig."""
    if name == "WarmUpPolyLR":
        return warmup_poly_lr(cfg.lr, cfg.lr_power, cfg.total_iters,
                              cfg.warmup_iters)
    if name == "PolyLR":
        return poly_lr(cfg.lr, cfg.lr_power, cfg.total_iters)
    if name in _LATER_SCHEDULES:
        raise NotImplementedError(
            f"lr schedule {name!r} is not ported yet: ROADMAP M11")
    raise KeyError(f"unknown schedule {name!r}")
