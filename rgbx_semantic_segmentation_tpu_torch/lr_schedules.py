"""Learning-rate schedules as plain functions `step -> float` (counterpart
of rgbx_semantic_segmentation_tpu/lr_schedules.py): the six schedules its
build_schedule names, and CyclicLR's paired momentum schedule.

As in the JAX package, the lr is applied at the current step: the original
repo's one-step lag (it sets the lr after optimizer.step()) is not kept.
The arithmetic runs in fp32 like the JAX schedules, so both give the same
lr to the last bit or two.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np

Schedule = Callable[[int], float]
f32 = np.float32


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


def multi_stage_lr(lr_stages: Sequence[Tuple[int, float]]) -> Schedule:
    """Piecewise constant, keyed by epoch: `lr_stages` is [(boundary_epoch,
    lr), ...]; the lr of the stage indexed by the count of boundaries the
    epoch has reached, clipped to the last stage (the JAX arithmetic)."""
    boundaries = np.asarray([b for b, _ in lr_stages], f32)
    lrs = np.asarray([lr for _, lr in lr_stages], f32)

    def schedule(epoch) -> float:
        idx = int(np.sum(f32(epoch) >= boundaries))
        return float(lrs[min(idx, len(lrs) - 1)])

    return schedule


def linear_increase_lr(start_lr: float, end_lr: float, warm_iters: int
                       ) -> Schedule:
    """start_lr + epoch * (end_lr - start_lr) / warm_iters, keyed by epoch."""
    delta = f32((end_lr - start_lr) / warm_iters)

    def schedule(epoch) -> float:
        return float(f32(start_lr) + f32(epoch) * delta)

    return schedule


def cyclic_lr(min_lr: float, max_lr: float, cycle_epochs: int,
              warmup_epochs: int, iters_per_epoch: int,
              min_momentum: float = 0.85, max_momentum: float = 0.95
              ) -> Tuple[Schedule, Schedule]:
    """Cosine annealing with warm restarts every `cycle_epochs` after a
    linear warm-up of `warmup_epochs`, and the inverse momentum schedule:
    (lr schedule, momentum schedule), both keyed by step. The momentum
    follows the cosine in the warm-up too, as in the JAX package. With no
    warm-up (warmup_epochs = 0) every step takes the cyclic branch (the JAX
    version computes the warm-up branch as inf / nan there and discards
    it)."""

    def cos_progress(step):
        epoch = np.floor(f32(step) / f32(iters_per_epoch))
        cycle_epoch = np.mod(epoch - f32(warmup_epochs), f32(cycle_epochs))
        return epoch, np.cos(f32(math.pi) * cycle_epoch / f32(cycle_epochs))

    def lr_schedule(step: int) -> float:
        epoch, cosp = cos_progress(step)
        if epoch < warmup_epochs:
            return float(f32(min_lr) + f32(max_lr - min_lr) * (
                f32(step) / f32(warmup_epochs * iters_per_epoch)))
        return float(f32(min_lr) + f32(0.5 * (max_lr - min_lr))
                     * (f32(1.0) + cosp))

    def momentum_schedule(step: int) -> float:
        _, cosp = cos_progress(step)
        return float(f32(max_momentum) - f32(0.5 * (max_momentum
                                                    - min_momentum))
                     * (f32(1.0) + cosp))

    return lr_schedule, momentum_schedule


def step_lr(start_lr: float, step_size: int, gamma: float) -> Schedule:
    """start_lr * gamma ** floor(epoch / step_size), keyed by epoch."""

    def schedule(epoch) -> float:
        k = np.floor(f32(epoch) / f32(step_size))
        return float(f32(start_lr) * f32(gamma) ** k)

    return schedule


def _by_epoch(inner: Schedule, iters_per_epoch: int) -> Schedule:
    """An epoch-keyed schedule keyed by step: the epoch is the float32 floor
    division of the step, as in the JAX package."""

    def schedule(step: int) -> float:
        return inner(f32(step) // f32(iters_per_epoch))

    return schedule


def build_schedule(name: str, cfg) -> Schedule:
    """A schedule by its `TrainConfig.lr_policy` name, from a TrainConfig.
    For CyclicLR the lr half (optim pairs it with its momentum half)."""
    if name == "WarmUpPolyLR":
        return warmup_poly_lr(cfg.lr, cfg.lr_power, cfg.total_iters,
                              cfg.warmup_iters)
    if name == "PolyLR":
        return poly_lr(cfg.lr, cfg.lr_power, cfg.total_iters)
    if name == "MultiStageLR":
        if not cfg.lr_stages:
            raise ValueError("lr_policy=MultiStageLR needs cfg.train.lr_stages "
                             "[(boundary_epoch, lr), ...]")
        return _by_epoch(multi_stage_lr(cfg.lr_stages), cfg.niters_per_epoch)
    if name == "LinearIncreaseLR":
        # The original keys it by epoch and divides the delta by its
        # `warm_iters`, which its callers pass nepochs (the JAX intent).
        return _by_epoch(linear_increase_lr(cfg.lr, cfg.end_lr, cfg.nepochs),
                         cfg.niters_per_epoch)
    if name == "CyclicLR":
        return cyclic_schedules(cfg)[0]
    if name == "StepLR":
        return _by_epoch(step_lr(cfg.lr, cfg.lr_step_size, cfg.lr_gamma),
                         cfg.niters_per_epoch)
    raise KeyError(f"unknown schedule {name!r}")


def cyclic_schedules(cfg) -> Tuple[Schedule, Schedule]:
    """CyclicLR's (lr, momentum) schedules from a TrainConfig (max lr =
    cfg.lr)."""
    return cyclic_lr(cfg.min_lr, cfg.lr, cfg.cycle_epochs, cfg.warm_up_epoch,
                     cfg.niters_per_epoch)
