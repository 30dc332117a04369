"""Training runtime: loss function, train step, single-device trainer
(counterpart of rgbx_semantic_segmentation_tpu/train.py).

One step = forward under bf16 autocast (fp32 params, no GradScaler: bf16
needs no loss scaling), cross-entropy, backward (the SR attentions through
the hand-written backward kernel on the card), AdamW at the scheduled lr.
uint8 batches are normalised on the device; fp32 batches are taken as
host-normalised. The drop-path / dropout masks of step `s` come from a
generator seeded from (seed, s), so a resumed run draws the same masks.
No mesh here: one device (data parallelism is ROADMAP M9).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from rgbx_semantic_segmentation_tpu_torch import losses as losses_lib
from rgbx_semantic_segmentation_tpu_torch import lr_schedules, optim
from rgbx_semantic_segmentation_tpu_torch.config import Config
from rgbx_semantic_segmentation_tpu_torch.device import resolve_device
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.ops.layers import set_generator


def make_loss_fn(cfg: Config) -> Callable:
    """The criterion on the model's output. Plain logits only: the aux-head
    tuple and the mask2former dict of the JAX make_loss_fn come with their
    decoders (ROADMAP M10)."""
    criterion = losses_lib.build_criterion(cfg)

    def loss_fn(outputs, labels):
        if isinstance(outputs, (tuple, dict)):
            raise NotImplementedError(
                "aux-head / mask2former outputs are not ported yet: "
                "ROADMAP M10")
        return criterion(outputs, labels)

    return loss_fn


def step_seed(seed: int, step: int) -> int:
    """Generator seed of one step's drop-path / dropout masks: a fixed
    mixing of (seed, step), so step s of any run with this seed, resumed or
    not, draws the same masks."""
    return (seed * 1000003 + step * 7919 + 12345) % (2 ** 63)


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    seed: Optional[int] = None) -> Callable:
    """Build `train_step(step, batch) -> loss` (a 0-d tensor on the device;
    no host sync). `seed` overrides cfg.train.seed for the mask stream."""
    loss_fn = make_loss_fn(cfg)
    schedule = lr_schedules.build_schedule(cfg.train.lr_policy, cfg.train)
    base_seed = cfg.train.seed if seed is None else seed
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    set_generator(model, generator)
    mean = torch.tensor(cfg.dataset.norm_mean, dtype=torch.float32,
                        device=device)
    std = torch.tensor(cfg.dataset.norm_std, dtype=torch.float32,
                       device=device)

    def to_device(x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device, non_blocking=True)

    def prep(batch):
        """uint8 batches normalise on the device ((x / 255 - mean) / std);
        fp32 batches pass through (host-normalised)."""
        rgb, mx = to_device(batch["rgb"]), to_device(batch["modal_x"])
        if rgb.dtype == torch.uint8:
            rgb = (rgb.float() / 255.0 - mean) / std
            mx = (mx.float() / 255.0 - mean) / std
        return rgb, mx, to_device(batch["label"]).long()

    def train_step(step: int, batch: Dict) -> torch.Tensor:
        rgb, mx, label = prep(batch)
        generator.manual_seed(step_seed(base_seed, step))
        optim.set_lr(optimizer, schedule(step))
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(rgb, mx), label)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


class Trainer:
    """Single-device trainer (the JAX Trainer without its mesh): model,
    AdamW, schedule and step counter on `device` (None: the card; see
    device.resolve_device)."""

    def __init__(self, cfg: Config, device=None, seed: Optional[int] = None,
                 init_values: bool = True):
        """`seed` (default cfg.train.seed) seeds both the weight init and
        the mask stream. init_values=False leaves the weights unset, for a
        state dict to be loaded."""
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = cfg.train.seed if seed is None else seed
        self.model = build_model(cfg, device=self.device,
                                 seed=seed if init_values else None)
        self.optimizer = optim.build_optimizer(cfg, self.model)
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          seed=seed)
        self.global_step = 0
        self.epoch = 0

    def step(self, batch) -> Dict[str, torch.Tensor]:
        loss = self.train_step(self.global_step, batch)
        self.global_step += 1
        return {"loss": loss}

    def fit_epoch(self, data_iter, niters: int, log_every: int = 50,
                  logger=None, should_stop: Optional[Callable[[], bool]] = None
                  ) -> float:
        """One epoch; returns the mean loss. Losses stay on the device until
        a log point or the end of the epoch: a host sync every step would
        serialise dispatch against the device. `should_stop` is polled each
        iteration and breaks out early."""
        t0 = time.time()
        losses = []
        for it in range(niters):
            if should_stop is not None and should_stop():
                break
            metrics = self.step(next(data_iter))
            losses.append(metrics["loss"])
            if (it + 1) % log_every == 0 and logger is not None:
                logger.info(
                    "epoch %d it %d/%d loss %.4f lr %.3e (%.2f img/s)",
                    self.epoch, it + 1, niters, float(metrics["loss"]),
                    optim.applied_lr(self.optimizer),
                    (it + 1) * self.cfg.train.batch_size / (time.time() - t0))
        self.epoch += 1
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())
