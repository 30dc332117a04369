"""Training runtime: loss function, train step, trainer
(counterpart of rgbx_semantic_segmentation_tpu/train.py).

One step = forward under bf16 autocast (fp32 params, no GradScaler: bf16
needs no loss scaling), the config's criterion (plus 0.4 x the aux head's,
for the decoders that carry one; Mask2Former's own loss on its query
dict), backward (the SR attentions through the hand-written backward
kernel on the card), the optimizer's update at the scheduled lr (and
momentum: SGD under CyclicLR). A trainable parameter that the loss does
not reach (a stage no head reads; a downsample that only feeds a frozen
Swin stage) gets a zero gradient, as in the JAX package, so that weight
decay and the moments still act on it. LBFGS (lbfgs.py) runs its line
search through a closure that evaluates the loss and its gradient again on
the same batch, with the same masks (the generator reseeded for each
evaluation), leaving the BatchNorm running statistics as the step's first
evaluation left them (the JAX step keeps only that evaluation's).
uint8 batches are normalised on the device; fp32 batches are taken as
host-normalised. The drop-path / dropout masks of step `s` come from a
generator seeded from (seed, s, rank), so a resumed run draws the same masks.

Data parallelism (`world`, parallel/dist.py): one process per device, the
model in DistributedDataParallel, with the JAX data mesh's semantics, where
one jitted step shards the global batch (JAX train.py:209-245): a step on N
ranks computes what one process computes on the global batch. So the
loss is that of the GLOBAL batch (each rank divides its sums by the
all-reduced counts, losses.py, and a comm hook SUMS the gradient buckets
where DDP's default averages per-rank means, which differ once the ranks
hold different counts of ignored pixels); the BatchNorms are
parallel/sync_bn's (global statistics); every rank builds the same weights
from the seed and runs the same update on the same gradients. Masks
differ per data rank: the data rank folds into the mask generator's seed,
and the window attention offsets its kernels' seed by the rank.

On a '2d:D,S' world (world.spatial, parallel/spatial.py) the S ranks of a
data rank hold the same images and each takes its row block of them,
sliced after the copy to the device; the model runs on those rows
(EncoderDecoder.set_spatial) and the loss is that of the rows, so the same
global-count loss and summing all-reduce give the global batch's mean and
gradient. The spatial ranks of an image draw its masks from one seed (the
data rank's), so drop-path and Dropout2d drop the same samples and
channels on all of them.

On a 'tp:D,M' world (world.model, parallel/tensor.py) the M ranks of a
data rank hold the same images whole, and each Mix-FFN / Swin MLP holds its
slice of the hidden width (EncoderDecoder.set_tensor_parallel, before the
optimizer takes the parameters). Every sum over the batch then goes over
the data group (World.batch_group): the losses' counts and order
statistics, the synced BatchNorms, the step's loss and DDP's buckets; the
gradients of the whole parameters are already equal on the model ranks
(the split layers' copy_to_model sums their input's gradient), so no sum
over the model group follows; model rank 0's gradients of the whole
parameters and its loss are handed to the others (tensor.agree: on the
card the ranks' atomics differ in the last bits). The model ranks draw the
data rank's masks (and the window kernels take its seed), so they keep
equal weights.
LBFGS takes its dot products over the model group too (lbfgs.py).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from rgbx_semantic_segmentation_tpu_torch import losses as losses_lib
from rgbx_semantic_segmentation_tpu_torch import optim
from rgbx_semantic_segmentation_tpu_torch.lbfgs import LBFGS
from rgbx_semantic_segmentation_tpu_torch.config import Config
from rgbx_semantic_segmentation_tpu_torch.device import resolve_device
from rgbx_semantic_segmentation_tpu_torch.models.builder import (
    AUX_RATE, build_model)
from rgbx_semantic_segmentation_tpu_torch.ops.layers import set_generator
from rgbx_semantic_segmentation_tpu_torch.parallel.dist import World
from rgbx_semantic_segmentation_tpu_torch.parallel.spatial import own_rows
from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
    convert_sync_batchnorm, set_group)
from rgbx_semantic_segmentation_tpu_torch.parallel import tensor

def make_loss_fn(cfg: Config, world: Optional[World] = None) -> Callable:
    """The criterion on the model's output: on an (logits, aux) pair
    criterion(logits) + AUX_RATE * criterion(aux), on the mask2former dict
    losses.mask2former_loss (no criterion: the head brings its own loss),
    as the JAX make_loss_fn.

    Each loss divides this rank's sum by the count summed over the
    `world`'s ranks (no gradient flows through it; see losses.py): the
    ranks' losses then add up to the loss of the global batch. Without a
    world, one process's: the loss of its batch."""
    world = world or World.solo()

    def global_sum(t: torch.Tensor) -> torch.Tensor:
        return world.batch_sum(t.detach().clone())

    criterion = (None if cfg.model.decoder == "mask2former" else
                 losses_lib.build_criterion(cfg, world.batch_ranks,
                                            global_sum, world.batch_group))

    def loss_fn(outputs, labels):
        if isinstance(outputs, dict):
            return losses_lib.mask2former_loss(
                outputs["pred_logits"], outputs["pred_masks"], labels,
                cfg.dataset.num_classes, cfg.dataset.background,
                denom_reduce=global_sum)
        if isinstance(outputs, tuple):
            logits, aux = outputs
            return criterion(logits, labels) + AUX_RATE * criterion(aux, labels)
        return criterion(outputs, labels)

    return loss_fn


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """Generator seed of one step's drop-path / dropout masks on data rank
    `rank`: a fixed mixing of (seed, step, rank), so step s of any run with
    this seed, resumed or not, draws the same masks, and data ranks draw
    different ones (rank 0 draws what a single process draws)."""
    return (seed * 1000003 + step * 7919 + rank * 2147483647
            + 12345) % (2 ** 63)


def _sum_hook(group, bucket):
    """DDP comm hook: SUM a gradient bucket over the ranks of `group` (the
    hook's state; DDP's default divides by the world size). With the
    global-count loss of make_loss_fn the sum is the gradient of the
    global mean."""
    fut = dist.all_reduce(bucket.buffer(), group=group,
                          async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    seed: Optional[int] = None,
                    world: Optional[World] = None) -> Callable:
    """Build `train_step(step, batch) -> loss` (a 0-d tensor on the device;
    no host sync). `seed` overrides cfg.train.seed for the mask stream.
    In a `world` with a process group the step runs `model` (its BatchNorms
    converted) in DistributedDataParallel over the world's batch group,
    on a spatial world on the rank's rows (`model.set_spatial`); the step
    returns the global batch's loss. On a 'tp' world `model` is split
    already (Trainer) or runs whole on every model rank."""
    device = next(model.parameters()).device
    world = world or World.solo(device)
    loss_fn = make_loss_fn(cfg, world)
    lr_schedule, momentum_schedule = optim.build_schedules(cfg)
    lbfgs = isinstance(optimizer, LBFGS)
    trainable = [p for g in optimizer.param_groups for p in g["params"]]
    base_seed = cfg.train.seed if seed is None else seed
    generator = torch.Generator(device=device)
    set_generator(model, generator, world.data_rank)
    sp = world.spatial
    if sp is not None:
        model.set_spatial(sp)
    if lbfgs and tensor.split_params(model):
        optimizer.set_tensor_parallel(model)
    net = model
    if world.distributed:
        set_group(model, world.batch_group)
        # Every rank built the same weights from the seed, so the
        # construction's broadcast from rank 0 changes nothing (nor do the
        # buffer broadcasts: the BN running statistics are global).
        net = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            find_unused_parameters=not model.every_param_in_loss,
            process_group=world.batch_group)
        net.register_comm_hook(world.batch_group, _sum_hook)
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
        label = to_device(batch["label"])
        if sp is not None:   # the rank's rows of its data rank's images
            rgb, mx, label = (own_rows(t, sp, 1) for t in (rgb, mx, label))
        if rgb.dtype == torch.uint8:
            rgb = (rgb.float() / 255.0 - mean) / std
            mx = (mx.float() / 255.0 - mean) / std
        return rgb, mx, label.long()

    def evaluate(step, rgb, mx, label) -> torch.Tensor:
        """Loss and gradient at the current parameters, with the masks of
        `step`; returns the global batch's loss."""
        generator.manual_seed(step_seed(base_seed, step, world.data_rank))
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(net(rgb, mx), label)
        loss.backward()
        for p in trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = world.batch_sum(loss.detach().clone())
        if world.model is not None:
            tensor.agree(model, world.model, [loss])
        return loss

    def train_step(step: int, batch: Dict) -> torch.Tensor:
        rgb, mx, label = prep(batch)
        if lr_schedule is not None:
            optim.set_lr(optimizer, lr_schedule(step),
                         None if momentum_schedule is None
                         else momentum_schedule(step))
        model.train()
        loss = evaluate(step, rgb, mx, label)
        if not lbfgs:
            optimizer.step()
            return loss
        stats = {k: v.clone() for k, v in model.named_buffers()
                 if k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))}
        optimizer.step(lambda: evaluate(step, rgb, mx, label), loss)
        for k, v in model.named_buffers():
            if k in stats:
                v.copy_(stats[k])
        return loss

    return train_step


class Trainer:
    """The JAX Trainer: model, optimizer, schedule and step counter on
    `device` (None: the card; see device.resolve_device), or, with a
    `world`, one rank of a data-parallel run on the world's device (the JAX
    Trainer on a 1-D data mesh; see the module docstring; the synced
    BatchNorms and DDP only where a process group joins the ranks; on a
    'tp' world the model split over the model ranks). `model` is the bare
    module (no DDP wrapper): its state dict is the checkpoint's, gathered
    whole on a 'tp' world (parallel/tensor.full_state_dict)."""

    def __init__(self, cfg: Config, device=None, seed: Optional[int] = None,
                 init_values: bool = True, world: Optional[World] = None):
        """`seed` (default cfg.train.seed) seeds both the weight init and
        the mask stream. init_values=False leaves the weights unset, for a
        state dict to be loaded."""
        self.cfg = cfg
        if world is None:
            world = World.solo(resolve_device(device))
        elif device is not None and torch.device(device) != world.device:
            raise ValueError(f"device {device} is not the rank's "
                             f"{world.device}")
        self.world = world
        self.device = world.device
        seed = cfg.train.seed if seed is None else seed
        self.model = build_model(cfg, device=self.device,
                                 seed=seed if init_values else None)
        if world.model is not None:
            self.model.set_tensor_parallel(world.model)
        if world.distributed:
            convert_sync_batchnorm(self.model)
        self.optimizer = optim.build_optimizer(cfg, self.model)
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          seed=seed, world=world)
        self.global_step = 0
        self.epoch = 0

    def step(self, batch) -> Dict[str, torch.Tensor]:
        loss = self.train_step(self.global_step, batch)
        self.global_step += 1
        return {"loss": loss}

    def fit_epoch(self, data_iter, niters: int, log_every: int = 50,
                  logger=None, should_stop: Optional[Callable[[], bool]] = None
                  ) -> float:
        """One epoch; returns the mean loss (of the global batches). Losses
        stay on the device until a log point or the end of the epoch: a host
        sync every step would serialise dispatch against the device.
        `should_stop` is polled each iteration and breaks out early; in a
        world the ranks agree on it (a stop on one rank stops all at the
        same step), so every rank must pass one or none."""
        t0 = time.time()
        losses = []
        for it in range(niters):
            if (should_stop is not None
                    and self.world.host_max(should_stop()) > 0):
                break
            metrics = self.step(next(data_iter))
            losses.append(metrics["loss"])
            if (it + 1) % log_every == 0 and logger is not None:
                lr = optim.applied_lr(self.optimizer)
                logger.info(
                    "epoch %d it %d/%d loss %.4f lr %s (%.2f img/s)",
                    self.epoch, it + 1, niters, float(metrics["loss"]),
                    "line search" if lr is None else f"{lr:.3e}",
                    (it + 1) * self.cfg.train.batch_size / (time.time() - t0))
        self.epoch += 1
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())
