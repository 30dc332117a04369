"""BatchNorm with statistics over the global batch, on the card and on the
CPU (counterpart of the JAX TorchBatchNorm, rgbx_semantic_segmentation_tpu/
ops/layers.py:58-112, under a batch-sharded jit, where XLA makes its
reductions global; the reference gets the same from SyncBatchNorm under
DDP, reference train.py:64-65).

torch.nn.SyncBatchNorm refuses CPU tensors once a process group is up, so
one module serves both backends here. In train mode each rank sums, in
fp32 and per channel, its x and x^2 and counts its elements; one
all-reduce of the three (autograd-aware: the backward all-reduces the
gradients of the sums, so every rank's input gradient sees every rank's
loss) gives mean = E[x], var = E[x^2] - E[x]^2 as JAX computes them; the
input is normalised with that biased var in fp32 and returned in its own
dtype (under bf16 autocast the statistics stay fp32); the running var takes
the unbiased factor n / (n - 1) of the GLOBAL count n (JAX :95-108). In eval
mode the running statistics normalise and no collective runs: ranks run
different numbers of eval forwards.

The state dict is nn.BatchNorm2d's (weight, bias, running_mean, running_var,
num_batches_tracked), so checkpoints and convert.py work both ways.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient is summed over the ranks too."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


class SyncBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode statistics are those of the global
    batch over the default process group (see the module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        C = x.shape[1]
        xf = x.float()
        count = xf.new_full((1,), xf.numel() // C)
        sums = _AllReduceSum.apply(torch.cat(
            [xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]))
        n = sums[2 * C]
        mean = sums[:C] / n
        var = sums[C:2 * C] / n - mean * mean
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(
                m * var * (n / torch.clamp(n - 1.0, min=1.0)))
            self.num_batches_tracked.add_(1)
        shape = (1, C, 1, 1)
        y = ((xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
             * self.weight.view(shape) + self.bias.view(shape))
        return y.to(x.dtype)


def convert_sync_batchnorm(model: nn.Module) -> nn.Module:
    """Swap every nn.BatchNorm2d of `model` for a SyncBatchNorm2d holding
    the same parameters and buffers (the same tensors: call it before an
    optimizer takes the parameters). Returns the model (or the new module
    when `model` itself is a BatchNorm2d)."""
    if type(model) is nn.BatchNorm2d:
        new = SyncBatchNorm2d(model.num_features, model.eps, model.momentum,
                              model.affine, model.track_running_stats)
        new.weight, new.bias = model.weight, model.bias
        new.running_mean = model.running_mean
        new.running_var = model.running_var
        new.num_batches_tracked = model.num_batches_tracked
        new.train(model.training)
        return new
    for name, child in model.named_children():
        model.add_module(name, convert_sync_batchnorm(child))
    return model
