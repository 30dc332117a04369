"""Shared layer primitives: initializers, DropPath, token/map reshapes.

Counterpart of rgbx_semantic_segmentation_tpu/ops/layers.py. The layers
themselves are torch's own: nn.Linear, nn.Conv2d with torch's symmetric
padding (k // 2 both sides, the convention the JAX package re-creates with
explicit padding), nn.LayerNorm with its eps passed explicitly, and
nn.BatchNorm2d, whose eval mode normalises with the running statistics
(the JAX TorchBatchNorm exists to re-create exactly torch's semantics).

Initialization follows the JAX package (which follows the original repo's
`_init_weights`): Linear = truncated normal (std 0.02) with zero bias;
Conv2d = normal(0, sqrt(2 / fan_out)), fan_out = kh * kw * out / groups,
with zero bias; norms = ones / zeros. `init_weights` applies it to a whole
model from an explicit torch.Generator.
"""
from __future__ import annotations

import math

import torch
from torch import nn

# Std of a standard normal truncated to [-2, 2]. jax's truncated_normal
# initializer divides by it so the samples have the requested std, and cuts
# them at +-2 of its own scale.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    s = std / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s,
                                 generator=generator)


@torch.no_grad()
def conv_kaiming_normal_(w: torch.Tensor, groups: int,
                         generator: torch.Generator) -> torch.Tensor:
    """torch-style fan-out kaiming normal for an OIHW conv weight."""
    out_ch, _, kh, kw = w.shape
    std = math.sqrt(2.0 / (kh * kw * out_ch / groups))
    return w.normal_(0.0, std, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every Linear, Conv2d, LayerNorm and BatchNorm2d of `model`
    in place (see module docstring); BatchNorm running stats are reset."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, 0.02, generator)
        elif isinstance(m, nn.Conv2d):
            conv_kaiming_normal_(m.weight, m.groups, generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
    return model


class DropPath(nn.Module):
    """Stochastic depth: the identity at eval (and at rate 0). Dropping
    residual branches in training comes with the train step."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError(
                "drop path in training: ROADMAP M5 (train step)")
        return x


def tokens_to_map(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, N, C) tokens -> (B, C, H, W) map (row-major token order)."""
    B, N, C = x.shape
    return x.transpose(1, 2).reshape(B, C, H, W)


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) map -> (B, H*W, C) tokens."""
    return x.flatten(2).transpose(1, 2)
