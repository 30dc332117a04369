"""Encoder-side ASPP / eASPP (counterpart of rgbx_semantic_segmentation_tpu/
models/encoders/aspp.py), and the ASPP that the DeepLabV3+ head also runs.

  - `ASPP`: a 1x1 branch, three dilated 3x3 branches, an image-pooling
    branch, concat, 1x1 projection, Dropout(0.5). With out == in channels
    it is the per-stage ASPP of `mit_*_w_aspp` (rates STAGE_ASPP_RATES);
    DeepLabV3+ runs it at rates (12, 24, 36) into 256 channels.
  - `EASPP`: eASPP after stage 4 of `mit_*_w_ef_aspp`, three cascaded
    bottleneck branches (64 channels) beside a 1x1 and an image-pooling
    branch, each of 256 channels, projected back to the stage's width.

Every conv is bias-free, as in the JAX modules. The encoder's ASPPs run their
BatchNorms at eps 1e-5 (the JAX modules do not pass the config's eps);
DeepLabV3+ hands its ASPP the config's. Attribute paths are the original
repo's: `b0.0`, `b1.block.0`, `b4.gap.1`, `project.0`, `branch1.0.0`,
`branch1.1.block.0`, `img_pooling.gap.1`, ...
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.ops.layers import (
    Dropout, conv_bn_relu)

STAGE_ASPP_RATES = ((3, 6, 9), (6, 12, 18), (12, 24, 36), (12, 24, 36))
DROPOUT = 0.5


class ASPPConv(nn.Module):
    """Dilated 3x3 conv + BN + ReLU branch (`block.0`, `block.1`)."""

    def __init__(self, in_ch: int, out_ch: int, rate: int,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        self.block = conv_bn_relu(in_ch, out_ch, 3, bias=False, dilation=rate,
                                  bn_momentum=bn_momentum, bn_eps=bn_eps)

    def forward(self, x):
        return self.block(x)


class GapBranch(nn.Module):
    """Image pooling + 1x1 conv + BN + ReLU (`gap.1`, `gap.2`), broadcast
    back to the input's size (an align_corners upsample of a 1x1 map)."""

    def __init__(self, in_ch: int, out_ch: int, bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.gap = nn.Sequential(nn.AdaptiveAvgPool2d(1), *conv_bn_relu(
            in_ch, out_ch, 1, bias=False, bn_momentum=bn_momentum,
            bn_eps=bn_eps))

    def forward(self, x):
        return self.gap(x).expand(-1, -1, *x.shape[2:])


def _project(in_ch: int, out_ch: int, bn_momentum: float,
             bn_eps: float) -> nn.Sequential:
    return nn.Sequential(*conv_bn_relu(in_ch, out_ch, 1, bias=False,
                                       bn_momentum=bn_momentum, bn_eps=bn_eps),
                         Dropout(DROPOUT))


class ASPP(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, rates: Sequence[int],
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        kw = {"bn_momentum": bn_momentum, "bn_eps": bn_eps}
        self.b0 = conv_bn_relu(in_ch, out_ch, 1, bias=False, **kw)
        self.b1, self.b2, self.b3 = (ASPPConv(in_ch, out_ch, r, **kw)
                                     for r in rates)
        self.b4 = GapBranch(in_ch, out_ch, **kw)
        self.project = _project(5 * out_ch, out_ch, **kw)

    def forward(self, x):
        return self.project(torch.cat(
            [b(x) for b in (self.b0, self.b1, self.b2, self.b3, self.b4)],
            dim=1))


class EASPP(nn.Module):
    def __init__(self, in_ch: int, rates: Sequence[int] = (12, 24, 36),
                 reduce_dim: int = 64, middle_dim: int = 256,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        kw = {"bn_momentum": bn_momentum, "bn_eps": bn_eps}
        self.input_conv = conv_bn_relu(in_ch, middle_dim, 1, bias=False, **kw)
        for i, rate in enumerate(rates, start=1):
            setattr(self, f"branch{i}", nn.Sequential(
                conv_bn_relu(in_ch, reduce_dim, 1, bias=False, **kw),
                *(ASPPConv(reduce_dim, reduce_dim, rate, **kw)
                  for _ in range(3)),
                conv_bn_relu(reduce_dim, middle_dim, 1, bias=False, **kw)))
        self.img_pooling = GapBranch(in_ch, middle_dim, **kw)
        self.project = _project(5 * middle_dim, in_ch, **kw)

    def forward(self, x):
        return self.project(torch.cat(
            [self.input_conv(x), self.branch1(x), self.branch2(x),
             self.branch3(x), self.img_pooling(x)], dim=1))
