"""UPerNet decode head: PPM pyramid + FPN top-down fusion (counterpart of
rgbx_semantic_segmentation_tpu/models/decoders/upernet.py).

PPM pool scales (1, 2, 3, 6) on c4 (adaptive average pool, 1x1 conv, BN,
ReLU, bilinear upsample back), concat with c4 -> 3x3 bottleneck; 1x1
lateral convs on c1..c3 and top-down adds; a 3x3 conv per level; every
level upsampled to 1/4 and concatenated -> 3x3 `fpn_bottleneck` ->
`conv_seg`. Every conv has a bias and every BN the config's eps, as in the
JAX module; like it, no dropout. Paired with an aux FCNHead by the builder.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.ops.layers import conv_bn_relu
from rgbx_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear


class UPerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        kw = {"bn_momentum": bn_momentum, "bn_eps": bn_eps}
        c4 = in_channels[-1]
        self.psp_modules = nn.ModuleList([
            nn.Sequential(nn.AdaptiveAvgPool2d(s),
                          *conv_bn_relu(c4, channels, 1, **kw))
            for s in pool_scales])
        self.bottleneck = conv_bn_relu(c4 + len(pool_scales) * channels,
                                       channels, 3, **kw)
        self.lateral_convs = nn.ModuleList([
            conv_bn_relu(c, channels, 1, **kw) for c in in_channels[:-1]])
        self.fpn_convs = nn.ModuleList([
            conv_bn_relu(channels, channels, 3, **kw)
            for _ in in_channels[:-1]])
        self.fpn_bottleneck = conv_bn_relu(len(in_channels) * channels,
                                           channels, 3, **kw)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, inputs: Sequence[torch.Tensor]):
        c4 = inputs[-1]
        size4 = c4.shape[2:]
        psp = [c4] + [resize_bilinear(m(c4), size4) for m in self.psp_modules]
        laterals = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        laterals.append(self.bottleneck(torch.cat(psp, dim=1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [m(x) for m, x in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])
        size0 = outs[0].shape[2:]
        outs = [outs[0]] + [resize_bilinear(o, size0) for o in outs[1:]]
        return self.conv_seg(self.fpn_bottleneck(torch.cat(outs, dim=1)))
