"""DeepLabV3+ decode head (counterpart of
rgbx_semantic_segmentation_tpu/models/decoders/deeplabv3plus.py).

ASPP (rates 12, 24, 36, image pooling, 256 channels, Dropout 0.5) on c4, a
48-channel 3x3 low-level branch on c1, the ASPP output resized to c1's size
with align_corners=True (unlike every other head), concat -> 3x3 conv, BN,
ReLU, Dropout(0.1) -> 1x1 classifier (`block.0` ... `block.4`). Every BN
takes the config's eps, the ASPP's too; the ASPP convs are bias-free, the
others have biases, as in the JAX module.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.models.encoders.aspp import ASPP
from rgbx_semantic_segmentation_tpu_torch.ops.layers import (
    Dropout, conv_bn_relu)
from rgbx_semantic_segmentation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners)

RATES = (12, 24, 36)


class DeepLabV3Plus(nn.Module):
    in_stages = (0, 3)   # the encoder stages forward reads (c1, c4)

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        kw = {"bn_momentum": bn_momentum, "bn_eps": bn_eps}
        self.low_level = conv_bn_relu(in_channels[0], 48, 3, **kw)
        self.aspp = ASPP(in_channels[-1], 256, RATES, **kw)
        self.block = nn.Sequential(*conv_bn_relu(256 + 48, 256, 3, **kw),
                                   Dropout(0.1),
                                   nn.Conv2d(256, num_classes, 1))

    def forward(self, inputs: Sequence[torch.Tensor]):
        low = self.low_level(inputs[0])
        y = resize_bilinear_align_corners(self.aspp(inputs[-1]),
                                          low.shape[2:])
        return self.block(torch.cat([y, low], dim=1))
