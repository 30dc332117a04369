"""FCN head: 3x3 conv + BN + ReLU -> 1x1 classifier (counterpart of
rgbx_semantic_segmentation_tpu/models/decoders/fcnhead.py).

The aux head of UPerNet and DeepLabV3+ (feature index 2, 256 channels) and
the head of the `fcn` / None decoder (index 3, in_channels // 4 channels).
Keys `conv.0`, `conv.1`, `classifier`, the original repo's; the convs have
biases (the JAX `L.conv` default).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.ops.layers import conv_bn_relu


class FCNHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, in_index: int = 2,
                 channels: Optional[int] = None, bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5):
        super().__init__()
        mid = channels or in_channels // 4
        self.in_index = in_index
        self.in_stages = (in_index,)   # the encoder stages forward reads
        self.conv = conv_bn_relu(in_channels, mid, 3, bn_momentum=bn_momentum,
                                 bn_eps=bn_eps)
        self.classifier = nn.Conv2d(mid, num_classes, 1)

    def forward(self, inputs: Sequence[torch.Tensor]):
        return self.classifier(self.conv(inputs[self.in_index]))
