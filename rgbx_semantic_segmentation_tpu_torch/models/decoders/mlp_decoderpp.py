"""MLPDecoder++ decode head (counterpart of rgbx_semantic_segmentation_tpu/
models/decoders/mlp_decoderpp.py): 1x1 conv embeddings, a GELU fuse and an
SE-style global gate.

Per scale a 1x1 conv to embed_dim, upsampled to 1/4; concat([c1, c2, c3,
c4]) (the reverse of MLPDecoder's order) -> `linear_fuse` (1x1 conv, BN,
exact GELU) -> times the gate `attention` (spatial mean, 1x1 conv to
embed_dim / 4, exact GELU, 1x1 conv back, sigmoid; its convs are the
Sequential's indices 1 and 3, as in the original repo) -> channel-wise
dropout -> `linear_pred`. Both GELUs are exact whatever
`ModelConfig.gelu_approximate` says, as in the JAX module.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.ops.layers import Dropout2d
from rgbx_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear


class MLPDecoderpp(nn.Module):
    """Input: 4 NCHW maps [1/4, 1/8, 1/16, 1/32]; output logits at 1/4."""

    in_stages = (0, 1, 2, 3)   # the encoder stages forward reads

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 embed_dim: int = 512, dropout_ratio: float = 0.1,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        c1, c2, c3, c4 = in_channels
        self.linear_c1 = nn.Conv2d(c1, embed_dim, 1)
        self.linear_c2 = nn.Conv2d(c2, embed_dim, 1)
        self.linear_c3 = nn.Conv2d(c3, embed_dim, 1)
        self.linear_c4 = nn.Conv2d(c4, embed_dim, 1)
        self.linear_fuse = nn.Sequential(
            nn.Conv2d(embed_dim * 4, embed_dim, 1),
            nn.BatchNorm2d(embed_dim, eps=bn_eps, momentum=bn_momentum),
            nn.GELU())
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(embed_dim, embed_dim // 4, 1),
            nn.GELU(),
            nn.Conv2d(embed_dim // 4, embed_dim, 1), nn.Sigmoid())
        self.dropout = Dropout2d(dropout_ratio)
        self.linear_pred = nn.Conv2d(embed_dim, num_classes, 1)

    def forward(self, inputs: Sequence[torch.Tensor]):
        c1, c2, c3, c4 = inputs
        size = c1.shape[2:]
        embeds = [self.linear_c1(c1)] + [
            resize_bilinear(conv(c), size) for conv, c in
            ((self.linear_c2, c2), (self.linear_c3, c3), (self.linear_c4, c4))]
        x = self.linear_fuse(torch.cat(embeds, dim=1))
        x = x * self.attention(x)
        return self.linear_pred(self.dropout(x))
