"""All-MLP SegFormer decode head (counterpart of
rgbx_semantic_segmentation_tpu/models/decoders/mlp_decoder.py).

Per-scale Linear to embed_dim, a 1x1 fuse conv over concat([c4, c3, c2, c1])
at 1/4 resolution, BN + ReLU, Dropout2d, 1x1 classifier. The fuse is applied
as the JAX SlicedFuse does: the 1x1 conv distributes over the concat and the
bilinear resize is channelwise-linear, so each scale's slice of the ONE
`linear_fuse.0` weight (E, 4E, 1, 1) is applied at that scale's native
resolution and the E-channel result is upsampled — the same math, without
the 4E-channel full-resolution concat.

On the spatial axis of `--mesh 2d:D,S` (`forward(..., sp)`) the rank
computes its row block of the 1/4-resolution logits: each coarser scale's
fused slice is gathered whole (where its stage was sharded) and only the own
output rows are upsampled from it (ops/resize.resize_bilinear_rows: the
whole resize's taps); BatchNorm (synced over the world), ReLU, Dropout2d
and the classifier act on those rows.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.ops.layers import (
    Dropout2d, map_to_tokens, tokens_to_map)
from rgbx_semantic_segmentation_tpu_torch.ops.resize import (
    resize_bilinear, resize_bilinear_rows)
from rgbx_semantic_segmentation_tpu_torch.parallel import spatial
from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
    set_replicas)


class MLPEmbed(nn.Module):
    """Linear embedding of one scale: NCHW map -> (B, N, E) tokens."""

    def __init__(self, input_dim: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Linear(input_dim, embed_dim)

    def forward(self, x):
        return self.proj(map_to_tokens(x))


def sliced_fuse(conv: nn.Conv2d, embeds: Sequence[torch.Tensor],
                shapes: Sequence[Sequence[int]], size,
                sp: Optional[spatial.SpatialGroup] = None,
                sharded: Sequence[bool] = ()) -> torch.Tensor:
    """1x1 `conv` over the virtual channel concat of `embeds` ((B, N_i, E)
    tokens of maps shaped `shapes[i]`), evaluated per input at its native
    resolution, upsampled to `size` and summed; the bias is added once.
    With `sp` the sum is the rank's row block of the `size` output: an
    input that is the rank's row block (`sharded[i]`) is gathered whole
    before its upsample, unless it is already at the output's size."""
    E = conv.out_channels
    acc = None
    for i, (e, (h, w)) in enumerate(zip(embeds, shapes)):
        wi = conv.weight[:, i * E:(i + 1) * E, 0, 0]           # (E_out, E_in)
        y = tokens_to_map(F.linear(e, wi), h, w)
        if sp is None:
            y = resize_bilinear(y, size)
        elif not (sharded[i] and (h * sp.size, w) == tuple(size)):
            if sharded[i]:
                y = spatial.gather_rows(y, sp, 2)
            y = resize_bilinear_rows(y, size, spatial.row_range(size[0], sp))
        acc = y if acc is None else acc + y
    return acc + conv.bias.to(acc.dtype).view(1, E, 1, 1)


class MLPDecoder(nn.Module):
    """Input: 4 NCHW maps [1/4, 1/8, 1/16, 1/32]; output logits at 1/4."""

    in_stages = (0, 1, 2, 3)   # the encoder stages forward reads

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 embed_dim: int = 768, dropout_ratio: float = 0.1,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        c1, c2, c3, c4 = in_channels
        self.linear_c4 = MLPEmbed(c4, embed_dim)
        self.linear_c3 = MLPEmbed(c3, embed_dim)
        self.linear_c2 = MLPEmbed(c2, embed_dim)
        self.linear_c1 = MLPEmbed(c1, embed_dim)
        self.linear_fuse = nn.Sequential(
            nn.Conv2d(embed_dim * 4, embed_dim, 1),
            nn.BatchNorm2d(embed_dim, eps=bn_eps, momentum=bn_momentum),
            nn.ReLU())
        self.dropout = Dropout2d(dropout_ratio)
        self.linear_pred = nn.Conv2d(embed_dim, num_classes, 1)

    def forward(self, inputs: Sequence[torch.Tensor],
                sp: Optional[spatial.SpatialGroup] = None,
                sharded: Sequence[bool] = (False,) * 4):
        """With `sp`, the spatial group of `--mesh 2d:D,S`, `inputs[i]` is
        the rank's row block of stage i's map where `sharded[i]`, else the
        whole map; the logits are then the rank's row block where c1 is
        sharded, else whole."""
        c1, c2, c3, c4 = inputs
        feats = [c4, c3, c2, c1]  # the original repo's concat order
        embeds = [self.linear_c4(c4), self.linear_c3(c3),
                  self.linear_c2(c2), self.linear_c1(c1)]
        rows = sp if sp is not None and sharded[0] else None
        size = tuple(c1.shape[2:])
        if rows is not None:
            size = (size[0] * sp.size, size[1])
        # a whole c1 on every spatial rank: its BatchNorm counts them once
        set_replicas(self, 1 if sp is None or rows is not None else sp.size)
        x = sliced_fuse(self.linear_fuse[0], embeds,
                        [f.shape[2:] for f in feats], size, rows,
                        sharded[::-1])
        x = self.linear_fuse[2](self.linear_fuse[1](x))
        return self.linear_pred(self.dropout(x))
