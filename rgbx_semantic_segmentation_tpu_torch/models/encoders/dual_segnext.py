"""Dual-branch SegNeXt encoder (MSCA conv attention).

Counterpart of rgbx_semantic_segmentation_tpu/models/encoders/dual_segnext.py:
on each tower a 4x4/4 conv stem + BN, four stages of MSCA blocks with
LayerScale, a BN on each stage's output, then IFRM rectification and IFFM
fusion (`reduction=1, num_heads=8`, hardwired: the config's FRM/FFM are
ignored), and 3x3/2 conv downsampling of the tower's own (unrectified) map
between stages. The towers are independent (the JAX package's fix of the
original's weight-tying). Attribute paths are the JAX names with `.` for
`_` (`stages.0.1.attn.conv17.0`, `extra_norm.3`, `FFMs.0`), so state dicts
convert with the generic key transform and a single-tower checkpoint
loads through convert.load_dualpath_pretrained (family "segnext").

BatchNorm momentum 3e-4 (torch's convention), eps 1e-5; LayerScale 1e-2 at
the start; drop path 0 (the JAX builder passes no rate). The IFFMs take the
model's kernel switch (`use_pallas`), as the MiT ones do; the JAX module
passes none, so its cross-attention always runs `_sdpa`. Their heads are
narrow (d = dim / 8: 8, 16, 40 and 64 for segnext_b), which
ops/attention.multi_head_attention sends to the flash kernels (padding d to
a multiple of 8 for segnext_tiny and segnext_large).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.models import fusion
from rgbx_semantic_segmentation_tpu_torch.ops.layers import DropPath

# SyncBN momentum of the original (torch convention).
BN_MOMENTUM = 3e-4


def _dw(dim: int, kh: int, kw: int) -> nn.Conv2d:
    """A depthwise conv with padding (kh // 2, kw // 2): non-square kernels
    pad their long side only."""
    return nn.Conv2d(dim, dim, (kh, kw), padding=(kh // 2, kw // 2),
                     groups=dim)


class MSCA(nn.Module):
    """Multi-scale conv attention: a 5x5 depthwise conv and three strip
    pairs (1x7 then 7x1, 1x11 then 11x1, 1x21 then 21x1), each on the
    input, summed, mixed by a 1x1 conv, and multiplied with the input."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv55 = _dw(dim, 5, 5)
        self.conv17 = nn.Sequential(_dw(dim, 1, 7), _dw(dim, 7, 1))
        self.conv111 = nn.Sequential(_dw(dim, 1, 11), _dw(dim, 11, 1))
        self.conv211 = nn.Sequential(_dw(dim, 1, 21), _dw(dim, 21, 1))
        self.conv11 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        mixed = (self.conv55(x) + self.conv17(x) + self.conv111(x)
                 + self.conv211(x))
        return self.conv11(mixed) * x


class SegNextBlock(nn.Module):
    """x += DropPath(ls1 * MSCA(BN(x))); x += DropPath(ls2 * FFN(BN(x))),
    the FFN 1x1 -> 3x3 depthwise -> erf GELU -> 1x1. `ls_init` is the
    LayerScales' start (ops/layers.init_weights sets it)."""

    def __init__(self, dim: int, ffn_ratio: float = 4.0,
                 ls_init: float = 1e-2, drop_path: float = 0.0,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        hid = int(dim * ffn_ratio)
        self.ls_init = ls_init
        self.norm1 = nn.BatchNorm2d(dim, momentum=bn_momentum)
        self.attn = MSCA(dim)
        self.ls1_layer_scale = nn.Parameter(torch.full((dim,), ls_init))
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.BatchNorm2d(dim, momentum=bn_momentum)
        self.ffn_fc1 = nn.Conv2d(dim, hid, 1)
        self.ffn_dwconv = nn.Conv2d(hid, hid, 3, padding=1, groups=hid)
        self.ffn_fc2 = nn.Conv2d(hid, dim, 1)
        self.ls2_layer_scale = nn.Parameter(torch.full((dim,), ls_init))

    def forward(self, x):
        y = self.attn(self.norm1(x))
        x = x + self.drop_path(y * self.ls1_layer_scale.view(-1, 1, 1)
                               .to(y.dtype))
        y = self.ffn_dwconv(self.ffn_fc1(self.norm2(x)))
        y = self.ffn_fc2(F.gelu(y))
        return x + self.drop_path(y * self.ls2_layer_scale.view(-1, 1, 1)
                                  .to(y.dtype))


class SegNextEncoder(nn.Module):
    """Dual-tower SegNeXt with IFRM/IFFM fusion. Takes NCHW rgb and modal
    maps; returns the 4 fused NCHW maps [1/4, 1/8, 1/16, 1/32]."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.0, ls_init: float = 1e-2,
                 bn_momentum: float = BN_MOMENTUM, bn_eps: float = 1e-5,
                 use_pallas: bool = False):
        super().__init__()
        self.channels = tuple(dims)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        starts = np.cumsum((0,) + tuple(depths))
        for pre in ("", "extra_"):
            setattr(self, f"{pre}stem", nn.Sequential(
                nn.Conv2d(3, dims[0], 4, stride=4),
                nn.BatchNorm2d(dims[0], momentum=bn_momentum)))
            setattr(self, f"{pre}stages", nn.ModuleList([
                nn.ModuleList([
                    SegNextBlock(dims[i], ls_init=ls_init,
                                 drop_path=dpr[starts[i] + j],
                                 bn_momentum=bn_momentum)
                    for j in range(depths[i])])
                for i in range(4)]))
            setattr(self, f"{pre}norm", nn.ModuleList([
                nn.BatchNorm2d(d, momentum=bn_momentum) for d in dims]))
            setattr(self, f"{pre}downsample", nn.ModuleList([
                nn.Conv2d(dims[i], dims[i + 1], 3, stride=2, padding=1)
                for i in range(3)]))
        self.FRMs = nn.ModuleList([
            fusion.ImprovedFeatureRectifyModule(dim=d, reduction=1)
            for d in dims])
        self.FFMs = nn.ModuleList([
            fusion.ImprovedFeatureFusionModule(
                dim=d, reduction=1, num_heads=8, bn_momentum=bn_momentum,
                bn_eps=bn_eps, use_pallas=use_pallas)
            for d in dims])

    def forward(self, x_rgb, x_e) -> List[torch.Tensor]:
        x_rgb, x_e = self.stem(x_rgb), self.extra_stem(x_e)
        outs = []
        for i in range(4):
            for blk, eblk in zip(self.stages[i], self.extra_stages[i]):
                x_rgb, x_e = blk(x_rgb), eblk(x_e)
            n, n_e = self.FRMs[i](self.norm[i](x_rgb),
                                  self.extra_norm[i](x_e))
            outs.append(self.FFMs[i](n, n_e))
            if i < 3:
                x_rgb = self.downsample[i](x_rgb)
                x_e = self.extra_downsample[i](x_e)
        return outs


def segnext_tiny(**kw):
    return SegNextEncoder(depths=(3, 3, 9, 3), dims=(32, 64, 160, 256), **kw)


def segnext_small(**kw):
    return SegNextEncoder(depths=(3, 3, 27, 3), dims=(64, 128, 320, 512),
                          **kw)


def segnext_base(**kw):
    return SegNextEncoder(depths=(3, 3, 27, 3), dims=(64, 128, 320, 512),
                          **kw)


def segnext_large(**kw):
    return SegNextEncoder(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768),
                          **kw)

