"""Dual-branch ResNet encoder.

Counterpart of rgbx_semantic_segmentation_tpu/models/encoders/dual_resnet.py:
two torchvision ResNet trunks (Bottleneck blocks, no fc) over the rgb and the
extra modality, with an FRM and an FFM after each of layer1-4; dims
(256, 512, 1024, 2048), FFM heads (4, 8, 16, 32). The trunks carry
torchvision's attribute paths (`conv1`, `bn1`, `layer{1-4}.{i}.conv{1-3}` /
`bn{1-3}`, `downsample.{0,1}`) under `backbone` and `backbone_d`, so an
ImageNet torchvision checkpoint loads through convert.load_dualpath_pretrained
(family "resnet") and the JAX names (`layer1_0`, `downsample_0`) convert with
the generic key transform. BatchNorm momentum 0.1 (torch's convention),
eps 1e-5; no drop path. The FRM/FFM are the config's; an IFFM takes the
model's kernel switch (`use_pallas`), as the MiT IFFMs do (the JAX module
passes none: its IFFM attention always runs the plain `_sdpa`).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.models import fusion

# torchvision's bottleneck widths (the stem's is the first; the stages'
# output dims are 4 x these) and the FFM heads of each stage.
PLANES = (64, 128, 256, 512)
HEADS = (4, 8, 16, 32)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (x4 channels),
    each with its BatchNorm, plus the identity or a strided 1x1 conv + BN
    (`downsample`) on the residual."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, bn_momentum: float = 0.1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, momentum=bn_momentum)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes, momentum=bn_momentum)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, momentum=bn_momentum)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
            nn.BatchNorm2d(out, momentum=bn_momentum))
            if has_downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNetTower(nn.Module):
    """One ResNet trunk: 7x7/2 conv + BN + ReLU, 3x3/2 max pool (padding 1,
    -inf, as flax pads), then layer1-4; returns the four layers' maps."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 bn_momentum: float = 0.1):
        super().__init__()
        self.conv1 = nn.Conv2d(3, PLANES[0], 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(PLANES[0], momentum=bn_momentum)
        inplanes = PLANES[0]
        for li, (width, depth) in enumerate(zip(PLANES, layers), start=1):
            blocks = []
            for bi in range(depth):
                stride = 2 if li > 1 and bi == 0 else 1
                blocks.append(Bottleneck(inplanes, width, stride,
                                         has_downsample=bi == 0,
                                         bn_momentum=bn_momentum))
                inplanes = width * Bottleneck.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats


class DualResNet(nn.Module):
    """Two ResNet towers with an FRM and an FFM per stage. Takes NCHW rgb
    and modal maps; returns the 4 fused NCHW maps [1/4, 1/8, 1/16, 1/32],
    of `channels` (4 x PLANES) channels."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 frm: str = "FRM", ffm: str = "FFM",
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 use_pallas: bool = False):
        super().__init__()
        self.channels = tuple(p * Bottleneck.expansion for p in PLANES)
        self.backbone = ResNetTower(layers, bn_momentum)
        self.backbone_d = ResNetTower(layers, bn_momentum)
        frm_cls, ffm_cls = fusion.get_frm(frm), fusion.get_ffm(ffm)
        ffm_kw = {"use_pallas": use_pallas} if ffm == "IFFM" else {}
        for i, (dim, heads) in enumerate(zip(self.channels, HEADS), start=1):
            setattr(self, f"frm{i}", frm_cls(dim=dim, reduction=1))
            setattr(self, f"ffm{i}", ffm_cls(
                dim=dim, reduction=1, num_heads=heads,
                bn_momentum=bn_momentum, bn_eps=bn_eps, **ffm_kw))

    def forward(self, x_rgb, x_d) -> List[torch.Tensor]:
        outs = []
        for i, (r, d) in enumerate(zip(self.backbone(x_rgb),
                                       self.backbone_d(x_d)), start=1):
            r, d = getattr(self, f"frm{i}")(r, d)
            outs.append(getattr(self, f"ffm{i}")(r, d))
        return outs


def dual_resnet50(**kw):
    return DualResNet(layers=(3, 4, 6, 3), **kw)


def dual_resnet101(**kw):
    return DualResNet(layers=(3, 4, 23, 3), **kw)


def dual_resnet152(**kw):
    return DualResNet(layers=(3, 8, 36, 3), **kw)
