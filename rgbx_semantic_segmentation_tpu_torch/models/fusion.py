"""Cross-modal fusion: FRM / FFM (counterpart of
rgbx_semantic_segmentation_tpu/models/fusion.py, FRM/FFM path only).

Maps are NCHW, tokens (B, N, C). Submodule paths are the original repo's
(`channel_weights.mlp.0`, `channel_emb.channel_embed.4`, ...).
"""
from __future__ import annotations

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.ops.layers import (
    map_to_tokens, tokens_to_map)


class ChannelWeights(nn.Module):
    """Global avg+max pooled MLP channel gates. Returns (w0, w1), each
    (B, C, 1, 1); w0 is the first half of the MLP output."""

    def __init__(self, dim: int, reduction: int = 1):
        super().__init__()
        self.dim = dim
        self.mlp = nn.Sequential(
            nn.Linear(dim * 4, dim * 4 // reduction), nn.ReLU(),
            nn.Linear(dim * 4 // reduction, dim * 2), nn.Sigmoid())

    def forward(self, x1, x2):
        B = x1.shape[0]
        x = torch.cat([x1, x2], dim=1)                       # (B, 2C, H, W)
        y = torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)
        y = self.mlp(y)                                      # (B, 2C)
        C = self.dim
        return y[:, :C].reshape(B, C, 1, 1), y[:, C:].reshape(B, C, 1, 1)


class SpatialWeights(nn.Module):
    """1x1-conv MLP spatial gates. Returns (w0, w1), each (B, 1, H, W)."""

    def __init__(self, dim: int, reduction: int = 1):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Conv2d(dim * 2, dim // reduction, 1), nn.ReLU(),
            nn.Conv2d(dim // reduction, 2, 1), nn.Sigmoid())

    def forward(self, x1, x2):
        y = self.mlp(torch.cat([x1, x2], dim=1))
        return y[:, 0:1], y[:, 1:2]


class FeatureRectifyModule(nn.Module):
    """FRM: cross-modal rectification with fixed lambdas 0.5."""

    def __init__(self, dim: int, reduction: int = 1, lambda_c: float = 0.5,
                 lambda_s: float = 0.5):
        super().__init__()
        self.lambda_c = lambda_c
        self.lambda_s = lambda_s
        self.channel_weights = ChannelWeights(dim, reduction)
        self.spatial_weights = SpatialWeights(dim, reduction)

    def forward(self, x1, x2):
        cw0, cw1 = self.channel_weights(x1, x2)
        sw0, sw1 = self.spatial_weights(x1, x2)
        out_x1 = x1 + self.lambda_c * cw1 * x2 + self.lambda_s * sw1 * x2
        out_x2 = x2 + self.lambda_c * cw0 * x1 + self.lambda_s * sw0 * x1
        return out_x1, out_x2


class CrossAttention(nn.Module):
    """Linear cross-modal exchange: per modality i,
    ctx_i = softmax over axis -2 of (k_i^T v_i) * scale, a (B, h, d, d)
    context; then y1 = q1 @ ctx2 and y2 = q2 @ ctx1. q is the raw
    head-reshaped input (no projection), scale = (dim / heads) ** -0.5.

    The contractions run in fp32 with autocast off, as the JAX module's
    fp32-accumulated einsums; ctx is rounded to v's dtype and y to x's."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.kv1 = nn.Linear(dim, dim * 2, bias=qkv_bias)
        self.kv2 = nn.Linear(dim, dim * 2, bias=qkv_bias)

    def forward(self, x1, x2):
        B, N, C = x1.shape
        h = self.num_heads
        d = C // h
        scale = d ** -0.5

        def heads(t):
            return t.reshape(B, N, h, d).transpose(1, 2)        # (B, h, N, d)

        kv1 = self.kv1(x1).reshape(B, N, 2, h, d)
        kv2 = self.kv2(x2).reshape(B, N, 2, h, d)
        k1, v1 = kv1[:, :, 0].transpose(1, 2), kv1[:, :, 1].transpose(1, 2)
        k2, v2 = kv2[:, :, 0].transpose(1, 2), kv2[:, :, 1].transpose(1, 2)
        with torch.autocast(x1.device.type, enabled=False):
            def ctx(k, v):
                c = torch.matmul(k.float().transpose(-1, -2), v.float()) * scale
                return torch.softmax(c, dim=-2).to(v.dtype)

            ctx1, ctx2 = ctx(k1, v1), ctx(k2, v2)
            y1 = torch.matmul(heads(x1).float(), ctx2.float()).to(x1.dtype)
            y2 = torch.matmul(heads(x2).float(), ctx1.float()).to(x2.dtype)
        return (y1.transpose(1, 2).reshape(B, N, C),
                y2.transpose(1, 2).reshape(B, N, C))


class CrossPath(nn.Module):
    """Per-branch expand + cross-attend + merge, residual + LayerNorm (torch
    default eps 1e-5)."""

    def __init__(self, dim: int, reduction: int = 1, num_heads: int = 8):
        super().__init__()
        inner = dim // reduction
        self.channel_proj1 = nn.Linear(dim, inner * 2)
        self.channel_proj2 = nn.Linear(dim, inner * 2)
        self.cross_attn = CrossAttention(inner, num_heads)
        self.end_proj1 = nn.Linear(inner * 2, dim)
        self.end_proj2 = nn.Linear(inner * 2, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x1, x2):
        y1, u1 = torch.relu(self.channel_proj1(x1)).chunk(2, dim=-1)
        y2, u2 = torch.relu(self.channel_proj2(x2)).chunk(2, dim=-1)
        v1, v2 = self.cross_attn(u1, u2)
        y1 = torch.cat([y1, v1], dim=-1)
        y2 = torch.cat([y2, v2], dim=-1)
        return (self.norm1(x1 + self.end_proj1(y1)),
                self.norm2(x2 + self.end_proj2(y2)))


class ChannelEmbed(nn.Module):
    """Token -> map projection: 1x1 residual + [1x1 -> 3x3 DW -> ReLU -> 1x1
    -> BN] bottleneck, summed then BN. BatchNorm eps is the encoder's
    (1e-5), not the config's."""

    def __init__(self, in_channels: int, out_channels: int,
                 reduction: int = 1, bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5):
        super().__init__()
        mid = out_channels // reduction
        self.residual = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.channel_embed = nn.Sequential(
            nn.Conv2d(in_channels, mid, 1),
            nn.Conv2d(mid, mid, 3, padding=1, groups=mid),
            nn.ReLU(),
            nn.Conv2d(mid, out_channels, 1),
            nn.BatchNorm2d(out_channels, eps=bn_eps, momentum=bn_momentum))
        self.norm = nn.BatchNorm2d(out_channels, eps=bn_eps,
                                   momentum=bn_momentum)

    def forward(self, x, H: int, W: int):
        x = tokens_to_map(x, H, W)
        return self.norm(self.residual(x) + self.channel_embed(x))


class FeatureFusionModule(nn.Module):
    """FFM: CrossPath token exchange + ChannelEmbed merge into one fused
    NCHW map."""

    def __init__(self, dim: int, reduction: int = 1, num_heads: int = 8,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        self.cross = CrossPath(dim, reduction, num_heads)
        self.channel_emb = ChannelEmbed(dim * 2, dim, reduction, bn_momentum,
                                        bn_eps)

    def forward(self, x1, x2):
        H, W = x1.shape[2:]
        t1, t2 = self.cross(map_to_tokens(x1), map_to_tokens(x2))
        return self.channel_emb(torch.cat([t1, t2], dim=-1), H, W)


def get_frm(name: str):
    if name == "FRM":
        return FeatureRectifyModule
    if name == "IFRM":
        raise NotImplementedError(
            "IFRM (mit_*pp) is not ported yet: ROADMAP M10 item 4")
    raise KeyError(f"unknown feature rectify module {name!r}")


def get_ffm(name: str):
    if name == "FFM":
        return FeatureFusionModule
    if name == "IFFM":
        raise NotImplementedError(
            "IFFM (mit_*pp) is not ported yet: ROADMAP M10 item 4 (needs K5)")
    raise KeyError(f"unknown feature fusion module {name!r}")
