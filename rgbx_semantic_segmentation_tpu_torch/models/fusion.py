"""Cross-modal fusion: FRM / FFM and their Improved variants IFRM / IFFM
(counterpart of rgbx_semantic_segmentation_tpu/models/fusion.py).

Maps are NCHW, tokens (B, N, C). Submodule paths are the original repo's
(`channel_weights.mlp.0`, `channel_weights.gate.0`,
`cross.cross_attn.kv1`, `channel_emb.channel_embed.4`, ...). LayerNorms
here use torch's default eps 1e-5 (the JAX `layer_norm` default), not the
MiT blocks' 1e-6.

All four also run on one rank's row block of their maps (`rows`, the
spatial group of `--mesh 2d:D,S`; parallel/spatial.py): the channel gates'
pooled statistics and the linear cross-attention's k^T v, which sum over
every token, are summed (maxed) over the spatial group; the IFFM's softmax
cross-attention takes q from the own tokens and k, v from the whole map's
(gathered); the 3x3 depthwise conv exchanges halo rows; the rest (the
spatial gates' 1x1 convs, the LayerNorms, the linears) is per token, and
the BatchNorms are synced over the world (parallel/sync_bn.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.ops.attention import (
    multi_head_attention)
from rgbx_semantic_segmentation_tpu_torch.ops.layers import (
    Dropout, map_to_tokens, tokens_to_map)
from rgbx_semantic_segmentation_tpu_torch.parallel import spatial


def _pooled(x, rows=None):
    """The mean and the max of the (B, C, H, W) map x over (H, W): with
    `rows`, of the whole map whose row block x is (the rows' fp32 sums
    summed over the spatial group, the max maxed over it), on every
    spatial rank."""
    if rows is None:
        return x.mean(dim=(2, 3)), x.amax(dim=(2, 3))
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    n = x.shape[2] * x.shape[3] * rows.size
    mean = (spatial.spatial_sum(x.to(wide).sum(dim=(2, 3)), rows)
            / n).to(x.dtype)
    return mean, spatial.spatial_amax(x, rows, (2, 3))


class ChannelWeights(nn.Module):
    """Global avg+max pooled MLP channel gates. Returns (w0, w1), each
    (B, C, 1, 1); w0 is the first half of the MLP output."""

    def __init__(self, dim: int, reduction: int = 1):
        super().__init__()
        self.dim = dim
        self.mlp = nn.Sequential(
            nn.Linear(dim * 4, dim * 4 // reduction), nn.ReLU(),
            nn.Linear(dim * 4 // reduction, dim * 2), nn.Sigmoid())

    def forward(self, x1, x2, rows=None):
        B = x1.shape[0]
        x = torch.cat([x1, x2], dim=1)                       # (B, 2C, H, W)
        y = self.mlp(torch.cat(_pooled(x, rows), dim=1))     # (B, 2C)
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

    def forward(self, x1, x2, rows=None):
        cw0, cw1 = self.channel_weights(x1, x2, rows)
        sw0, sw1 = self.spatial_weights(x1, x2)
        out_x1 = x1 + self.lambda_c * cw1 * x2 + self.lambda_s * sw1 * x2
        out_x2 = x2 + self.lambda_c * cw0 * x1 + self.lambda_s * sw0 * x1
        return out_x1, out_x2


class ImprovedChannelWeights(nn.Module):
    """LayerNorm + GELU MLP over the pooled statistics with a learned
    sigmoid gate on its output. Returns (w0, w1), each (B, C, 1, 1)."""

    def __init__(self, dim: int, reduction: int = 1):
        super().__init__()
        self.dim = dim
        hidden = dim * 4 // reduction
        self.mlp = nn.Sequential(
            nn.Linear(dim * 4, hidden), nn.LayerNorm(hidden), nn.GELU(),
            nn.Linear(hidden, dim * 2), nn.LayerNorm(dim * 2))
        self.gate = nn.Sequential(nn.Linear(dim * 2, dim * 2), nn.Sigmoid())

    def forward(self, x1, x2, rows=None):
        B = x1.shape[0]
        x = torch.cat([x1, x2], dim=1)
        y = self.mlp(torch.cat(_pooled(x, rows), dim=1))
        y = y * self.gate(y)
        C = self.dim
        return y[:, :C].reshape(B, C, 1, 1), y[:, C:].reshape(B, C, 1, 1)


class ImprovedSpatialWeights(nn.Module):
    """Three 1x1 convs with BatchNorm + GELU and a residual around the
    second; no final sigmoid. Returns (w0, w1), each (B, 1, H, W)."""

    def __init__(self, dim: int, reduction: int = 1):
        super().__init__()
        mid = dim // reduction
        self.conv1 = nn.Conv2d(dim * 2, mid, 1)
        self.norm1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 1)
        self.norm2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, 2, 1)

    def forward(self, x1, x2):
        y = F.gelu(self.norm1(self.conv1(torch.cat([x1, x2], dim=1))))
        y = F.gelu(self.norm2(self.conv2(y))) + y
        y = self.conv3(y)
        return y[:, 0:1], y[:, 1:2]


class ImprovedFeatureRectifyModule(nn.Module):
    """IFRM: learnable lambdas (0-d parameters, 0.5 at the start) and one
    LayerNorm over channels shared by both outputs."""

    def __init__(self, dim: int, reduction: int = 1):
        super().__init__()
        self.channel_weights = ImprovedChannelWeights(dim, reduction)
        self.spatial_weights = ImprovedSpatialWeights(dim, reduction)
        self.lambda_channel = nn.Parameter(torch.tensor(0.5))
        self.lambda_spatial = nn.Parameter(torch.tensor(0.5))
        self.norm = nn.LayerNorm(dim)

    def _norm(self, x):
        return self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def forward(self, x1, x2, rows=None):
        cw0, cw1 = self.channel_weights(x1, x2, rows)
        sw0, sw1 = self.spatial_weights(x1, x2)
        lam_c, lam_s = self.lambda_channel, self.lambda_spatial
        out_x1 = x1 + lam_c * cw1 * x2 + lam_s * sw1 * x2
        out_x2 = x2 + lam_c * cw0 * x1 + lam_s * sw0 * x1
        return self._norm(out_x1), self._norm(out_x2)


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

    def forward(self, x1, x2, rows=None):
        """`rows`: the spatial group when x1, x2 are the rank's tokens; k^T v
        (a sum over the tokens) is summed over the group before its
        softmax."""
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
                c = torch.matmul(k.float().transpose(-1, -2), v.float())
                if rows is not None:
                    c = spatial.spatial_sum(c, rows)
                return torch.softmax(c * scale, dim=-2).to(v.dtype)

            ctx1, ctx2 = ctx(k1, v1), ctx(k2, v2)
            y1 = torch.matmul(heads(x1).float(), ctx2.float()).to(x1.dtype)
            y2 = torch.matmul(heads(x2).float(), ctx1.float()).to(x2.dtype)
        return (y1.transpose(1, 2).reshape(B, N, C),
                y2.transpose(1, 2).reshape(B, N, C))


class ImprovedCrossAttention(nn.Module):
    """Softmax cross-attention q1 k2^T -> v2 and q2 k1^T -> v1 with q, kv
    and output projections. Quadratic in the tokens: at the first stage of
    a 480x640 image N = M = 19200, and the probabilities of one call would
    be 11.8 GB in fp32 at batch 8. With `use_pallas` the middle goes through
    ops/attention.multi_head_attention to the hand-written kernels (long kv:
    the flash attention kernels; the short last stage: the SR kernels) and
    no (N, M) tensor reaches device memory. `attn_drop` sits between the
    softmax and p @ v, so a non-zero rate in training takes the
    materialising path (every config leaves it 0).

    With `rows` (a spatial rank's tokens, `--mesh 2d:D,S`) q comes from
    the own tokens and k, v from the whole map's: the tokens are gathered
    (spatial.gather_rows) and projected whole on every rank, and the
    attention runs on the own q rows (ops/flash_attention.py says what its
    dk, dv are then), routed as the whole map's attention. Each rank's
    kv-projection gradient is the partial sum over its own q rows, which
    the world's summing all-reduce completes; the gather's backward sums
    the tokens' gradient over the group. A dropout mask is drawn at the
    whole q length (the output dropout's at the whole token count) and the
    own rows kept: one process's masks."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        # Name kept from the JAX module: it enables the kernels here.
        self.use_pallas = use_pallas
        self.q1 = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv1 = nn.Linear(dim, dim * 2, bias=qkv_bias)
        self.q2 = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv2 = nn.Linear(dim, dim * 2, bias=qkv_bias)
        self.proj1 = nn.Linear(dim, dim)
        self.proj2 = nn.Linear(dim, dim)
        self.attn_dropout = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def _attend(self, q, k, v, scale, rows=None):
        if self.attn_drop == 0.0 or not self.training:
            return multi_head_attention(
                q, k, v, scale, use_kernels=self.use_pallas,
                n_whole=None if rows is None else q.shape[2] * rows.size)
        B, h, N, d = q.shape
        split = None if rows is None else (rows.rank, rows.size)
        with torch.autocast(q.device.type, enabled=False):
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            probs = self.attn_dropout(
                torch.softmax(logits, dim=-1).to(v.dtype), split, -2)
            out = torch.matmul(probs.float(), v.float()).to(v.dtype)
        return out.transpose(1, 2).reshape(B, N, h * d)

    def forward(self, x1, x2, rows=None):
        B, N, C = x1.shape
        h = self.num_heads
        d = C // h
        scale = d ** -0.5

        def project(x, q_lin, kv_lin):
            q = q_lin(x).reshape(B, N, h, d).transpose(1, 2)
            if rows is not None:
                x = spatial.gather_rows(x, rows, 1)
            # unbind: its backward is one stack of dk and dv, which the
            # kernels' backward already writes side by side.
            k, v = (t.transpose(1, 2) for t in
                    kv_lin(x).reshape(B, x.shape[1], 2, h, d).unbind(2))
            return q, k, v

        q1, k1, v1 = project(x1, self.q1, self.kv1)
        q2, k2, v2 = project(x2, self.q2, self.kv2)
        split = None if rows is None else (rows.rank, rows.size)
        y1 = self.proj_drop(self.proj1(self._attend(q1, k2, v2, scale, rows)),
                            split, -2)
        y2 = self.proj_drop(self.proj2(self._attend(q2, k1, v1, scale, rows)),
                            split, -2)
        return y1, y2


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

    def forward(self, x1, x2, rows=None):
        y1, u1 = torch.relu(self.channel_proj1(x1)).chunk(2, dim=-1)
        y2, u2 = torch.relu(self.channel_proj2(x2)).chunk(2, dim=-1)
        v1, v2 = self.cross_attn(u1, u2, rows)
        y1 = torch.cat([y1, v1], dim=-1)
        y2 = torch.cat([y2, v2], dim=-1)
        return (self.norm1(x1 + self.end_proj1(y1)),
                self.norm2(x2 + self.end_proj2(y2)))


class ImprovedCrossPath(nn.Module):
    """CrossPath with erf-GELU expansions and ImprovedCrossAttention."""

    def __init__(self, dim: int, reduction: int = 1, num_heads: int = 8,
                 use_pallas: bool = False):
        super().__init__()
        inner = dim // reduction
        self.channel_proj1 = nn.Linear(dim, inner * 2)
        self.channel_proj2 = nn.Linear(dim, inner * 2)
        self.cross_attn = ImprovedCrossAttention(inner, num_heads,
                                                 use_pallas=use_pallas)
        self.end_proj1 = nn.Linear(inner * 2, dim)
        self.end_proj2 = nn.Linear(inner * 2, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x1, x2, rows=None):
        y1, u1 = F.gelu(self.channel_proj1(x1)).chunk(2, dim=-1)
        y2, u2 = F.gelu(self.channel_proj2(x2)).chunk(2, dim=-1)
        v1, v2 = self.cross_attn(u1, u2, rows)
        y1 = torch.cat([y1, v1], dim=-1)
        y2 = torch.cat([y2, v2], dim=-1)
        return (self.norm1(x1 + self.end_proj1(y1)),
                self.norm2(x2 + self.end_proj2(y2)))


class ChannelEmbed(nn.Module):
    """Token -> map projection: 1x1 residual + [1x1 -> 3x3 DW -> ReLU (erf
    GELU with act="gelu", the Improved variant) -> 1x1 -> BN] bottleneck,
    summed then BN. BatchNorm eps is the encoder's (1e-5), not the
    config's."""

    def __init__(self, in_channels: int, out_channels: int,
                 reduction: int = 1, bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5, act: str = "relu"):
        super().__init__()
        mid = out_channels // reduction
        self.residual = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.channel_embed = nn.Sequential(
            nn.Conv2d(in_channels, mid, 1),
            nn.Conv2d(mid, mid, 3, padding=1, groups=mid),
            nn.ReLU() if act == "relu" else nn.GELU(),
            nn.Conv2d(mid, out_channels, 1),
            nn.BatchNorm2d(out_channels, eps=bn_eps, momentum=bn_momentum))
        self.norm = nn.BatchNorm2d(out_channels, eps=bn_eps,
                                   momentum=bn_momentum)

    def forward(self, x, H: int, W: int, rows=None):
        """`rows`: the spatial group when x holds the rank's H rows (the
        depthwise conv exchanges halo rows; the BatchNorms are synced over
        the world by parallel/sync_bn.py)."""
        x = tokens_to_map(x, H, W)
        if rows is None:
            y = self.channel_embed(x)
        else:
            e = self.channel_embed
            y = spatial.conv2d_rows(e[0](x), e[1], rows)
            y = e[4](e[3](e[2](y)))
        return self.norm(self.residual(x) + y)


class FeatureFusionModule(nn.Module):
    """FFM: CrossPath token exchange + ChannelEmbed merge into one fused
    NCHW map."""

    def __init__(self, dim: int, reduction: int = 1, num_heads: int = 8,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        self.cross = CrossPath(dim, reduction, num_heads)
        self.channel_emb = ChannelEmbed(dim * 2, dim, reduction, bn_momentum,
                                        bn_eps)

    def forward(self, x1, x2, rows=None):
        H, W = x1.shape[2:]
        t1, t2 = self.cross(map_to_tokens(x1), map_to_tokens(x2), rows)
        return self.channel_emb(torch.cat([t1, t2], dim=-1), H, W, rows)


class ImprovedFeatureFusionModule(nn.Module):
    """IFFM: ImprovedCrossPath token exchange + GELU ChannelEmbed."""

    def __init__(self, dim: int, reduction: int = 1, num_heads: int = 8,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 use_pallas: bool = False):
        super().__init__()
        self.cross = ImprovedCrossPath(dim, reduction, num_heads, use_pallas)
        self.channel_emb = ChannelEmbed(dim * 2, dim, reduction, bn_momentum,
                                        bn_eps, act="gelu")

    def forward(self, x1, x2, rows=None):
        H, W = x1.shape[2:]
        t1, t2 = self.cross(map_to_tokens(x1), map_to_tokens(x2), rows)
        return self.channel_emb(torch.cat([t1, t2], dim=-1), H, W, rows)


def get_frm(name: str):
    return {"FRM": FeatureRectifyModule,
            "IFRM": ImprovedFeatureRectifyModule}[name]


def get_ffm(name: str):
    return {"FFM": FeatureFusionModule,
            "IFFM": ImprovedFeatureFusionModule}[name]
