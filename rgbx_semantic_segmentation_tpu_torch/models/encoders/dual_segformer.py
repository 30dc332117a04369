"""Dual-branch SegFormer (MiT) encoder — the CMX backbone.

Counterpart of rgbx_semantic_segmentation_tpu/models/encoders/
dual_segformer.py: two parallel MiT towers (rgb + extra modality), 4 stages of
OverlapPatchEmbed + spatial-reduction attention Blocks + Mix-FFN, with
per-stage FRM rectification and FFM fusion, and optionally an ASPP on each
stage's fused map or one eASPP after stage 4 (the `mit_*_w_aspp` /
`mit_*_w_ef_aspp` names; models/encoders/aspp.py). Attribute paths are the original
torch repo's (`block1.0.attn.q`, `FRMs.0`, ...), which the JAX names mirror
with `_` for `.`, so state dicts convert both ways with no key tables.

Layouts: maps are NCHW (convs), tokens (B, N, C) with N = H*W in row-major
order — `flatten(2).transpose(1, 2)` of a map gives the JAX NHWC reshape's
token order.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.models import fusion
from rgbx_semantic_segmentation_tpu_torch.models.encoders.aspp import (
    ASPP, EASPP, STAGE_ASPP_RATES)
from rgbx_semantic_segmentation_tpu_torch.ops.attention import (
    multi_head_attention)
from rgbx_semantic_segmentation_tpu_torch.ops.layers import (
    DropPath, Dropout, checkpointed, map_to_tokens, tokens_to_map)

LN_EPS = 1e-6  # MiT LayerNorms (original repo partial(nn.LayerNorm, eps=1e-6))


class DWConv(nn.Module):
    """3x3 depthwise conv over tokens."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, H: int, W: int):
        return map_to_tokens(self.dwconv(tokens_to_map(x, H, W)))


class Mlp(nn.Module):
    """Mix-FFN: fc1 -> 3x3 DWConv -> GELU -> fc2. gelu_approximate selects
    the tanh form (the JAX flagship default) over erf."""

    def __init__(self, in_features: int, hidden_features: int,
                 drop: float = 0.0, gelu_approximate: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.dwconv = DWConv(hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)
        self.drop = Dropout(drop)
        self.gelu = "tanh" if gelu_approximate else "none"

    def forward(self, x, H: int, W: int):
        x = self.dwconv(self.fc1(x), H, W)
        x = self.drop(F.gelu(x, approximate=self.gelu))
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """Spatial-reduction attention: kv from a sr_ratio-strided conv
    downsample of the token map (kernel = stride = sr_ratio, no padding,
    then LayerNorm); sr_ratio 1 attends over all tokens."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 sr_ratio: int = 1, use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.attn_drop = attn_drop
        # Name kept from the JAX module (ModelConfig.use_pallas_kernels): it
        # enables the hand-written kernel here.
        self.use_pallas = use_pallas
        self.dtype = dtype
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, dim * 2, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)
        self.attn_dropout = Dropout(attn_drop)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, H: int, W: int):
        B, N, C = x.shape
        h = self.num_heads
        d = C // h
        scale = d ** -0.5
        q = self.q(x).reshape(B, N, h, d).transpose(1, 2)
        if self.sr_ratio > 1:
            xk = self.norm(map_to_tokens(self.sr(tokens_to_map(x, H, W))))
        else:
            xk = x
        M = xk.shape[1]
        # unbind, not two selects: its backward is one stack of dk and dv,
        # which the kernel's backward already writes side by side.
        k, v = (t.transpose(1, 2)
                for t in self.kv(xk).reshape(B, M, 2, h, d).unbind(2))
        if self.attn_drop > 0.0 and self.training:
            out = self._attend_with_dropout(q, k, v, scale)
        else:
            out = self._attend(q, k, v, scale)
        return self.proj_drop(self.proj(out))

    def _attend_with_dropout(self, q, k, v, scale):
        """attn_drop sits between the softmax and p @ v, so a non-zero
        training rate takes the plain path with dropout on the fp32 probs
        (as the JAX module does; the kernels never hold the probs in device
        memory). Autograd differentiates it as written."""
        B, h, N, d = q.shape
        # Autocast off and explicit upcasts, as in sr_attention_reference:
        # fp32 logits and softmax, probs in v's dtype, fp32 accumulation.
        with torch.autocast(q.device.type, enabled=False):
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            probs = self.attn_dropout(torch.softmax(logits, dim=-1))
            out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
        return out.transpose(1, 2).reshape(B, N, h * d)

    def _attend(self, q, k, v, scale):
        """The attention middle: the kernel where the JAX package used its
        Pallas kernel (use_pallas; see ops/attention.multi_head_attention)."""
        if (self.use_pallas and q.is_cuda and self.dtype == torch.bfloat16
                and q.dtype != torch.bfloat16):
            raise TypeError(f"bf16 model sent {q.dtype} q/k/v to the kernel "
                            "(the forward must run under bf16 autocast)")
        return multi_head_attention(q, k, v, scale, use_kernels=self.use_pallas)


class Block(nn.Module):
    """x += DropPath(Attn(LN(x))); x += DropPath(MixFFN(LN(x)))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 sr_ratio: int = 1, use_pallas: bool = False,
                 gelu_approximate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop,
                              sr_ratio, use_pallas, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, gelu_approximate)

    def forward(self, x, H: int, W: int):
        x = x + self.drop_path(self.attn(self.norm1(x), H, W))
        return x + self.drop_path(self.mlp(self.norm2(x), H, W))


class OverlapPatchEmbed(nn.Module):
    """Strided-conv patch embedding with overlap: NCHW map -> tokens, H, W."""

    def __init__(self, patch_size: int, stride: int, in_chans: int,
                 embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=stride,
                              padding=patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x):
        x = self.proj(x)
        H, W = x.shape[2:]
        return self.norm(map_to_tokens(x)), H, W


class RGBXTransformer(nn.Module):
    """Dual-tower MiT with per-stage FRM/FFM. Takes NCHW rgb and modal maps;
    returns the 4 fused NCHW maps [1/4, 1/8, 1/16, 1/32]."""

    def __init__(self, in_chans: int = 3,
                 embed_dims: Sequence[int] = (64, 128, 256, 512),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 mlp_ratios: Sequence[float] = (4, 4, 4, 4),
                 depths: Sequence[int] = (3, 4, 6, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 qkv_bias: bool = False, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 frm: str = "FRM", ffm: str = "FFM",
                 aspp: Optional[str] = None,
                 use_pallas: bool = False, gelu_approximate: bool = False,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        # remat: each Block under activation checkpointing (the JAX
        # module's nn.remat; ops/layers.checkpointed).
        self.remat = remat
        frm_cls = fusion.get_frm(frm)
        ffm_cls = fusion.get_ffm(ffm)
        # SegFormer decay rule dpr[cur + i] for both towers (the JAX package's
        # documented fix of the original repo's stage-2 indices).
        dpr = [float(x) for x in np.linspace(0, drop_path_rate, sum(depths))]
        patch_cfg = [(7, 4), (3, 2), (3, 2), (3, 2)]  # (kernel, stride)
        cur = 0
        for s in range(4):
            k, st = patch_cfg[s]
            dim = embed_dims[s]
            prev = in_chans if s == 0 else embed_dims[s - 1]
            for pre in ("", "extra_"):
                setattr(self, f"{pre}patch_embed{s + 1}",
                        OverlapPatchEmbed(k, st, prev, dim))
                setattr(self, f"{pre}block{s + 1}", nn.ModuleList([
                    Block(dim, num_heads[s], mlp_ratios[s], qkv_bias,
                          drop_rate, attn_drop_rate, dpr[cur + i],
                          sr_ratios[s], use_pallas, gelu_approximate, dtype)
                    for i in range(depths[s])]))
                setattr(self, f"{pre}norm{s + 1}", nn.LayerNorm(dim, eps=LN_EPS))
            cur += depths[s]
        self.FRMs = nn.ModuleList([frm_cls(dim=d, reduction=1)
                                   for d in embed_dims])
        # IFFM's quadratic cross-attention needs the kernels to fit at
        # production resolution; plain FFM has no such knob.
        ffm_kw = {"use_pallas": use_pallas} if ffm == "IFFM" else {}
        self.FFMs = nn.ModuleList([
            ffm_cls(dim=d, reduction=1, num_heads=h, bn_momentum=bn_momentum,
                    bn_eps=bn_eps, **ffm_kw)
            for d, h in zip(embed_dims, num_heads)])
        # None | "aspp" (an ASPP on each stage's fused map) | "easpp" (one
        # eASPP after stage 4).
        if aspp == "aspp":
            self.aspp_modules = nn.ModuleList([
                ASPP(d, d, rates, bn_momentum=bn_momentum)
                for d, rates in zip(embed_dims, STAGE_ASPP_RATES)])
        elif aspp == "easpp":
            self.single_aspp = EASPP(embed_dims[3], bn_momentum=bn_momentum)
        self.aspp = aspp

    def forward(self, x_rgb, x_e) -> List[torch.Tensor]:
        outs = []
        for s in range(4):
            n = s + 1
            x_rgb, H, W = getattr(self, f"patch_embed{n}")(x_rgb)
            x_e, _, _ = getattr(self, f"extra_patch_embed{n}")(x_e)
            for blk, eblk in zip(getattr(self, f"block{n}"),
                                 getattr(self, f"extra_block{n}")):
                if self.remat:
                    x_rgb = checkpointed(blk, x_rgb, H, W)
                    x_e = checkpointed(eblk, x_e, H, W)
                else:
                    x_rgb = blk(x_rgb, H, W)
                    x_e = eblk(x_e, H, W)
            x_rgb = getattr(self, f"norm{n}")(x_rgb)
            x_e = getattr(self, f"extra_norm{n}")(x_e)
            m_rgb, m_e = self.FRMs[s](tokens_to_map(x_rgb, H, W),
                                      tokens_to_map(x_e, H, W))
            fused = self.FFMs[s](m_rgb, m_e)
            if self.aspp == "aspp":
                fused = self.aspp_modules[s](fused)
            elif self.aspp == "easpp" and s == 3:
                fused = self.single_aspp(fused)
            outs.append(fused)
            x_rgb, x_e = m_rgb, m_e  # next stage embeds the rectified maps
        return outs


@contextlib.contextmanager
def plain_attention(model: nn.Module) -> Iterator[nn.Module]:
    """Run `model`'s MiT attentions and IFFM cross-attentions on the plain
    path inside the block (for holding the kernel path against it; see
    ops/attention.multi_head_attention); restores on exit."""
    mods = [m for m in model.modules()
            if isinstance(m, (Attention, fusion.ImprovedCrossAttention))]
    saved = [m.use_pallas for m in mods]
    try:
        for m in mods:
            m.use_pallas = False
        yield model
    finally:
        for m, s in zip(mods, saved):
            m.use_pallas = s


def _mit(embed_dims, depths, **overrides) -> RGBXTransformer:
    kw = dict(
        embed_dims=embed_dims, num_heads=(1, 2, 5, 8), mlp_ratios=(4, 4, 4, 4),
        qkv_bias=True, depths=depths, sr_ratios=(8, 4, 2, 1),
        drop_rate=0.0, drop_path_rate=0.1)
    kw.update(overrides)
    return RGBXTransformer(**kw)


def mit_b0(**kw):
    return _mit((32, 64, 160, 256), (2, 2, 2, 2), **kw)


def mit_tiny(**kw):
    """Test-scale variant: one block per stage at mit_b0 widths."""
    return _mit((32, 64, 160, 256), (1, 1, 1, 1), **kw)


def mit_b1(**kw):
    return _mit((64, 128, 320, 512), (2, 2, 2, 2), **kw)


def mit_b2(**kw):
    return _mit((64, 128, 320, 512), (3, 4, 6, 3), **kw)


def mit_b3(**kw):
    return _mit((64, 128, 320, 512), (3, 4, 18, 3), **kw)


def mit_b4(**kw):
    return _mit((64, 128, 320, 512), (3, 8, 27, 3), **kw)


def mit_b5(**kw):
    return _mit((64, 128, 320, 512), (3, 6, 40, 3), **kw)


# Output channel lists per variant (what decoders consume).
CHANNELS = {
    "mit_tiny": (32, 64, 160, 256),
    "mit_b0": (32, 64, 160, 256),
    "mit_b1": (64, 128, 320, 512),
    "mit_b2": (64, 128, 320, 512),
    "mit_b3": (64, 128, 320, 512),
    "mit_b4": (64, 128, 320, 512),
    "mit_b5": (64, 128, 320, 512),
}
