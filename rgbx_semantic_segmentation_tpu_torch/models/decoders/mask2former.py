"""Simplified Mask2Former head (counterpart of rgbx_semantic_segmentation_tpu/
models/decoders/mask2former.py): learned queries, an FPN pixel decoder, a
transformer decoder and class / mask predictors.

100 learned queries (normal(0.02) init), an FPN pixel decoder over the four
fused scales, 9 post-norm decoder layers (self-attention, cross-attention
to the 1/32 map, FFN), a (num_classes + 1)-way class head and a dot-product
mask predictor with a learned sigmoid temperature `scale` (init 20). The
forward returns {"pred_logits", "pred_masks"} in fp32 for
losses.mask2former_loss; `semantic_inference` composes them into per-pixel
class scores for evaluation.

As in the JAX module: the nine layers are independent (the original repo
appends ONE layer nine times, tying their weights; the JAX package
documents the deviation and keeps them apart), the LayerNorms take flax's
default eps 1e-6, the BatchNorms torch's 1e-5 and momentum 0.1 (the builder
passes the config's BN settings to no part of this head), and the decoder's
dropout rate is 0.1, on each attention's projected output and in the FFN.
These are module constants, as they are fixed in the JAX module. The attentions
run the plain `_sdpa` (`use_kernels=False`): the JAX module calls
`multi_head_attention` without its kernels, and no Pallas kernel is on its
path.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.ops.attention import (
    multi_head_attention)
from rgbx_semantic_segmentation_tpu_torch.ops.layers import (
    Dropout, map_to_tokens)
from rgbx_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear

HIDDEN = 256
NUM_HEADS = 8
FFN_DIM = 2048
DROPOUT = 0.1   # the JAX decoder layers' rate, which no config reaches
LN_EPS = 1e-6   # flax nn.LayerNorm's default, which the JAX module keeps
BN_EPS = 1e-5   # the BatchNorms take the JAX head's defaults: the builder
BN_MOMENTUM = 0.1   # passes the config's settings to no part of this head


class PixelDecoder(nn.Module):
    """FPN pixel decoder: 1x1 laterals, top-down adds each followed by a
    3x3 conv + BN + ReLU; returns (mask features at 1/4, transformer
    features at 1/32), NCHW."""

    def __init__(self, in_channels: Sequence[int]):
        super().__init__()

        def bn():
            return nn.BatchNorm2d(HIDDEN, eps=BN_EPS, momentum=BN_MOMENTUM)

        self.lateral_convs = nn.ModuleList(
            [nn.Conv2d(c, HIDDEN, 1) for c in in_channels])
        self.output_convs = nn.ModuleList([
            nn.Sequential(nn.Conv2d(HIDDEN, HIDDEN, 3, padding=1), bn(),
                          nn.ReLU())
            for _ in in_channels[:-1]])
        self.mask_features = nn.Sequential(
            nn.Conv2d(HIDDEN, HIDDEN, 3, padding=1), bn(), nn.ReLU())
        self.transformer_features = nn.Sequential(
            nn.Conv2d(HIDDEN, HIDDEN, 1), bn())

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, features)]
        for i in range(len(laterals) - 1, 0, -1):
            up = resize_bilinear(laterals[i], laterals[i - 1].shape[2:])
            laterals[i - 1] = self.output_convs[i - 1](laterals[i - 1] + up)
        return (self.mask_features(laterals[0]),
                self.transformer_features(laterals[-1]))


class MHA(nn.Module):
    """Multi-head attention with separate q / k / v / out projections
    (nn.MultiheadAttention's math), dropout on the projected output."""

    def __init__(self):
        super().__init__()
        self.q_proj = nn.Linear(HIDDEN, HIDDEN)
        self.k_proj = nn.Linear(HIDDEN, HIDDEN)
        self.v_proj = nn.Linear(HIDDEN, HIDDEN)
        self.out_proj = nn.Linear(HIDDEN, HIDDEN)
        self.dropout = Dropout(DROPOUT)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        h = NUM_HEADS

        def heads(x, proj):
            B, N, C = x.shape
            return proj(x).reshape(B, N, h, C // h).transpose(1, 2)

        qh = heads(q, self.q_proj)
        out = multi_head_attention(qh, heads(k, self.k_proj),
                                   heads(v, self.v_proj),
                                   qh.shape[-1] ** -0.5, use_kernels=False)
        return self.dropout(self.out_proj(out))


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention, cross-attention, FFN, each
    added to its input and LayerNorm-ed."""

    def __init__(self):
        super().__init__()
        self.self_attn = MHA()
        self.norm1 = nn.LayerNorm(HIDDEN, eps=LN_EPS)
        self.cross_attn = MHA()
        self.norm2 = nn.LayerNorm(HIDDEN, eps=LN_EPS)
        self.ffn = nn.Sequential(
            nn.Linear(HIDDEN, FFN_DIM), nn.ReLU(), Dropout(DROPOUT),
            nn.Linear(FFN_DIM, HIDDEN))
        self.dropout = Dropout(DROPOUT)
        self.norm3 = nn.LayerNorm(HIDDEN, eps=LN_EPS)

    def forward(self, queries: torch.Tensor,
                memory: torch.Tensor) -> torch.Tensor:
        queries = self.norm1(queries + self.self_attn(queries, queries,
                                                      queries))
        queries = self.norm2(queries + self.cross_attn(queries, memory,
                                                       memory))
        return self.norm3(queries + self.dropout(self.ffn(queries)))


class Mask2Former(nn.Module):
    """Input: 4 NCHW maps [1/4 .. 1/32]; output {"pred_logits": (B, Q,
    num_classes + 1), "pred_masks": (B, Q, H/4, W/4)}, both fp32."""

    in_stages = (0, 1, 2, 3)   # the encoder stages forward reads

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 num_queries: int = 100, num_decoder_layers: int = 9):
        super().__init__()
        self.pixel_decoder = PixelDecoder(in_channels)
        self.query_embed = nn.Parameter(torch.empty(num_queries, HIDDEN))
        self.layers = nn.ModuleList([
            TransformerDecoderLayer() for _ in range(num_decoder_layers)])
        self.decoder_norm = nn.LayerNorm(HIDDEN, eps=LN_EPS)
        self.class_embed = nn.Linear(HIDDEN, num_classes + 1)
        self.query_proj = nn.Linear(HIDDEN, HIDDEN)
        self.out_proj = nn.Linear(HIDDEN, HIDDEN)
        self.scale = nn.Parameter(torch.empty(1))

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        mask_feats, tr_feats = self.pixel_decoder(features)
        memory = map_to_tokens(tr_feats)                   # (B, Ht*Wt, C)
        B = memory.shape[0]
        queries = self.query_embed.expand(B, -1, -1).to(memory.dtype)
        for layer in self.layers:
            queries = layer(queries, memory)
        queries = self.decoder_norm(queries)
        logits = self.class_embed(queries)
        q = self.out_proj(self.query_proj(queries))
        q = q * torch.sigmoid(self.scale.to(q.dtype))
        # The mask product takes the operands in the compute dtype and
        # accumulates in fp32 (the JAX einsum's preferred_element_type):
        # upcast, and keep autocast from rounding the product to bf16.
        with torch.autocast(q.device.type, enabled=False):
            masks = torch.matmul(q.float(), mask_feats.flatten(2).float())
        return {"pred_logits": logits.float(),
                "pred_masks": masks.reshape(B, -1, *mask_feats.shape[2:])}


def semantic_inference(pred_logits: torch.Tensor,
                       pred_masks: torch.Tensor) -> torch.Tensor:
    """Per-pixel class scores of the query predictions: log(sum_q
    softmax(logits)[b, q, c] * sigmoid(masks)[b, q, h, w] + 1e-8), the
    no-object class dropped; (B, H, W, C) NHWC, fp32. The log lets the
    evaluator's exp-and-sum average probabilities over windows and scales."""
    with torch.autocast(pred_logits.device.type, enabled=False):
        probs = torch.softmax(pred_logits.float(), dim=-1)[..., :-1]
        masks = torch.sigmoid(pred_masks.float())
        sem = torch.einsum("bqc,bqhw->bhwc", probs, masks)
    return torch.log(sem + 1e-8)
