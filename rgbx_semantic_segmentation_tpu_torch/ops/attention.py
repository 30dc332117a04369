"""Attention compute paths (counterpart of rgbx_semantic_segmentation_tpu/
ops/attention.py).

`multi_head_attention` dispatches as the JAX version does on its
accelerator: with kernels enabled, short-kv shapes (sr_attention.supported)
go to the SR kernels and, tried after them, long-kv shapes
(flash_attention.supported: N >= 1024, any d up to 128) to the flash
attention kernels, a head dim that is not a multiple of 8 zero-padded to
one; shapes that pass neither gate run the plain `_sdpa`, forward and
backward. On a CPU tensor
each kernel wrapper itself takes its plain versions. With kernels disabled
the same shapes run `_sdpa`, except the long-kv ones, whose (N, M)
probabilities `_sdpa` would keep for its backward (5.9 GB a call at the
first mit_b2pp stage): they take the chunked plain versions of the flash
attention, which keep none. That plain path differs from the JAX package's
`_sdpa` in its rounding point: it rounds the unnormalised p to v's dtype
and divides by the row sum after p @ v (the flash kernels' order), where
`_sdpa` normalises first and rounds the probabilities. In fp32 the two agree
to summation order (the CPU parity tests); in bf16 they differ by the
rounding of p, about a bf16 ulp of the output.

The JAX package sends a long-kv shape to its flash kernel only where d >= 32
and d % 8 == 0 (the upstream TPU kernel's blocks), and it builds the
SegNeXt and ResNet IFFMs without `use_pallas`, so their cross-attention
always runs `_sdpa` there. Here those IFFMs take the model's kernel switch,
as the MiT ones do, and their narrow heads (SegNeXt: d = dim / 8, 4 to 96) the
flash kernels: `_sdpa` would keep 94 GB of fp32 logits for one call at the
first segnext_b stage of a batch of eight 480x640 images.

On the data x spatial mesh (`--mesh 2d:D,S`, parallel/spatial.py) a rank
attends with its own N / S query rows to the whole map's keys. It takes
the route that one process takes for the same attention: the caller passes
the whole map's query count (`n_whole`), and the gates read it in place of
the rank's N (flash_attention.supported asks N >= 1024: at 2d:1,2 the
third mit_b2pp stage's 1,200 query rows are 600 a rank, whose keys, 1,200,
the SR gate refuses too). `multi_head_attention.routes` counts the calls
of each route ("sr", "flash", "sdpa").
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F

from rgbx_semantic_segmentation_tpu_torch.ops import flash_attention as FA
from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as SR


class _Sdpa(torch.autograd.Function):
    """The JAX `_sdpa` custom VJP: the residual is (q, k, v, probs in v's
    dtype) and the softmax backward runs from the ROUNDED probs (`_sdpa_bwd`;
    the kernel's backward uses the unrounded ones, see ops/sr_attention.py)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        with torch.autocast(q.device.type, enabled=False):
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.matmul(probs.float(), v.float()).to(v.dtype)
        ctx.save_for_backward(q, k, v, probs)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, probs = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            gf = g.to(v.dtype).float()
            pf = probs.float()
            dv = torch.matmul(pf.transpose(-1, -2), gf).to(v.dtype)
            dp = torch.matmul(gf, v.float().transpose(-1, -2))
            dl = ((dp - (dp * pf).sum(-1, keepdim=True)) * pf * ctx.scale)
            dl = dl.to(q.dtype).float()
            dq = torch.matmul(dl, k.float()).to(q.dtype)
            dk = torch.matmul(dl.transpose(-1, -2), q.float()).to(k.dtype)
        return dq, dk, dv, None


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          scale: float) -> torch.Tensor:
    """Plain attention with the JAX `_sdpa`'s numerics, forward (fp32 logits
    and softmax, probs in v's dtype into an fp32-accumulated p @ v: the same
    arithmetic as SR.sr_attention_reference) and backward (see _Sdpa). The
    path for shapes no kernel takes, and the plain attention path a model
    on the card is held against."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Sdpa.apply(q, k, v, scale)
    return SR.sr_attention_reference(q, k, v, scale)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, use_kernels: bool = False,
                         n_whole: Optional[int] = None) -> torch.Tensor:
    """Softmax attention. q: (B, h, N, d); k, v: (B, h, M, d) -> (B, N, h*d).
    `n_whole`: the whole map's query count where q holds a spatial rank's
    rows of it (the route is that of the whole map's attention)."""
    B, h, N, d = q.shape
    route_q = q.shape if n_whole is None else (B, h, n_whole, d)
    if SR.supported(route_q, k.shape):
        multi_head_attention.routes["sr"] += 1
        # The kernel takes the head-split views as they are, and its output
        # is laid out so that the merge below is a view.
        out = (SR.sr_attention if use_kernels else _sdpa)(q, k, v, scale)
    elif FA.supported(route_q, k.shape):
        multi_head_attention.routes["flash"] += 1
        if use_kernels:
            # The kernels take head dims that are multiples of 8: zero
            # columns add nothing to the logits and their output columns are
            # dropped, so the padded call is exact (with the scale of the
            # true d), and autograd carries dq, dk and dv back through the
            # pad.
            pad = -d % 8
            if pad:
                q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
            out = FA.flash_attention(q, k, v, scale)[..., :d]
        else:
            out = FA.flash_attention_plain(q, k, v, scale)
    else:
        multi_head_attention.routes["sdpa"] += 1
        out = _sdpa(q, k, v, scale)
    return out.transpose(1, 2).reshape(B, N, h * d)


multi_head_attention.routes = collections.Counter()
