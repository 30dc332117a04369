"""Attention compute paths (counterpart of rgbx_semantic_segmentation_tpu/
ops/attention.py).

`multi_head_attention` dispatches as the JAX version does on its
accelerator: with kernels enabled, short-kv shapes (sr_attention.supported)
go to the hand-written kernel; long-kv shapes (flash_supported) have no port
yet and raise; everything else runs the plain `_sdpa` forward. On a CPU
tensor the kernel wrapper itself takes the plain version.
"""
from __future__ import annotations

import torch

from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as SR


def flash_supported(q_shape, k_shape) -> bool:
    """Shapes the JAX package sends to the long-kv flash kernel (its
    `flash_supported` without the TPU test)."""
    N, d = q_shape[2], q_shape[3]
    return N >= 1024 and d >= 32 and d % 8 == 0


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          scale: float) -> torch.Tensor:
    """Plain forward of the JAX `_sdpa_fwd`: fp32 logits and softmax, probs
    in v's dtype into an fp32-accumulated p @ v."""
    return SR.sr_attention_reference(q, k, v, scale)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float,
                         use_kernels: bool = False) -> torch.Tensor:
    """Softmax attention. q: (B, h, N, d); k, v: (B, h, M, d) -> (B, N, h*d)."""
    B, h, N, d = q.shape
    if use_kernels and SR.supported(q.shape, k.shape):
        # The kernel takes the head-split views as they are, and its output
        # is laid out so that the merge below is a view.
        out = SR.sr_attention(q, k, v, scale)
    elif use_kernels and q.is_cuda and flash_supported(q.shape, k.shape):
        raise NotImplementedError(
            "long-kv attention (M > 1024) has no CUDA kernel yet: ROADMAP K5")
    else:
        out = _sdpa(q, k, v, scale)
    return out.transpose(1, 2).reshape(B, N, h * d)
