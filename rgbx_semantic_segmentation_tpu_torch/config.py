"""Configuration: the JAX package's dataclasses, reused as they are.

rgbx_semantic_segmentation_tpu.config is host-only (it pulls in no jax
module), so the port imports it instead of copying it. Its one jax-bound
member, `ModelConfig.compute_dtype`, is replaced here by `torch_dtype`.
"""
from __future__ import annotations

import torch

from rgbx_semantic_segmentation_tpu.config import (  # noqa: F401
    Config, DatasetConfig, EvalConfig, ModelConfig, get_config, mfnet_config)


def torch_dtype(model_cfg: ModelConfig) -> torch.dtype:
    """Compute dtype for `use_mixed_precision`: bf16 compute with fp32
    params, as the JAX package's policy, else fp32."""
    return torch.bfloat16 if model_cfg.use_mixed_precision else torch.float32
