"""rgbx_semantic_segmentation_tpu_torch: the PyTorch/CUDA port of
rgbx_semantic_segmentation_tpu for NVIDIA Hopper GPUs.

The JAX package beside it is the reference. This package mirrors its module
structure and names, imports its jax-free host code (config dataclasses,
data/cv_ops, dataset, logger) instead of copying it, and never imports jax.
The short-kv SR-attention forward runs as a hand-written CUDA kernel
(csrc/sr_attention_fwd.cu); all other math is plain PyTorch.

First slice: whole-image inference of the CMX MiT + MLPDecoder models
(models/builder.py, evaluator.py, eval_cli.py).
"""
