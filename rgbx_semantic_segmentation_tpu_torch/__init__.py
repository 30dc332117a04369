"""rgbx_semantic_segmentation_tpu_torch: the PyTorch/CUDA port of
rgbx_semantic_segmentation_tpu for NVIDIA Hopper GPUs.

The JAX package beside it is the reference. This package mirrors its module
structure and names, keeps its own copies of the host-side code it needs
(config, data pipeline, logger, visualize, the C++ image ops) and never
imports jax or the JAX package. The attentions run as hand-written CUDA
kernels (csrc/); all other math is plain PyTorch.

Entry points: models/builder.build_model, evaluator.SegEvaluator,
train.Trainer, engine.Engine, and the CLIs train_cli, eval_cli and
predict_cli (python -m rgbx_semantic_segmentation_tpu_torch.<cli>).
"""
