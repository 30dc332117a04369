"""Scalar metrics logging: JSONL always, TensorBoard when available (the
port's own copy of rgbx_semantic_segmentation_tpu/metrics_writer.py).

Parity target: reference train.py:26,49-53,226-229,306-307 (tensorboardX
SummaryWriter on rank 0 logging train/learning_rate every 100 iters and
train/epoch_loss). Here the primary sink is an append-only JSONL file (robust,
greppable) with TensorBoard as an optional mirror via
torch.utils.tensorboard when importable.

One difference from the JAX writer: where TensorFlow is installed, the
TensorBoard mirror stays off. TensorBoard's event writer then imports
TensorFlow, and TensorFlow imports jax where jax is installed; the port
imports neither.
"""
from __future__ import annotations

import importlib.util
import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                           buffering=1)
        self._tb = None
        if use_tensorboard and importlib.util.find_spec("tensorflow") is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"ts": time.time(), "tag": tag, "value": float(value),
             "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
