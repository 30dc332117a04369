"""The port imports no jax, flax or optax and nothing of the JAX package
(rgbx_semantic_segmentation_tpu, not even its jax-free modules): a fresh
interpreter imports it, builds mit_tiny, runs one forward and one train
step with none of them in sys.modules, and a static scan of the package
sources and chip_smoke.py finds no such import."""
import os
import re
import subprocess
import sys

import rgbx_semantic_segmentation_tpu_torch as port

FORBIDDEN = ("jax", "flax", "optax")
_CHILD = r"""
import sys
import torch
torch.set_num_threads(2)
from rgbx_semantic_segmentation_tpu_torch.config import (
    DatasetConfig, ModelConfig, TrainConfig, mfnet_config)
from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
from rgbx_semantic_segmentation_tpu_torch.eval_cli import main  # noqa: F401
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.train import Trainer
cfg = mfnet_config().replace(
    dataset=DatasetConfig(num_classes=9, image_height=32, image_width=32),
    model=ModelConfig(backbone="mit_tiny", decoder_embed_dim=32,
                      use_mixed_precision=False),
    train=TrainConfig(batch_size=2, nepochs=1, niters_per_epoch=2,
                      warm_up_epoch=0))
model = build_model(cfg, device="cpu", seed=0)
with torch.no_grad():
    out = model(torch.zeros(1, 32, 32, 3), torch.zeros(1, 32, 32, 3))
assert out.shape == (1, 32, 32, 9), out.shape
SegEvaluator(cfg, model, device="cpu")
trainer = Trainer(cfg, device="cpu", seed=0)
batch = {"rgb": torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
         "modal_x": torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
         "label": torch.zeros(2, 32, 32, dtype=torch.uint8)}
loss = float(trainer.step(batch)["loss"])
assert loss == loss, loss
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "rgbx_semantic_segmentation_tpu"))
print("FORBIDDEN:", bad)
"""


def test_port_runs_without_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN: []" in proc.stdout, proc.stdout


def test_no_jax_import_in_sources():
    # `\b` after the JAX package's name would also match the port's own
    # `..._tpu_torch`: the name must be followed by `.` or whitespace.
    pattern = re.compile(
        r"^\s*(import|from)\s+((%s)\b|rgbx_semantic_segmentation_tpu[.\s])"
        % "|".join(FORBIDDEN), re.M)
    root = os.path.dirname(os.path.abspath(port.__file__))
    sources = [os.path.join(os.path.dirname(root), "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        sources += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    for path in sources:
        with open(path) as f:
            hits = pattern.findall(f.read())
        assert not hits, (path, hits)
    assert len(sources) >= 10
