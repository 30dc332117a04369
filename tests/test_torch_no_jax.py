"""The port imports no jax, flax or optax and nothing of the JAX package
(rgbx_semantic_segmentation_tpu, not even its jax-free modules): a fresh
interpreter imports it, builds mit_tiny, runs one forward and one train
step, imports the window-attention op and the Swin encoder and runs a small
Swin tower forward and backward, builds mit_tinypp (IFRM/IFFM) and runs a
train step through the flash-attention op, imports the bench tools and the
offline tools (tools/: resize_images ... check_gpu) and runs resize_nearest,
builds mit_tiny_w_aspp + UPernet (ASPPs, the aux head) and runs a train
step and a multi-scale, flipped, stride-swapped sliding-window prediction,
builds mit_tiny + mask2former and runs a train step (its own loss) and an
evaluation, runs a train step under every criterion name and under LBFGS
(lbfgs.py) and SGDM with CyclicLR, runs a small Swin with the absolute
position embedding, frozen stages and remat forward and backward,
runs train_cli -> eval_cli -e last -> predict_cli on a synthetic dataset (the
threaded loader on the native image ops, checkpoints, the engine) and
train_cli -c and eval_cli over two CPU ranks (parallel/: the launcher, the
process group, the synced BatchNorm) and train_cli -c on the data x spatial
mesh 2d:1,2 (parallel/spatial.py) and on the data x model mesh tp:1,2
(parallel/tensor.py), with none of them in sys.modules, and a
static scan of the package sources (the CUDA and C++ sources too) and
chip_smoke.py finds no such import."""
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
from rgbx_semantic_segmentation_tpu_torch.models.encoders import dual_swin
from rgbx_semantic_segmentation_tpu_torch.ops import window_attention
swin = dual_swin.DualSwinTransformer(
    embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 2, 4),
    attn_drop_rate=0.3, use_pallas=True).train()
outs = swin(torch.zeros(1, 3, 64, 64), torch.zeros(1, 3, 64, 64))
assert [o.shape[1] for o in outs] == [16, 32, 64, 128], outs
assert all(torch.isfinite(o).all() for o in outs)
sum(o.sum() for o in outs).backward()
grads = [p.grad for p in swin.parameters() if p.grad is not None]
assert grads and all(torch.isfinite(g).all() for g in grads)
assert window_attention.window_attention.launches == 0
swin = dual_swin.DualSwinTransformer(
    embed_dim=16, depths=(1, 1), num_heads=(1, 2), out_indices=(0, 1),
    pretrain_img_size=64, ape=True, frozen_stages=2, remat=True,
    attn_drop_rate=0.3, drop_path_rate=0.2, use_pallas=True).train()
outs = swin(torch.zeros(1, 3, 56, 56), torch.zeros(1, 3, 56, 56))
sum(o.sum() for o in outs).backward()
assert swin.absolute_pos_embed.grad is None
assert swin.layers[1].blocks[0].attn.qkv.weight.grad is not None
import dataclasses
from rgbx_semantic_segmentation_tpu_torch.lbfgs import LBFGS
for opt_name, policy in (("LBFGS", "WarmUpPolyLR"), ("SGDM", "CyclicLR")):
    named = cfg.replace(train=dataclasses.replace(
        cfg.train, optimizer=opt_name, lr_policy=policy, lr=1e-2))
    trainer = Trainer(named, device="cpu", seed=0)
    loss = float(trainer.step(batch)["loss"])
    assert loss == loss, (opt_name, loss)
assert isinstance(trainer.optimizer, torch.optim.SGD)
from rgbx_semantic_segmentation_tpu_torch.ops import flash_attention
from rgbx_semantic_segmentation_tpu_torch.tools import (  # noqa: F401
    bench_flash_attention, bench_input, bench_sr_attention,
    bench_window_attention, check_gpu, check_labels, clean_logs,
    compare_labels, copy_split, fetch_mfnet, resize_images, split_rgbt,
    visualize_labels)
from rgbx_semantic_segmentation_tpu_torch.ops.resize import resize_nearest
assert resize_nearest(torch.zeros(1, 4, 6, dtype=torch.uint8),
                      (2, 3)).shape == (1, 2, 3)
cfg_pp = cfg.replace(
    dataset=DatasetConfig(num_classes=9, image_height=160, image_width=128),
    model=dataclasses.replace(cfg.model, backbone="mit_tinypp",
                              use_pallas_kernels=True))
trainer = Trainer(cfg_pp, device="cpu", seed=0)
calls = []
plain_forward = flash_attention._forward
flash_attention._forward = lambda *a: calls.append(a[0].shape) or plain_forward(*a)
batch = {"rgb": torch.zeros(2, 160, 128, 3, dtype=torch.uint8),
         "modal_x": torch.zeros(2, 160, 128, 3, dtype=torch.uint8),
         "label": torch.zeros(2, 160, 128, dtype=torch.uint8)}
loss = float(trainer.step(batch)["loss"])
assert loss == loss, loss
assert calls == [(2, 1, 1280, 32)] * 2, calls
assert flash_attention.flash_attention.launches == 0
cfg_pst = cfg.replace(
    dataset=DatasetConfig(num_classes=5, image_height=32, image_width=32),
    model=dataclasses.replace(cfg.model, backbone="mit_tiny_w_aspp",
                              decoder="UPernet"),
    eval=dataclasses.replace(cfg.eval, eval_scale_array=(0.75, 1.0, 1.25),
                             eval_flip=True, eval_crop_size=(32, 32)))
trainer = Trainer(cfg_pst, device="cpu", seed=0)
batch = {"rgb": torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
         "modal_x": torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
         "label": torch.zeros(2, 32, 32, dtype=torch.uint8)}
loss = float(trainer.step(batch)["loss"])
assert loss == loss, loss
import numpy as np
pred = SegEvaluator(cfg_pst, trainer.model.eval(), device="cpu",
                    compat_stride_swap=True).sliding_eval_rgbx(
    np.zeros((40, 48, 3), np.uint8), np.zeros((40, 48), np.uint8))
assert pred.shape == (40, 48), pred.shape
cfg_m2f = cfg.replace(
    model=dataclasses.replace(cfg.model, decoder="mask2former"),
    eval=dataclasses.replace(cfg.eval, eval_crop_size=(32, 32)))
trainer = Trainer(cfg_m2f, device="cpu", seed=0)
batch = {"rgb": torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
         "modal_x": torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
         "label": torch.ones(2, 32, 32, dtype=torch.uint8)}
loss = float(trainer.step(batch)["loss"])
assert loss == loss and loss > 0, loss
items = [{"rgb": np.zeros((32, 32, 3), np.uint8),
          "modal_x": np.zeros((32, 32), np.uint8),
          "label": np.ones((32, 32), np.uint8)}] * 2
scores, line = SegEvaluator(cfg_m2f, trainer.model.eval(),
                            device="cpu").evaluate(items, eval_batch=2)
assert "mean_IoU" in line, line
criteria = ("CrossEntropyLoss", "FocalLoss", "SigmoidFocalLoss", "DiceLoss",
            "DiceCELoss", "RCELoss", "BalanceLoss", "FocalLoss2d",
            "OhemCrossEntropy", "berHuLoss", "CE_Focal", "TopologyAwareLoss",
            "TopologyAwareCE")
for name in criteria:
    named = cfg.replace(train=dataclasses.replace(cfg.train, criterion=name))
    loss = float(Trainer(named, device="cpu", seed=0).step(batch)["loss"])
    assert loss == loss, (name, loss)
import os
import tempfile
from rgbx_semantic_segmentation_tpu_torch import (
    config, eval_cli, predict_cli, train_cli)
from rgbx_semantic_segmentation_tpu_torch.data import transforms  # noqa: F401
from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
    make_synthetic_dataset)
with tempfile.TemporaryDirectory() as tmp:
    ds = make_synthetic_dataset(os.path.join(tmp, "d"), num_train=2,
                                num_val=1, hw=(32, 32), num_classes=9)
    small = cfg.replace(dataset=ds, log_dir=os.path.join(tmp, "logs"),
                        eval=dataclasses.replace(cfg.eval,
                                                 eval_crop_size=(32, 32)))
    config.get_config = lambda name: small
    root = ["--dataset_root", ds.dataset_path, "--device", "cpu"]
    rec = train_cli.main(root + ["--epochs", "1", "--niters", "1"])
    assert rec[0]["epoch"] == 1, rec
    res = eval_cli.main(root + ["-e", "last"])
    assert list(res) == ["epoch 1"], res
    assert predict_cli.main(root + ["-p", os.path.join(tmp, "p")]) == [
        "val_0000"]
    # parallel/: two gloo ranks (the launcher, the process group, the
    # synced BatchNorm, the summed comm hook) through train_cli and eval_cli
    rec = train_cli.main(root + ["--epochs", "2", "-c", "-d", "0,1"])
    assert rec[0]["epoch"] == 2, rec
    res2 = eval_cli.main(root + ["-e", "last", "-d", "0,1"])
    assert list(res2) == ["epoch 2"], res2
    rec = train_cli.main(root + ["--epochs", "3", "-c", "-d", "0,1",
                                 "--mesh", "2d:1,2"])
    assert rec[0]["epoch"] == 3, rec
    rec = train_cli.main(root + ["--epochs", "4", "-c", "-d", "0,1",
                                 "--mesh", "tp:1,2"])
    assert rec[0]["epoch"] == 4, rec
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
        sources += [os.path.join(dirpath, n) for n in files
                    if n.endswith((".py", ".cu", ".cuh", ".cpp"))]
    for path in sources:
        with open(path) as f:
            hits = pattern.findall(f.read())
        assert not hits, (path, hits)
    names = {os.path.relpath(p, root) for p in sources}
    assert {"ops/window_attention.py", "models/encoders/dual_swin.py",
            "csrc/window_attention_fwd.cu", "csrc/window_attention_bwd.cu",
            "csrc/attention_common.cuh", "ops/flash_attention.py",
            "tools/bench_flash_attention.py", "csrc/flash_attention_fwd.cu",
            "csrc/flash_attention_bwd.cu",
            "csrc/flash_attention_common.cuh", "native/cv_ops.cpp",
            "native/cv_ops.py", "data/loader.py", "data/preprocess.py",
            "data/transforms.py", "data/synthetic.py", "checkpoint.py",
            "engine.py", "train_cli.py", "eval_cli.py", "predict_cli.py",
            "metrics_writer.py", "visualize.py", "utils/fs.py",
            "models/encoders/aspp.py", "models/decoders/fcnhead.py",
            "models/decoders/upernet.py", "models/decoders/deeplabv3plus.py",
            "ops/resize.py", "evaluator.py", "parallel/dist.py",
            "parallel/spatial.py", "parallel/tensor.py",
            "parallel/launch.py", "parallel/sync_bn.py",
            "parallel/multihost.py", "models/decoders/mask2former.py",
            "models/decoders/mlp_decoderpp.py", "losses.py",
            "lbfgs.py", "optim.py", "lr_schedules.py"} <= names
    assert {f"tools/{n}.py" for n in (
        "bench_input", "check_gpu", "check_labels", "clean_logs",
        "compare_labels", "copy_split", "fetch_mfnet", "resize_images",
        "split_rgbt", "visualize_labels")} <= names
    assert len(sources) >= 10
