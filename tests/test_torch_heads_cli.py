"""The CLIs with the last two heads on the CPU: train_cli --decoder
{mask2former, MLPDecoderpp} for one epoch (mit_tiny at 32x32 on a synthetic
dataset, `--device cpu`), then eval_cli and predict_cli -e last with the
same --decoder: the checkpoint carries the head's tensors, eval_cli's
confusion matrix is SegEvaluator.evaluate's on the checkpoint's weights
(mask2former's eval output is the log of its composed probabilities, which
the evaluator's exp-and-sum takes as it takes logits), and predict_cli's
PNGs are eval_cli's argmax maps. Exact: the same arithmetic on the same
inputs."""
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch import (
    eval_cli, predict_cli, train_cli)
from rgbx_semantic_segmentation_tpu_torch.checkpoint import (
    CheckpointManager)
from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
    make_synthetic_dataset)
from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model

torch.set_num_threads(2)


@pytest.mark.parametrize("decoder,key", [
    ("mask2former", "decode_head.layers.8.ffn.3.weight"),
    ("MLPDecoderpp", "decode_head.attention.3.weight")])
def test_cli_with_decoder(tmp_path, monkeypatch, decoder, key):
    data = str(tmp_path / "data")
    ds = make_synthetic_dataset(data, num_train=4, num_val=2, hw=(32, 32),
                                num_classes=9, seed=6)
    base = tconfig.mfnet_config()
    small = base.replace(
        dataset=ds,
        model=tconfig.ModelConfig(backbone="mit_tiny", decoder_embed_dim=32,
                                  use_mixed_precision=False),
        train=dataclasses.replace(base.train, batch_size=2, num_workers=2),
        eval=tconfig.EvalConfig(eval_scale_array=(1.0,),
                                eval_crop_size=(32, 32)))
    monkeypatch.setattr(tconfig, "get_config", lambda name: small)
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset_root", data, "--decoder", decoder, "--device", "cpu"]
    rec = train_cli.main(argv + ["--epochs", "1", "--niters", "2"])
    res = eval_cli.main(argv + ["-e", "last", "-p", "eval_out"])
    names = predict_cli.main(argv + ["-e", "last", "-p", "pred_out"])
    assert [r["epoch"] for r in rec] == [1] and np.isfinite(rec[0]["loss"])
    cfg = small.replace(model=dataclasses.replace(small.model,
                                                  decoder=decoder))
    sd = CheckpointManager(str(tmp_path / "logs" / cfg.tag() /
                               "checkpoint")).load(1)["model"]
    assert key in sd
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(sd, strict=True)
    ev = SegEvaluator(cfg, model, device="cpu")
    ev.evaluate(RGBXDataset(cfg.dataset, "val", root=data), eval_batch=8)
    np.testing.assert_array_equal(res["epoch 1"][1], ev.last_hist)
    assert names == ["val_0000", "val_0001"]
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "pred_out" / f"{name}.png")),
            np.asarray(Image.open(tmp_path / "eval_out" / f"{name}.png")))
