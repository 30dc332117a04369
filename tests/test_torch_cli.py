"""The slice as a whole on the CPU: the port's train_cli -> eval_cli -e last
-> predict_cli on a synthetic MFNet-shaped dataset (mit_tiny at 32x32,
`--device cpu`), resume against an uninterrupted run, and a preemption in
the middle of an epoch (the first epoch against the JAX Trainer:
tests/test_torch_epoch_parity.py).

Tolerance: resume is the same arithmetic on the same inputs, so the final
weights, BatchNorm statistics, optimizer state and step are torch.equal.
"""
import contextlib
import dataclasses
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

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
from rgbx_semantic_segmentation_tpu_torch.train import Trainer

torch.set_num_threads(2)
TRAIN = ["--epochs", "2", "--niters", "2", "--device", "cpu"]


def small_cfg(ds):
    """mfnet with the tiny model and the synthetic dataset; the preset's
    warm-up (10 epochs) covers every step here, so the lr does not depend
    on --epochs and a resumed run can equal an uninterrupted one."""
    cfg = tconfig.mfnet_config()
    return cfg.replace(
        dataset=ds,
        model=tconfig.ModelConfig(backbone="mit_tiny", decoder_embed_dim=32,
                                  use_mixed_precision=False),
        train=dataclasses.replace(cfg.train, batch_size=2, num_workers=2),
        eval=tconfig.EvalConfig(eval_scale_array=(1.0,),
                                eval_crop_size=(32, 32)))


@contextlib.contextmanager
def cli_env(cfg, cwd):
    """The CLIs see `cfg` for any --config and write logs/ under `cwd`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "get_config", lambda name: cfg)
        mp.chdir(cwd)
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: 2 epochs, then -c to 3. Run B: 3 epochs at once. Each in its
    own working directory (logs/ under it)."""
    root = tmp_path_factory.mktemp("cli")
    ds = make_synthetic_dataset(str(root / "data"), num_train=6, num_val=3,
                                hw=(32, 32), num_classes=5, seed=3)
    cfg = small_cfg(ds)
    data = str(root / "data")
    out = {"cfg": cfg, "data": data, "root": root}
    for run in ("A", "B"):
        os.makedirs(root / run)
    with cli_env(cfg, root / "A"):
        out["A1"] = train_cli.main(["--dataset_root", data] + TRAIN)
        out["A2"] = train_cli.main(["--dataset_root", data, "-c", "--epochs",
                                    "3", "--niters", "2", "--device", "cpu"])
    with cli_env(cfg, root / "B"):
        out["B"] = train_cli.main(["--dataset_root", data, "--epochs", "3",
                                   "--niters", "2", "--device", "cpu"])
    return out


def _ckpt_dir(runs, run):
    return str(runs["root"] / run / "logs" / runs["cfg"].tag() / "checkpoint")


def test_cli_train_records_and_scalars(runs):
    assert [r["epoch"] for r in runs["A1"]] == [1, 2]
    assert [r["epoch"] for r in runs["A2"]] == [3]
    assert [r["epoch"] for r in runs["B"]] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["img_per_s"] > 0
               for r in runs["A1"] + runs["B"])
    # the cadence: the final epoch of each run (start epoch 350 is far off)
    assert CheckpointManager(_ckpt_dir(runs, "A")).all_epochs() == [2, 3]
    assert CheckpointManager(_ckpt_dir(runs, "B")).all_epochs() == [3]
    log = runs["root"] / "A" / "logs" / runs["cfg"].tag() / "metrics.jsonl"
    rows = [json.loads(line) for line in open(log)]
    tags = [(r["tag"], r["step"]) for r in rows]
    assert tags == [("train/epoch_loss", 1), ("train/learning_rate", 2),
                    ("train/epoch_loss", 2), ("train/learning_rate", 4),
                    ("train/epoch_loss", 3), ("train/learning_rate", 6)]
    lr = [r["value"] for r in rows if r["tag"] == "train/learning_rate"]
    warmup = runs["cfg"].train.warm_up_epoch * 2
    # the lr of the last update of each epoch: step 2e - 1 of the warm-up
    np.testing.assert_allclose(
        lr, [runs["cfg"].train.lr * (2 * e - 1) / warmup for e in (1, 2, 3)],
        rtol=1e-6)


def test_cli_resume_equals_uninterrupted_run(runs):
    """2 epochs then -c to 3 reaches the weights, BN statistics, optimizer
    moments and step counters, and global step of 3 epochs at once."""
    a = CheckpointManager(_ckpt_dir(runs, "A")).load(3)
    b = CheckpointManager(_ckpt_dir(runs, "B")).load(3)
    assert (a["epoch"], a["iteration"]) == (b["epoch"], b["iteration"]) == (3, 6)
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 100
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    # and it did train: epoch 2's weights differ from epoch 3's
    two = CheckpointManager(_ckpt_dir(runs, "A")).load(2)
    assert not all(torch.equal(two["model"][k], a["model"][k])
                   for k in a["model"])


def test_cli_eval_then_predict(runs):
    """eval_cli -e last: its confusion matrix is SegEvaluator.evaluate's on
    the same weights loaded in-process; predict_cli -e last writes PNGs
    equal to the eval's saved argmax maps (and the maps evaluate() makes)."""
    from PIL import Image

    cfg, data, root = runs["cfg"], runs["data"], runs["root"]
    with cli_env(cfg, root / "A"):
        res = eval_cli.main(["--dataset_root", data, "-e", "last", "-p",
                             "eval_out", "-s", "--device", "cpu"])
        names = predict_cli.main(["--dataset_root", data, "-e", "last", "-p",
                                  "pred_out", "-s", "--device", "cpu"])
    assert list(res) == ["epoch 3"]
    scores, hist = res["epoch 3"]
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(
        CheckpointManager(_ckpt_dir(runs, "A")).load(3)["model"])
    ev = SegEvaluator(cfg, model, device="cpu")
    want, _ = ev.evaluate(RGBXDataset(cfg.dataset, "val", root=data),
                          eval_batch=8)
    np.testing.assert_array_equal(hist, ev.last_hist)
    assert scores.mean_iou == want.mean_iou and hist.sum() > 0
    assert names == ["val_0000", "val_0001", "val_0002"]
    dataset = RGBXDataset(cfg.dataset, "val", root=data)
    for i, name in enumerate(names):
        a = np.asarray(Image.open(root / "A" / "pred_out" / f"{name}.png"))
        b = np.asarray(Image.open(root / "A" / "eval_out" / f"{name}.png"))
        np.testing.assert_array_equal(a, b)
        item = dataset[i]
        np.testing.assert_array_equal(
            a, ev.sliding_eval_rgbx(item["rgb"], item["modal_x"]).numpy())
        assert (root / "A" / "pred_out_color" / f"{name}.png").exists()
        assert (root / "A" / "pred_out_compare" / f"{name}.png").exists()
        assert (root / "A" / "eval_out_compare" / f"{name}.png").exists()
    log = root / "A" / "logs" / cfg.tag() / "val_last.log"
    assert "epoch 3" in log.read_text()


def test_cli_preemption_saves_and_stops_the_loader(runs, tmp_path,
                                                   monkeypatch):
    """SIGTERM during the second step: fit_epoch stops, the loader's
    generator is closed (no worker thread left), the epoch is saved and
    the signal is re-raised (recorded here instead of killing the test)."""
    cfg, data = runs["cfg"], runs["data"]
    raised = []
    monkeypatch.setattr(signal, "raise_signal", raised.append)
    real_step = Trainer.step

    def step(self, batch):
        if self.global_step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real_step(self, batch)

    monkeypatch.setattr(Trainer, "step", step)
    with cli_env(cfg, tmp_path):
        rec = train_cli.main(["--dataset_root", data, "--epochs", "1",
                              "--niters", "3", "--device", "cpu"])
    assert raised == [signal.SIGTERM]
    assert not [t for t in threading.enumerate()
                if t.name != "MainThread" and getattr(t, "_target", None)
                and t._target.__qualname__.endswith("epoch.<locals>.worker")]
    payload = CheckpointManager(str(
        tmp_path / "logs" / cfg.tag() / "checkpoint")).load(1)
    # steps 0 and 1 ran (the signal lands inside step 1), step 2 did not
    assert payload["iteration"] == 2 and rec[0]["epoch"] == 1


@pytest.mark.parametrize("cli", ["train", "eval", "predict"])
def test_clis_default_to_the_card(runs, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    main = {"train": train_cli.main, "eval": eval_cli.main,
            "predict": predict_cli.main}[cli]
    with cli_env(runs["cfg"], tmp_path):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--dataset_root", runs["data"]])


def test_cli_unported_options_raise(runs, tmp_path):
    """The 2-D meshes still raise (ROADMAP Queue 1 item 5). The
    --compat-* options now run: at scale 1.5 under a 32x40 crop the 32x32
    images take the sliding grid (swapped with --compat-stride-swap), and
    eval_cli -e last gives the confusion matrix of an in-process
    SegEvaluator with the same flag."""
    data = runs["data"]
    with cli_env(runs["cfg"], tmp_path):
        with pytest.raises(NotImplementedError, match="2-D"):
            train_cli.main(["--dataset_root", data, "--mesh", "tp:2,4",
                            "--device", "cpu"])
    cfg = runs["cfg"].replace(eval=tconfig.EvalConfig(
        eval_scale_array=(1.5,), eval_crop_size=(32, 40)))
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(
        CheckpointManager(_ckpt_dir(runs, "A")).load(3)["model"])
    dataset = RGBXDataset(cfg.dataset, "val", root=data)
    for flag in ("--compat-stride-swap", "--compat-double-normalize"):
        with cli_env(cfg, runs["root"] / "A"):
            res = eval_cli.main(["--dataset_root", data, "-e", "last",
                                 "--val_log", str(tmp_path / "val.log"),
                                 "--device", "cpu", flag])
        ev = SegEvaluator(cfg, model, device="cpu",
                          **{flag[2:].replace("-", "_"): True})
        ev.evaluate(dataset, eval_batch=8)
        np.testing.assert_array_equal(res["epoch 3"][1], ev.last_hist)
        assert ev.last_hist.sum() > 0


def test_train_cli_pst900(tmp_path):
    """train_cli --config pst900 (mit_*_w_aspp + UPernet with the aux
    FCNHead; mit_tiny widths at 32x32 on a synthetic 5-class dataset) for
    one epoch of 2 steps, then eval_cli -e last: the checkpoint carries the
    ASPP, UPerHead and aux-head tensors, the loss is finite, and the eval's
    confusion matrix is evaluate()'s on the checkpoint's weights."""
    data = str(tmp_path / "data")
    ds = make_synthetic_dataset(data, num_train=4, num_val=2, hw=(32, 32),
                                num_classes=5, seed=4)
    pst = tconfig.pst900_config()
    cfg = pst.replace(
        dataset=ds,
        model=dataclasses.replace(pst.model, backbone="mit_tiny_w_aspp",
                                  use_mixed_precision=False),
        train=dataclasses.replace(pst.train, batch_size=2, num_workers=2),
        eval=tconfig.EvalConfig(eval_scale_array=(1.0,),
                                eval_crop_size=(32, 32)))
    assert cfg.model.decoder == "UPernet"
    with cli_env(cfg, tmp_path):
        rec = train_cli.main(["--config", "pst900", "--dataset_root", data,
                              "--epochs", "1", "--niters", "2",
                              "--device", "cpu"])
        res = eval_cli.main(["--config", "pst900", "--dataset_root", data,
                             "-e", "last", "--device", "cpu"])
    assert [r["epoch"] for r in rec] == [1] and np.isfinite(rec[0]["loss"])
    sd = CheckpointManager(str(tmp_path / "logs" / cfg.tag() /
                               "checkpoint")).load(1)["model"]
    for key in ("backbone.aspp_modules.3.b4.gap.1.weight",
                "decode_head.psp_modules.3.1.weight",
                "decode_head.fpn_bottleneck.0.weight",
                "aux_head.conv.0.weight", "aux_head.classifier.bias"):
        assert key in sd, key
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(sd, strict=True)
    ev = SegEvaluator(cfg, model, device="cpu")
    ev.evaluate(RGBXDataset(cfg.dataset, "val", root=data), eval_batch=8)
    np.testing.assert_array_equal(res["epoch 1"][1], ev.last_hist)
