"""The slice as a whole on the CPU: the port's SegEvaluator against the JAX
SegEvaluator on a synthetic MFNet-shaped dataset (exact-fit single-scale
crop, batched whole-image path), with the same weights; and the port's
metrics against the JAX metrics.

Tolerances: pixel-level prediction agreement > 0.999 and mIoU within 0.5
points (fp32 both sides; a near-tied pixel may flip on ~1e-6 logit
differences). The metrics on an identical confusion matrix are exact.
"""
import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import metrics as jmetrics
from rgbx_semantic_segmentation_tpu.config import (
    EvalConfig, ModelConfig, mfnet_config)
from rgbx_semantic_segmentation_tpu.data.dataset import RGBXDataset
from rgbx_semantic_segmentation_tpu.data.synthetic import make_synthetic_dataset
from rgbx_semantic_segmentation_tpu.evaluator import SegEvaluator as JaxEvaluator
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch import eval_cli
from rgbx_semantic_segmentation_tpu_torch import metrics as tmetrics
from rgbx_semantic_segmentation_tpu_torch.convert import flax_to_torch_state_dict
from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from tests.test_torch_layers import random_variables

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval")
    ds_cfg = make_synthetic_dataset(str(root), num_train=1, num_val=8,
                                    hw=(64, 64), num_classes=9, seed=5)
    cfg = mfnet_config().replace(
        dataset=ds_cfg,
        model=ModelConfig(backbone="mit_tiny", decoder="MLPDecoder",
                          decoder_embed_dim=64, use_mixed_precision=False),
        eval=EvalConfig(eval_scale_array=(1.0,), eval_flip=False,
                        eval_crop_size=(64, 64)))
    dataset = RGBXDataset(ds_cfg, "val")
    jmod = JaxEncoderDecoder(cfg=cfg)
    x = np.zeros((1, 64, 64, 3), np.float32)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, x),
                           seed=7)
    jev = JaxEvaluator(cfg, lambda v, r, m, train: jmod.apply(v, r, m, train))
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    return cfg, dataset, var, jev, SegEvaluator(cfg, model, device="cpu")


@pytest.mark.parametrize("with_weights", [True, False])
def test_eval_cli_main(setup, tmp_path, monkeypatch, capsys, with_weights):
    """`eval_cli.main` end to end on the synthetic dataset: config lookup,
    the weights file (strict load) or seeded init, RGBXDataset, evaluate().
    The config is the small one of this file; the printed mIoU line must be
    the one evaluate() gives for the same weights."""
    cfg, _, _, _, tev = setup
    monkeypatch.setattr(tconfig, "get_config", lambda name: cfg)
    argv = ["--config", "mfnet", "--dataset_root", cfg.dataset.dataset_path,
            "--eval_batch", "4", "--device", "cpu"]
    if with_weights:
        weights = tmp_path / "model.pt"
        torch.save(tev.model.state_dict(), weights)
        argv += ["--weights", str(weights)]
        model = tev.model
    else:
        model = build_model(cfg, device="cpu", seed=0)
    _, want = SegEvaluator(cfg, model, device="cpu").evaluate(
        RGBXDataset(cfg.dataset, "val"), eval_batch=4)
    eval_cli.main(argv)
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1] == want.splitlines()[-1]
    assert "mean_IoU" in "\n".join(printed)


def test_evaluate_matches_jax(setup):
    cfg, dataset, var, jev, tev = setup
    jscores, _ = jev.evaluate(var, dataset, eval_batch=4)
    tscores, line = tev.evaluate(dataset, eval_batch=4)
    assert abs(tscores.mean_iou - jscores.mean_iou) * 100 < 0.5
    assert abs(tscores.pixel_acc - jscores.pixel_acc) * 100 < 0.5
    assert "mean_IoU" in line
    agree, total = 0, 0
    for i in range(0, len(dataset), 4):
        group = [dataset[j] for j in range(i, i + 4)]
        jp = np.stack(jev._batched_whole_image(var, group))
        tp = tev._batched_whole_image(group).numpy()
        agree += (jp == tp).sum()
        total += jp.size
    assert agree / total > 0.999


def test_one_shot_per_image_matches_batched(setup):
    _, dataset, _, _, tev = setup
    item = dataset[0]
    single = tev.sliding_eval_rgbx(item["rgb"], item["modal_x"])
    batched = tev._batched_whole_image([item, dataset[1]])[0]
    assert torch.equal(single, batched)


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    n = 9
    gt = rng.randint(0, n, (2, 32, 40)).astype(np.uint8)
    gt[rng.rand(*gt.shape) < 0.05] = 255
    pred = np.where(rng.rand(*gt.shape) < 0.7, gt % n,
                    rng.randint(0, n, gt.shape))
    jh, jl, jc = jmetrics.hist_info(n, pred, gt)
    th, tl, tc = tmetrics.hist_info(n, torch.from_numpy(pred),
                                    torch.from_numpy(gt))
    np.testing.assert_array_equal(th.numpy(), jh)
    assert (tl.item(), tc.item()) == (jl, jc)
    js = jmetrics.compute_score(jh, jc, jl)
    ts = tmetrics.compute_score(th.numpy(), tc.item(), tl.item())
    np.testing.assert_array_equal(ts.iou, js.iou)
    assert ts[1:] == js[1:]
    names = [f"c{i}" for i in range(n)]
    for no_back in (False, True):
        assert (tmetrics.print_iou(ts, names, no_back)
                == jmetrics.print_iou(js, names, no_back))


def test_unported_protocols_raise(setup):
    cfg, dataset, _, _, tev = setup
    with pytest.raises(NotImplementedError, match="M6"):
        SegEvaluator(cfg.replace(eval=EvalConfig(eval_scale_array=(0.75, 1.0))),
                     tev.model, device="cpu")
    with pytest.raises(NotImplementedError, match="M6"):
        big = np.zeros((96, 96, 3), np.uint8)
        tev.sliding_eval_rgbx(big, big)
