"""Data parallelism of the criteria and of the Mask2Former loss on the CPU:
2 gloo ranks (parallel/launch.py), each with its half of a global batch
whose images ignore different counts of pixels, against one process on the
global batch (tests/test_torch_ddp.py's semantics: the ranks' losses add
up to the global batch's loss, and each rank's gradient is the global
loss's gradient on its rows).

Through train.make_loss_fn(cfg, world), as a rank's Trainer builds it:
every criterion of build_criterion that decomposes (11 names) and the
mask2former dict; OHEM and berHu (order statistics of the global batch)
must raise NotImplementedError naming their ROADMAP item. Then the first
train step of mit_tiny + Mask2Former over the 2 ranks against one process
(float64). Tolerances: loss rtol 1e-5, gradients 1e-4 of their tensor's
largest (a tensor whose true gradient is 0, rounding noise only: 1e-4 of
the model's largest). The ranks' function is module-level and the file
imports no JAX (the ranks import it).
"""
import re

import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from rgbx_semantic_segmentation_tpu_torch.parallel import launch
from rgbx_semantic_segmentation_tpu_torch.parallel.multihost import (
    process_batch_slice)
from rgbx_semantic_segmentation_tpu_torch.train import make_loss_fn

torch.set_num_threads(2)
WORLD, BATCH, C = 2, 8, 9
DECOMPOSING = ["BalanceLoss", "CE_Focal", "CrossEntropyLoss", "DiceCELoss",
               "DiceLoss", "FocalLoss", "FocalLoss2d", "RCELoss",
               "SigmoidFocalLoss", "TopologyAwareCE", "TopologyAwareLoss"]
ORDER_STATISTIC = ["OhemCrossEntropy", "berHuLoss"]
# Biases whose true gradient is 0: in front of a BatchNorm (per-channel
# constants it subtracts), a key projection's (softmax is shift-invariant
# along the keys), and the FFM's (tests/test_torch_ddp.py).
ZERO_GRADIENT = re.compile(
    r"channel_embed\.[34]\.bias$|channel_emb\.norm\.bias$"
    r"|k_proj\.bias$|(mask|transformer)_features\.0\.bias$"
    r"|output_convs\.\d\.0\.bias$")


def _cfg(criterion="CrossEntropyLoss", decoder="MLPDecoder"):
    """tests/test_torch_ddp.py's geometry: mit_tiny at 32x32, drop rates 0,
    global batch 8."""
    return tconfig.mfnet_config().replace(
        model=tconfig.ModelConfig(
            backbone="mit_tiny", decoder=decoder, decoder_embed_dim=64,
            use_mixed_precision=False, drop_path_rate=0.0,
            decoder_dropout_ratio=0.0),
        dataset=tconfig.DatasetConfig(num_classes=5, image_height=32,
                                      image_width=32,
                                      class_names=tuple("abcde")),
        train=tconfig.TrainConfig(batch_size=BATCH, nepochs=2,
                                  niters_per_epoch=4, warm_up_epoch=0,
                                  lr=1e-3, criterion=criterion))


def _ragged_labels(rng, shape, classes):
    """Labels whose image b ignores ~b/10 of its pixels."""
    labels = rng.randint(0, classes, shape)
    for b in range(shape[0]):
        labels[b][rng.rand(*shape[1:]) < 0.1 * b] = 255
    return labels.astype(np.int64)


def _data():
    rng = np.random.RandomState(0)
    logits = rng.randn(BATCH, 16, 12, C).astype(np.float32)
    labels = _ragged_labels(rng, (BATCH, 16, 12), C)
    for b in range(BATCH):    # a blob per image: components to count
        logits[b, 4:9, 3:8, b % C] += 3.0
    m2f = {"pred_logits": rng.randn(BATCH, 7, 6).astype(np.float32),
           "pred_masks": (4 * rng.randn(BATCH, 7, 16, 12)).astype(
               np.float32)}
    m2f_labels = _ragged_labels(rng, (BATCH, 16, 12), 5)
    batch = {"rgb": rng.randn(BATCH, 32, 32, 3).astype(np.float32),
             "modal_x": rng.randn(BATCH, 32, 32, 3).astype(np.float32),
             "label": _ragged_labels(rng, (BATCH, 32, 32), 5).astype(
                 np.int32)}
    return logits, labels, m2f, m2f_labels, batch


def _losses(world, rows):
    """{name: (this rank's loss, its gradient w.r.t. its rows)} through
    make_loss_fn(cfg, world); the mask2former entry's gradient is the
    masks'; an order-statistic criterion maps to its error's text."""
    logits, labels, m2f, m2f_labels, _ = _data()
    out = {}
    for name in DECOMPOSING:
        x = torch.from_numpy(logits[rows]).requires_grad_()
        loss = make_loss_fn(_cfg(name), world)(x, torch.from_numpy(
            labels[rows]))
        loss.backward()
        out[name] = (float(loss.detach()), x.grad.numpy().copy())
    masks = torch.from_numpy(m2f["pred_masks"][rows]).requires_grad_()
    loss = make_loss_fn(_cfg(decoder="mask2former"), world)(
        {"pred_logits": torch.from_numpy(m2f["pred_logits"][rows]),
         "pred_masks": masks}, torch.from_numpy(m2f_labels[rows]))
    loss.backward()
    out["mask2former"] = (float(loss.detach()), masks.grad.numpy().copy())
    for name in ORDER_STATISTIC:
        try:
            make_loss_fn(_cfg(name), world)
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _first_step(world, start, rows):
    """The first train step of mit_tiny + Mask2Former in float64 (dropouts
    at rate 0), built as Trainer builds it (synced BatchNorms when the
    world has a process group, then make_train_step's DDP wrapper and its
    summed all-reduce): (the step's loss, {name: gradient})."""
    from rgbx_semantic_segmentation_tpu_torch import optim
    from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
        convert_sync_batchnorm)
    from rgbx_semantic_segmentation_tpu_torch.train import make_train_step

    cfg = _cfg(decoder="mask2former")
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(start, strict=True)
    if world.distributed:
        convert_sync_batchnorm(model)
    model.double()
    for m in model.modules():
        if isinstance(m, tlayers._Stochastic):
            m.rate = 0.0
    step = make_train_step(cfg, model, optim.build_optimizer(cfg, model),
                           seed=0, world=world)
    batch = {k: v[rows].astype(np.float64) if v.dtype == np.float32
             else v[rows] for k, v in _data()[4].items()}
    loss = float(step(0, batch))
    return loss, {n: p.grad.numpy().copy()
                  for n, p in model.named_parameters()}


def _rank(world, start):
    torch.set_num_threads(1)
    rows = process_batch_slice(BATCH, world.rank, world.size)
    return {"rows": rows, "losses": _losses(world, rows),
            "step": _first_step(world, start, rows)}


@pytest.fixture(scope="module")
def start():
    return build_model(_cfg(decoder="mask2former"), device="cpu",
                       seed=0).state_dict()


@pytest.fixture(scope="module")
def ranks(start):
    return launch.spawn(_rank, list(range(WORLD)), "cpu", (start,),
                        timeout=180)


@pytest.fixture(scope="module")
def one_process(start):
    from rgbx_semantic_segmentation_tpu_torch.parallel.dist import World

    rows = slice(0, BATCH)
    world = World.solo()
    return {"losses": _losses(world, rows),
            "step": _first_step(world, start, rows)}


@pytest.mark.parametrize("name", DECOMPOSING + ["mask2former"])
def test_loss_over_ranks_is_the_global_loss(name, ranks, one_process):
    """The ranks' losses add up to the global batch's, and their gradients,
    stacked in rank order, are the global loss's gradient."""
    want, wgrad = one_process["losses"][name]
    got = sum(r["losses"][name][0] for r in ranks)
    assert got == pytest.approx(want, rel=1e-5)
    assert [r["rows"] for r in ranks] == [slice(0, 4), slice(4, 8)]
    grad = np.concatenate([r["losses"][name][1] for r in ranks], axis=0)
    np.testing.assert_allclose(grad, wgrad, rtol=0,
                               atol=1e-4 * np.abs(wgrad).max())
    # A rank's own mean (without the global counts) would differ.
    assert abs(ranks[0]["losses"][name][0] - want / WORLD) > 1e-6 * want


@pytest.mark.parametrize("name", ORDER_STATISTIC)
def test_order_statistic_criteria_raise_over_ranks(name, ranks,
                                                   one_process):
    assert one_process["losses"][name] is None
    for r in ranks:
        assert "ROADMAP M11 (order statistics" in r["losses"][name]


def test_mask2former_first_step_over_ranks(ranks, one_process):
    """The first step of mit_tiny + Mask2Former over 2 ranks (synced
    BatchNorms, the summed gradient all-reduce, the loss with the global
    counts and the global `present` classes) against one process on the
    global batch: the reported loss at rtol 1e-5, every gradient within
    1e-4 of its tensor's largest (ZERO_GRADIENT tensors of the model's
    largest). In float64: in fp32 one process alone, given the batch and
    the batch in reverse order, already differs by up to 8e-3 of a
    gradient's largest (measured; decoder FFN units near the ReLU's kink
    flip)."""
    want_loss, want = one_process["step"]
    for r in ranks:
        assert r["step"][0] == pytest.approx(want_loss, rel=1e-5)
    got = ranks[0]["step"][1]
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        scale = top if ZERO_GRADIENT.search(k) else np.abs(g).max()
        np.testing.assert_allclose(got[k], g, atol=1e-4 * scale, rtol=0,
                                   err_msg=k)
    for k in got:    # every rank holds the same gradient
        np.testing.assert_array_equal(ranks[1]["step"][1][k], got[k])
