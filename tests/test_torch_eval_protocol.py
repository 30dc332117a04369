"""The full evaluation protocol of the port (sliding window, multi-scale,
flip, the compat flags) against the JAX SegEvaluator on the CPU in fp32,
on the same weights and the same synthetic items.

The model is mit_tiny + MLPDecoder (5 classes) with JAX weights carried
over by flax_to_torch_state_dict; the crop is 48x64 (non-square, so the
swapped grid differs); items are numpy from a seed at sizes that take
every path: exact fit, one-shot with padding (36x80 at every scale),
the 4-window grid at scale 1.25 (48x64), the 6-window grid at scale 1
(100x90, 90x100). The JAX image ops run on their numpy path (the port's
are numpy).

Tolerances: each scale's exp-score canvas within 1e-5 relative of the JAX
canvas, element by element (fp32 on both sides; ~1e-6 logit differences);
argmax maps equal except at pixels whose top two summed scores lie within
1e-5 relative (counted and printed); evaluate()'s scores at eval_batch 1
and 4 equal to JAX's, and its confusion matrix equal to the one of the JAX
per-image predictions, when no such pixel differs.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import metrics as jmetrics
from rgbx_semantic_segmentation_tpu import native as jnative
from rgbx_semantic_segmentation_tpu.config import (
    DatasetConfig, EvalConfig, ModelConfig, nyu_config)
from rgbx_semantic_segmentation_tpu.data import cv_ops as jcv
from rgbx_semantic_segmentation_tpu.evaluator import SegEvaluator as JaxEvaluator
from rgbx_semantic_segmentation_tpu.evaluator import _window_grid as jgrid
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu_torch import evaluator as tev
from rgbx_semantic_segmentation_tpu_torch.convert import flax_to_torch_state_dict
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from tests.test_torch_layers import random_variables

torch.set_num_threads(2)

NUM_CLASSES = 5
CROP = (48, 64)
RTOL = 1e-5

CASES = {
    "multiscale_x1": dict(scales=(0.75, 1.0, 1.25), x=1,
                          sizes=[(36, 80), (36, 80), (48, 64), (48, 64)]),
    "multiscale_x3": dict(scales=(0.75, 1.0, 1.25), x=3,
                          sizes=[(36, 80), (36, 80), (48, 64), (48, 64)]),
    "flip": dict(scales=(1.0,), flip=True, x=1,
                 sizes=[(48, 64), (48, 64), (36, 80), (100, 90)]),
    "larger_than_crop": dict(scales=(1.0,), x=3, sizes=[(100, 90), (90, 100)]),
    "stride_swap": dict(scales=(1.0,), x=1, sizes=[(100, 90), (90, 100)],
                        compat_stride_swap=True),
    "double_normalize": dict(scales=(1.0,), x=3,
                             sizes=[(48, 64), (48, 64), (100, 90)],
                             compat_double_normalize=True),
}


@contextlib.contextmanager
def jax_numpy_ops():
    """The JAX cv_ops on their numpy path (the native library, when built,
    is 1 LSB away)."""
    saved = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = None, True
    try:
        yield
    finally:
        jnative._lib, jnative._tried = saved


def _cfg(scales=(1.0,), flip=False):
    return nyu_config().replace(
        dataset=DatasetConfig(num_classes=NUM_CLASSES,
                              class_names=tuple("abcde")),
        model=ModelConfig(backbone="mit_tiny", decoder="MLPDecoder",
                          decoder_embed_dim=32, use_mixed_precision=False),
        eval=EvalConfig(eval_scale_array=scales, eval_flip=flip,
                        eval_crop_size=CROP))


def _items(sizes, x_channels, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i, (h, w) in enumerate(sizes):
        label = rng.randint(0, NUM_CLASSES, (h, w)).astype(np.uint8)
        label[rng.rand(h, w) < 0.05] = 255
        mx_shape = (h, w) if x_channels == 1 else (h, w, 3)
        out.append({"rgb": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                    "modal_x": rng.randint(0, 256, mx_shape).astype(np.uint8),
                    "label": label, "fn": f"item{i}"})
    return out


@pytest.fixture(scope="module")
def weights():
    cfg = _cfg()
    jmod = JaxEncoderDecoder(cfg=cfg)
    x = np.zeros((1, *CROP, 3), np.float32)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, x),
                           seed=9)
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    return jmod, var, model


_JAX_EVALUATORS = {}


def _evaluators(weights, case):
    """(JAX evaluator, port evaluator) for a case; the JAX one (and its
    compiled forwards) shared by the cases of one protocol."""
    jmod, var, model = weights
    cfg = _cfg(case["scales"], case.get("flip", False))
    compat = {k: case.get(k, False) for k in ("compat_stride_swap",
                                              "compat_double_normalize")}
    key = (case["scales"], case.get("flip", False), *compat.values())
    if key not in _JAX_EVALUATORS:
        _JAX_EVALUATORS[key] = JaxEvaluator(
            cfg, lambda v, r, m, train: jmod.apply(v, r, m, train), **compat)
    return (_JAX_EVALUATORS[key],
            tev.SegEvaluator(cfg, model, device="cpu", **compat))


def _jax_scaled(jev, img, mx, s):
    """The JAX sliding_eval_rgbx's scaled, normalised pair."""
    img_s = jcv.resize_by_factor(img, s, s)
    if mx.ndim == 2:
        mx_s = np.stack([jcv.resize_by_factor(mx, s, s, nearest=True)] * 3,
                        axis=-1)
    else:
        mx_s = jcv.resize_by_factor(mx, s, s)
    return jev._normalize_pair(img_s, mx_s)


@pytest.mark.parametrize("name", sorted(CASES))
def test_protocol_matches_jax(weights, name):
    case = CASES[name]
    var = weights[1]
    items = _items(case["sizes"], case["x"])
    jev, pev = _evaluators(weights, case)
    ties = mismatched = 0
    with jax_numpy_ops():
        for item in items:
            img, mx = item["rgb"], item["modal_x"]
            total = None
            for s in case["scales"]:
                pair = pev._scaled(img, mx, s)
                for a, b in zip(pair, _jax_scaled(jev, img, mx, s)):
                    np.testing.assert_array_equal(a, b)
                want = jev._batched_windows_forward(var, *pair)
                got = pev._windows_forward(*pair).numpy()
                assert got.shape == want.shape
                np.testing.assert_array_less(
                    np.abs(got - want), RTOL * np.abs(want) + 1e-30)
                score = tev.resize_linear(torch.from_numpy(got),
                                          img.shape[:2]).numpy()
                np.testing.assert_allclose(
                    score, jcv.resize_linear(got, img.shape[:2]), rtol=1e-6,
                    atol=0)
                total = score if total is None else total + score
            top2 = np.sort(total, axis=-1)[..., -2:]
            near = top2[..., 1] - top2[..., 0] <= RTOL * top2[..., 1]
            jpred = jev.sliding_eval_rgbx(var, img, mx)
            tpred = pev.sliding_eval_rgbx(img, mx).numpy()
            assert tpred.shape == img.shape[:2]
            differ = jpred != tpred
            assert not (differ & ~near).any(), name
            ties += int(near.sum())
            mismatched += int(differ.sum())
            item["jax_pred"] = jpred
        print(f"{name}: {ties} pixels with top two scores within {RTOL} "
              f"relative, {mismatched} of them predicted differently")
        for batch in (1, 4):
            jscores, _ = jev.evaluate(var, items, eval_batch=batch)
            tscores, _ = pev.evaluate(items, eval_batch=batch)
            if mismatched == 0:
                np.testing.assert_array_equal(tscores.iou, jscores.iou)
                assert tscores[1:] == jscores[1:]
    hist = sum(jmetrics.hist_info(NUM_CLASSES, it["jax_pred"], it["label"])[0]
               for it in items)
    if mismatched == 0:
        np.testing.assert_array_equal(pev.last_hist, hist)
    else:
        assert np.abs(pev.last_hist - hist).sum() <= 2 * mismatched


@pytest.mark.parametrize("pad_hw,crop,rate", [
    ((100, 90), (48, 64), 2 / 3), ((60, 80), (48, 64), 2 / 3),
    ((600, 800), (480, 640), 2 / 3), ((900, 1200), (480, 640), 2 / 3),
    ((65, 65), (64, 64), 0.5), ((48, 64), (48, 64), 2 / 3)])
def test_window_grid_matches_jax(pad_hw, crop, rate):
    assert tev._window_grid(*pad_hw, crop, rate) == jgrid(*pad_hw, crop, rate)


def test_swapped_grid_differs_for_a_non_square_crop():
    """The original repo's rectangles are crop_h wide and crop_w tall, some
    starting at negative (wrapped) indices; for a square crop they are the
    grid's windows."""
    rects = tev._stride_swap_rects(100, 90, CROP, 2 / 3)
    grid = tev._window_grid(100, 90, CROP, 2 / 3)
    assert {(ey - ay, ex - ax) for ay, ey, ax, ex in rects} != {CROP}
    assert [(ay, ax) for ay, _, ax, _ in rects] != grid
    square = tev._stride_swap_rects(100, 90, (48, 48), 2 / 3)
    assert [(ay, ax) for ay, _, ax, _ in square] == tev._window_grid(
        100, 90, (48, 48), 2 / 3)
    assert all(ey - ay == 48 and ex - ax == 48 for ay, ey, ax, ex in square)


@pytest.mark.parametrize("shape,out_hw", [
    ((15, 20, 5), (60, 80)), ((60, 80, 5), (45, 100)), ((2, 36, 80, 5),
                                                        (48, 64))])
def test_resize_linear_matches_numpy(shape, out_hw):
    """The device resize of the canvas against cv_ops.resize_linear (numpy,
    per image): same weights, same order of operations, 1e-6 relative."""
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got = tev.resize_linear(torch.from_numpy(x), out_hw).numpy()
    with jax_numpy_ops():
        want = (np.stack([jcv.resize_linear(a, out_hw) for a in x])
                if x.ndim == 4 else jcv.resize_linear(x, out_hw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
