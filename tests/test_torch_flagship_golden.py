"""The flagship at its own geometry: the port against the JAX package with
CMX mit_b2 + MLPDecoder, the mfnet preset (9 classes), 480x640, batch 1,
fp32, exact (erf) GELU on both sides, on the CPU. The JAX model runs its
plain attention path (use_pallas_kernels=False); the port runs its kernel
route, which on CPU tensors is the kernels' plain versions. Both hold the
same seeded weights (tests/test_torch_layers.random_variables on the JAX
tree, carried over by convert.flax_to_torch_state_dict).

Asserted:
  * the logits of one seeded input pair within LOGIT_RTOL of the logits'
    largest magnitude, and argmax agreement >= ARGMAX_AGREE;
  * both packages' whole-image evaluate() on two synthetic 480x640 images
    (the preset's protocol: scale 1, no flip, one 480x640 crop): their
    confusion matrices differ by at most 2 counts for each labelled pixel
    whose prediction differs between the packages (a pixel that flips
    moves one count out of one cell and into another), and such pixels
    are at most 1 - ARGMAX_AGREE of the labelled ones.

LOGIT_RTOL: measured 2.4e-6 of the largest logit (5.4e-6 absolute, |logit|
up to 2.25) on this file's input pair: fp32 summation orders and the
LayerNorm variances of the 2 x 16 transformer blocks of the towers, the
fusion modules, the decoder and the 4x upsample. The bound is 10x the
reading, inside the 1e-5 to 2e-3 range of the smaller CPU forwards. The
evaluation read 2 of 602,375 labelled pixels predicted differently and
confusion matrices 4 counts apart. The file takes ~61 s on one worker
(30 s the evaluation test alone; most of it the JAX compiles at this
size), beyond the 30 s criterion of pytest.ini, so it is marked slow here.
"""
import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import evaluator as jevaluator
from rgbx_semantic_segmentation_tpu.config import ModelConfig, mfnet_config
from rgbx_semantic_segmentation_tpu.data.dataset import (
    RGBXDataset as JaxDataset)
from rgbx_semantic_segmentation_tpu.data.synthetic import make_synthetic_dataset
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch.convert import flax_to_torch_state_dict
from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from tests.test_torch_layers import random_variables

pytestmark = pytest.mark.slow

torch.set_num_threads(2)

HW = (480, 640)
LOGIT_RTOL = 2.5e-5
ARGMAX_AGREE = 0.999


def _model_cfg(use_pallas):
    return ModelConfig(backbone="mit_b2", decoder="MLPDecoder",
                       use_mixed_precision=False, gelu_approximate=False,
                       use_pallas_kernels=use_pallas)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    root = tmp_path_factory.mktemp("flagship")
    ds_cfg = make_synthetic_dataset(str(root), num_train=1, num_val=2, hw=HW,
                                    num_classes=9, seed=3)
    jcfg = mfnet_config().replace(dataset=ds_cfg, model=_model_cfg(False))
    assert jcfg.eval.eval_crop_size == HW and jcfg.eval.eval_scale_array == (
        1.0,)
    tcfg = tconfig.mfnet_config().replace(
        dataset=tconfig.DatasetConfig(**vars(ds_cfg)), model=tconfig.ModelConfig(
            **vars(_model_cfg(True))))
    jmod = JaxEncoderDecoder(cfg=jcfg)
    x = np.zeros((1,) + HW + (3,), np.float32)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, x),
                           seed=16)
    model = build_model(tcfg, device="cpu", seed=None)
    model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    return jcfg, tcfg, jmod, var, model.eval()


def test_flagship_logits_match_jax(flagship):
    _, _, jmod, var, model = flagship
    rng = np.random.RandomState(17)
    rgb, mx = (rng.randn(1, *HW, 3).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax.jit(jmod.apply)(var, rgb, mx))
    with torch.no_grad():
        got = model(torch.from_numpy(rgb), torch.from_numpy(mx)).numpy()
    assert got.shape == ref.shape == (1,) + HW + (9,)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
    print(f"flagship logits: max |port - JAX| {err:.3e} = "
          f"{err / scale:.3e} of max |logit| {scale:.3f}; argmax agreement "
          f"{agree:.6f}")
    assert err <= LOGIT_RTOL * scale
    assert agree >= ARGMAX_AGREE


def test_flagship_evaluate_matches_jax(flagship, monkeypatch):
    jcfg, tcfg, jmod, var, model = flagship
    jdata = JaxDataset(jcfg.dataset, "val")
    tdata = RGBXDataset(tcfg.dataset, "val")
    assert len(jdata) == len(tdata) == 2
    for i in range(2):
        for key in ("rgb", "modal_x", "label"):
            np.testing.assert_array_equal(tdata[i][key], jdata[i][key])
    # The JAX evaluator keeps no confusion matrix: take the one it scores.
    hists = []
    score = jevaluator.metrics_lib.compute_score
    monkeypatch.setattr(jevaluator.metrics_lib, "compute_score",
                        lambda h, c, n: hists.append(np.array(h))
                        or score(h, c, n))
    jev = jevaluator.SegEvaluator(
        jcfg, lambda v, r, m, train: jmod.apply(v, r, m, train))
    jev.evaluate(var, jdata, eval_batch=2)
    tev = SegEvaluator(tcfg, model, device="cpu")
    tev.evaluate(tdata, eval_batch=2)
    jhist, thist = hists[-1], tev.last_hist
    group = [jdata[0], jdata[1]]
    jpred = np.stack(jev._batched_whole_image(var, group))
    tpred = tev._batched_whole_image([tdata[0], tdata[1]]).numpy()
    labels = np.stack([it["label"] for it in group])
    labelled = labels < jcfg.dataset.num_classes
    flipped = int(((jpred != tpred) & labelled).sum())
    moved = int(np.abs(thist - jhist).sum())
    print(f"flagship evaluate(): {int(labelled.sum())} labelled pixels, "
          f"{flipped} predicted differently, confusion matrices "
          f"{moved} counts apart")
    assert jhist.sum() == thist.sum() == labelled.sum()
    assert moved <= 2 * flipped
    assert flipped <= (1 - ARGMAX_AGREE) * labelled.sum()
