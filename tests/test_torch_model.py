"""The whole port model against the JAX EncoderDecoder on the CPU in fp32,
the state-dict conversion in both directions, and the flagship (mit_b2 +
MLPDecoder) parameter count.

Weights: numpy from a seed on the JAX model's variable tree (see
test_torch_layers.random_variables), carried over with
flax_to_torch_state_dict.

Tolerance: logits atol 2e-3 (fp32 both sides; summation-order and
LayerNorm-variance differences of ~1e-6 relative per op, compounded through
~40 layers of both towers, the decoder and the upsample) and argmax
agreement > 0.999.
"""
import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rgbx_semantic_segmentation_tpu import convert as jconvert
from rgbx_semantic_segmentation_tpu.config import (
    DatasetConfig, ModelConfig, mfnet_config)
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu_torch.convert import flax_to_torch_state_dict
from rgbx_semantic_segmentation_tpu_torch.models.builder import (
    EncoderDecoder, build_model)
from tests.test_torch_layers import random_variables

torch.set_num_threads(2)


def _cfg(backbone):
    return mfnet_config().replace(
        dataset=DatasetConfig(num_classes=9, image_height=64, image_width=64),
        model=ModelConfig(backbone=backbone, decoder="MLPDecoder",
                          decoder_embed_dim=64, use_mixed_precision=False))


def _pair(seed, b=2, hw=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hw, hw, 3).astype(np.float32),
            rng.randn(b, hw, hw, 3).astype(np.float32))


def _jax_model_and_vars(cfg, rgb, mx, seed=0):
    jmod = JaxEncoderDecoder(cfg=cfg)
    var = random_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), rgb, mx), seed=seed)
    return jmod, var


@pytest.mark.parametrize("backbone", ["mit_tiny", "mit_b0"])
def test_whole_model_matches_jax(backbone):
    cfg = _cfg(backbone)
    rgb, mx = _pair(1)
    jmod, var = _jax_model_and_vars(cfg, rgb, mx)
    ref = np.asarray(jax.jit(jmod.apply)(var, rgb, mx))
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(rgb), torch.from_numpy(mx)).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 9)
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.999


def test_state_dict_round_trip():
    """JAX tree -> port (strict: no missing or unexpected keys) -> port
    state_dict -> JAX convert.torch_to_flax_variables -> merge_variables
    (strict) reproduces the JAX tree exactly."""
    cfg = _cfg("mit_tiny")
    rgb, mx = _pair(2, b=1, hw=32)
    jmod, var = _jax_model_and_vars(cfg, rgb, mx, seed=3)
    model = build_model(cfg, device="cpu", seed=None)
    res = model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    back = jconvert.torch_to_flax_variables(model.state_dict())
    assert jconvert.missing_leaves(var, back) == []
    merged = jconvert.merge_variables(var, back, strict=True)
    want, got = flatten_dict(var), flatten_dict(merged)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg="/".join(k))


def test_flagship_parameter_count_matches_jax():
    """mfnet_config(): CMX mit_b2 + MLPDecoder, 9 classes, at full width."""
    cfg = mfnet_config()
    x = np.zeros((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(
        lambda: JaxEncoderDecoder(cfg=cfg).init(jax.random.PRNGKey(0), x, x))
    n_jax = sum(int(np.prod(v.shape))
                for v in jax.tree_util.tree_leaves(shapes["params"]))
    model = build_model(cfg, device="cpu", seed=None)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    n_stats = sum(int(np.prod(v.shape))
                  for v in jax.tree_util.tree_leaves(shapes["batch_stats"]))
    assert sum(b.numel() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var"))) == n_stats


def test_unported_names_raise():
    """Every name of the JAX registry builds now (the SegNeXt and ResNet
    backbones: tests/test_torch_segnext.py, tests/test_torch_resnet.py);
    the ASPP variants and the UPernet head build (tests/test_torch_heads.py),
    and so do the MLPDecoderpp and mask2former heads on the flagship's
    mit_b2, with the JAX model's parameter count (by eval_shape); a name
    outside the registry raises KeyError."""
    cfg = mfnet_config().replace(model=ModelConfig(backbone="segnext_xl"))
    with pytest.raises(KeyError, match="unknown backbone"):
        build_model(cfg, device="cpu", seed=None)
    x = np.zeros((1, 64, 64, 3), np.float32)
    for decoder in ("MLPDecoderpp", "mask2former"):
        cfg = mfnet_config().replace(model=ModelConfig(decoder=decoder))
        with torch.device("meta"):
            model = EncoderDecoder(cfg)
        shapes = jax.eval_shape(lambda: JaxEncoderDecoder(cfg=cfg).init(
            jax.random.PRNGKey(0), x, x))
        assert sum(p.numel() for p in model.parameters()) == sum(
            int(np.prod(v.shape))
            for v in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        for backbone, decoder in (("mit_b2_w_aspp", "UPernet"),
                                  ("mit_b2_w_ef_aspp", "MLPDecoder")):
            cfg = mfnet_config().replace(
                model=ModelConfig(backbone=backbone, decoder=decoder))
            model = EncoderDecoder(cfg)
            assert (model.aux_head is not None) == (decoder == "UPernet")
