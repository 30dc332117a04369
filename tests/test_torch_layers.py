"""Port modules against their JAX counterparts, one by one, on the CPU in
fp32: Mix-FFN, SR attention, Block, OverlapPatchEmbed, FRM, CrossAttention /
CrossPath, FFM (eval-mode BN) and MLPDecoder.

Weights are made with numpy from a seed on the JAX module's own variable
tree (jax.eval_shape of its init), carried to the port with
flax_to_torch_state_dict and loaded strictly, so every parameter and BN
statistic is non-trivial and both sides hold the same values. The helpers
here are shared by the other test_torch_* files.

Tolerance: atol 1e-4 at O(1) activations. Both sides compute in fp32 with
the same formulas; what differs is summation order (XLA vs ATen) and the
LayerNorm variance form (flax E[x^2]-E[x]^2 vs torch two-pass), each ~1e-6
relative per op, compounded over a few ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu.models import fusion as jfusion
from rgbx_semantic_segmentation_tpu.models.decoders import mlp_decoder as jdec
from rgbx_semantic_segmentation_tpu.models.encoders import dual_segformer as jseg
from rgbx_semantic_segmentation_tpu_torch.convert import flax_to_torch_state_dict
from rgbx_semantic_segmentation_tpu_torch.models import fusion as tfusion
from rgbx_semantic_segmentation_tpu_torch.models.decoders import (
    mlp_decoder as tdec)
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_segformer as tseg)

torch.set_num_threads(2)
ATOL = 1e-4


def random_variables(init_fn, seed: int = 0):
    """numpy variables shaped like `init_fn()`'s output tree: kernels
    ~ N(0, 1/fan_in), biases and norm offsets small, norm scales near 1,
    BN running means near 0 and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.RandomState(seed)

    def fill(tree, coll):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf, coll)
                continue
            shape = leaf.shape
            if coll == "batch_stats":
                val = (rng.uniform(0.5, 1.5, shape) if name == "var"
                       else 0.1 * rng.randn(*shape))
            elif name == "kernel":
                val = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            elif name == "scale":
                val = 1.0 + 0.1 * rng.randn(*shape)
            else:
                val = 0.05 * rng.randn(*shape)
            out[name] = np.asarray(val, np.float32)  # 0-d leaves too
        return out

    return {coll: fill(tree, coll) for coll, tree in shapes.items()}


def port_module(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    return module.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("gelu_approximate", [True, False])
def test_mlp_matches_jax(gelu_approximate):
    H = W = 8
    x = _randn(0, 2, H * W, 32)
    jmod = jseg.Mlp(32, 128, gelu_approximate=gelu_approximate)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, H, W))
    ref = np.asarray(jmod.apply(var, x, H, W))
    tmod = port_module(tseg.Mlp(32, 128, gelu_approximate=gelu_approximate),
                       var)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), H, W).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("sr_ratio", [8, 2, 1])
def test_attention_matches_jax(sr_ratio):
    H, W, C = 16, 24, 64
    x = _randn(1, 2, H * W, C)
    jmod = jseg.Attention(C, num_heads=2, qkv_bias=True, sr_ratio=sr_ratio)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, H, W))
    ref = np.asarray(jmod.apply(var, x, H, W))
    tmod = port_module(tseg.Attention(C, num_heads=2, qkv_bias=True,
                                      sr_ratio=sr_ratio, use_pallas=True), var)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), H, W).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("gelu_approximate", [True, False])
def test_block_matches_jax(gelu_approximate):
    H, W, C = 8, 8, 32
    x = _randn(2, 2, H * W, C)
    jmod = jseg.Block(C, num_heads=1, qkv_bias=True, sr_ratio=2,
                      gelu_approximate=gelu_approximate)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, H, W))
    ref = np.asarray(jmod.apply(var, x, H, W))
    tmod = port_module(tseg.Block(C, num_heads=1, qkv_bias=True, sr_ratio=2,
                                  use_pallas=True,
                                  gelu_approximate=gelu_approximate), var)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), H, W).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("patch,stride,cin", [(7, 4, 3), (3, 2, 32)])
def test_patch_embed_matches_jax(patch, stride, cin):
    x = _randn(3, 2, 30, 22, cin)
    jmod = jseg.OverlapPatchEmbed(patch, stride, 48)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x))
    ref, H, W = jmod.apply(var, x)
    tmod = port_module(tseg.OverlapPatchEmbed(patch, stride, cin, 48), var)
    with torch.no_grad():
        got, tH, tW = tmod(nchw(x))
    assert (tH, tW) == (H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_frm_matches_jax():
    x1, x2 = _randn(4, 2, 6, 5, 32), _randn(5, 2, 6, 5, 32)
    jmod = jfusion.FeatureRectifyModule(32)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x1, x2))
    r1, r2 = jmod.apply(var, x1, x2)
    tmod = port_module(tfusion.FeatureRectifyModule(32), var)
    with torch.no_grad():
        g1, g2 = tmod(nchw(x1), nchw(x2))
    np.testing.assert_allclose(nhwc(g1), np.asarray(r1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(nhwc(g2), np.asarray(r2), atol=ATOL, rtol=0)


@pytest.mark.parametrize("which", ["CrossAttention", "CrossPath"])
def test_cross_matches_jax(which):
    x1, x2 = _randn(6, 2, 40, 64), _randn(7, 2, 40, 64)
    jmod = getattr(jfusion, which)(64, num_heads=2)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x1, x2))
    r1, r2 = jmod.apply(var, x1, x2)
    tmod = port_module(getattr(tfusion, which)(64, num_heads=2), var)
    with torch.no_grad():
        g1, g2 = tmod(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(g1.numpy(), np.asarray(r1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(g2.numpy(), np.asarray(r2), atol=ATOL, rtol=0)


def test_ffm_matches_jax():
    x1, x2 = _randn(8, 2, 6, 5, 32), _randn(9, 2, 6, 5, 32)
    jmod = jfusion.FeatureFusionModule(32, num_heads=2)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x1, x2))
    ref = jmod.apply(var, x1, x2)  # train=False: BN on running stats
    tmod = port_module(tfusion.FeatureFusionModule(32, num_heads=2), var)
    with torch.no_grad():
        got = tmod(nchw(x1), nchw(x2))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL, rtol=0)


def test_mlp_decoder_matches_jax():
    chans = (32, 64, 160, 256)
    feats = [_randn(10 + i, 2, 16 >> i, 12 >> i, c)
             for i, c in enumerate(chans)]
    jmod = jdec.MLPDecoder(num_classes=9, embed_dim=64, bn_eps=1e-3)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), feats))
    ref = jmod.apply(var, feats)
    tmod = port_module(tdec.MLPDecoder(chans, 9, embed_dim=64, bn_eps=1e-3),
                       var)
    with torch.no_grad():
        got = tmod([nchw(f) for f in feats])
    assert got.shape == (2, 9, 16, 12)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL, rtol=0)


def test_port_keys_match_jax_tree():
    """flax_to_torch_state_dict keys are exactly the port module's keys
    (checked here on the FFM, whose tree holds indexed Sequential members,
    conv and dense kernels, and BN statistics)."""
    x = _randn(0, 1, 4, 4, 32)
    jmod = jfusion.FeatureFusionModule(32, num_heads=2)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, x))
    sd = flax_to_torch_state_dict(var)
    assert set(sd) == set(tfusion.FeatureFusionModule(32, num_heads=2).state_dict())
    assert sd["channel_emb.channel_embed.1.weight"].shape == (32, 1, 3, 3)
    assert jnp.asarray(var["params"]["cross"]["channel_proj1"]["kernel"]).shape \
        == tuple(sd["cross.channel_proj1.weight"].shape[::-1])
