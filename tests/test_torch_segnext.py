"""The port's dual SegNeXt encoder (models/encoders/dual_segnext.py) against
the JAX package on the CPU: MSCA (its non-square depthwise kernels carried
HWIO -> OIHW), the SegNextBlock in eval and train mode, a narrow encoder
whose first stage is a long-kv IFFM at d = 4 (the padded flash route with
the kernels on, its chunked plain version with them off), the parameter
count of every SegNeXt registry name, build_model's settings, the
weight-decay mask on the new names, the pretrained loader and the synced
BatchNorm conversion.

Weights: numpy from a seed on the JAX module's variable tree
(test_torch_layers.random_variables), carried over with
flax_to_torch_state_dict and loaded strictly; inputs numpy from a seed. The
JAX IFFM runs its plain `_sdpa`. Forward outputs within 1e-5 (one module)
to 2e-3 (the encoder) of their largest magnitude in fp32; running
statistics 1e-5; gradients within 2e-3 of each tensor's largest in float64
on both sides (the JAX modules under enable_x64), with the BatchNorms on
their running statistics for the encoder (the JAX BatchNorm keeps fp32
batch statistics under x64; the block test holds train-mode gradients).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu.config import ModelConfig, mfnet_config
from rgbx_semantic_segmentation_tpu.models import builder as jbuilder
from rgbx_semantic_segmentation_tpu.models.encoders import (
    dual_segnext as jsegnext)
from rgbx_semantic_segmentation_tpu_torch import optim as toptim
from rgbx_semantic_segmentation_tpu_torch.convert import (
    flax_to_torch_state_dict, load_dualpath_pretrained)
from rgbx_semantic_segmentation_tpu_torch.models import builder as tbuilder
from rgbx_semantic_segmentation_tpu_torch.models import fusion as tfusion
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.ops import flash_attention as FA
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_segnext as tsegnext)
from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
    SyncBatchNorm2d, convert_sync_batchnorm)
from tests.test_torch_layers import nchw, nhwc, port_module, random_variables
from tests.test_torch_resnet import (
    _close, _grads64, _hold_stats, _randn, mask_of_jax)

torch.set_num_threads(2)
# The narrow encoder: at 136x128 its first stage is 34 x 32 = 1088 tokens
# (long kv) with heads of 32 / 8 = 4 dims; stages 2-4 are short kv (the SR
# route with the kernels on, `_sdpa` with them off).
NARROW = dict(depths=(1, 1, 1, 1), dims=(32, 64, 96, 128))
NARROW_HW = (136, 128)


def test_msca_matches_jax():
    """Output 1e-5 of its largest; the 1x7 / 7x1 ... 21x1 kernels land
    OIHW as (C, 1, kh, kw) with the JAX HWIO kernel's values."""
    x = _randn(0, 2, 23, 25, 16)
    jmod = jsegnext.MSCA(16)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x),
                           seed=1)
    tmod = port_module(tsegnext.MSCA(16), var)
    for name, (kh, kw) in (("conv17_0", (1, 7)), ("conv17_1", (7, 1)),
                           ("conv211_0", (1, 21)), ("conv211_1", (21, 1))):
        hwio = var["params"][name]["kernel"]
        assert hwio.shape == (kh, kw, 1, 16)
        seq, idx = name.split("_")
        oihw = getattr(tmod, seq)[int(idx)].weight.detach().numpy()
        assert oihw.shape == (16, 1, kh, kw)
        np.testing.assert_array_equal(oihw[:, 0], hwio[:, :, 0].transpose(
            2, 0, 1))
        assert getattr(tmod, seq)[int(idx)].padding == (kh // 2, kw // 2)
    _close(nhwc(tmod(nchw(x))), jmod.apply(var, x), 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_block_matches_jax(train):
    """Output 1e-5 of its largest (LayerScales away from their start); in
    train mode the running statistics (momentum 3e-4) 1e-5 and every
    gradient, the LayerScales' among them, 2e-3."""
    x = _randn(2, 2, 11, 12, 16)
    jmod = jsegnext.SegNextBlock(16)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x),
                           seed=3)
    for ls in ("ls1_layer_scale", "ls2_layer_scale"):
        var["params"][ls] = (0.5 + _randn(4, 16)).astype(np.float32)
    ref, new = jmod.apply(var, x, train, mutable=["batch_stats"])
    tmod = port_module(tsegnext.SegNextBlock(16), var).train(train)
    assert tmod.norm1.momentum == tsegnext.BN_MOMENTUM == 3e-4
    _close(nhwc(tmod(nchw(x))), ref, 1e-5)
    if train:
        _hold_stats(tmod, new["batch_stats"])
        want, got = _grads64(jmod, tmod, var, [x], [_randn(5, *ref.shape)])
        assert "ls1_layer_scale" in got
        for k in want:
            _close(got[k], want[k], 2e-3)


@pytest.fixture(scope="module")
def narrow():
    rgb, mx = (_randn(s, 2, *NARROW_HW, 3) for s in (6, 7))
    jmod = jsegnext.SegNextEncoder(**NARROW)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), rgb, mx),
                           seed=8)
    return jmod, var, rgb, mx, jax.jit(jmod.apply)(var, rgb, mx)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_narrow_encoder_matches_jax(narrow, use_pallas, monkeypatch):
    """The four fused maps 2e-3 of their largest in eval mode. The first
    stage's two cross-attention calls take the flash route: with the
    kernels on, q, k, v zero-padded from d = 4 to 8 with the scale of
    d = 4; with them off, the chunked plain version at d = 4."""
    jmod, var, rgb, mx, ref = narrow
    tmod = port_module(tsegnext.SegNextEncoder(**NARROW,
                                               use_pallas=use_pallas), var)
    calls = []

    def spy(name, fn):
        def wrapped(q, k, v, scale):
            calls.append((name, q.shape[2], q.shape[3], scale))
            return fn(q, k, v, scale)
        return wrapped

    for name, mod, attr in (("flash", FA, "flash_attention"),
                            ("plain", FA, "flash_attention_plain"),
                            ("sr", S, "sr_attention")):
        monkeypatch.setattr(mod, attr, spy(name, getattr(mod, attr)))
    with torch.no_grad():
        got = tmod(nchw(rgb), nchw(mx))
    long_kv = [c for c in calls if c[0] != "sr"]
    want_d = 8 if use_pallas else 4
    assert long_kv == [("flash" if use_pallas else "plain", 1088, want_d,
                        4 ** -0.5)] * 2
    assert len(calls) == (8 if use_pallas else 2)
    for g, r in zip(got, ref):
        _close(nhwc(g), r, 2e-3)


def test_narrow_encoder_gradients_and_statistics_match_jax(narrow):
    """Every gradient of a weighted sum of the four maps (float64, the
    BatchNorms on their running statistics; the padded flash route's dq,
    dk, dv through the pad among them) 2e-3 of its tensor's largest; every
    running statistic after a train-mode forward 1e-5."""
    jmod, var, rgb, mx, outs = narrow
    weights = [_randn(20 + i, *np.asarray(o).shape)
               for i, o in enumerate(outs)]
    tmod = port_module(tsegnext.SegNextEncoder(**NARROW, use_pallas=True),
                       var)
    want, got = _grads64(jmod, tmod, var, [rgb, mx], weights, train=False)
    assert "FFMs.0.cross.cross_attn.q1.weight" in got
    for k in want:
        _close(got[k], want[k], 2e-3)
    _, new = jax.jit(lambda v, a, b: jmod.apply(
        v, a, b, True, mutable=["batch_stats"]))(var, rgb, mx)
    tmod = port_module(tsegnext.SegNextEncoder(**NARROW), var).train()
    with torch.no_grad():
        tmod(nchw(rgb), nchw(mx))
    _hold_stats(tmod, new["batch_stats"])


def _cfg(backbone, **model_kw):
    return mfnet_config().replace(
        model=ModelConfig(backbone=backbone, **model_kw))


@functools.lru_cache(maxsize=None)
def _jax_param_count(name):
    jmod, channels = jbuilder.build_backbone(_cfg(name))
    x = np.zeros((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, x))
    return tuple(channels), sum(
        int(np.prod(v.shape))
        for v in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", sorted(tbuilder.SEGNEXT_FACTORIES)
                         + sorted(tbuilder.SEGNEXT_ALIASES))
def test_every_segnext_name_has_the_jax_parameter_count(name):
    """Each registry name, the original's spellings segnext_s / segnext_b
    among them, builds (meta device) with the JAX backbone's channels and
    parameter count (by eval_shape)."""
    with torch.device("meta"):
        module, channels = tbuilder.build_backbone(_cfg(name))
    real = tbuilder.SEGNEXT_ALIASES.get(name, name)
    assert (tuple(channels), sum(p.numel() for p in module.parameters())) \
        == _jax_param_count(real)


def test_builder_settings():
    """IFRM/IFFM whatever the config names, 8 heads on the stage width,
    drop path 0 everywhere (the JAX builder passes SegNeXt no rate), the
    model's kernel switch on every IFFM, BatchNorm momentum 3e-4, the
    LayerScales at 1e-2 after a seeded init, every stage read."""
    cfg = _cfg("segnext_tiny", feature_rectify_module="FRM",
               feature_fusion_module="FFM", drop_path_rate=0.3,
               use_pallas_kernels=True)
    model = build_model(cfg, device="cpu", seed=0)
    bb = model.backbone
    assert all(isinstance(m, tfusion.ImprovedFeatureRectifyModule)
               for m in bb.FRMs)
    assert [m.cross.cross_attn.num_heads for m in bb.FFMs] == [8] * 4
    assert all(m.cross.cross_attn.use_pallas for m in bb.FFMs)
    assert all(m.rate == 0.0 for m in model.modules()
               if isinstance(m, tlayers.DropPath))
    assert bb.stem[1].momentum == bb.norm[3].momentum == 3e-4
    assert bb.FFMs[0].channel_emb.norm.momentum == 3e-4
    assert torch.equal(bb.extra_stages[2][8].ls2_layer_scale.detach(),
                       torch.full((160,), 1e-2))
    assert model.every_param_in_loss
    assert len(bb.stages[2]) == len(bb.extra_stages[2]) == 9


def test_decay_mask_matches_jax(narrow):
    """Only the conv and linear kernels decay: not the LayerScales, the
    BatchNorms or the biases, as the JAX mask on the same tree."""
    jmod, _, rgb, mx, _ = narrow
    with torch.device("meta"):
        model = tsegnext.SegNextEncoder(**NARROW)
    got = toptim.weight_decay_mask(model)
    assert got == mask_of_jax(jmod, rgb[:1], mx[:1])
    assert got["stages.0.0.attn.conv211.1.weight"]
    assert not got["stages.0.0.ls1_layer_scale"]
    assert not got["extra_norm.2.weight"]


def test_load_dualpath_pretrained_segnext(tmp_path):
    """A single-tower checkpoint (stem, stages, downsample, norm) loads into
    both towers: nothing in the file goes unused, the only keys left at
    init are the IFRM/IFFM ones, both towers hold the file's values."""
    model = build_model(dataclasses.replace(_cfg("segnext_tiny")),
                        device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    single = {k: (v if v.dtype == torch.long
                  else torch.randn(v.shape, generator=gen))
              for k, v in model.backbone.state_dict().items()
              if not k.startswith(("extra_", "FRMs", "FFMs"))}
    assert {k.split(".")[0] for k in single} == {
        "stem", "stages", "downsample", "norm"}
    path = tmp_path / "segnext.pth"
    torch.save({"state_dict": single}, path)
    missing, unexpected = load_dualpath_pretrained(str(path), model,
                                                   family="segnext")
    assert unexpected == []
    assert missing and all(k.startswith(("FRMs.", "FFMs.")) for k in missing)
    state = model.backbone.state_dict()
    for k, v in single.items():
        assert torch.equal(state[k], v) and torch.equal(state["extra_" + k],
                                                        v), k


def test_sync_bn_reaches_every_batchnorm():
    """convert_sync_batchnorm swaps every BatchNorm of segnext_b: two per
    block (2 x 36 blocks), the stems', the stage norms', the IFRMs' and the
    IFFMs', for the global-statistics one."""
    with torch.device("meta"):
        model = tbuilder.EncoderDecoder(_cfg("segnext_b"))
    n = sum(type(m) is torch.nn.BatchNorm2d for m in model.modules())
    assert n == 2 * 36 * 2 + 2 + 2 * 4 + 4 * 2 + 4 * 2 + 1
    convert_sync_batchnorm(model)
    assert not any(type(m) is torch.nn.BatchNorm2d for m in model.modules())
    assert sum(isinstance(m, SyncBatchNorm2d) for m in model.modules()) == n
