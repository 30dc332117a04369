"""The encoder-side ASPP / eASPP, the FCN, UPerNet and DeepLabV3+ heads, the
aux-head models (`mit_*_w_aspp` + UPernet, `mit_*_w_ef_aspp` + deeplabv3+)
and the resizes they run, against the JAX package on the CPU in fp32; the
weight carrier (`flax_to_torch_state_dict`) on every model built here.

Weights: numpy from a seed on the JAX variable tree (test_torch_layers.
random_variables), carried over with flax_to_torch_state_dict; inputs numpy
from a seed at the sizes a 64x80 image gives (stage maps 16x20 .. 2x3, so
the rate-24/36 taps of stages 3-4 fall outside the map). Each tolerance is
stated at its test.
"""
import copy

import flax.linen
import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from rgbx_semantic_segmentation_tpu import convert as jconvert
from rgbx_semantic_segmentation_tpu import train as jtrain
from rgbx_semantic_segmentation_tpu.config import (
    DatasetConfig, ModelConfig, TrainConfig, pst900_config)
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu.models.decoders import (
    deeplabv3plus as jdlv3, fcnhead as jfcn, mlp_decoderpp as jmlppp,
    upernet as jupn)
from rgbx_semantic_segmentation_tpu.models.encoders import aspp as jaspp
from rgbx_semantic_segmentation_tpu.ops import resize as jresize
from rgbx_semantic_segmentation_tpu_torch import train as ttrain
from rgbx_semantic_segmentation_tpu_torch.convert import (
    flax_params_to_torch, flax_to_torch_state_dict)
from rgbx_semantic_segmentation_tpu_torch.models import builder as tbuilder
from rgbx_semantic_segmentation_tpu_torch.models.decoders import (
    deeplabv3plus as tdlv3, fcnhead as tfcn, mlp_decoderpp as tmlppp,
    upernet as tupn)
from rgbx_semantic_segmentation_tpu_torch.models.encoders import aspp as taspp
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from rgbx_semantic_segmentation_tpu_torch.ops import resize as tresize
from tests.test_torch_layers import nchw, nhwc, random_variables

torch.set_num_threads(2)

CHANNELS = (32, 64, 160, 256)                  # mit_tiny / mit_b0
STAGE_HW = ((16, 20), (8, 10), (4, 5), (2, 3))  # of a 64x80 image
NUM_CLASSES = 5
CFG_EPS = 1e-3                                  # ModelConfig.bn_eps


def _feats(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(batch, h, w, c).astype(np.float32)
            for (h, w), c in zip(STAGE_HW, CHANNELS)]


def _small_variances(var):
    """Running variances of every other channel 1e-4, where eps 1e-3 and
    1e-5 give outputs ~3x apart."""
    flat = flatten_dict(var)
    for k, v in flat.items():
        if k[0] == "batch_stats" and k[-1] == "var":
            v = v.copy()
            v[::2] = 1e-4
            flat[k] = v
    return unflatten_dict(flat)


def _cfg(backbone, decoder, batch=2, **model_kw):
    return pst900_config().replace(
        dataset=DatasetConfig(num_classes=NUM_CLASSES, image_height=64,
                              image_width=80,
                              class_names=tuple("abcde")),
        model=ModelConfig(backbone=backbone, decoder=decoder,
                          decoder_embed_dim=32, use_mixed_precision=False,
                          **model_kw),
        train=TrainConfig(batch_size=batch, nepochs=2, niters_per_epoch=4,
                          warm_up_epoch=1, lr=1e-3))


def _pair(seed, batch=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, 64, 80, 3).astype(np.float32),
            rng.randn(batch, 64, 80, 3).astype(np.float32))


# ------------------------------------------------------------- the resizes --


@pytest.mark.parametrize("out_hw", [(1, 1), (2, 2), (3, 3), (6, 6), (4, 7)])
def test_adaptive_avg_pool_matches_jax(out_hw):
    """torch's AdaptiveAvgPool2d (the port's UPerNet PPM and image-pooling
    branches) against the JAX `adaptive_avg_pool`, uneven bins (15x20 ->
    6x6, 4x7): 1e-6 of the largest magnitude."""
    x = np.random.RandomState(0).randn(2, 15, 20, 8).astype(np.float32)
    ref = np.asarray(jresize.adaptive_avg_pool(x, out_hw))
    got = nhwc(torch.nn.AdaptiveAvgPool2d(out_hw)(nchw(x)))
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(),
                               rtol=0)


@pytest.mark.parametrize("out_hw", [(6, 6), (120, 160), (16, 20), (1, 5)])
def test_resize_bilinear_align_corners_matches_jax(out_hw):
    """Down and up at uneven factors: 1e-6 of the largest magnitude (torch
    forms the source coordinate in fp32 arithmetic of its own, the JAX
    version from numpy float64 weights: ~1 fp32 ulp apart)."""
    x = np.random.RandomState(1).randn(2, 15, 20, 4).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear_align_corners(x, out_hw))
    got = nhwc(tresize.resize_bilinear_align_corners(nchw(x), out_hw))
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(),
                               rtol=0)


@pytest.mark.parametrize("scale", [1, 2, 3, 6])
def test_resize_bilinear_ppm_upsample_matches_jax(scale):
    """UPerHead's PPM upsample of the 1/2/3/6 pooled maps to c4's 15x20:
    jax.image.resize renormalises edge weights where torch clamps the source
    index; for upsampling the two agree (1e-6 of the largest magnitude)."""
    x = np.random.RandomState(scale).randn(2, scale, scale, 4).astype(
        np.float32)
    ref = np.asarray(jresize.resize_bilinear(x, (15, 20)))
    got = nhwc(tresize.resize_bilinear(nchw(x), (15, 20)))
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(),
                               rtol=0)


# ------------------------------------------------------- each module alone --


def _stage_aspp(stage, eps):
    c = CHANNELS[stage]
    return (jaspp.StageASPP(c, jaspp.STAGE_ASPP_RATES[stage]),
            taspp.ASPP(c, c, taspp.STAGE_ASPP_RATES[stage], bn_eps=eps),
            _feats()[stage])


MODULES = {
    # (JAX module, port module at bn eps `eps`, input); the JAX module's
    # own eps is the first of the pair below.
    "StageASPP_stage1": lambda eps: _stage_aspp(0, eps),
    "StageASPP_stage4": lambda eps: _stage_aspp(3, eps),
    "EASPP": lambda eps: (jaspp.EASPP(CHANNELS[3]),
                          taspp.EASPP(CHANNELS[3], bn_eps=eps), _feats()[3]),
    "FCNHead_aux": lambda eps: (
        jfcn.FCNHead(NUM_CLASSES, in_index=2, channels=32, bn_eps=CFG_EPS),
        tfcn.FCNHead(CHANNELS[2], NUM_CLASSES, in_index=2, channels=32,
                     bn_eps=eps), _feats()),
    "FCNHead_fcn": lambda eps: (
        jfcn.FCNHead(NUM_CLASSES, in_index=3, bn_eps=CFG_EPS),
        tfcn.FCNHead(CHANNELS[3], NUM_CLASSES, in_index=3, bn_eps=eps),
        _feats()),
    "UPerHead": lambda eps: (
        jupn.UPerHead(CHANNELS, NUM_CLASSES, channels=64, bn_eps=CFG_EPS),
        tupn.UPerHead(CHANNELS, NUM_CLASSES, channels=64, bn_eps=eps),
        _feats()),
    "DeepLabV3Plus": lambda eps: (
        jdlv3.DeepLabV3Plus(CHANNELS, NUM_CLASSES, bn_eps=CFG_EPS),
        tdlv3.DeepLabV3Plus(CHANNELS, NUM_CLASSES, bn_eps=eps), _feats()),
    "MLPDecoderpp": lambda eps: (
        jmlppp.MLPDecoderpp(NUM_CLASSES, embed_dim=32, bn_eps=CFG_EPS),
        tmlppp.MLPDecoderpp(CHANNELS, NUM_CLASSES, embed_dim=32, bn_eps=eps),
        _feats()),
}
# (the eps the JAX module runs at, another one): the encoder's ASPPs do not
# take the config's eps, the heads do.
EPS = {"StageASPP_stage1": (1e-5, CFG_EPS), "StageASPP_stage4": (1e-5, CFG_EPS),
       "EASPP": (1e-5, CFG_EPS), "FCNHead_aux": (CFG_EPS, 1e-5),
       "FCNHead_fcn": (CFG_EPS, 1e-5), "UPerHead": (CFG_EPS, 1e-5),
       "DeepLabV3Plus": (CFG_EPS, 1e-5), "MLPDecoderpp": (CFG_EPS, 1e-5)}


def _to_port(x):
    return [nchw(f) for f in x] if isinstance(x, list) else nchw(x)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    """Eval-mode forward of each module alone: 1e-5 of the output's largest
    magnitude, with half the channels' running variances at 1e-4; the same
    port module at the other BatchNorm eps misses by > 100x that."""
    eps, other = EPS[name]
    jmod, tmod, x = MODULES[name](eps)
    var = _small_variances(random_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), x, False), seed=3))
    ref = np.asarray(jmod.apply(var, x, False))
    sd = flax_to_torch_state_dict(var)
    res = tmod.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    with torch.no_grad():
        got = nhwc(tmod.eval()(_to_port(x)))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)
    wrong = MODULES[name](other)[1]
    wrong.load_state_dict(sd, strict=True)
    with torch.no_grad():
        off = np.abs(nhwc(wrong.eval()(_to_port(x))) - ref).max()
    assert off > 1e-3 * scale, (name, off)


# ----------------------------------------------------------- whole models --

MODELS = [("mit_b0_w_aspp", "UPernet"), ("mit_b0_w_ef_aspp", "deeplabv3+")]


@pytest.fixture(scope="module", params=MODELS, ids=lambda p: "+".join(p))
def model_case(request):
    backbone, decoder = request.param
    cfg = _cfg(backbone, decoder, drop_path_rate=0.0)
    rgb, mx = _pair(1)
    jmod = JaxEncoderDecoder(cfg=cfg)
    var = random_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), rgb, mx), seed=5)
    model = tbuilder.build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    return cfg, jmod, var, model, rgb, mx


def test_model_matches_jax(model_case):
    """Eval-mode logits and aux logits of the whole model (the JAX model
    returns the pair in eval mode too): atol 2e-4 x max(1, the output's
    largest magnitude)."""
    cfg, jmod, var, model, rgb, mx = model_case
    ref = jax.jit(lambda v, a, b: jmod.apply(v, a, b, False))(var, rgb, mx)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(rgb), torch.from_numpy(mx))
    assert isinstance(got, tuple) and len(got) == 2
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape == (2, 64, 80, NUM_CLASSES)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=2e-4 * max(1.0, np.abs(r).max()))
    assert torch.equal(tbuilder.main_logits(got), got[0])


class _NoDropout(flax.linen.Dropout):
    """flax Dropout that keeps everything (for the JAX side of a train
    step held against the port's with its dropouts at rate 0)."""

    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


def _port_train_step(model, rgb, mx, label, cfg, dtype):
    """Train-mode forward, the loss and backward of a copy of `model` in
    `dtype` with every dropout at rate 0: (loss, {name: grad}, state)."""
    model = copy.deepcopy(model).to(dtype).train()
    for m in model.modules():
        if isinstance(m, tlayers._Stochastic):
            m.rate = 0.0
    loss = ttrain.make_loss_fn(cfg)(
        model(torch.from_numpy(rgb).to(dtype), torch.from_numpy(mx).to(dtype)),
        torch.from_numpy(label))
    loss.backward()
    return (float(loss.detach()),
            # A stage whose fused map no head reads (stage 2 under
            # deeplabv3+) has no gradient: JAX's zeros.
            {k: (np.zeros(p.shape) if p.grad is None
                 else p.grad.double().numpy())
             for k, p in model.named_parameters()},
            model.state_dict())


def test_train_step_matches_jax(model_case, monkeypatch):
    """One train-mode step of the whole model: the loss with the aux head at
    weight 0.4, every gradient and the BatchNorm running statistics, with
    dropouts off on both sides (flax Dropout swapped for an identity here;
    the port's modules at rate 0) and drop path 0. fp32: loss rtol 1e-5,
    running statistics 1e-5. Gradients: max abs error <= 1e-5 + 2e-3 of the
    tensor's largest, held in float64 on both sides (the JAX model under
    enable_x64; its BatchNorm statistics stay fp32): at this geometry the
    fp32 gradients of the FPN convs and the stage-1 ASPP lie up to 3e-3
    (the port) and 9e-3 (JAX) of their largest from each package's own
    float64 run (train-mode BatchNorms over 2 images cancel most of the
    gradient), while the float64 runs agree to ~1e-4."""
    cfg, jmod, var, model, rgb, mx = model_case
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    assert any(m.rate == 0.5 for m in model.modules()
               if isinstance(m, tlayers._Stochastic))
    label = np.random.RandomState(2).randint(0, NUM_CLASSES, (2, 64, 80))
    label[np.random.RandomState(3).rand(2, 64, 80) < 0.05] = 255
    loss_fn = jtrain.make_loss_fn(cfg)

    def jax_step(variables, a, b):
        def jloss(params):
            out, new = jmod.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                a, b, True, mutable=["batch_stats"])
            assert isinstance(out, tuple)
            return loss_fn(out, label), new
        return jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            variables["params"])

    (ref_loss, new), _ = jax_step(var, rgb, mx)
    loss, _, state = _port_train_step(model, rgb, mx, label, cfg,
                                      torch.float32)
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    want = flax_to_torch_state_dict({"batch_stats": new["batch_stats"]})
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert any("aspp" in k for k in stats) and any("aux_head" in k
                                                   for k in stats)
    for k in stats:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)

    with jax.enable_x64(True):
        var64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       var)
        _, ref_grads = jax_step(var64, rgb.astype(np.float64),
                                mx.astype(np.float64))
        ref = {k: np.asarray(v, np.float64)
               for k, v in flax_params_to_torch(ref_grads).items()}
    _, grads, _ = _port_train_step(model, rgb, mx, label, cfg, torch.float64)
    assert set(ref) == set(grads)
    assert any(k.startswith("aux_head.") for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, ref[k], rtol=0,
                                   atol=1e-5 + 2e-3 * np.abs(ref[k]).max(),
                                   err_msg=k)


def test_aux_loss_weight():
    """An (logits, aux) pair costs criterion(logits) + 0.4 criterion(aux)."""
    cfg = _cfg("mit_tiny_w_aspp", "UPernet")
    rng = np.random.RandomState(0)
    logits, aux = (torch.from_numpy(rng.randn(2, 8, 8, 5).astype(np.float32))
                   for _ in range(2))
    label = torch.from_numpy(rng.randint(0, 5, (2, 8, 8)))
    loss_fn = ttrain.make_loss_fn(cfg)
    assert float(loss_fn((logits, aux), label)) == pytest.approx(
        float(loss_fn(logits, label)) + 0.4 * float(loss_fn(aux, label)),
        rel=1e-6)


# ------------------------------------------------- the weight carrier --

CARRIED = [("mit_tiny_w_aspp", "UPernet"), ("mit_tiny_w_ef_aspp", "deeplabv3+"),
           ("mit_tiny", "fcn"), ("mit_tiny", None),
           ("mit_tiny_w_aspp", "MLPDecoder"), ("mit_tiny", "MLPDecoder"),
           ("mit_b0_w_aspp", "UPernet"), ("mit_b0_w_ef_aspp", "deeplabv3+"),
           ("mit_b0", "mask2former"), ("mit_b0", "MLPDecoderpp")]


def test_segment_indices_map_every_trailing_index():
    """Every trailing run of `_<digits>` of a path segment becomes
    `.`-indices, the inverse of the JAX convert.torch_key_to_path."""
    tree = {"params": {
        "psp_modules_0_1": {"kernel": np.zeros((1, 1, 2, 3), np.float32)},
        "branch1_0_0": {"bias": np.zeros(3, np.float32)},
        "lateral_convs_2_0": {"bias": np.zeros(3, np.float32)},
        "block1_0": {"linear_c4": {"bias": np.zeros(3, np.float32)}}}}
    keys = set(flax_to_torch_state_dict(tree))
    assert keys == {"psp_modules.0.1.weight", "branch1.0.0.bias",
                    "lateral_convs.2.0.bias", "block1.0.linear_c4.bias"}
    for k in keys:
        assert jconvert.torch_key_to_path(k)[:-1] in (
            ("psp_modules_0_1",), ("branch1_0_0",), ("lateral_convs_2_0",),
            ("block1_0", "linear_c4"))


@pytest.mark.parametrize("backbone,decoder", CARRIED)
def test_state_dict_carries_both_ways(backbone, decoder):
    """The JAX model's variables load strict=True into the port's model
    (the key sets equal both ways, shapes equal), and the port's state dict
    converts back to the JAX tree exactly."""
    cfg = _cfg(backbone, decoder)
    rgb, mx = _pair(0, batch=1)
    jmod = JaxEncoderDecoder(cfg=cfg)
    var = random_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), rgb, mx), seed=4)
    sd = flax_to_torch_state_dict(var)
    model = tbuilder.build_model(cfg, device="cpu", seed=None)
    assert set(sd) == set(model.state_dict())
    res = model.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    back = jconvert.torch_to_flax_variables(model.state_dict())
    merged = jconvert.merge_variables(var, back, strict=True)
    want, got = flatten_dict(var), flatten_dict(merged)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg="/".join(k))


# ----------------------------------------------------------- the registry --

ASPP_NAMES = [f"{base}{suffix}" for base in tbuilder.MIT_FACTORIES
              for suffix in tbuilder.ASPP_SUFFIXES]


@pytest.mark.parametrize("backbone", ASPP_NAMES)
def test_every_aspp_name_builds(backbone):
    """Every MiT `_w_aspp` / `_w_ef_aspp` name with each ported decoder
    (on the meta device): ASPPs on all four stages or one eASPP after stage
    4; the aux head with UPernet and deeplabv3+ only; the parameter count
    of the JAX model at mit_tiny and mit_b0 (fcn head, by eval_shape)."""
    ef = backbone.endswith("_w_ef_aspp")
    for decoder in ("MLPDecoder", "UPernet", "deeplabv3+", "fcn"):
        cfg = _cfg(backbone, decoder)
        with torch.device("meta"):
            model = tbuilder.EncoderDecoder(cfg)
        bb = model.backbone
        assert bb.aspp == ("easpp" if ef else "aspp")
        assert hasattr(bb, "single_aspp") == ef
        assert hasattr(bb, "aspp_modules") != ef
        assert (model.aux_head is not None) == (
            decoder in ("UPernet", "deeplabv3+"))
    if backbone.startswith(("mit_tiny", "mit_b0")):
        x = np.zeros((1, 64, 80, 3), np.float32)
        shapes = jax.eval_shape(lambda: JaxEncoderDecoder(cfg=cfg).init(
            jax.random.PRNGKey(0), x, x))
        n_jax = sum(int(np.prod(v.shape))
                    for v in jax.tree_util.tree_leaves(shapes["params"]))
        assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("backbone,decoder,item", [
    ("segnext_tiny", "MLPDecoder", "M10 item 6"),
    ("resnet50", "UPernet", "M10 item 7")])
def test_unported_names_still_raise(backbone, decoder, item):
    """The two pairings that raised until M10 items 6-7 were ported now
    build (on the meta device), read all four stages (UPernet with its aux
    head on stage 3), and have the JAX model's parameter count (by
    eval_shape); tests/test_torch_segnext.py and tests/test_torch_resnet.py
    hold their outputs against JAX."""
    cfg = _cfg(backbone, decoder)
    with torch.device("meta"):
        model = tbuilder.EncoderDecoder(cfg)
    assert model.every_param_in_loss
    assert (model.aux_head is not None) == (decoder == "UPernet")
    x = np.zeros((1, 64, 80, 3), np.float32)
    shapes = jax.eval_shape(lambda: JaxEncoderDecoder(cfg=cfg).init(
        jax.random.PRNGKey(0), x, x))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape))
        for v in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("decoder", ["MLPDecoderpp", "mask2former"])
@pytest.mark.parametrize("backbone", sorted(tbuilder.MIT_FACTORIES))
def test_last_heads_build_on_every_mit(backbone, decoder):
    """The two heads that raised before now build on every MiT backbone
    (on the meta device), read all four stages, and at mit_tiny / mit_b0
    have the JAX model's parameter count (by eval_shape); their outputs are
    held against JAX in tests/test_torch_mask2former.py and
    tests/test_torch_mlp_decoderpp.py."""
    cfg = _cfg(backbone, decoder)
    with torch.device("meta"):
        model = tbuilder.EncoderDecoder(cfg)
    assert model.aux_head is None and model.every_param_in_loss
    if backbone in ("mit_tiny", "mit_b0"):
        x = np.zeros((1, 64, 80, 3), np.float32)
        shapes = jax.eval_shape(lambda: JaxEncoderDecoder(cfg=cfg).init(
            jax.random.PRNGKey(0), x, x))
        assert sum(p.numel() for p in model.parameters()) == sum(
            int(np.prod(v.shape))
            for v in jax.tree_util.tree_leaves(shapes["params"]))
