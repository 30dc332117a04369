"""The port's IFRM / IFFM fusion (the `mit_*pp` family) against the JAX
package on the CPU in fp32: each Improved module, IFRM and IFFM in eval and
in train mode (BatchNorm statistics), the whole mit_tinypp / mit_b0pp
EncoderDecoder, one train step (loss and every gradient), the names
`build_model` knows, the initialisation of the new parameters and the
kernels' dispatch inside the model.

Weights: numpy from a seed on the JAX module's variable tree
(test_torch_layers.random_variables; the 0-d lambdas too), carried over with
flax_to_torch_state_dict and loaded strictly. On the CPU the JAX side runs
its plain `_sdpa` attention and the port its plain versions (the chunked
flash reference for long kv with kernels on). Each tolerance is stated at
its test; the module tests use atol 1e-4 at O(1) activations (fp32 on both
sides: summation order and the two LayerNorm variance forms).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import losses as jlosses
from rgbx_semantic_segmentation_tpu import train as jtrain
from rgbx_semantic_segmentation_tpu.models import fusion as jfusion
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu_torch import train as ttrain
from rgbx_semantic_segmentation_tpu_torch.config import mfnet_config
from rgbx_semantic_segmentation_tpu_torch.convert import (
    flax_params_to_torch, flax_to_torch_state_dict)
from rgbx_semantic_segmentation_tpu_torch.models import builder as tbuilder
from rgbx_semantic_segmentation_tpu_torch.models import fusion as tfusion
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_segformer as tseg)
from rgbx_semantic_segmentation_tpu_torch.ops import flash_attention as FA
from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S
from tests.test_torch_layers import nchw, nhwc, port_module, random_variables
from tests.test_torch_model import _cfg, _jax_model_and_vars, _pair
from tests.test_torch_train import _stats, synthetic_batch, tiny_cfg

torch.set_num_threads(2)
ATOL = 1e-4


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _maps(seed, B=2, H=6, W=5, C=32):
    return _randn(seed, B, H, W, C), _randn(seed + 1, B, H, W, C)


def test_improved_channel_weights_match_jax():
    x1, x2 = _maps(0)
    jmod = jfusion.ImprovedChannelWeights(32)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x1, x2))
    ref = jmod.apply(var, x1, x2)
    tmod = port_module(tfusion.ImprovedChannelWeights(32), var)
    assert {"mlp.0.weight", "mlp.1.weight", "mlp.3.bias", "mlp.4.bias",
            "gate.0.weight"} <= set(tmod.state_dict())
    got = tmod(nchw(x1), nchw(x2))
    for g, r in zip(got, ref):
        assert g.shape == (2, 32, 1, 1)
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=ATOL, rtol=0)


@pytest.mark.parametrize("train", [False, True])
def test_improved_spatial_weights_match_jax(train):
    """Eval: running statistics. Train: batch statistics normalise and the
    running ones move (atol 1e-5 on them)."""
    x1, x2 = _maps(2)
    jmod = jfusion.ImprovedSpatialWeights(32)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x1, x2))
    ref, new = jmod.apply(var, x1, x2, train, mutable=["batch_stats"])
    tmod = port_module(tfusion.ImprovedSpatialWeights(32), var).train(train)
    got = tmod(nchw(x1), nchw(x2))
    for g, r in zip(got, ref):
        assert g.shape == (2, 1, 6, 5)
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=ATOL, rtol=0)
    want = _stats(flax_to_torch_state_dict({"batch_stats": new["batch_stats"]}))
    have = _stats(tmod.state_dict())
    assert set(want) == set(have) and len(want) == 4
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_ifrm_matches_jax(train):
    """The 0-d lambdas convert as they are; one LayerNorm (eps 1e-5) serves
    both outputs."""
    x1, x2 = _maps(4)
    jmod = jfusion.ImprovedFeatureRectifyModule(32)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x1, x2))
    var["params"]["lambda_channel"] = np.float32(0.37)
    var["params"]["lambda_spatial"] = np.float32(-0.61)
    ref, _ = jmod.apply(var, x1, x2, train, mutable=["batch_stats"])
    tmod = port_module(tfusion.ImprovedFeatureRectifyModule(32), var)
    tmod.train(train)
    assert tmod.lambda_channel.shape == () and tmod.norm.eps == 1e-5
    assert float(tmod.lambda_spatial.detach()) == pytest.approx(-0.61)
    got = tmod(nchw(x1), nchw(x2))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("N,C,heads", [(1100, 64, 2), (70, 64, 2)])
def test_improved_cross_attention_matches_jax(N, C, heads, use_pallas):
    """Long tokens (N >= 1024, d = 32: the flash path when kernels are on,
    its chunked plain version when off) and short ones (the SR path / plain
    `_sdpa`); the JAX side runs `_sdpa`."""
    x1, x2 = _randn(6, 2, N, C), _randn(7, 2, N, C)
    jmod = jfusion.ImprovedCrossAttention(C, heads, use_pallas=use_pallas)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x1, x2))
    ref = jmod.apply(var, x1, x2)
    tmod = port_module(
        tfusion.ImprovedCrossAttention(C, heads, use_pallas=use_pallas), var)
    assert set(tmod.state_dict()) == {
        f"{n}.weight" for n in ("q1", "kv1", "q2", "kv2", "proj1", "proj2")
    } | {"proj1.bias", "proj2.bias"}
    got = tmod(torch.from_numpy(x1), torch.from_numpy(x2))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=ATOL, rtol=0)


def test_improved_cross_attention_dropout_takes_the_materialising_path(
        monkeypatch):
    """attn_drop > 0 in train mode: dropout between softmax and p @ v from
    the explicit generator, and no attention kernel path; in eval mode the
    module is the rate-0 module."""
    x1, x2 = (torch.from_numpy(_randn(s, 1, 40, 32)) for s in (8, 9))
    mod = tfusion.ImprovedCrossAttention(32, 2, attn_drop=0.5, use_pallas=True)
    ref = tfusion.ImprovedCrossAttention(32, 2, use_pallas=True)
    ref.load_state_dict(mod.state_dict())
    for a, b in zip(mod.eval()(x1, x2), ref.eval()(x1, x2)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)

    def forbidden(*a, **kw):
        raise AssertionError("dropout went through multi_head_attention")

    monkeypatch.setattr(tfusion, "multi_head_attention", forbidden)
    mod.train()
    outs = []
    for seed in (0, 0, 1):
        mod.attn_dropout.generator = torch.Generator().manual_seed(seed)
        outs.append(mod(x1, x2)[0])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def test_improved_cross_path_matches_jax():
    x1, x2 = _randn(10, 2, 30, 32), _randn(11, 2, 30, 32)
    jmod = jfusion.ImprovedCrossPath(32, num_heads=2)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x1, x2))
    ref = jmod.apply(var, x1, x2)
    tmod = port_module(tfusion.ImprovedCrossPath(32, num_heads=2), var)
    got = tmod(torch.from_numpy(x1), torch.from_numpy(x2))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=ATOL, rtol=0)


def test_channel_embed_gelu_matches_jax():
    H, W = 4, 3
    x = _randn(12, 2, H * W, 64)
    jmod = jfusion.ChannelEmbed(64, 32, act="gelu")
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, H, W))
    ref = jmod.apply(var, x, H, W)
    tmod = port_module(tfusion.ChannelEmbed(64, 32, act="gelu"), var)
    got = tmod(torch.from_numpy(x), H, W)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL, rtol=0)
    relu = port_module(tfusion.ChannelEmbed(64, 32), var)
    assert not torch.allclose(relu(torch.from_numpy(x), H, W), got, atol=1e-3)


@pytest.mark.parametrize("train", [False, True])
def test_iffm_matches_jax(train):
    x1, x2 = _maps(13, H=5, W=4)
    jmod = jfusion.ImprovedFeatureFusionModule(32, num_heads=2,
                                               bn_momentum=0.3)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x1, x2))
    ref, new = jmod.apply(var, x1, x2, train, mutable=["batch_stats"])
    tmod = port_module(tfusion.ImprovedFeatureFusionModule(
        32, num_heads=2, bn_momentum=0.3), var).train(train)
    assert "cross.cross_attn.kv1.weight" in tmod.state_dict()
    got = tmod(nchw(x1), nchw(x2))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=ATOL, rtol=0)
    want = _stats(flax_to_torch_state_dict({"batch_stats": new["batch_stats"]}))
    have = _stats(tmod.state_dict())
    assert set(want) == set(have) and len(want) == 4
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------- whole model --


@pytest.mark.parametrize("backbone", ["mit_tinypp", "mit_b0pp"])
def test_whole_pp_model_matches_jax(backbone):
    """Logits atol 2e-3 and argmax agreement > 0.999, as the other families
    (fp32 both sides through ~40 layers, the decoder and the upsample)."""
    cfg = _cfg(backbone)
    rgb, mx = _pair(1)
    jmod, var = _jax_model_and_vars(cfg, rgb, mx)
    ref = np.asarray(jax.jit(jmod.apply)(var, rgb, mx))
    model = build_model(cfg, device="cpu", seed=None)
    res = model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    with torch.no_grad():
        got = model(torch.from_numpy(rgb), torch.from_numpy(mx)).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 9)
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.999


def test_config_fusion_names_build_the_improved_modules():
    """`mit_*pp` hardwires IFRM/IFFM; a plain name takes them from the
    config, as the JAX builder does. All seven pp names resolve."""
    for name in ("mit_tiny", "mit_b0", "mit_b1", "mit_b2", "mit_b3", "mit_b4",
                 "mit_b5"):
        assert name in tbuilder.MIT_FACTORIES
    cfg = _cfg("mit_tiny")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, feature_rectify_module="IFRM", feature_fusion_module="IFFM"))
    by_cfg = build_model(cfg, device="cpu", seed=None)
    by_name = build_model(_cfg("mit_tinypp"), device="cpu", seed=None)
    assert set(by_cfg.state_dict()) == set(by_name.state_dict())
    assert isinstance(by_name.backbone.FRMs[0],
                      tfusion.ImprovedFeatureRectifyModule)
    assert isinstance(by_name.backbone.FFMs[3],
                      tfusion.ImprovedFeatureFusionModule)
    plain = build_model(_cfg("mit_tiny"), device="cpu", seed=None)
    assert isinstance(plain.backbone.FFMs[0], tfusion.FeatureFusionModule)
    with torch.device("meta"):
        big, channels = tbuilder.build_backbone(_cfg("mit_b5pp"))
    assert channels == (64, 128, 320, 512) and len(big.block3) == 40
    assert isinstance(big.FFMs[0], tfusion.ImprovedFeatureFusionModule)
    with pytest.raises(KeyError):
        tfusion.get_frm("XFRM")
    with pytest.raises(KeyError):
        build_model(_cfg("mit_b9pp"), device="cpu", seed=None)


def test_only_mit_factory_names_plus_pp_are_mit_pp():
    """`is_mit_pp` holds for a MiT factory's name + "pp" and for no other
    name that ends in "pp": mit_b2pp builds IFRM/IFFM, the ASPP variants
    build FRM/FFM with their ASPPs."""
    for name in tbuilder.MIT_FACTORIES:
        assert tbuilder.is_mit_pp(name + "pp")
        assert not tbuilder.is_mit_pp(name)
    for name in ("mit_b2_w_aspp", "mit_b2_w_ef_aspp", "mit_b9pp", "pp",
                 "swin_spp"):
        assert not tbuilder.is_mit_pp(name)
    with torch.device("meta"):
        pp, _ = tbuilder.build_backbone(_cfg("mit_b2pp"))
    assert isinstance(pp.FRMs[0], tfusion.ImprovedFeatureRectifyModule)
    assert isinstance(pp.FFMs[3], tfusion.ImprovedFeatureFusionModule)
    for name, kind in (("mit_b2_w_aspp", "aspp"),
                       ("mit_b2_w_ef_aspp", "easpp")):
        with torch.device("meta"):
            bb, _ = tbuilder.build_backbone(_cfg(name))
        assert bb.aspp == kind
        assert isinstance(bb.FRMs[0], tfusion.FeatureRectifyModule)


def test_init_reaches_the_new_parameters():
    """Seeded init: lambdas 0.5, the IFRM/IFFM LayerNorms ones / zeros,
    their Linears truncated normal (std 0.02) with zero bias; only the IFFM
    gets `use_pallas`."""
    cfg = _cfg("mit_tinypp")
    model = build_model(cfg, device="cpu", seed=0)
    sd = model.state_dict()
    for s in range(4):
        assert float(sd[f"backbone.FRMs.{s}.lambda_channel"]) == 0.5
        assert float(sd[f"backbone.FRMs.{s}.lambda_spatial"]) == 0.5
    assert torch.equal(sd["backbone.FRMs.0.norm.weight"], torch.ones(32))
    assert torch.equal(sd["backbone.FRMs.1.channel_weights.mlp.4.bias"],
                       torch.zeros(128))
    w = sd["backbone.FFMs.0.cross.cross_attn.kv1.weight"]
    assert 0.01 < float(w.std()) < 0.03 and float(w.abs().max()) <= 0.0455
    assert torch.equal(sd["backbone.FFMs.0.cross.cross_attn.proj1.bias"],
                       torch.zeros(32))
    assert all(torch.isfinite(v).all() for v in sd.values())
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                use_pallas_kernels=True))
    model = build_model(cfg, device="cpu", seed=None)
    assert all(m.cross.cross_attn.use_pallas for m in model.backbone.FFMs)
    with tseg.plain_attention(model):
        assert not any(m.cross.cross_attn.use_pallas
                       for m in model.backbone.FFMs)
        assert not model.backbone.block1[0].attn.use_pallas
    assert model.backbone.FFMs[0].cross.cross_attn.use_pallas


def test_model_dispatch_reaches_both_kernel_wrappers(monkeypatch):
    """A 192x128 mit_tinypp forward with kernels on: the stage-1 IFFM
    (N = M = 1536, d = 32) calls the flash wrapper twice, every other
    attention (8 SR blocks, 6 short IFFM calls) the SR wrapper, none
    `_sdpa`; with kernels off the long-kv calls take the chunked plain
    versions."""
    from rgbx_semantic_segmentation_tpu_torch.ops import attention as A

    cfg = mfnet_config()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, backbone="mit_tinypp", decoder_embed_dim=32,
        use_mixed_precision=False))
    model = build_model(cfg, device="cpu", seed=0)
    calls = []

    def spy(name, fn):
        def wrapped(q, k, v, scale):
            calls.append((name, tuple(q.shape), k.shape[2]))
            return fn(q, k, v, scale)
        return wrapped

    for name, mod, attr in (("flash", FA, "flash_attention"),
                            ("plain", FA, "flash_attention_plain"),
                            ("sr", S, "sr_attention"), ("sdpa", A, "_sdpa")):
        monkeypatch.setattr(mod, attr, spy(name, getattr(mod, attr)))
    x = torch.from_numpy(_randn(20, 1, 192, 128, 3))
    with torch.no_grad():
        out = model(x, x)
        kinds = [c[0] for c in calls]
        assert kinds.count("flash") == 2 and kinds.count("sr") == 14
        assert set(kinds) == {"flash", "sr"}
        assert [c for c in calls if c[0] == "flash"][0][1:] == (
            (1, 1, 1536, 32), 1536)
        calls.clear()
        with tseg.plain_attention(model):
            plain = model(x, x)
    kinds = [c[0] for c in calls]
    assert kinds.count("plain") == 2 and kinds.count("sdpa") == 14
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=0)


# ------------------------------------------------------------ train step --


@pytest.fixture(scope="module")
def tiny_pp():
    cfg = tiny_cfg(backbone="mit_tinypp")
    batch = synthetic_batch(cfg)
    jmod = JaxEncoderDecoder(cfg=cfg)
    var = random_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), batch["rgb"][:1],
                          batch["modal_x"][:1]), seed=11)
    for s in range(4):   # lambdas near their initial value, not near 0
        frm = var["params"]["backbone"][f"FRMs_{s}"]
        frm["lambda_channel"] = np.float32(0.5 + 0.1 * s)
        frm["lambda_spatial"] = np.float32(0.4 - 0.1 * s)
    return cfg, batch, jmod, var


def test_pp_loss_and_all_gradients_match_jax(tiny_pp):
    """Train-mode forward, cross-entropy and every parameter's gradient of
    mit_tinypp (the lambdas' among them) against jax.value_and_grad. Loss
    rtol 1e-5; per tensor, max abs error <= 1e-5 + 2e-3 of the tensor's
    largest gradient (as the mit_tiny test)."""
    cfg, batch, jmod, var = tiny_pp

    def loss_fn(params):
        out, new = jmod.apply(
            {"params": params, "batch_stats": var["batch_stats"]},
            batch["rgb"], batch["modal_x"], True, mutable=["batch_stats"])
        return jlosses.cross_entropy_loss(out, batch["label"]), new

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        var["params"])
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    model.train()
    loss = ttrain.make_loss_fn(cfg)(
        model(torch.from_numpy(batch["rgb"]), torch.from_numpy(batch["modal_x"])),
        torch.from_numpy(batch["label"]))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    ref = flax_params_to_torch(jgrads)
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    assert "backbone.FRMs.0.lambda_channel" in named
    for k, p in named.items():
        r = ref[k].numpy()
        tol = 1e-5 + 2e-3 * np.abs(r).max()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=tol, rtol=0,
                                   err_msg=k)
    lam = named["backbone.FRMs.1.lambda_spatial"].grad
    assert lam.shape == () and float(lam.abs()) > 0


def test_pp_train_step_matches_make_train_step():
    """One Trainer.step against the jitted JAX make_train_step from the
    same weights (the JAX init, converted): loss rtol 1e-5; after the step
    every parameter within 2 * lr of the JAX one (AdamW moves a coordinate
    by about lr) and the lambdas moved off 0.5 the same way."""
    cfg = tiny_cfg(backbone="mit_tinypp")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, warm_up_epoch=0))
    batch = synthetic_batch(cfg, seed=1)
    state = jtrain.create_train_state(cfg, jax.random.PRNGKey(0))
    start = flax_to_torch_state_dict(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)})
    assert float(start["backbone.FRMs.0.lambda_channel"]) == 0.5
    trainer = ttrain.Trainer(cfg, device="cpu", seed=0, init_values=False)
    trainer.model.load_state_dict(start, strict=True)
    state, metrics = jtrain.make_train_step(cfg)(state, batch)
    loss = float(trainer.step(batch)["loss"])
    assert loss == pytest.approx(float(metrics["loss"]), rel=1e-5)
    end = flax_to_torch_state_dict({"params": jax.device_get(state.params)})
    sd = trainer.model.state_dict()
    lr = cfg.train.lr
    for k, ref in end.items():
        assert float((sd[k] - ref).abs().max()) <= 2 * lr, k
    for s in range(4):
        for lam in ("lambda_channel", "lambda_spatial"):
            k = f"backbone.FRMs.{s}.{lam}"
            assert abs(float(end[k]) - 0.5) > 0.5 * lr, k
            assert float(sd[k]) == pytest.approx(float(end[k]), abs=0.1 * lr)
