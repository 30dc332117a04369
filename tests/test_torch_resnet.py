"""The port's dual ResNet encoder (models/encoders/dual_resnet.py) against
the JAX package on the CPU: the Bottleneck (eval and train mode, with and
without its strided downsample), one ResNet tower, the whole DualResNet
with FRM/FFM at 64x64, the parameter count of every ResNet registry name,
the weight-decay mask on the new names, the torchvision key space of the
pretrained loader and the synced BatchNorm conversion.

Weights: numpy from a seed on the JAX module's variable tree
(test_torch_layers.random_variables), carried over with
flax_to_torch_state_dict and loaded strictly; inputs numpy from a seed.
Forward outputs within 1e-5 (one block) to 2e-3 (a tower) of their largest
magnitude, fp32 both sides; BatchNorm running statistics 1e-5; gradients
within 2e-3 of each tensor's largest, in float64 on both sides (the JAX
modules under enable_x64): train-mode BatchNorms over two images cancel
most of a gradient, and fp32 rounding of either side alone then reaches
1e-3 of it.
"""
import types

import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import optim as joptim
from rgbx_semantic_segmentation_tpu.config import ModelConfig, mfnet_config
from rgbx_semantic_segmentation_tpu.models import builder as jbuilder
from rgbx_semantic_segmentation_tpu.models.encoders import (
    dual_resnet as jresnet)
from rgbx_semantic_segmentation_tpu_torch import optim as toptim
from rgbx_semantic_segmentation_tpu_torch.convert import (
    flax_params_to_torch, flax_to_torch_state_dict, load_dualpath_pretrained)
from rgbx_semantic_segmentation_tpu_torch.models import builder as tbuilder
from rgbx_semantic_segmentation_tpu_torch.models import fusion as tfusion
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_resnet as tresnet)
from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
    SyncBatchNorm2d, convert_sync_batchnorm)
from tests.test_torch_layers import nchw, nhwc, port_module, random_variables
from tests.test_torch_train import _stats

torch.set_num_threads(2)


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1e-30, np.abs(want).max()))


def _hold_stats(tmod, new):
    want = _stats(flax_to_torch_state_dict({"batch_stats": new}))
    have = _stats(tmod.state_dict())
    assert set(want) == set(have) and want
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def _grads64(jmod, tmod, var, inputs, weights, train=True):
    """Gradients of sum_i <out_i, w_i> (BatchNorms in train or eval mode)
    of every parameter, on both sides in float64: ({name: JAX gradient},
    {name: port gradient})."""
    with jax.enable_x64(True):
        var64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       var)

        def loss(params):
            outs, _ = jmod.apply(
                {"params": params, "batch_stats": var64["batch_stats"]},
                *(a.astype(np.float64) for a in inputs), train,
                mutable=["batch_stats"])
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            return sum((o * w).sum() for o, w in zip(outs, weights))

        ref = {k: v.double().numpy() for k, v in flax_params_to_torch(
            jax.jit(jax.grad(loss))(var64["params"])).items()}
    tmod = tmod.double().train(train)
    outs = tmod(*(nchw(a).double() for a in inputs))
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(w).double()).sum()
        for o, w in zip(outs, weights)).backward()
    got = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    assert set(got) == set(ref)
    return ref, got


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("inplanes,planes,stride,downsample", [
    (16, 8, 1, True), (32, 8, 1, False), (32, 16, 2, True)])
def test_bottleneck_matches_jax(inplanes, planes, stride, downsample,
                                train):
    """Output 1e-5 of its largest; in train mode the running statistics
    (momentum 0.1, the unbiased variance) 1e-5 and every gradient 2e-3."""
    x = _randn(0, 2, 9, 10, inplanes)
    jmod = jresnet.Bottleneck(planes, stride=stride,
                              has_downsample=downsample)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x),
                           seed=1)
    ref, new = jmod.apply(var, x, train, mutable=["batch_stats"])
    tmod = port_module(tresnet.Bottleneck(inplanes, planes, stride,
                                          downsample), var).train(train)
    assert (tmod.downsample is None) == (not downsample)
    _close(nhwc(tmod(nchw(x))), ref, 1e-5)
    if train:
        _hold_stats(tmod, new["batch_stats"])
        w = _randn(2, *ref.shape)
        want, got = _grads64(jmod, tmod, var, [x], [w])
        for k in want:
            _close(got[k], want[k], 2e-3)


def test_tower_matches_jax():
    """One ResNet tower, one block a stage, at 64x64: the four stage maps
    2e-3 of their largest in eval mode, every running statistic after a
    train-mode forward, and every gradient (float64) 2e-3 in eval mode.
    (In train mode the JAX BatchNorm keeps fp32 statistics under x64, and
    through five train-mode BatchNorms over two images, whose statistics
    cancel most of each gradient, that rounding alone moves the stem's
    gradients by up to a quarter of their largest; the Bottleneck test
    holds the train-mode gradients.)"""
    x = _randn(3, 2, 64, 64, 3)
    jmod = jresnet.ResNetTower((1, 1, 1, 1))
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x),
                           seed=4)
    tmod = port_module(tresnet.ResNetTower((1, 1, 1, 1)), var).eval()
    ref = jmod.apply(var, x)
    got = tmod(nchw(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 256, 16, 16), (2, 512, 8, 8), (2, 1024, 4, 4), (2, 2048, 2, 2)]
    for g, r in zip(got, ref):
        _close(nhwc(g), r, 2e-3)
    weights = [_randn(5 + i, *r.shape) for i, r in enumerate(ref)]
    want, got = _grads64(jmod, tmod, var, [x], weights, train=False)
    for k in want:
        _close(got[k], want[k], 2e-3)
    _, new = jmod.apply(var, x, True, mutable=["batch_stats"])
    tmod = port_module(tresnet.ResNetTower((1, 1, 1, 1)), var).train()
    tmod(nchw(x))
    _hold_stats(tmod, new["batch_stats"])


def test_dual_resnet_matches_jax():
    """Two towers (one block a stage) with the preset's FRM and FFM per
    stage (dims 256-2048, the fusion modules' 240M parameters) at 64x64:
    the fused maps 2e-3 of their largest in eval mode, the running
    statistics of every BatchNorm (towers and fusion) after a train-mode
    forward 1e-5."""
    ffm = "FFM"
    rgb, mx = _randn(7, 2, 64, 64, 3), _randn(8, 2, 64, 64, 3)
    jmod = jresnet.DualResNet((1, 1, 1, 1), frm="FRM", ffm=ffm)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), rgb, mx),
                           seed=9)
    tmod = port_module(tresnet.DualResNet((1, 1, 1, 1), ffm=ffm), var)
    ref = jax.jit(jmod.apply)(var, rgb, mx)
    with torch.no_grad():
        got = tmod(nchw(rgb), nchw(mx))
        assert [g.shape[1] for g in got] == list(tmod.channels)
        for g, r in zip(got, ref):
            _close(nhwc(g), r, 2e-3)
        _, new = jax.jit(lambda v, a, b: jmod.apply(
            v, a, b, True, mutable=["batch_stats"]))(var, rgb, mx)
        tmod.train()(nchw(rgb), nchw(mx))
    _hold_stats(tmod, new["batch_stats"])
    assert isinstance(tmod.ffm1, tfusion.get_ffm(ffm))


def mask_of_jax(jmod, *inputs):
    """The JAX weight-decay mask of `jmod`'s parameters in the port's key
    space, from their shapes alone (each leaf a zero array of its ndim)."""
    params = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), *inputs))["params"]
    tiny = jax.tree_util.tree_map(
        lambda s: np.zeros((1,) * len(s.shape), np.float32), params)
    mask = joptim.weight_decay_mask(tiny)
    flags = jax.tree_util.tree_map(
        lambda m, t: np.full(t.shape, float(m), np.float32), mask, tiny)
    return {k: bool(v.reshape(-1)[0])
            for k, v in flax_params_to_torch(flags).items()}


def _cfg(backbone, **model_kw):
    return mfnet_config().replace(
        model=ModelConfig(backbone=backbone, **model_kw))


@pytest.mark.parametrize("name", sorted(tbuilder.RESNET_FACTORIES))
def test_every_resnet_name_has_the_jax_parameter_count(name):
    """Each registry name builds (meta device) with the JAX backbone's
    channels and parameter count (by eval_shape), every BatchNorm at
    momentum 0.1 and eps 1e-5, and the config's FRM/FFM."""
    cfg = _cfg(name)
    with torch.device("meta"):
        module, channels = tbuilder.build_backbone(cfg)
    jmod, jchannels = jbuilder.build_backbone(cfg)
    assert tuple(channels) == tuple(jchannels) == (256, 512, 1024, 2048)
    x = np.zeros((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, x))
    assert sum(p.numel() for p in module.parameters()) == sum(
        int(np.prod(v.shape))
        for v in jax.tree_util.tree_leaves(shapes["params"]))
    bns = [m for m in module.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(m.eps == 1e-5 and m.momentum == 0.1 for m in bns)
    assert isinstance(module.frm1, tfusion.FeatureRectifyModule)
    assert isinstance(module.ffm4, tfusion.FeatureFusionModule)


def test_builder_passes_the_fusion_and_the_kernel_switch():
    """FRM/FFM from the config; an IFFM takes the model's kernel switch
    (the one routing deviation from JAX, whose IFFM there has none); the
    whole model reads all four stages."""
    cfg = _cfg("resnet50", feature_rectify_module="IFRM",
               feature_fusion_module="IFFM", use_pallas_kernels=True,
               decoder="UPernet")
    with torch.device("meta"):
        model = tbuilder.EncoderDecoder(cfg)
    bb = model.backbone
    assert isinstance(bb.frm2, tfusion.ImprovedFeatureRectifyModule)
    assert all(getattr(bb, f"ffm{i}").cross.cross_attn.use_pallas
               for i in range(1, 5))
    assert [getattr(bb, f"ffm{i}").cross.cross_attn.num_heads
            for i in range(1, 5)] == list(tresnet.HEADS)
    assert model.every_param_in_loss and model.aux_head is not None


def test_decay_mask_matches_jax():
    """The weight-decay mask of a tower and of the fusion modules: the conv
    kernels (bias-free) decay, the BatchNorms and biases do not, as the
    JAX mask on the same tree."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    jmod = jresnet.DualResNet((1, 1, 1, 1))
    with torch.device("meta"):
        model = tresnet.DualResNet((1, 1, 1, 1))
    assert mask_of_jax(jmod, x, x) == toptim.weight_decay_mask(model)
    got = toptim.weight_decay_mask(model)
    assert got["backbone.layer2.0.downsample.0.weight"]
    assert not got["backbone_d.layer3.0.bn2.weight"]
    assert not got["frm1.channel_weights.mlp.0.bias"]


def _torchvision_keys(layers):
    """The state-dict keys of a torchvision ResNet with Bottleneck blocks,
    by its naming rules (fc included)."""
    bn = ("weight", "bias", "running_mean", "running_var",
          "num_batches_tracked")
    keys = ["conv1.weight"] + [f"bn1.{s}" for s in bn]
    for li, depth in enumerate(layers, start=1):
        for b in range(depth):
            p = f"layer{li}.{b}"
            for i in (1, 2, 3):
                keys += [f"{p}.conv{i}.weight"] + [f"{p}.bn{i}.{s}"
                                                   for s in bn]
            if b == 0:
                keys += [f"{p}.downsample.0.weight"] + [
                    f"{p}.downsample.1.{s}" for s in bn]
    return keys + ["fc.weight", "fc.bias"]


def test_tower_keys_are_torchvision_keys():
    """A resnet50 / resnet101 tower's state dict is torchvision's without
    the fc head (resnet50: 320 keys with it)."""
    for layers in ((3, 4, 6, 3), (3, 4, 23, 3)):
        with torch.device("meta"):
            tower = tresnet.ResNetTower(layers)
        want = _torchvision_keys(layers)
        assert list(tower.state_dict()) == want[:-2]
    assert len(_torchvision_keys((3, 4, 6, 3))) == 320


def test_load_dualpath_pretrained_resnet(tmp_path, monkeypatch):
    """A single-tower torchvision checkpoint (fc head included) loads into
    both towers: nothing in the file goes unused, the only keys left at
    init are the FRM/FFM ones, and both towers hold the file's values."""
    layers = (2, 1, 1, 1)
    monkeypatch.setattr(tresnet, "PLANES", (8, 16, 32, 64))
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        shapes = tresnet.ResNetTower(layers).state_dict()
    sd = {k: (torch.randint(0, 9, (), generator=gen) if v.dtype == torch.long
              else torch.randn(v.shape, generator=gen))
          for k, v in shapes.items()}
    sd["fc.weight"], sd["fc.bias"] = torch.randn(10, 256), torch.randn(10)
    assert sorted(sd) == sorted(_torchvision_keys(layers))
    path = tmp_path / "resnet.pth"
    torch.save(sd, path)
    model = types.SimpleNamespace(
        backbone=tresnet.DualResNet(layers))
    missing, unexpected = load_dualpath_pretrained(str(path), model,
                                                   family="resnet")
    assert unexpected == []
    assert missing and all(k.startswith(("frm", "ffm")) for k in missing)
    state = model.backbone.state_dict()
    for k, v in sd.items():
        if not k.startswith("fc."):
            assert torch.equal(state["backbone." + k], v), k
            assert torch.equal(state["backbone_d." + k], v), k


def test_sync_bn_reaches_every_batchnorm():
    """convert_sync_batchnorm swaps every BatchNorm of resnet50 + UPernet
    (towers, fusion, heads) for the global-statistics one."""
    with torch.device("meta"):
        model = tbuilder.EncoderDecoder(_cfg("resnet50", decoder="UPernet"))
    n = sum(type(m) is torch.nn.BatchNorm2d for m in model.modules())
    assert n > 2 * 53
    convert_sync_batchnorm(model)
    assert not any(type(m) is torch.nn.BatchNorm2d for m in model.modules())
    assert sum(isinstance(m, SyncBatchNorm2d) for m in model.modules()) == n
