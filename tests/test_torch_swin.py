"""The port's dual Swin encoder (rgbx_semantic_segmentation_tpu_torch/
models/encoders/dual_swin.py) against the JAX modules on the CPU in fp32:
SwinBlock (shifted and not), PatchMerging (odd H and W), PatchEmbed
(padding), a small DualSwinTransformer on both attention routes, the whole
EncoderDecoder built from config, and one train step (loss and every
gradient, the relative-position bias tables included).

Weights: numpy from a seed on the JAX module's variable tree
(test_torch_layers.random_variables; the bias tables are scaled up so that
they matter), carried over with flax_to_torch_state_dict and loaded
strictly. The JAX side runs its XLA composition; with use_pallas it runs
its Pallas kernel in interpret mode, as tests/test_window_attention.py
does. Drop rates are 0 wherever the two packages are compared (their
generators differ). Tolerances: module outputs 2e-4 (fp32 summation order
through a few layers at outputs of magnitude ~1); the rest at its test.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

os.environ.setdefault("RGBX_PALLAS_INTERPRET", "1")

from rgbx_semantic_segmentation_tpu import losses as jlosses
from rgbx_semantic_segmentation_tpu.config import (
    DatasetConfig, ModelConfig, TrainConfig, mfnet_config)
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu.models.encoders import dual_swin as jswin
from rgbx_semantic_segmentation_tpu_torch import train as ttrain
from rgbx_semantic_segmentation_tpu_torch.convert import (
    flax_params_to_torch, flax_to_torch_state_dict)
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_swin as tswin)
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as W
from tests.test_torch_layers import nchw, nhwc, port_module, random_variables

torch.set_num_threads(2)


def _variables(init_fn, seed=0):
    """random_variables with the bias tables at magnitude ~0.5."""
    var = random_variables(init_fn, seed=seed)

    def scale(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                scale(v)
            elif k == "relative_position_bias_table":
                tree[k] = v * 10.0
    scale(var["params"])
    return var


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("B,H,W,C,heads,ws,shift", [
    (2, 10, 13, 24, 4, 7, 3),    # pads 10x13 -> 14x14, shifted
    (1, 21, 14, 16, 2, 7, 0),    # exact fit, unshifted
    (2, 9, 20, 32, 2, 7, 0),     # pads, unshifted
    (1, 13, 24, 16, 2, 12, 6),   # window 12 (swin_b)
])
def test_swin_block_matches_jax(B, H, W, C, heads, ws, shift, use_pallas):
    x = np.random.RandomState(0).randn(B, H * W, C).astype(np.float32)
    kw = dict(dim=C, num_heads=heads, window_size=ws, shift_size=shift)
    jmod = jswin.SwinBlock(use_pallas=use_pallas, **kw)
    var = _variables(lambda: jmod.init(jax.random.PRNGKey(0), x, H, W))
    ref = np.asarray(jmod.apply(var, x, H, W))
    tmod = port_module(tswin.SwinBlock(use_pallas=use_pallas, **kw), var)
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), H, W).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("H,W", [(7, 9), (8, 6), (5, 5)])
def test_patch_merging_matches_jax(H, W):
    x = np.random.RandomState(1).randn(2, H * W, 16).astype(np.float32)
    jmod = jswin.PatchMerging(16)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, H, W))
    ref = np.asarray(jmod.apply(var, x, H, W))
    tmod = port_module(tswin.PatchMerging(16), var)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), H, W).numpy()
    assert got.shape == ref.shape == (2, ((H + 1) // 2) * ((W + 1) // 2), 32)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("H,W", [(16, 16), (18, 21), (15, 8)])
def test_patch_embed_matches_jax(H, W):
    x = np.random.RandomState(2).randn(2, H, W, 3).astype(np.float32)
    jmod = jswin.PatchEmbed(4, 24)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x))
    ref, rh, rw = jmod.apply(var, x)
    tmod = port_module(tswin.PatchEmbed(4, 3, 24), var)
    with torch.no_grad():
        got, gh, gw = tmod(nchw(x))
    assert (gh, gw) == (rh, rw) == ((H + 3) // 4, (W + 3) // 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=0)


SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
             window_size=7, drop_path_rate=0.0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dual_swin_matches_jax(use_pallas):
    """64x96 input: token maps 16x24 / 8x12 / 4x6 / 2x3, so every stage pads
    to its windows and every second block shifts."""
    rng = np.random.RandomState(3)
    rgb = rng.randn(2, 64, 96, 3).astype(np.float32)
    mx = rng.randn(2, 64, 96, 3).astype(np.float32)
    jmod = jswin.DualSwinTransformer(use_pallas=use_pallas, **SMALL)
    var = _variables(lambda: jmod.init(jax.random.PRNGKey(0), rgb, mx))
    ref = jax.jit(jmod.apply)(var, rgb, mx)
    tmod = port_module(tswin.DualSwinTransformer(use_pallas=use_pallas,
                                                 **SMALL), var)
    tmod.eval()
    with torch.no_grad():
        got = tmod(nchw(rgb), nchw(mx))
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape[1] == 32 * 2 ** i
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=2e-4, rtol=0,
                                   err_msg=f"stage {i}")


def test_both_routes_agree_and_route_through_the_op():
    """use_pallas sends every block through ops.window_attention (the plain
    version on the CPU, never a kernel launch); without it no block does."""
    calls = []
    real = W.window_attention

    def spy(*args):
        qkv, bias = args[:2]
        calls.append(qkv.shape)
        # what the kernels take: a contiguous image, whole bias blocks
        assert qkv.is_contiguous() and bias[0].is_contiguous()
        assert bias.stride(0) in (0, bias[0].numel()) or bias.shape[0] == 1
        return real(*args)

    x = torch.from_numpy(np.random.RandomState(4).randn(
        1, 3, 64, 96).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    mods = [tlayers.init_weights(tswin.DualSwinTransformer(
        use_pallas=p, **SMALL), g.manual_seed(0)).eval() for p in (True, False)]
    outs = []
    tswin.WA.window_attention = spy
    try:
        for m in mods:
            before = (real.launches, len(calls))
            with torch.no_grad():
                outs.append(m(x, x))
            assert real.launches == before[0]
            assert len(calls) - before[1] == (16 if m is mods[0] else 0)
    finally:
        tswin.WA.window_attention = real
    assert calls[0] == (1, 21, 28, 96) and calls[-1] == (1, 7, 7, 768)
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=0)
    with tswin.plain_attention(mods[0]):
        assert not any(m.use_pallas for m in mods[0].modules()
                       if isinstance(m, tswin.SwinBlock))
    assert all(m.use_pallas for m in mods[0].modules()
               if isinstance(m, tswin.SwinBlock))


def test_use_pallas_alone_routes_a_block_to_the_op():
    """A head dim the kernels do not take (160 > 128) still goes to the op
    when use_pallas is set: the block does not choose the plain composition
    by shape. On the CPU the op runs its plain version (any shape); on the
    card it raises (tests/test_torch_window_attention.py)."""
    assert not W.usable(49, 160)
    x = torch.from_numpy(np.random.RandomState(6).randn(
        1, 7 * 9, 160).astype(np.float32))
    blk = tswin.SwinBlock(160, 1, 7, 3, use_pallas=True).eval()
    tlayers.init_weights(blk, torch.Generator().manual_seed(0))
    calls = []
    real = W.window_attention
    tswin.WA.window_attention = lambda *a: calls.append(a[0].shape) or real(*a)
    try:
        with torch.no_grad():
            got = blk(x, 7, 9)
            blk.use_pallas = False
            want = blk(x, 7, 9)
    finally:
        tswin.WA.window_attention = real
    assert calls == [(1, 7, 14, 480)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


def test_init_weights_reaches_the_bias_tables():
    model = tswin.DualSwinTransformer(**SMALL)
    tlayers.init_weights(model, torch.Generator().manual_seed(0))
    tables = [p for n, p in model.named_parameters()
              if n.endswith("relative_position_bias_table")]
    assert len(tables) == 16
    for t in tables:
        t = t.detach()
        assert 0.01 < float(t.std()) < 0.03 and float(t.abs().max()) <= 0.0455


def test_kernel_dropout_in_training_is_seeded_by_the_generator():
    """Training with attn_drop > 0 on the kernel route draws its seed from
    the module's generator: same generator state, same output; eval mode
    drops nothing."""
    blk = tswin.SwinBlock(16, 2, 7, 3, attn_drop=0.3, use_pallas=True)
    tlayers.init_weights(blk, torch.Generator().manual_seed(0))
    g = torch.Generator()
    tlayers.set_generator(blk, g)
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, 10 * 13, 16).astype(np.float32))
    blk.train()
    a = blk(x, 10, 13)
    b = blk(x, 10, 13)
    g.manual_seed(g.initial_seed())
    c = blk(x, 10, 13)
    assert torch.equal(a, c) and not torch.equal(a, b)
    blk.eval()
    assert torch.equal(blk(x, 10, 13), blk(x, 10, 13))


# ------------------------------------------------------ the whole model ----


def _cfg(backbone="swin_s", **model_kw):
    kw = dict(backbone=backbone, decoder="MLPDecoder", decoder_embed_dim=64,
              use_mixed_precision=False, drop_path_rate=0.0,
              decoder_dropout_ratio=0.0)
    kw.update(model_kw)
    return mfnet_config().replace(
        dataset=DatasetConfig(num_classes=5, image_height=64, image_width=64,
                              class_names=tuple("abcde")),
        model=ModelConfig(**kw),
        train=TrainConfig(batch_size=2, nepochs=2, niters_per_epoch=4,
                          warm_up_epoch=1, lr=1e-3))


@pytest.fixture(scope="module")
def swin_s_pair():
    """The JAX swin_s EncoderDecoder at 64x64 with numpy weights and the
    port's model loaded strictly from them."""
    cfg = _cfg()
    rng = np.random.RandomState(6)
    batch = {"rgb": rng.randn(2, 64, 64, 3).astype(np.float32),
             "modal_x": rng.randn(2, 64, 64, 3).astype(np.float32),
             "label": rng.randint(0, 5, size=(2, 64, 64)).astype(np.int32)}
    batch["label"][rng.rand(2, 64, 64) < 0.05] = 255
    jmod = JaxEncoderDecoder(cfg=cfg)
    var = _variables(lambda: jmod.init(
        jax.random.PRNGKey(0), batch["rgb"][:1], batch["modal_x"][:1]), seed=7)
    model = build_model(cfg, device="cpu", seed=None)
    res = model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    return cfg, batch, jmod, var, model


def test_whole_model_matches_jax(swin_s_pair):
    """swin_s (full width and depth) + MLPDecoder from config, eval mode:
    logits atol 2e-3 (48 blocks of both towers, the decoder and the
    upsample), argmax agreement > 0.999."""
    cfg, batch, jmod, var, model = swin_s_pair
    ref = np.asarray(jax.jit(jmod.apply)(var, batch["rgb"], batch["modal_x"]))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(batch["rgb"]),
                    torch.from_numpy(batch["modal_x"])).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 5)
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.999


def test_train_step_loss_and_gradients_match_jax(swin_s_pair):
    """One train-mode forward and backward of swin_s + MLPDecoder with the
    attention dropout off (both towers built with attn_drop_rate = 0)
    against jax.value_and_grad of the JAX model and loss. Loss rtol 1e-5;
    per tensor, max abs error <= 1e-5 + 2e-3 of the tensor's largest
    gradient, the 48 relative-position bias tables included."""
    cfg, batch, jmod, var, model = swin_s_pair
    from rgbx_semantic_segmentation_tpu.models.decoders.mlp_decoder import (
        MLPDecoder as JaxDecoder)

    jback = jswin.swin_s(use_pallas=True).clone(attn_drop_rate=0.0,
                                                drop_path_rate=0.0)
    jhead = JaxDecoder(num_classes=5, embed_dim=64, dropout_ratio=0.0,
                       bn_momentum=cfg.model.bn_momentum,
                       bn_eps=cfg.model.bn_eps)

    def loss_fn(params):
        stats = var["batch_stats"]
        feats, s1 = jback.apply(
            {"params": params["backbone"], "batch_stats": stats["backbone"]},
            batch["rgb"], batch["modal_x"], True, mutable=["batch_stats"])
        out, s2 = jhead.apply(
            {"params": params["decode_head"],
             "batch_stats": stats["decode_head"]},
            feats, True, mutable=["batch_stats"])
        out = jax.image.resize(out, (2, 64, 64, 5), "bilinear")
        return jlosses.cross_entropy_loss(out, batch["label"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(var["params"])
    for m in model.modules():
        if isinstance(m, tswin.WindowAttention):
            m.attn_drop.rate = 0.0
    model.train()
    model.zero_grad()
    loss = ttrain.make_loss_fn(cfg)(
        model(torch.from_numpy(batch["rgb"]),
              torch.from_numpy(batch["modal_x"])),
        torch.from_numpy(batch["label"]))
    loss.backward()
    model.eval()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    ref = flax_params_to_torch(jgrads)
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    tables = [k for k in named if k.endswith("relative_position_bias_table")]
    assert len(tables) == 48
    for k, p in named.items():
        r = ref[k].numpy()
        tol = 1e-5 + 2e-3 * np.abs(r).max()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=tol, rtol=0,
                                   err_msg=k)
    assert all(np.abs(ref[k].numpy()).max() > 0 for k in tables)


def test_trainer_steps_on_swin():
    """Trainer.step on a swin_s model with the preset's drop rates on the
    CPU, labels a function of the rgb input: finite losses, below the first
    after 4 steps on the repeated batch (AdamW's first steps overshoot),
    and every bias table moves."""
    cfg = _cfg(drop_path_rate=0.1)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, warm_up_epoch=0,
                                                lr=2e-4))
    rng = np.random.RandomState(8)
    rgb = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    batch = {"rgb": rgb,
             "modal_x": rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
             "label": (rgb[..., 0] // 52).astype(np.uint8)}
    trainer = ttrain.Trainer(cfg, device="cpu", seed=0)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()
              if n.endswith("relative_position_bias_table")}
    losses = [float(trainer.step(batch)["loss"]) for _ in range(4)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    named = dict(trainer.model.named_parameters())
    assert len(before) == 48
    assert all(not torch.equal(named[n], v) for n, v in before.items())


def test_swin_b_builds_and_matches_jax_parameter_count():
    cfg = _cfg("swin_b")
    x = np.zeros((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(
        lambda: JaxEncoderDecoder(cfg=cfg).init(jax.random.PRNGKey(0), x, x))
    n_jax = sum(int(np.prod(v.shape))
                for v in jax.tree_util.tree_leaves(shapes["params"]))
    model = build_model(cfg, device="cpu", seed=None)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    blocks = [m for m in model.modules() if isinstance(m, tswin.SwinBlock)]
    assert len(blocks) == 48 and blocks[1].shift_size == 6
    assert blocks[0].attn.attn_drop.rate == 0.3
