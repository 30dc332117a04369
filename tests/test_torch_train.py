"""The port's train step against the JAX package's on the CPU in fp32:
train-mode BatchNorm, loss and all gradients of the tiny model, an N-step
loss and parameter trajectory of `Trainer.step` against `make_train_step`,
device normalisation of uint8 batches, the mask stream of drop-path and
dropout, and the trainer's control flow.

Weights come from the JAX init (or numpy on the JAX tree) and are carried
over with flax_to_torch_state_dict; inputs are numpy from a seed. Drop rates
are 0 wherever the two packages are compared (their generators differ).
Each tolerance is stated at its test.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import losses as jlosses
from rgbx_semantic_segmentation_tpu import train as jtrain
from rgbx_semantic_segmentation_tpu.config import (
    DatasetConfig, ModelConfig, TrainConfig, mfnet_config)
from rgbx_semantic_segmentation_tpu.models import fusion as jfusion
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu.models.decoders import mlp_decoder as jdec
from rgbx_semantic_segmentation_tpu_torch import losses as tlosses
from rgbx_semantic_segmentation_tpu_torch import train as ttrain
from rgbx_semantic_segmentation_tpu_torch.convert import (
    flax_params_to_torch, flax_to_torch_state_dict)
from rgbx_semantic_segmentation_tpu_torch.data import cv_ops
from rgbx_semantic_segmentation_tpu_torch.models import fusion as tfusion
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.models.decoders import (
    mlp_decoder as tdec)
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from tests.test_torch_layers import nchw, nhwc, random_variables

torch.set_num_threads(2)


def tiny_cfg(batch=4, **model_kw):
    """The tests/test_train_step.py geometry at mit_tiny, drop rates 0."""
    kw = dict(backbone="mit_tiny", decoder="MLPDecoder", decoder_embed_dim=64,
              use_mixed_precision=False, drop_path_rate=0.0,
              decoder_dropout_ratio=0.0)
    kw.update(model_kw)
    return mfnet_config().replace(
        dataset=DatasetConfig(num_classes=5, image_height=32, image_width=32,
                              class_names=tuple("abcde")),
        model=ModelConfig(**kw),
        train=TrainConfig(batch_size=batch, nepochs=2, niters_per_epoch=4,
                          warm_up_epoch=1, lr=1e-3))


def synthetic_batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    B = cfg.train.batch_size
    H, W = cfg.dataset.image_height, cfg.dataset.image_width
    label = rng.randint(0, cfg.dataset.num_classes, size=(B, H, W))
    label[rng.rand(B, H, W) < 0.05] = 255
    return {"rgb": rng.randn(B, H, W, 3).astype(np.float32),
            "modal_x": rng.randn(B, H, W, 3).astype(np.float32),
            "label": label.astype(np.int32)}


# --------------------------------------------------- train-mode BatchNorm --


def _stats(sd):
    return {k: v.numpy() for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def test_channel_embed_train_bn_matches_jax():
    """Batch statistics normalise, running stats move with bn_momentum and
    the UNBIASED variance (what the JAX TorchBatchNorm re-creates). atol
    1e-4 on O(1) outputs, 1e-5 on the statistics (fp32 summation order and
    E[x^2]-E[x]^2 against torch's two-pass variance)."""
    H, W = 3, 2   # 12 elements per channel: the unbiased factor is 12/11
    x = np.random.RandomState(0).randn(2, H * W, 64).astype(np.float32)
    jmod = jfusion.ChannelEmbed(64, 32, bn_momentum=0.3, bn_eps=1e-3)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, H, W))
    ref, new = jmod.apply(var, x, H, W, True, mutable=["batch_stats"])
    tmod = tfusion.ChannelEmbed(64, 32, bn_momentum=0.3, bn_eps=1e-3)
    tmod.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    tmod.train()
    got = tmod(torch.from_numpy(x), H, W)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-4, rtol=0)
    want = _stats(flax_to_torch_state_dict(
        {"batch_stats": new["batch_stats"]}))
    have = _stats(tmod.state_dict())
    before = _stats(flax_to_torch_state_dict(
        {"batch_stats": var["batch_stats"]}))
    assert set(want) == set(have) and len(want) == 4
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
        assert np.abs(have[k] - before[k]).max() > 1e-3, k


def test_mlp_decoder_train_bn_matches_jax():
    chans = (32, 64, 160, 256)
    feats = [np.random.RandomState(10 + i).randn(
        2, 8 >> i, 8 >> i, c).astype(np.float32) for i, c in enumerate(chans)]
    jmod = jdec.MLPDecoder(num_classes=5, embed_dim=32, dropout_ratio=0.0,
                           bn_momentum=0.1, bn_eps=1e-3)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), feats))
    ref, new = jmod.apply(var, feats, True, mutable=["batch_stats"])
    tmod = tdec.MLPDecoder(chans, 5, embed_dim=32, dropout_ratio=0.0,
                           bn_momentum=0.1, bn_eps=1e-3)
    tmod.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    tmod.train()
    got = tmod([nchw(f) for f in feats])
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-4, rtol=0)
    want = _stats(flax_to_torch_state_dict(
        {"batch_stats": new["batch_stats"]}))
    have = _stats(tmod.state_dict())
    for k in want:
        np.testing.assert_allclose(have[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    assert int(tmod.linear_fuse[1].num_batches_tracked) == 1


# ------------------------------------------------------ loss and gradients --


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    batch = synthetic_batch(cfg)
    jmod = JaxEncoderDecoder(cfg=cfg)
    var = random_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), batch["rgb"][:1],
                          batch["modal_x"][:1]), seed=11)
    return cfg, batch, jmod, var


def test_loss_and_all_gradients_match_jax(tiny):
    """Train-mode forward, cross-entropy and every parameter's gradient of
    the tiny model against jax.value_and_grad. Loss rtol 1e-5. Gradients:
    per tensor, max abs error <= 1e-5 + 2e-3 of the tensor's largest
    gradient (fp32 on both sides; summation order through ~25 layers and two
    normalisation flavours; measured ~1e-4 of the largest gradient)."""
    cfg, batch, jmod, var = tiny

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
    for k, p in named.items():
        r = ref[k].numpy()
        tol = 1e-5 + 2e-3 * np.abs(r).max()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=tol, rtol=0,
                                   err_msg=k)


# A per-channel constant added in front of a BatchNorm, directly or through
# linear maps and resizes, has a true gradient of exactly 0 (the norm
# subtracts the batch mean); under AdamW it follows rounding noise. In this
# model: the ChannelEmbed biases and, since the decoder embeds and fuses the
# FFM outputs linearly before its own BatchNorm, the FFM's final norm bias
# and the decoder's embedding and fuse biases.
ZERO_GRADIENT = re.compile(
    r"channel_embed\.[34]\.bias$|channel_emb\.norm\.bias$"
    r"|linear_c\d\.proj\.bias$|linear_fuse\.0\.bias$")


def test_step_trajectory_matches_jax():
    """5 steps of Trainer.step against the jitted JAX make_train_step on one
    batch from the same weights (the JAX init, converted). Losses: rtol
    1e-3. Parameters: AdamW moves every coordinate by about lr a step
    whatever its gradient's size, so a coordinate whose gradient is ~0
    follows rounding noise: no coordinate may differ by more than the
    2 * lr * steps it can travel, and per tensor (ZERO_GRADIENT ones aside)
    the MEAN abs difference must stay below 2% of the distance travelled.
    BatchNorm running stats: lr * steps (they see the drift of those
    zero-gradient biases; the two BatchNorm tests above hold them tightly)."""
    cfg = tiny_cfg()
    batch = synthetic_batch(cfg, seed=1)
    steps = 5
    state = jtrain.create_train_state(cfg, jax.random.PRNGKey(0))
    start = flax_to_torch_state_dict(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)})
    trainer = ttrain.Trainer(cfg, device="cpu", seed=0, init_values=False)
    trainer.model.load_state_dict(start, strict=True)
    jstep = jtrain.make_train_step(cfg)
    jl, tl = [], []
    for _ in range(steps):
        state, metrics = jstep(state, batch)
        jl.append(float(metrics["loss"]))
        tl.append(float(trainer.step(batch)["loss"]))
    assert trainer.global_step == steps == int(state.step)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    end = flax_to_torch_state_dict(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)})
    lr = cfg.train.lr
    sd = trainer.model.state_dict()
    travelled, off = 0.0, {}
    for k, ref in end.items():
        got = sd[k]
        if k.endswith("num_batches_tracked"):
            assert int(got) == steps
            continue
        diff = (got - ref).abs()
        if k.endswith(("running_mean", "running_var")):
            assert diff.max().item() <= lr * steps, k
            continue
        moved = (ref - start[k]).abs().mean().item()
        travelled = max(travelled, moved)
        assert diff.max().item() <= 2 * lr * steps, k
        if not ZERO_GRADIENT.search(k):
            off[k] = (diff.mean().item(), moved)
    bad = {k: v for k, v in off.items() if v[0] > 0.02 * v[1] + 1e-7}
    assert not bad, sorted(bad)
    assert travelled > lr  # the parameters did move


def test_uint8_batch_matches_fp32_batch():
    """uint8 batches normalised on the device give the first loss of
    host-normalised fp32 batches (same fp32 ops: rel 1e-6), and labels may
    come as uint8."""
    cfg = tiny_cfg()
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 255, (4, 32, 32, 3)).astype(np.uint8)
    mx = rng.randint(0, 255, (4, 32, 32, 3)).astype(np.uint8)
    label = rng.randint(0, 5, (4, 32, 32)).astype(np.uint8)
    norm = lambda x: cv_ops.normalize(x, cfg.dataset.norm_mean,
                                      cfg.dataset.norm_std)
    batches = [{"rgb": rgb, "modal_x": mx, "label": label},
               {"rgb": norm(rgb), "modal_x": norm(mx),
                "label": label.astype(np.int32)}]
    losses = [float(ttrain.Trainer(cfg, device="cpu", seed=3).step(b)["loss"])
              for b in batches]
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)


# ------------------------------------------------------------ randomness --


@pytest.mark.parametrize("cls", [tlayers.DropPath, tlayers.Dropout,
                                 tlayers.Dropout2d])
def test_stochastic_layers(cls):
    x = torch.ones(64, 8, 6, 6)
    assert cls(0.0).train()(x) is x           # rate 0: the identity
    assert cls(0.5).eval()(x) is x            # eval: the identity
    m = cls(0.25).train()
    m.generator = torch.Generator().manual_seed(0)
    y = m(x)
    assert set(y.unique().tolist()) <= {0.0, float(np.float32(1.0 / 0.75))}
    # the mean is kept: 64 to 18432 draws at keep 0.75, five sigma
    n = {tlayers.DropPath: 64, tlayers.Dropout2d: 64 * 8}.get(cls, x.numel())
    assert abs(y.mean().item() - 1.0) < 5 * (0.25 / 0.75 / n) ** 0.5
    if cls is tlayers.DropPath:    # whole samples
        assert (y.flatten(1).min(1).values == y.flatten(1).max(1).values).all()
    if cls is tlayers.Dropout2d:   # whole channel maps
        assert (y.flatten(2).min(2).values == y.flatten(2).max(2).values).all()
    m.generator.manual_seed(0)
    assert torch.equal(m(x), y)               # same seed, same mask
    m.generator.manual_seed(1)
    assert not torch.equal(m(x), y)
    with pytest.raises(ValueError):
        cls(1.0)


def test_seed_and_step_fix_the_masks():
    """The same (seed, step) draws the same masks (a resumed run repeats the
    stream) and another seed or step draws others; mirrors the JAX
    test_train_step_seed_override_changes_dropout_stream."""
    cfg = tiny_cfg(drop_path_rate=0.5, decoder_dropout_ratio=0.5)
    batch = synthetic_batch(cfg)

    def run(seed, step, weights=None):
        tr = ttrain.Trainer(cfg, device="cpu", seed=0)
        if weights is not None:
            tr.model.load_state_dict(weights)
        start = {k: v.clone() for k, v in tr.model.state_dict().items()}
        step_fn = ttrain.make_train_step(cfg, tr.model, tr.optimizer,
                                         seed=seed)
        return float(step_fn(step, batch)), start

    a, weights = run(111, 3)
    assert run(111, 3, weights)[0] == a        # deterministic per (seed, step)
    assert run(222, 3, weights)[0] != a        # independent across seeds
    assert run(111, 4, weights)[0] != a        # and across steps
    assert ttrain.step_seed(1, 2) != ttrain.step_seed(2, 1)


def test_attention_dropout_takes_the_plain_path():
    """attn_drop > 0 in training: dropout on the probs of the plain path, as
    the JAX Attention; eval stays on the kernel dispatch and is unchanged."""
    from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
        dual_segformer as tseg)

    x = torch.randn(2, 64, 32)
    plain = tseg.Attention(32, num_heads=2, sr_ratio=2, use_pallas=True)
    drop = tseg.Attention(32, num_heads=2, sr_ratio=2, use_pallas=True,
                          attn_drop=0.5)
    drop.load_state_dict(plain.state_dict())
    torch.testing.assert_close(drop.eval()(x, 8, 8), plain.eval()(x, 8, 8))
    drop.train()
    drop.attn_dropout.generator = torch.Generator().manual_seed(0)
    y1 = drop(x, 8, 8)
    drop.attn_dropout.generator.manual_seed(0)
    assert torch.equal(drop(x, 8, 8), y1)
    assert not torch.allclose(y1, plain.train()(x, 8, 8))
    drop.attn_dropout.rate = 0.0   # same path, no mask: the plain numbers
    torch.testing.assert_close(drop(x, 8, 8), plain(x, 8, 8),
                               atol=1e-5, rtol=1e-5)
    y1.sum().backward()
    assert drop.q.weight.grad is not None


# ---------------------------------------------------------- control flow --


def test_fit_epoch_and_should_stop():
    cfg = tiny_cfg(batch=2)
    batch = synthetic_batch(cfg)
    tr = ttrain.Trainer(cfg, device="cpu", seed=0)

    def batches():
        while True:
            yield batch

    calls = []

    def stop_after_two():
        calls.append(1)
        return len(calls) > 2

    mean = tr.fit_epoch(batches(), niters=4, should_stop=stop_after_two)
    assert tr.global_step == 2 and tr.epoch == 1 and np.isfinite(mean)
    assert tr.fit_epoch(batches(), niters=3, should_stop=lambda: True) == 0.0
    assert tr.global_step == 2 and tr.epoch == 2

    class Log:
        lines = []

        def info(self, fmt, *args):
            self.lines.append(fmt % args)

    mean = tr.fit_epoch(batches(), niters=2, log_every=1, logger=Log())
    assert tr.global_step == 4 and len(Log.lines) == 2
    assert "loss" in Log.lines[0] and "img/s" in Log.lines[0]
    # step 0 ran at lr 0 (warm-up); by now the schedule has a positive lr
    from rgbx_semantic_segmentation_tpu_torch import optim as toptim
    assert toptim.applied_lr(tr.optimizer) == pytest.approx(
        cfg.train.lr * 3 / 4, rel=1e-6)


def test_trainer_default_device_and_unported_outputs():
    """The trainer defaults to the card. The outputs and criteria that
    raised before now give the JAX make_loss_fn's loss (rtol 1e-5): the
    mask2former dict (its own loss, no criterion) and DiceLoss."""
    cfg = tiny_cfg()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.Trainer(cfg)
    rng = np.random.RandomState(0)
    label = rng.randint(0, 5, (2, 8, 8)).astype(np.int32)
    label[0, 0] = 255
    m2f = cfg.replace(model=dataclasses.replace(cfg.model,
                                                decoder="mask2former"))
    out = {"pred_logits": rng.randn(2, 6, 6).astype(np.float32),
           "pred_masks": rng.randn(2, 6, 8, 8).astype(np.float32)}
    got = ttrain.make_loss_fn(m2f)(
        {k: torch.from_numpy(v) for k, v in out.items()},
        torch.from_numpy(label))
    assert float(got) == pytest.approx(
        float(jtrain.make_loss_fn(m2f)(out, label)), rel=1e-5)
    dice = cfg.replace(train=dataclasses.replace(cfg.train,
                                                 criterion="DiceLoss"))
    logits = rng.randn(2, 8, 8, 5).astype(np.float32)
    got = ttrain.make_loss_fn(dice)(torch.from_numpy(logits),
                                    torch.from_numpy(label))
    assert float(got) == pytest.approx(
        float(jtrain.make_loss_fn(dice)(logits, label)), rel=1e-5)
    assert tlosses.build_criterion(cfg) is not None
