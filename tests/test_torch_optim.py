"""The port's lr schedules, weight-decay mask and AdamW update against the
JAX package's (optax) on the CPU.

Tolerances: schedules 1e-6 relative (fp32 arithmetic on both sides; pow may
differ in the last bit); one AdamW update 1e-6 absolute on O(0.1) params.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rgbx_semantic_segmentation_tpu import lr_schedules as jsched
from rgbx_semantic_segmentation_tpu import optim as joptim
from rgbx_semantic_segmentation_tpu.config import (
    DatasetConfig, ModelConfig, TrainConfig, mfnet_config)
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu_torch import lr_schedules as tsched
from rgbx_semantic_segmentation_tpu_torch import optim as toptim
from rgbx_semantic_segmentation_tpu_torch.convert import (
    flax_params_to_torch, flax_to_torch_state_dict)
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from tests.test_torch_layers import random_variables

torch.set_num_threads(2)
TOTAL, WARM = 400, 40
STEPS = [0, 1, WARM - 1, WARM, 200, TOTAL, TOTAL + 7]


@pytest.mark.parametrize("step", STEPS)
def test_warmup_poly_matches_jax(step):
    ref = float(jsched.warmup_poly_lr(6e-5, 0.9, TOTAL, WARM)(step))
    got = tsched.warmup_poly_lr(6e-5, 0.9, TOTAL, WARM)(step)
    assert isinstance(got, float)
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("step", STEPS)
def test_poly_matches_jax(step):
    ref = float(jsched.poly_lr(2e-4, 0.9, TOTAL)(step))
    got = tsched.poly_lr(2e-4, 0.9, TOTAL)(step)
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-12)


def test_no_warmup_and_build_schedule():
    assert tsched.warmup_poly_lr(1e-3, 0.9, 100, 0)(0) == pytest.approx(1e-3)
    tc = TrainConfig(lr=1e-3, nepochs=2, niters_per_epoch=10, warm_up_epoch=1,
                     lr_stages=((1, 1e-3), (2, 1e-4)))
    for name in ("WarmUpPolyLR", "PolyLR", "MultiStageLR", "LinearIncreaseLR",
                 "CyclicLR", "StepLR"):
        t, j = tsched.build_schedule(name, tc), jsched.build_schedule(name, tc)
        for step in (0, 3, 10, 15, 20):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-6, abs=1e-12)
    with pytest.raises(KeyError):
        tsched.build_schedule("nope", tc)


def _cfg(**train_kw):
    return mfnet_config().replace(
        dataset=DatasetConfig(num_classes=9, image_height=32, image_width=32),
        model=ModelConfig(backbone="mit_b0", decoder="MLPDecoder",
                          decoder_embed_dim=64, use_mixed_precision=False),
        train=TrainConfig(lr=1e-3, nepochs=2, niters_per_epoch=4,
                          warm_up_epoch=1, **train_kw))


@pytest.fixture(scope="module")
def model_and_vars():
    cfg = _cfg()
    x = np.zeros((1, 32, 32, 3), np.float32)
    jmod = JaxEncoderDecoder(cfg=cfg)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, x))
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    return cfg, model, var


def test_decay_mask_matches_jax(model_and_vars):
    """mit_b0 + MLPDecoder: the same set of decayed names as the JAX mask
    carried into the port's key space."""
    _, model, var = model_and_vars
    jmask = joptim.weight_decay_mask(var["params"])
    ref = {k: bool(v.all()) for k, v in flax_params_to_torch(
        jax.tree_util.tree_map(lambda m, p: np.full(p.shape, bool(m)),
                               jmask, var["params"])).items()}
    got = toptim.weight_decay_mask(model)
    assert set(got) == set(ref)
    assert got == ref
    decayed = [k for k, v in got.items() if v]
    assert decayed and all(k.endswith(".weight") for k in decayed)
    assert "backbone.block1.0.mlp.dwconv.dwconv.weight" in decayed
    assert not got["backbone.block1.0.norm1.weight"]
    assert not got["decode_head.linear_fuse.1.weight"]  # BatchNorm scale
    assert not got["backbone.block1.0.attn.q.bias"]


def test_adamw_update_matches_optax(model_and_vars):
    """Two AdamW updates on seeded random gradients, at the scheduled lr of
    steps 1 and 2 (step 0 has lr 0), against optax.adamw with the mask."""
    cfg, model, var = model_and_vars
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(3)
    params = var["params"]
    tx = joptim.build_optimizer(cfg, params)
    state = tx.init(params)
    opt = toptim.build_optimizer(cfg, model)
    sched = tsched.build_schedule(cfg.train.lr_policy, cfg.train)
    named = dict(model.named_parameters())
    try:
        # optax's schedule counts updates from 0: burn step 0 (lr 0) first
        zero = jax.tree_util.tree_map(jnp.zeros_like, params)
        _, state = tx.update(zero, state, params)
        jparams = params
        for step in (1, 2):
            grads = jax.tree_util.tree_map(
                lambda p: rng.randn(*p.shape).astype(np.float32) * 1e-2,
                params)
            updates, state = tx.update(grads, state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            if step == 1:  # torch's Adam step count must match optax's
                toptim.set_lr(opt, sched(0))
                for p in named.values():
                    p.grad = torch.zeros_like(p)
                opt.step()
            toptim.set_lr(opt, sched(step))
            for k, g in flax_params_to_torch(grads).items():
                named[k].grad = g.clone()
            opt.step()
            assert toptim.applied_lr(opt) == pytest.approx(
                joptim.applied_lr(state), rel=1e-6)
        ref = flax_params_to_torch(jparams)
        assert set(ref) == set(named)
        moved = 0.0
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)
            moved = max(moved, (p.detach() - sd0[k]).abs().max().item())
        assert moved > 1e-4  # the update did something
    finally:
        model.load_state_dict(sd0)


def test_unknown_optimizer_raises(model_and_vars):
    _, model, _ = model_and_vars
    with pytest.raises(KeyError):
        toptim.build_optimizer(_cfg(optimizer="nope"), model)
