"""SGDM and SGD in the port's Trainer against the JAX package on the CPU.

- Each optimizer under each of the 6 lr schedules: 3 Trainer steps on
  mit_tiny at 32x32 (float64: the model converted with .double(), float64
  batches; drop rates 0), and the JAX package's optimizer
  (optim.build_optimizer: optax's add_decayed_weights on the decay mask,
  then sgd's momentum trace, the schedule and, under CyclicLR, the momentum
  schedule injected) fed the same gradients, step by step, on the same
  start. SGD's update is elementwise, so the JAX optimizer runs on the
  model's parameters packed into two vectors, the decayed kernels and the
  rest (the port's weight_decay_mask, which tests/test_torch_optim.py
  holds against the JAX mask): 300 leaves made each eager optax update
  take ~6 s on the CPU, and jitting it ~15 s. With niters_per_epoch = 1
  every step is an epoch: the 3 steps cross the warm-up's end,
  MultiStageLR's and StepLR's boundaries and CyclicLR's restart.
  Parameters to 1e-12 of the model's largest move and momentum buffers to
  1e-10 (float64 summation order only); the applied lr and momentum read
  back from each optimizer to 1e-7 relative (both fp32 schedules).
- SGDM under CyclicLR (the momentum schedule) through the JAX package's
  whole jitted make_train_step, fp32, at 64x64: at 32x32 (1x1 stage-4
  maps, train-mode BatchNorm over 4 values) the gradients are so
  ill-conditioned that fp32 rounding moves the updates by 4e-4. Losses
  rel 5e-6 (read 1.2e-6); each parameter tensor within 1e-5 of its norm
  plus 2e-3 of the distance it moved (read: 5.7e-4 of the move at most;
  fp32 gradients of two summation orders), every coordinate within 5e-4 of
  the model's largest move (read 1.4e-4); BatchNorm statistics 1e-3
  relative (the JAX TorchBatchNorm's fp32 E[x^2] - E[x]^2).
"""
import dataclasses

import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch import optim as toptim
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.train import Trainer
from tests.test_torch_ddp import ZERO_GRADIENT

torch.set_num_threads(2)
BATCH, STEPS = 4, 3
SCHEDULES = ("WarmUpPolyLR", "PolyLR", "MultiStageLR", "LinearIncreaseLR",
             "CyclicLR", "StepLR")


def tiny_cfg(optimizer, lr_policy, hw=32, cfg_lib=tconfig):
    return cfg_lib.mfnet_config().replace(
        dataset=cfg_lib.DatasetConfig(num_classes=5, image_height=hw,
                                      image_width=hw,
                                      class_names=tuple("abcde")),
        model=cfg_lib.ModelConfig(
            backbone="mit_tiny", decoder="MLPDecoder", decoder_embed_dim=64,
            use_mixed_precision=False, use_pallas_kernels=False,
            drop_path_rate=0.0, decoder_dropout_ratio=0.0),
        train=cfg_lib.TrainConfig(
            batch_size=BATCH, optimizer=optimizer, lr_policy=lr_policy,
            lr=1e-4, momentum=0.9, weight_decay=0.01, nepochs=3,
            niters_per_epoch=1, warm_up_epoch=1, lr_power=0.9,
            lr_stages=((1, 1e-4), (2, 4e-5)), end_lr=2e-4, min_lr=2e-5,
            cycle_epochs=2, lr_step_size=1, lr_gamma=0.5))


def batch_of(hw=32, dtype=np.float64, seed=0):
    """Host-normalised inputs."""
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 5, size=(BATCH, hw, hw))
    label[rng.rand(BATCH, hw, hw) < 0.05] = 255
    return {"rgb": rng.randn(BATCH, hw, hw, 3).astype(dtype),
            "modal_x": rng.randn(BATCH, hw, hw, 3).astype(dtype),
            "label": label.astype(np.int32)}


def _hyperparam(opt_state, name):
    """An injected hyperparameter (optax inject_hyperparams) of the JAX
    optimizer's state."""
    hp = getattr(opt_state, "hyperparams", None)
    if isinstance(hp, dict) and name in hp:
        return float(hp[name])
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            got = _hyperparam(s, name)
            if got is not None:
                return got
    return None


def _trace(opt_state):
    """The momentum trace of the JAX optimizer's state."""
    if type(opt_state).__name__ == "TraceState":
        return opt_state.trace
    for s in (opt_state if isinstance(opt_state, (tuple, list)) else
              [getattr(opt_state, "inner_state", ())]):
        got = _trace(s)
        if got is not None:
            return got
    return None


def _packed(tensors, decay):
    """{name: tensor} -> the JAX tree of two leaves: the decayed kernels
    (a (n, 1) `kernel`, which the JAX decay mask decays) and the rest."""
    def cat(names):
        return np.concatenate([tensors[n].detach().numpy().ravel()
                               for n in names])

    d = [n for n in tensors if decay[n]]
    nd = [n for n in tensors if not decay[n]]
    return {"d": {"kernel": cat(d)[:, None]}, "n": {"bias": cat(nd)}}


LEAVES = (("d", "kernel"), ("n", "bias"))


@pytest.mark.parametrize("lr_policy", SCHEDULES)
@pytest.mark.parametrize("optimizer", ["SGDM", "SGD"])
def test_sgd_steps_match_jax_optimizer(optimizer, lr_policy):
    import jax
    import optax

    from rgbx_semantic_segmentation_tpu import config as jconfig
    from rgbx_semantic_segmentation_tpu import optim as joptim

    cfg = tiny_cfg(optimizer, lr_policy)
    trainer = Trainer(cfg, device="cpu", seed=0)
    model = trainer.model.double()
    assert isinstance(trainer.optimizer, torch.optim.SGD)
    named = dict(model.named_parameters())
    decay = toptim.weight_decay_mask(model)
    batch = batch_of()
    with jax.enable_x64(True):
        params = _packed(named, decay)
        tx = joptim.build_optimizer(tiny_cfg(optimizer, lr_policy,
                                             cfg_lib=jconfig), params)
        state = tx.init(params)
        start = params
        for step in range(STEPS):
            trainer.step(batch)
            grads = _packed({n: p.grad for n, p in named.items()}, decay)
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            assert toptim.applied_lr(trainer.optimizer) == pytest.approx(
                joptim.applied_lr(state), rel=1e-7), step
            mom = toptim.applied_momentum(trainer.optimizer)
            assert mom == pytest.approx(_hyperparam(state, "momentum"),
                                        rel=1e-7), step
            if lr_policy != "CyclicLR":
                assert mom == cfg.train.momentum
        want = jax.device_get(params)
        trace = jax.device_get(_trace(state))
    got = _packed(named, decay)
    buf = _packed({n: trainer.optimizer.state[p]["momentum_buffer"]
                   for n, p in named.items()}, decay)
    top = max(np.abs(want[g][k] - start[g][k]).max() for g, k in LEAVES)
    assert top > 1e-6   # the parameters moved
    for g, k in LEAVES:
        np.testing.assert_allclose(got[g][k], want[g][k], rtol=0,
                                   atol=1e-12 * top)
        np.testing.assert_allclose(buf[g][k], trace[g][k], rtol=1e-10,
                                   atol=1e-14)


def test_whole_train_step_matches_jax():
    """SGDM + CyclicLR: 3 Trainer steps (fp32, 64x64) against 3 steps of
    the JAX package's jitted make_train_step from the same weights."""
    import jax

    from rgbx_semantic_segmentation_tpu import config as jconfig
    from rgbx_semantic_segmentation_tpu import optim as joptim
    from rgbx_semantic_segmentation_tpu import train as jtrain
    from rgbx_semantic_segmentation_tpu.convert import torch_to_flax_variables
    from rgbx_semantic_segmentation_tpu.models.builder import (
        EncoderDecoder as JaxEncoderDecoder)
    from rgbx_semantic_segmentation_tpu_torch.convert import (
        flax_to_torch_state_dict)

    cfg = tiny_cfg("SGDM", "CyclicLR", hw=64)
    jcfg = tiny_cfg("SGDM", "CyclicLR", hw=64, cfg_lib=jconfig)
    start = build_model(cfg, device="cpu", seed=0).state_dict()
    var = torch_to_flax_variables(start)
    batch = batch_of(64, np.float32)
    state = jtrain.TrainState.create(
        apply_fn=JaxEncoderDecoder(cfg=jcfg).apply, params=var["params"],
        tx=joptim.build_optimizer(jcfg, var["params"]),
        batch_stats=var["batch_stats"])
    step_fn = jtrain.make_train_step(jcfg)
    trainer = Trainer(cfg, device="cpu", init_values=False)
    trainer.model.load_state_dict(start, strict=True)
    losses, want_losses = [], []
    for _ in range(STEPS):
        state, metrics = step_fn(state, batch)
        want_losses.append(float(metrics["loss"]))
        losses.append(float(trainer.step(batch)["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=5e-6)
    want = flax_to_torch_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    got = trainer.model.state_dict()
    params = [k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    top = max(float((want[k] - start[k]).abs().max()) for k in params)
    assert top > 1e-5
    for k in params:
        diff = got[k] - want[k]
        assert float(diff.abs().max()) <= 5e-4 * top, k
        if not ZERO_GRADIENT.search(k):
            bound = (1e-5 * float(want[k].norm())
                     + 2e-3 * float((want[k] - start[k]).norm()))
            assert float(diff.norm()) <= bound, k
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=k)


def test_frozen_parameters_stay_out_of_sgd():
    """SGD with weight decay on a Swin model with frozen stages: the
    frozen parameters are in no param group and require no gradient."""
    cfg = tiny_cfg("SGDM", "PolyLR")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, backbone="swin_s", swin_frozen_stages=2, swin_ape=True))
    model = build_model(cfg, device="cpu", seed=None)
    opt = toptim.build_optimizer(cfg, model)
    frozen = toptim.frozen_mask(cfg, model)
    in_groups = {id(p) for g in opt.param_groups for p in g["params"]}
    named = dict(model.named_parameters())
    assert sum(frozen.values()) > 0
    for n, p in named.items():
        assert (id(p) in in_groups) == (not frozen[n]) == p.requires_grad, n
    assert frozen["backbone.absolute_pos_embed_d"]
    assert frozen["backbone.layers_d.0.blocks.1.attn.qkv.weight"]
    assert not frozen["backbone.layers.1.blocks.0.attn.qkv.weight"]
    assert not frozen["backbone.downsamples.0.reduction.weight"]


def test_resume_matches_uninterrupted(tmp_path):
    """SGDM under CyclicLR: 3 steps straight against 2 steps, a checkpoint
    (the momentum buffers in the optimizer's state, the scheduled lr and
    momentum in its groups), a restore into a fresh Trainer and 1 more
    step: bit-equal parameters, statistics and momentum buffers."""
    from rgbx_semantic_segmentation_tpu_torch.checkpoint import (
        CheckpointManager)

    cfg = tiny_cfg("SGDM", "CyclicLR")
    batch = batch_of(dtype=np.float32)
    straight = Trainer(cfg, device="cpu", seed=0)
    for _ in range(3):
        straight.step(batch)
    first = Trainer(cfg, device="cpu", seed=0)
    for _ in range(2):
        first.step(batch)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, first)
    resumed = Trainer(cfg, device="cpu", seed=0, init_values=False)
    assert mgr.restore(resumed) == 2 and resumed.global_step == 2
    resumed.step(batch)
    got, want = resumed.model.state_dict(), straight.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = resumed.optimizer.state_dict(), straight.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys() and a["state"]
    for i, st in a["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           b["state"][i]["momentum_buffer"]), i
