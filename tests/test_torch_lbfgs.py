"""The port's L-BFGS (rgbx_semantic_segmentation_tpu_torch/lbfgs.py) and the
Trainer's L-BFGS step on the CPU.

- The optimizer alone against optax.lbfgs (what the JAX package trains
  with, its optim.py) in float64 on softmax regression over seeded data, 10
  steps at three learning rates that drive the zoom line search through
  its interval search and its zoom: parameters and values to 1e-10, and the
  same count of line-search evaluations at every step.
- The Trainer's step on mit_tiny against the port's own reference: the
  JAX package's train step with L-BFGS compiles its line search around two
  copies of the model's value and gradient, which took 180 s on this
  geometry on the CPU (the second step 207 s more), far past a test file's
  budget; so the step's plumbing is held against a plain loop instead: the
  same LBFGS driven by a closure that reseeds the mask generator before
  each evaluation and runs the line-search evaluations with BatchNorm
  momentum 0. Bit-equal, at drop rates above 0 (a closure that does not
  reseed draws other masks and moves elsewhere). The BatchNorm running
  statistics after a step equal JAX's new_stats of one forward on the batch
  (1e-5, fp32 summation order).
- Two gloo ranks against one process on the same global batch, and a
  resumed run against an uninterrupted one, through the Trainer and
  through train_cli -c (bit-equal).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch.checkpoint import CheckpointManager
from rgbx_semantic_segmentation_tpu_torch.lbfgs import LBFGS
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.ops.layers import set_generator
from rgbx_semantic_segmentation_tpu_torch.parallel import launch
from rgbx_semantic_segmentation_tpu_torch.parallel.multihost import (
    process_batch_slice)
from rgbx_semantic_segmentation_tpu_torch.train import (
    Trainer, make_loss_fn, step_seed)
from tests.test_torch_ddp import ZERO_GRADIENT

torch.set_num_threads(2)
HW, BATCH = 32, 4


# ---------------------------------------------- the optimizer vs optax --


def _softmax_regression(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(64, 5) * np.array([1.0, 3.0, 0.3, 10.0, 1.0])
    y = rng.randint(0, 3, 64)
    return x, y, rng.randn(5, 3) * 0.1, rng.randn(3) * 0.1


@pytest.mark.parametrize("lr", [0.05, 3.0, 30.0])
def test_optimizer_matches_optax_lbfgs(lr):
    import jax
    import jax.numpy as jnp
    import optax

    x, y, w0, b0 = _softmax_regression()
    with jax.enable_x64(True):
        def jloss(p):
            logp = jax.nn.log_softmax(x @ p["w"] + p["b"])
            return (-jnp.mean(logp[jnp.arange(len(y)), y])
                    + 0.01 * jnp.sum(p["w"] ** 2))

        tx = optax.lbfgs(learning_rate=lr)
        p = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
        state = tx.init(p)
        vg = jax.value_and_grad(jloss)
        want_values, want_evals, want_params = [], [], []
        for _ in range(10):
            v, g = vg(p)
            u, state = tx.update(g, state, p, value=v, grad=g, value_fn=jloss)
            p = optax.apply_updates(p, u)
            want_values.append(float(v))
            want_evals.append(int(state[-1].info.num_linesearch_steps))
            want_params.append(np.concatenate(
                [np.asarray(p["w"]).ravel(), np.asarray(p["b"])]))

    w = torch.tensor(w0, requires_grad=True)
    b = torch.tensor(b0, requires_grad=True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    opt = LBFGS([w, b], lr=lr)
    assert not isinstance(opt, torch.optim.LBFGS)

    def closure():
        opt.zero_grad()
        loss = (torch.nn.functional.cross_entropy(xt @ w + b, yt)
                + 0.01 * (w ** 2).sum())
        loss.backward()
        return loss.detach()

    for step in range(10):
        v = closure()
        assert float(v) == pytest.approx(want_values[step], rel=0, abs=1e-10)
        opt.step(closure, v)
        assert opt.last_step["evaluations"] == want_evals[step]
        got = torch.cat([w.detach().ravel(), b.detach()]).numpy()
        np.testing.assert_allclose(got, want_params[step], rtol=0, atol=1e-10)
    # the cases reach the zoom (more than one evaluation) and the loss fell
    assert max(want_evals) > 1 and want_values[-1] < want_values[0]


# ---------------------------------------------------- the Trainer's step --


def tiny_cfg(lr=1.0, rates=0.1, batch=BATCH, cfg_lib=tconfig):
    """mit_tiny at 32x32 with LBFGS; drop-path and the decoder's dropout at
    `rates`."""
    return cfg_lib.mfnet_config().replace(
        dataset=cfg_lib.DatasetConfig(num_classes=5, image_height=HW,
                                      image_width=HW,
                                      class_names=tuple("abcde")),
        model=cfg_lib.ModelConfig(
            backbone="mit_tiny", decoder="MLPDecoder", decoder_embed_dim=64,
            use_mixed_precision=False, use_pallas_kernels=False,
            drop_path_rate=rates, decoder_dropout_ratio=rates),
        train=cfg_lib.TrainConfig(batch_size=batch, nepochs=2,
                                  niters_per_epoch=4, optimizer="LBFGS",
                                  lr=lr))


def batch_of(seed=0, batch=BATCH):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 5, size=(batch, HW, HW))
    for b in range(batch):
        label[b][rng.rand(HW, HW) < 0.1 * b] = 255
    return {"rgb": rng.randn(batch, HW, HW, 3).astype(np.float32),
            "modal_x": rng.randn(batch, HW, HW, 3).astype(np.float32),
            "label": label.astype(np.int32)}


def _bn_modules(model):
    return [m for m in model.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


def reference_steps(cfg, batch, steps, seed=0, reseed=True):
    """The Trainer's LBFGS steps written out: a model, the optimizer, a
    closure over the batch that (with `reseed`) draws the step's masks
    before every evaluation; the line-search evaluations run with BatchNorm
    momentum 0, so the running statistics stay as the first evaluation
    left them."""
    model = build_model(cfg, device="cpu", seed=seed).train()
    gen = torch.Generator()
    set_generator(model, gen)
    opt = LBFGS(model.parameters(), lr=cfg.train.lr)
    loss_fn = make_loss_fn(cfg)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    bns = _bn_modules(model)
    losses, evals = [], []
    for step in range(steps):
        def closure():
            if reseed:
                gen.manual_seed(step_seed(seed, step))
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model(t["rgb"], t["modal_x"]), t["label"].long())
            loss.backward()
            return loss.detach()

        gen.manual_seed(step_seed(seed, step))
        loss = closure()
        momenta = [m.momentum for m in bns]
        for m in bns:
            m.momentum = 0.0
        opt.step(closure, loss)
        for m, mom in zip(bns, momenta):
            m.momentum = mom
        losses.append(float(loss))
        evals.append(opt.last_step["evaluations"])
    return model, losses, evals


def test_trainer_lbfgs_steps_match_reference():
    """2 Trainer steps (drop-path and dropout 0.1) against reference_steps:
    losses, parameters and running statistics bit-equal (num_batches_tracked
    aside: the reference's momentum-0 evaluations still count); the loss
    fell; a reference that does not reseed draws other masks and lands
    elsewhere."""
    cfg, batch = tiny_cfg(), batch_of()
    trainer = Trainer(cfg, device="cpu", seed=0)
    losses = [float(trainer.step(batch)["loss"]) for _ in range(2)]
    evals = trainer.optimizer.last_step["evaluations"]
    model, ref_losses, ref_evals = reference_steps(cfg, batch, 2)
    assert losses == ref_losses and evals == ref_evals[-1]
    got, want = trainer.model.state_dict(), model.state_dict()
    for k in want:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
    assert trainer.optimizer.last_step["value"] < losses[0]
    assert trainer.global_step == 2
    other, _, _ = reference_steps(cfg, batch, 2, reseed=False)
    moved = other.state_dict()
    assert any(not torch.equal(moved[k], want[k]) for k in want
               if k.endswith(".weight"))


def test_lbfgs_bn_statistics_equal_jax_new_stats():
    """After one Trainer LBFGS step (several line-search evaluations), the
    BatchNorm running statistics are those one train-mode forward on the
    batch gives: JAX's new_stats from the same weights and batch (drop
    rates 0), 1e-5."""
    import jax

    from rgbx_semantic_segmentation_tpu import config as jconfig
    from rgbx_semantic_segmentation_tpu.convert import torch_to_flax_variables
    from rgbx_semantic_segmentation_tpu.models.builder import (
        EncoderDecoder as JaxEncoderDecoder)
    from rgbx_semantic_segmentation_tpu_torch.convert import (
        flax_to_torch_state_dict)

    cfg, batch = tiny_cfg(rates=0.0), batch_of(1)
    trainer = Trainer(cfg, device="cpu", seed=0)
    var = torch_to_flax_variables(trainer.model.state_dict())
    trainer.step(batch)
    assert trainer.optimizer.last_step["evaluations"] > 1
    jmod = JaxEncoderDecoder(cfg=tiny_cfg(rates=0.0, cfg_lib=jconfig))
    rngs = {"droppath": jax.random.PRNGKey(0),
            "dropout": jax.random.PRNGKey(1)}
    _, new = jax.jit(lambda v: jmod.apply(
        v, batch["rgb"], batch["modal_x"], True, rngs=rngs,
        mutable=["batch_stats"]))(var)
    want = flax_to_torch_state_dict(
        {"batch_stats": jax.device_get(new["batch_stats"])})
    got = trainer.model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * len(_bn_modules(trainer.model))
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _lbfgs_rank(world, cfg, batch, steps):
    torch.set_num_threads(1)
    trainer = Trainer(cfg, device="cpu", seed=0, world=world)
    rows = process_batch_slice(len(batch["label"]), world.rank, world.size)
    losses = [float(trainer.step({k: v[rows] for k, v in batch.items()})
                    ["loss"]) for _ in range(steps)]
    return {"losses": losses,
            "evals": trainer.optimizer.last_step["evaluations"],
            "state": {k: v.numpy().copy()
                      for k, v in trainer.model.state_dict().items()}}


def test_two_gloo_ranks_match_one_process():
    """2 LBFGS steps over 2 gloo ranks (each half of the batch, whose
    halves ignore different counts of pixels; drop rates 0) against one
    process on the whole batch: the ranks agree bit for bit (every rank
    takes the same line-search decisions on the global loss and gradient),
    the losses within 1e-5 relative, the same line-search evaluations, the
    parameters within 1e-4 of the distance they moved (summation order of
    the all-reduce), the running statistics within 1e-5."""
    cfg, batch = tiny_cfg(rates=0.0), batch_of(2)
    ranks = launch.spawn(_lbfgs_rank, [0, 1], "cpu", (cfg, batch, 2),
                         timeout=120)
    one = Trainer(cfg, device="cpu", seed=0)
    start = {k: v.clone() for k, v in one.model.state_dict().items()}
    losses = [float(one.step(batch)["loss"]) for _ in range(2)]
    r0, r1 = ranks
    assert r0["losses"] == r1["losses"] and r0["evals"] == r1["evals"]
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(v, r1["state"][k], err_msg=k)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    assert r0["evals"] == one.optimizer.last_step["evaluations"]
    want = one.model.state_dict()
    top = max(float((w - start[k]).abs().max()) for k, w in want.items()
              if not k.endswith("num_batches_tracked"))
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        # a bias whose true gradient is 0 moves by rounding noise: its
        # tensor's own distance means nothing, the model's largest does
        moved = (top if ZERO_GRADIENT.search(k)
                 else float((w - start[k]).abs().max()))
        # plus 2 fp32 ulps of the tensor's magnitude: the rounding of
        # x + stepsize * direction
        tol = 1e-5 if k.endswith(("running_mean", "running_var")) else (
            1e-4 * moved + 2.4e-7 * float(w.abs().max()))
        np.testing.assert_allclose(r0["state"][k], w.numpy(), rtol=0,
                                   atol=tol, err_msg=k)


def _equal_optimizer_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        assert st.keys() == sb["state"][i].keys()
        for k, v in st.items():
            w = sb["state"][i][k]
            assert (torch.equal(v, w) if torch.is_tensor(v) else v == w), k


def test_resume_matches_uninterrupted(tmp_path):
    """3 steps straight against 2 steps, a checkpoint (the memory of
    parameter and gradient differences in the optimizer's state), a restore
    into a fresh Trainer and 1 more step: bit-equal parameters, statistics
    and optimizer state."""
    cfg, batch = tiny_cfg(), batch_of(3)
    straight = Trainer(cfg, device="cpu", seed=0)
    for _ in range(3):
        straight.step(batch)
    first = Trainer(cfg, device="cpu", seed=0)
    for _ in range(2):
        first.step(batch)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, first)
    state = first.optimizer.state[first.optimizer.param_groups[0]["params"][0]]
    assert state["count"] == 2 and state["diff_params"].shape[0] == 10
    resumed = Trainer(cfg, device="cpu", seed=0, init_values=False)
    assert mgr.restore(resumed) == 2 and resumed.global_step == 2
    resumed.step(batch)
    got, want = resumed.model.state_dict(), straight.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _equal_optimizer_state(resumed.optimizer, straight.optimizer)
    assert os.path.exists(mgr.path(1))


def test_train_cli_resume_with_lbfgs(tmp_path):
    """train_cli with LBFGS: 2 epochs of 1 step, then -c to 3, against 3
    epochs at once: the same parameters and optimizer state bit for bit;
    the metrics log records the constant lr (cfg.train.lr, as the JAX CLI
    does where no schedule is applied)."""
    import json

    from rgbx_semantic_segmentation_tpu_torch import train_cli
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)
    from tests.test_torch_cli import cli_env, small_cfg

    ds = make_synthetic_dataset(str(tmp_path / "data"), num_train=4,
                                num_val=2, hw=(32, 32), num_classes=5, seed=4)
    cfg = small_cfg(ds)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, optimizer="LBFGS", lr=0.5, num_workers=0))
    data = str(tmp_path / "data")
    args = ["--dataset_root", data, "--niters", "1", "--device", "cpu"]
    for run in ("A", "B"):
        os.makedirs(tmp_path / run)
    with cli_env(cfg, tmp_path / "A"):
        train_cli.main(args + ["--epochs", "2"])
        rec = train_cli.main(args + ["--epochs", "3", "-c"])
    assert [r["epoch"] for r in rec] == [3]
    with cli_env(cfg, tmp_path / "B"):
        train_cli.main(args + ["--epochs", "3"])
    logs = [tmp_path / run / "logs" / cfg.tag() for run in ("A", "B")]
    a, b = (CheckpointManager(str(d / "checkpoint")).load(3) for d in logs)
    assert a["iteration"] == b["iteration"] == 3
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    sa, sb = a["optimizer"]["state"][0], b["optimizer"]["state"][0]
    assert sa["count"] == sb["count"] == 3
    assert all(torch.equal(sa[k], sb[k]) for k in ("diff_params", "params"))
    rows = [json.loads(line) for line in open(logs[1] / "metrics.jsonl")]
    assert [r["value"] for r in rows
            if r["tag"] == "train/learning_rate"] == [0.5] * 3
