"""Data parallelism of the port on the CPU: N gloo ranks (parallel/launch.py)
against one process and against the JAX package's Trainer on an N-device
CPU mesh, on the tests/test_train_step.py geometry (mit_tiny, 32x32, fp32,
drop rates 0, global batch 8, 2 or 4 ranks).

A step on N ranks must compute what one process computes on the global
batch (the JAX mesh's semantics): the batch's ranks hold different counts
of ignored pixels, so the mean over the global batch's valid pixels and the
mean of the ranks' means differ, and the second is shown to miss. Also: the
synced BatchNorm against the JAX TorchBatchNorm on a mesh, each rank's
TrainLoader rows, the window attention's per-rank seed, evaluation over
ranks, checkpoints across world sizes, a stop signal to one rank, the
train and eval CLIs over two CPU ranks, and the launcher's failure paths.

The ranks' functions are module-level (the processes start from a fresh
interpreter and import this file): JAX is imported only inside the tests
and fixtures that compare with it. Each world has its own timeout.
Tolerances are stated at each test.
"""
import contextlib
import dataclasses
import os
import re
import signal
import time
import types

import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException
from torch.nn.parallel import DistributedDataParallel

from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch.checkpoint import CheckpointManager
from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
from rgbx_semantic_segmentation_tpu_torch.engine import Engine
from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.parallel import dist as pdist
from rgbx_semantic_segmentation_tpu_torch.parallel import launch
from rgbx_semantic_segmentation_tpu_torch.parallel.multihost import (
    process_batch_slice)
from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
    SyncBatchNorm2d, convert_sync_batchnorm)
from rgbx_semantic_segmentation_tpu_torch.train import Trainer, make_loss_fn

torch.set_num_threads(2)
WORLD_TIMEOUT = 120   # seconds a world may take before it is killed
BATCH, HW, STEPS, LR = 8, 32, 3, 1e-3
# As tests/test_torch_train.py: biases whose true gradient is exactly 0
# (a per-channel constant in front of a BatchNorm; SegNeXt's: the stem
# conv's, the IFRM's first two convs', and the per-channel constants that
# enter the last stage's residual stream, which reaches only BatchNorms);
# AdamW moves them by rounding noise.
ZERO_GRADIENT = re.compile(
    r"channel_embed\.[34]\.bias$|channel_emb\.norm\.bias$"
    r"|linear_c\d\.proj\.bias$|linear_fuse\.0\.bias$"
    r"|stem\.0\.bias$|spatial_weights\.conv[12]\.bias$"
    r"|downsample\.2\.bias$|stages\.3\.\d+\.ffn_fc2\.bias$")
STATS = ("running_mean", "running_var")


def tiny_cfg(cfg_lib=tconfig, batch=BATCH):
    """tests/test_train_step.py's geometry at mit_tiny, drop rates 0, in
    either package's config classes."""
    return cfg_lib.mfnet_config().replace(
        dataset=cfg_lib.DatasetConfig(num_classes=5, image_height=HW,
                                      image_width=HW,
                                      class_names=tuple("abcde")),
        model=cfg_lib.ModelConfig(
            backbone="mit_tiny", decoder="MLPDecoder", decoder_embed_dim=64,
            use_mixed_precision=False, drop_path_rate=0.0,
            decoder_dropout_ratio=0.0),
        train=cfg_lib.TrainConfig(batch_size=batch, nepochs=2,
                                  niters_per_epoch=4, warm_up_epoch=1,
                                  lr=LR))


def ragged_batch(seed=0, batch=BATCH):
    """Host-normalised inputs; sample b ignores ~b/10 of its pixels, so
    every rank holds another count of valid pixels."""
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 5, size=(batch, HW, HW))
    for b in range(batch):
        label[b][rng.rand(HW, HW) < 0.1 * b] = 255
    return {"rgb": rng.randn(batch, HW, HW, 3).astype(np.float32),
            "modal_x": rng.randn(batch, HW, HW, 3).astype(np.float32),
            "label": label.astype(np.int32)}


def rows_of(batch, world):
    rows = process_batch_slice(len(batch["label"]), world.rank, world.size)
    return {k: v[rows] for k, v in batch.items()}


def numpy_state(module):
    return {k: v.detach().numpy().copy() for k, v in
            module.state_dict().items()}


def grads_of(model):
    return {n: p.grad.detach().numpy().copy()
            for n, p in model.named_parameters()}


def spawn(fn, n, *args):
    return launch.spawn(fn, list(range(n)), "cpu", args,
                        timeout=WORLD_TIMEOUT)


# ------------------------------------------------------------ the ranks --


def _parity_rank(world, cfg, start, batch, steps):
    """STEPS of Trainer.step on this rank's rows; then one DDP step with
    DDP's default (each rank's own mean, gradients averaged)."""
    torch.set_num_threads(1)
    trainer = Trainer(cfg, device="cpu", seed=0, world=world)
    fresh = build_model(cfg, device="cpu", seed=0).state_dict()
    built = trainer.model.state_dict()
    out = {"no_op": all(torch.equal(built[k], fresh[k]) for k in fresh),
           "losses": []}
    trainer.model.load_state_dict(start, strict=True)
    local = rows_of(batch, world)
    for step in range(steps):
        out["losses"].append(float(trainer.step(local)["loss"]))
        if step == 0:
            out["grads"] = grads_of(trainer.model)
            out["stats0"] = {k: v for k, v in numpy_state(
                trainer.model).items() if k.endswith(STATS)}
    out["state"] = numpy_state(trainer.model)

    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(start, strict=True)
    net = DistributedDataParallel(convert_sync_batchnorm(model).train())
    t = {k: torch.from_numpy(v) for k, v in local.items()}
    loss = make_loss_fn(cfg)(net(t["rgb"], t["modal_x"]), t["label"].long())
    loss.backward()
    mean = world.all_reduce(loss.detach().clone()) / world.size
    out["rank_mean"] = {"loss": float(mean), "grads": grads_of(model)}
    return out


def _bn_rank(world, cases):
    """SyncBatchNorm2d in train mode on this rank's rows of each case:
    output, input gradient, the summed parameter gradients, the running
    statistics, and the eval-mode output after the update."""
    torch.set_num_threads(1)
    out = []
    for x, w, b, rm, rv, g in cases:
        bn = SyncBatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1)
        bn.load_state_dict({"weight": torch.from_numpy(w),
                            "bias": torch.from_numpy(b),
                            "running_mean": torch.from_numpy(rm),
                            "running_var": torch.from_numpy(rv),
                            "num_batches_tracked": torch.tensor(0)})
        rows = process_batch_slice(len(x), world.rank, world.size)
        xl = torch.from_numpy(x[rows]).requires_grad_()
        y = bn.train()(xl)
        (y * torch.from_numpy(g[rows])).sum().backward()
        out.append({"y": y.detach().numpy(), "dx": xl.grad.numpy(),
                    "dw": world.all_reduce(bn.weight.grad.clone()).numpy(),
                    "db": world.all_reduce(bn.bias.grad.clone()).numpy(),
                    "rm": bn.running_mean.numpy().copy(),
                    "rv": bn.running_var.numpy().copy(),
                    "eval": bn.eval()(xl).detach().numpy()})
    return out


def _eval_rank(world, cfg, state, root):
    torch.set_num_threads(1)
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(state, strict=True)
    ev = SegEvaluator(cfg, model, device="cpu")
    ev.evaluate(RGBXDataset(cfg.dataset, "val", root=root), eval_batch=1,
                world=world)
    return ev.last_hist


def _checkpoint_rank(world, cfg, start, batch, directory):
    """With `start`: 2 steps on this rank's rows, then a checkpoint at epoch
    1, counting this rank's torch.save calls. Without: restore the latest
    checkpoint of `directory`."""
    torch.set_num_threads(1)
    trainer = Trainer(cfg, device="cpu", seed=0, world=world,
                      init_values=start is not None)
    mgr = CheckpointManager(directory)
    if start is None:
        epoch = mgr.restore(trainer)
        return {"epoch": epoch, "step": trainer.global_step,
                "model": trainer.model.state_dict(),
                "optimizer": trainer.optimizer.state_dict()}
    trainer.model.load_state_dict(start, strict=True)
    for _ in range(2):
        trainer.step(rows_of(batch, world))
    saves, save = [], torch.save
    torch.save = lambda obj, f, *a, **kw: saves.append(f) or save(obj, f, *a,
                                                                   **kw)
    try:
        mgr.save(1, trainer)
    finally:
        torch.save = save
    return {"saves": len(saves), "model": trainer.model.state_dict(),
            "optimizer": trainer.optimizer.state_dict()}


def _preempt_rank(world, cfg, batch, signal_at):
    """fit_epoch of 6 steps; rank 1 sends itself SIGTERM while it loads
    batch `signal_at`; then the engine's preemption drain."""
    torch.set_num_threads(1)
    with Engine(cfg, types.SimpleNamespace(device="cpu"), world) as engine:
        trainer = Trainer(cfg, device=engine.device, seed=0, world=world)
        engine.install_preemption_handler()

        def batches():
            for i in range(6):
                if i == signal_at and world.rank == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield rows_of(batch, world)

        trainer.fit_epoch(batches(), 6, should_stop=lambda: engine.preempted)
        handled = engine.drain_preemption(1, trainer, reraise=False)
        return {"step": trainer.global_step, "handled": handled,
                "signalled": engine.preempted,
                "epochs": engine.checkpoints.all_epochs()}


# Test-scale encoders of the two conv families, put in place of a registry
# name (FAMILIES) while the model is built: one block a stage.
FAMILIES = {"segnext_tiny": "SEGNEXT_FACTORIES", "resnet50": "RESNET_FACTORIES"}
FAMILY_HW = 64   # stage-4 maps 2x2: no 1x1 BatchNorm inputs


@contextlib.contextmanager
def narrow_family(backbone):
    """Within the block the registry's `backbone` builds its narrow
    version; the registry and the ResNet widths are put back on exit."""
    from rgbx_semantic_segmentation_tpu_torch.models import builder
    from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
        dual_resnet, dual_segnext)

    narrow = {
        "segnext_tiny": lambda **kw: dual_segnext.SegNextEncoder(
            depths=(1, 1, 1, 1), dims=(16, 32, 48, 64), **kw),
        "resnet50": lambda **kw: dual_resnet.DualResNet(
            (1, 1, 1, 1), **kw)}[backbone]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dual_resnet, "PLANES", (8, 16, 32, 64))
        mp.setitem(getattr(builder, FAMILIES[backbone]), backbone, narrow)
        yield


def family_cfg(backbone):
    """tiny_cfg's at FAMILY_HW with no warm-up (the one step moves the
    weights)."""
    cfg = tiny_cfg()
    return cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_height=FAMILY_HW,
                                    image_width=FAMILY_HW),
        model=dataclasses.replace(cfg.model, backbone=backbone),
        train=dataclasses.replace(cfg.train, warm_up_epoch=0))


def family_batch(seed=3):
    rng = np.random.RandomState(seed)
    shape = (BATCH, FAMILY_HW, FAMILY_HW)
    label = rng.randint(0, 5, size=shape)
    for b in range(BATCH):
        label[b][rng.rand(*shape[1:]) < 0.1 * b] = 255
    return {"rgb": rng.randn(*shape, 3).astype(np.float32),
            "modal_x": rng.randn(*shape, 3).astype(np.float32),
            "label": label.astype(np.int32)}


def _family_step(world, cfg, start, batch):
    """One train step of the narrow family from `start` on this world's
    rows in float64, built as Trainer builds it (synced BatchNorms where
    the world has a process group, make_train_step's DDP wrapper and its
    summed all-reduce): the loss, the gradients, the BN running statistics
    and the state after the step."""
    from rgbx_semantic_segmentation_tpu_torch import optim
    from rgbx_semantic_segmentation_tpu_torch.train import make_train_step

    torch.set_num_threads(1)
    with narrow_family(cfg.model.backbone):
        model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(start, strict=True)
    if world.distributed:
        convert_sync_batchnorm(model)
    model.double()
    step = make_train_step(cfg, model, optim.build_optimizer(cfg, model),
                           seed=0, world=world)
    loss = float(step(0, {k: v.astype(np.float64) if v.dtype == np.float32
                          else v for k, v in rows_of(batch, world).items()}))
    state = numpy_state(model)
    return {"loss": loss, "grads": grads_of(model),
            "stats": {k: v for k, v in state.items() if k.endswith(STATS)},
            "state": state}


def _raise_on_rank1(world):
    if world.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    world.barrier()   # rank 0 waits in a collective for the failed rank


def _sleep(world):
    time.sleep(600)


# ------------------------------------------- the step against one process --


@pytest.fixture(scope="module")
def start():
    """JAX-random weights (tests/test_torch_layers.random_variables on the
    JAX model's shapes) as the JAX variables and the port's state dict."""
    import jax

    from rgbx_semantic_segmentation_tpu import config as jconfig
    from rgbx_semantic_segmentation_tpu.models.builder import (
        EncoderDecoder as JaxEncoderDecoder)
    from rgbx_semantic_segmentation_tpu_torch.convert import (
        flax_to_torch_state_dict)
    from tests.test_torch_layers import random_variables

    x = np.zeros((1, HW, HW, 3), np.float32)
    jmod = JaxEncoderDecoder(cfg=tiny_cfg(jconfig))
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, x),
                           seed=11)
    return var, flax_to_torch_state_dict(var)


@pytest.fixture(scope="module")
def one_process(start):
    """The reference: the one-process Trainer on the whole batch."""
    cfg, batch = tiny_cfg(), ragged_batch()
    trainer = Trainer(cfg, device="cpu", seed=0, init_values=False)
    trainer.model.load_state_dict(start[1], strict=True)
    out = {"losses": []}
    for step in range(STEPS):
        out["losses"].append(float(trainer.step(batch)["loss"]))
        if step == 0:
            out["grads"] = grads_of(trainer.model)
            out["stats0"] = {k: v for k, v in numpy_state(
                trainer.model).items() if k.endswith(STATS)}
    out["state"] = numpy_state(trainer.model)
    return out


_WORLDS = {}


@pytest.fixture(scope="module")
def ranks(start):
    """{N: the ranks' results} of _parity_rank, each world run once."""

    def get(n):
        if n not in _WORLDS:
            _WORLDS[n] = spawn(_parity_rank, n, tiny_cfg(), start[1],
                               ragged_batch(), STEPS)
        return _WORLDS[n]

    return get


def assert_gradients_close(got, want, rtol):
    """Every gradient within `rtol` of its tensor's largest magnitude; a
    ZERO_GRADIENT tensor's (rounding noise only) within `rtol` of the
    model's largest."""
    top = max(np.abs(g).max() for g in want.values())
    assert set(got) == set(want)
    for k, g in want.items():
        scale = top if ZERO_GRADIENT.search(k) else np.abs(g).max()
        np.testing.assert_allclose(got[k], g, atol=rtol * scale, rtol=0,
                                   err_msg=k)


def assert_params_close(got, want, atol, start):
    """Parameters after STEPS AdamW steps. AdamW moves a coordinate by
    about the lr whatever its gradient's size, so where the gradient is
    rounding noise (the ZERO_GRADIENT tensors, and the few coordinates
    elsewhere whose gradient is ~0) two summation orders part by up to
    2 * lr * steps, and the weights those flips move change the next
    step's gradients of the small-gradient coordinates of the 1x1 stage-4
    maps. So: every coordinate within 2 * lr * STEPS (BN running statistics
    lr * STEPS: they see those biases); outside ZERO_GRADIENT at most 1e-4
    of the coordinates beyond `atol` (measured 29-167 of 8.0 million,
    4e-6 to 2.1e-5); and the parameters did move."""
    beyond = total = 0
    moved = 0.0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(w), k
            continue
        diff = np.abs(got[k] - w)
        limit = LR * STEPS if k.endswith(STATS) else 2 * LR * STEPS
        assert diff.max() <= limit, (k, diff.max())
        if k.endswith(STATS) or ZERO_GRADIENT.search(k):
            continue
        beyond += int((diff > atol).sum())
        total += diff.size
        moved = max(moved, float(np.abs(w - start[k].numpy()).mean()))
    assert beyond <= 1e-4 * total, (beyond, total)
    assert moved > 0.1 * LR   # the parameters did move


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_one_process(n, ranks, one_process, start):
    """N ranks against one process on the same global batch, whose ranks
    hold different counts of ignored pixels. Step losses within 1e-5
    relative; every first-step gradient within 1e-4 of its tensor's largest
    magnitude (measured 5e-6); the BN running statistics after the first
    step (the lr is 0 there: the same weights) within 1e-5; the parameters
    after 3 AdamW steps within 2e-5 (see assert_params_close); every rank
    ends with the same bits; DDP's construction broadcast changed nothing
    (every rank built the seed's weights)."""
    res, ref = ranks(n), one_process
    assert all(r["no_op"] for r in res)
    ours = res[0]
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=1e-5)
    assert_gradients_close(ours["grads"], ref["grads"], 1e-4)
    for k, v in ref["stats0"].items():
        np.testing.assert_allclose(ours["stats0"][k], v, atol=1e-5, rtol=0,
                                   err_msg=k)
    assert_params_close(ours["state"], ref["state"], 2e-5, start[1])
    for r in res[1:]:
        assert r["losses"] == ours["losses"]
        for k, v in ours["state"].items():
            assert np.array_equal(r["state"][k], v), k


@pytest.mark.parametrize("n", [2, 4])
def test_rank_mean_loss_differs(n, ranks, one_process):
    """DDP's default (each rank's mean, gradients averaged) on the same
    batch misses the global mean: its loss lies more than 100x the bound
    above from the one-process loss, and its gradients more than 100x the
    gradient bound on some tensor. So the batch does tell the two apart."""
    ref = one_process
    miss = ranks(n)[0]["rank_mean"]
    assert abs(miss["loss"] / ref["losses"][0] - 1) > 100 * 1e-5
    worst = max(np.abs(miss["grads"][k] - g).max() / np.abs(g).max()
                for k, g in ref["grads"].items()
                if not ZERO_GRADIENT.search(k))
    assert worst > 100 * 1e-4, worst


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_jax_mesh(n, ranks, start):
    """N ranks against the JAX Trainer on an N-device CPU mesh (the 8
    virtual devices of conftest.py), same weights and batch, 3 steps: loss
    within 1e-4 relative and parameters within 2e-5 (the bounds of
    tests/test_train_step.py::test_mesh_train_matches_single_device, with
    assert_params_close's reading of AdamW)."""
    import jax

    from rgbx_semantic_segmentation_tpu import config as jconfig
    from rgbx_semantic_segmentation_tpu import train as jtrain
    from rgbx_semantic_segmentation_tpu.parallel import mesh as jmesh
    from rgbx_semantic_segmentation_tpu_torch.convert import (
        flax_to_torch_state_dict)

    var, state = start
    mesh = jmesh.make_mesh(n_devices=n)
    jt = jtrain.Trainer(tiny_cfg(jconfig), mesh=mesh, seed=0,
                        init_values=False)
    jt.state = jt.state.replace(
        params=jmesh.replicate(mesh, var["params"]),
        batch_stats=jmesh.replicate(mesh, var["batch_stats"]))
    batch = ragged_batch()
    losses = [float(jt.step(batch)["loss"]) for _ in range(STEPS)]
    # (JAX keeps no BatchNorm batch counters.)
    want = {k: v.numpy() for k, v in flax_to_torch_state_dict(
        {"params": jax.device_get(jt.state.params),
         "batch_stats": jax.device_get(jt.state.batch_stats)}).items()
        if not k.endswith("num_batches_tracked")}
    ours = ranks(n)[0]
    np.testing.assert_allclose(ours["losses"], losses, rtol=1e-4)
    assert_params_close({k: ours["state"][k] for k in want}, want, 2e-5,
                        state)


# ------------------------------------------------------------- the parts --


def test_sync_bn_matches_jax_mesh():
    """SyncBatchNorm2d over 2 ranks against the JAX TorchBatchNorm on a
    2-device mesh (batch sharded on 'data'): train-mode output, input and
    parameter gradients, running statistics with the GLOBAL n / (n - 1)
    factor, eval-mode output. Cases: a 3x5 map, and a 1x1 map where each
    rank holds 2 elements a channel and the batch 4 (factor 4/3, where a
    per-rank factor would be 2). fp32: outputs 1e-5, gradients 1e-4 of the
    largest, statistics 1e-6."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rgbx_semantic_segmentation_tpu.ops.layers import TorchBatchNorm
    from rgbx_semantic_segmentation_tpu.parallel import mesh as jmesh

    rng = np.random.RandomState(0)
    cases = []
    for hw in ((3, 5), (1, 1)):
        x = (2.0 + 3.0 * rng.randn(4, 6, *hw)).astype(np.float32)
        cases.append((x, (1 + 0.1 * rng.randn(6)).astype(np.float32),
                      (0.1 * rng.randn(6)).astype(np.float32),
                      (0.1 * rng.randn(6)).astype(np.float32),
                      rng.uniform(0.5, 1.5, 6).astype(np.float32),
                      rng.randn(*x.shape).astype(np.float32)))
    res = spawn(_bn_rank, 2, cases)
    mesh = jmesh.make_mesh(n_devices=2)
    shard = NamedSharding(mesh, P("data"))
    mod = TorchBatchNorm(momentum=0.1, epsilon=1e-5)
    nhwc = lambda a: np.ascontiguousarray(a.transpose(0, 2, 3, 1))
    for i, (x, w, b, rm, rv, g) in enumerate(cases):
        stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}

        def loss(params, xs, gs):
            y, new = mod.apply({"params": params, "batch_stats": stats}, xs,
                               False, mutable=["batch_stats"])
            return jnp.sum(y * gs), (y, new["batch_stats"])

        fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
        (_, (y, new)), (dp, dx) = fn(
            {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
            jax.device_put(nhwc(x), shard), jax.device_put(nhwc(g), shard))
        ev = mod.apply({"params": {"scale": w, "bias": b},
                        "batch_stats": new}, nhwc(x), True)
        nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
        got = lambda key: np.concatenate([r[i][key] for r in res])
        np.testing.assert_allclose(got("y"), nchw(y), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got("eval"), nchw(ev), atol=1e-5, rtol=0)
        dx = nchw(dx)
        np.testing.assert_allclose(got("dx"), dx,
                                   atol=1e-4 * np.abs(dx).max(), rtol=0)
        for key, want in (("dw", dp["scale"]), ("db", dp["bias"])):
            want = np.asarray(want)
            for r in res:
                np.testing.assert_allclose(r[i][key], want, rtol=0,
                                           atol=1e-4 * np.abs(want).max())
        for key, want in (("rm", new["mean"]), ("rv", new["var"])):
            for r in res:
                np.testing.assert_allclose(r[i][key], np.asarray(want),
                                           atol=1e-6, rtol=1e-6)
    # the 1x1 case: the factor is the global 4/3 (a rank's own 2 differs)
    x, rv = cases[1][0], cases[1][4]
    var = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(res[0][1]["rv"], 0.9 * rv + 0.1 * var * 4 / 3,
                               rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_loader_rank_rows_concatenate(world, tmp_path):
    """Each rank's TrainLoader (2 threads) yields its rows of the same
    global batches: in rank order they are the one-process batch, bit for
    bit (augmentation keyed by (seed, epoch, index), not by the loader)."""
    from rgbx_semantic_segmentation_tpu_torch.data.loader import TrainLoader
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)

    ds = make_synthetic_dataset(str(tmp_path), num_train=8, num_val=1,
                                hw=(40, 48), num_classes=5, seed=1)
    cfg = tiny_cfg(batch=4).replace(dataset=dataclasses.replace(
        ds, image_height=HW, image_width=HW, train_source="train.txt"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                niters_per_epoch=3))
    one = list(TrainLoader(cfg, num_workers=2).epoch(1))
    parts = [list(TrainLoader(cfg, num_workers=2, rank=r,
                              world=world).epoch(1)) for r in range(world)]
    assert len(one) == 3 and all(len(p) == 3 for p in parts)
    for i, batch in enumerate(one):
        for key, t in batch.items():
            assert torch.equal(torch.cat([p[i][key] for p in parts]), t), key
    with pytest.raises(ValueError, match="does not divide"):
        TrainLoader(cfg, rank=0, world=3)


def test_window_seed_offset_per_rank():
    """The window attention's kernel seed: on rank 1 at rate > 0 it is the
    drawn seed + 1000003, so rank 1's keep mask is keep_mask(seed +
    1000003), unlike rank 0's (the drawn seed itself); at rate 0 no seed
    goes to the op, whatever the rank. The module hands the seed to the op
    (spied), which the CPU runs through its plain version."""
    from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
        dual_swin)
    from rgbx_semantic_segmentation_tpu_torch.ops import layers
    from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as WA

    seed = torch.tensor([123456789], dtype=torch.int64)
    assert torch.equal(WA.rank_seed(seed, 0.3, 1), seed + 1000003)
    assert WA.rank_seed(seed, 0.3, 0) is seed
    assert WA.rank_seed(seed, 0.0, 3) is seed
    x = torch.randn(2, 7, 14, 32)
    seen = {}
    op = WA.window_attention

    def spy(qkv, comb, s, *args):
        seen[key] = s
        return op(qkv, comb, s, *args)

    outs = {}
    try:
        WA.window_attention = spy
        for key in ((0, 0.3), (1, 0.3), (0, 0.0), (1, 0.0)):
            rank, rate = key
            torch.manual_seed(0)
            attn = dual_swin.WindowAttention(32, 7, 2, attn_drop=rate).train()
            layers.set_generator(attn, torch.Generator().manual_seed(5), rank)
            outs[key] = attn(x)
    finally:
        WA.window_attention = op
    drawn = torch.empty(1, dtype=torch.int64).random_(
        generator=torch.Generator().manual_seed(5))
    assert torch.equal(seen[(0, 0.3)], drawn)
    assert torch.equal(seen[(1, 0.3)], drawn + 1000003)
    assert seen[(0, 0.0)] is None and seen[(1, 0.0)] is None
    masks = [WA.keep_mask(seen[(r, 0.3)], 2, 2, 2, 49, 0.3) for r in (0, 1)]
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(outs[(0, 0.3)], outs[(1, 0.3)])
    assert torch.equal(outs[(0, 0.0)], outs[(1, 0.0)])


def test_eval_over_ranks_matches_one_process_and_jax(tmp_path, start):
    """Evaluation over 2 ranks (items r, r + 2, ...; the confusion matrix
    summed once at the end): the same hist, element for element, on both
    ranks, as one process's and as the JAX SegEvaluator's predictions give
    (exact-fit single scale, one image a forward)."""
    import jax

    from rgbx_semantic_segmentation_tpu import config as jconfig
    from rgbx_semantic_segmentation_tpu.evaluator import (
        SegEvaluator as JaxEvaluator)
    from rgbx_semantic_segmentation_tpu.models.builder import (
        EncoderDecoder as JaxEncoderDecoder)
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)

    ds = make_synthetic_dataset(str(tmp_path), num_train=1, num_val=5,
                                hw=(HW, HW), num_classes=5, seed=4)
    cfg = tiny_cfg().replace(dataset=ds, eval=tconfig.EvalConfig(
        eval_scale_array=(1.0,), eval_crop_size=(HW, HW)))
    var, state = start
    res = spawn(_eval_rank, 2, cfg, state, str(tmp_path))
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(state, strict=True)
    ev = SegEvaluator(cfg, model, device="cpu")
    dataset = RGBXDataset(cfg.dataset, "val")
    ev.evaluate(dataset, eval_batch=1)
    jcfg = tiny_cfg(jconfig).replace(
        dataset=dataclasses.replace(jconfig.mfnet_config().dataset,
                                    **dataclasses.asdict(ds)),
        eval=jconfig.EvalConfig(eval_scale_array=(1.0,),
                                eval_crop_size=(HW, HW)))
    jmod = JaxEncoderDecoder(cfg=jcfg)
    jev = JaxEvaluator(jcfg, lambda v, r, m, train: jmod.apply(v, r, m, train))
    jhist = np.zeros((5, 5), np.int64)
    for i in range(len(dataset)):
        item = dataset[i]
        pred = np.asarray(jev._batched_whole_image(var, [item]))[0]
        gt = np.asarray(item["label"])
        keep = gt != 255
        jhist += np.bincount(5 * gt[keep] + pred[keep],
                             minlength=25).reshape(5, 5)
    assert ev.last_hist.sum() > 0
    for hist in res:
        assert np.array_equal(hist, ev.last_hist)
    assert np.array_equal(ev.last_hist, jhist)


def test_checkpoints_across_world_sizes(tmp_path, start):
    """A checkpoint written by 2 ranks (rank 0 alone calls torch.save; the
    bare model's keys, no DDP prefix) resumes in one process, and one
    written by one process resumes on 2 ranks, each onto its own device:
    weights, BN statistics, optimizer state and step torch.equal."""
    cfg, batch = tiny_cfg(), ragged_batch(seed=2)
    two = spawn(_checkpoint_rank, 2, cfg, start[1], batch, str(tmp_path / "a"))
    assert [r["saves"] for r in two] == [1, 0]
    mgr = CheckpointManager(str(tmp_path / "a"))
    assert mgr.all_epochs() == [1]
    assert not any(k.startswith("module.") for k in mgr.load(1)["model"])
    one = Trainer(cfg, device="cpu", seed=0, init_values=False)
    assert mgr.restore(one) == 2 and one.global_step == 2
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, two[0]["model"][k]), k
    _assert_optimizer_equal(one.optimizer.state_dict(), two[0]["optimizer"])

    single = Trainer(cfg, device="cpu", seed=0, init_values=False)
    single.model.load_state_dict(start[1], strict=True)
    for _ in range(3):
        single.step(batch)
    CheckpointManager(str(tmp_path / "b")).save(4, single)
    back = spawn(_checkpoint_rank, 2, cfg, None, None, str(tmp_path / "b"))
    for r in back:
        assert r["epoch"] == 5 and r["step"] == 3
        for k, v in single.model.state_dict().items():
            assert torch.equal(v, r["model"][k]), k
        _assert_optimizer_equal(single.optimizer.state_dict(), r["optimizer"])


def _assert_optimizer_equal(a, b):
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for i, s in a["state"].items():
        for key, v in s.items():
            assert torch.equal(v, b["state"][i][key]), (i, key)


def test_stop_signal_to_one_rank_stops_all(tmp_path):
    """SIGTERM to rank 1 while it loads batch 2: both ranks stop at the
    same step (3: steps 0-2 ran), agree on the stop, and rank 0 writes the
    one preemption checkpoint (epoch 1)."""
    cfg = tiny_cfg(batch=4).replace(log_dir=str(tmp_path))
    res = spawn(_preempt_rank, 2, cfg, ragged_batch(batch=4), 2)
    assert [r["step"] for r in res] == [3, 3]
    assert all(r["handled"] for r in res)
    assert [r["signalled"] for r in res] == [False, False]   # drained
    assert all(r["epochs"] == [1] for r in res)
    files = os.listdir(os.path.join(str(tmp_path), cfg.tag(), "checkpoint"))
    assert sorted(files) == ["epoch-1.pth", "epoch-last.pth"]


def test_cli_over_two_cpu_ranks(tmp_path, monkeypatch):
    """train_cli --device cpu -d 0,1 end to end (the config resolved once
    and handed to both ranks) against train_cli on one process, drop rates
    0 (the ranks draw their own masks): the epoch loss within 1e-5
    relative, the checkpoint's weights within 1e-5 (two steps at the
    preset's warm-up lr); then eval_cli -d 0,1 -e last gives one process's
    confusion matrix on those weights, element for element."""
    from rgbx_semantic_segmentation_tpu_torch import eval_cli, train_cli
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)

    data = str(tmp_path / "data")
    ds = make_synthetic_dataset(data, num_train=4, num_val=3, hw=(HW, HW),
                                num_classes=5, seed=3)
    base = tconfig.mfnet_config()
    cfg = base.replace(
        dataset=ds,
        model=tconfig.ModelConfig(backbone="mit_tiny", decoder_embed_dim=32,
                                  use_mixed_precision=False,
                                  drop_path_rate=0.0,
                                  decoder_dropout_ratio=0.0),
        train=dataclasses.replace(base.train, batch_size=4, num_workers=2),
        eval=tconfig.EvalConfig(eval_scale_array=(1.0,),
                                eval_crop_size=(HW, HW)))
    monkeypatch.setattr(tconfig, "get_config", lambda name: cfg)
    argv = ["--dataset_root", data, "--epochs", "1", "--niters", "2",
            "--device", "cpu"]
    records = {}
    for run, extra in (("one", []), ("two", ["-d", "0,1"])):
        os.makedirs(tmp_path / run)
        monkeypatch.chdir(tmp_path / run)
        records[run] = train_cli.main(argv + extra)
    assert records["two"][0]["epoch"] == 1
    assert records["two"][0]["loss"] == pytest.approx(
        records["one"][0]["loss"], rel=1e-5)
    ckpt = {run: CheckpointManager(str(tmp_path / run / "logs" / cfg.tag()
                                       / "checkpoint")).load(1)["model"]
            for run in records}
    for k, v in ckpt["one"].items():
        assert torch.allclose(ckpt["two"][k].float(), v.float(), atol=1e-5,
                              rtol=0), k
    evals = {d: eval_cli.main(["--dataset_root", data, "-e", "last",
                               "--eval_batch", "1", "--device", "cpu"]
                              + (["-d", d] if d else []))
             for d in ("", "0,1")}
    assert np.array_equal(evals["0,1"]["epoch 1"][1], evals[""]["epoch 1"][1])
    assert evals[""]["epoch 1"][1].sum() > 0


# ------------------------------------------------------------ the world --


def test_a_failed_rank_fails_the_run():
    """A rank that raises fails the whole run: the launcher raises with
    the rank's traceback, the rank waiting in a collective is stopped."""
    with pytest.raises(ProcessRaisedException, match="failed on purpose"):
        spawn(_raise_on_rank1, 2)


def test_the_first_failed_rank_is_reported(tmp_path):
    """When the rank waiting in a collective has failed too ("connection
    closed by peer") by the time the launcher looks, the launcher still
    raises the rank that failed first, not the lowest failed rank. Both
    ranks are made to end before the join."""
    init = "file://" + str(tmp_path / "rendezvous")
    ctx = torch.multiprocessing.start_processes(
        launch._rank_main, args=(_raise_on_rank1, [0, 1], "cpu", init,
                                 str(tmp_path), ()),
        nprocs=2, join=False, start_method="spawn")
    for p in ctx.processes:
        p.join(120)
    assert [p.exitcode for p in ctx.processes] == [1, 1]
    with pytest.raises(ProcessRaisedException,
                       match="failed on purpose") as raised:
        launch._join(ctx, 60, str(tmp_path))
    assert raised.value.error_index == 1


def test_a_world_past_its_timeout_is_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch.spawn(_sleep, [0, 1], "cpu", timeout=3)
    assert time.monotonic() - t0 < 60


def test_solo_world_is_one_process():
    """World.solo: rank 0 of 1 with no process group, whose collectives are
    identities; launch.run gives one device's CLI run such a world."""
    world = pdist.World.solo()
    t = torch.tensor([3.0])
    assert not world.distributed and world.is_main() and world.size == 1
    assert world.all_reduce(t) is t and torch.equal(t, torch.tensor([3.0]))
    assert world.host_max(True) == 1 and world.host_max(0) == 0
    world.barrier()
    got = launch.run(lambda w, x: (w.rank, w.size, w.device, w.distributed,
                                   x), "cpu", [0], ("x",))
    assert got == (0, 1, torch.device("cpu"), False, "x")


@pytest.mark.parametrize("backbone", sorted(FAMILIES))
def test_conv_families_over_ranks_match_one_process(backbone):
    """One train step of a narrow SegNeXt (IFRM/IFFM, LayerScales, MSCA's
    depthwise convs) and of a narrow ResNet (FRM/FFM) on 2 ranks against
    one process on the same global batch, whose ranks hold different counts
    of ignored pixels: the loss within 1e-5 relative, every gradient within
    1e-4 of its tensor's largest (assert_gradients_close), the synced
    BatchNorm statistics (every BatchNorm of towers, fusion and head)
    within 1e-5, the parameters after one AdamW step within 2e-5
    (assert_params_close), both ranks the same bits. In float64: in fp32
    one process alone, given the batch in reverse order, already moves the
    narrow ResNet's stage-3 gradients by 7% of their largest (measured),
    which AdamW's first step, about lr x sign(g), turns into flips."""
    cfg, batch = family_cfg(backbone), family_batch()
    with narrow_family(backbone):
        model = build_model(cfg, device="cpu", seed=0)
    start = model.state_dict()
    one = _family_step(pdist.World.solo(), cfg, start, batch)
    res = spawn(_family_step, 2, cfg, start, batch)
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert len(one["stats"]) == 2 * n_bn
    assert res[0]["loss"] == pytest.approx(one["loss"], rel=1e-5)
    assert_gradients_close(res[0]["grads"], one["grads"], 1e-4)
    for k, v in one["stats"].items():
        np.testing.assert_allclose(res[0]["stats"][k], v, atol=1e-5, rtol=0,
                                   err_msg=k)
    assert_params_close(res[0]["state"], one["state"], 2e-5,
                        {k: v.double() for k, v in start.items()})
    for k, v in res[0]["state"].items():
        assert np.array_equal(res[1]["state"][k], v), k


@pytest.mark.parametrize("decoder", ["MLPDecoder", "UPernet", "deeplabv3+",
                                     "fcn", "None"])
def test_every_param_in_loss(decoder):
    """The builder's every_param_in_loss (from the stages the heads read,
    which decides DDP's find_unused_parameters) against one train step's
    gradients: True iff every parameter got one (deeplabv3+ reads stages 1
    and 4, fcn and None stage 4 only: the other stages' fusion modules
    stay out of the loss)."""
    cfg = tiny_cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, decoder=decoder))
    model = build_model(cfg, device="cpu", seed=0).train()
    batch = {k: torch.from_numpy(v[:2]) for k, v in ragged_batch().items()}
    make_loss_fn(cfg)(model(batch["rgb"], batch["modal_x"]),
                      batch["label"].long()).backward()
    every = all(p.grad is not None for p in model.parameters())
    assert model.every_param_in_loss == every
    assert every == (decoder in ("MLPDecoder", "UPernet"))


def test_torchrun_mesh_and_devices(monkeypatch):
    """Under torchrun (RANK, WORLD_SIZE set) a CLI's --mesh must take the
    whole world: the 2-D meshes raise, dp:N raises unless N is WORLD_SIZE,
    dp raises when the batch does not divide by it; -d is refused."""
    from rgbx_semantic_segmentation_tpu_torch import train_cli

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert launch.cli_devices("cpu", "", "dp", 8) == []
    assert launch.cli_devices("cpu", "", "dp:4", 8) == []
    assert launch.cli_devices("cpu", "") == []
    with pytest.raises(ValueError, match="takes 2 of the 4"):
        launch.cli_devices("cpu", "", "dp:2", 8)
    with pytest.raises(ValueError, match="takes 3 of the 4"):
        launch.cli_devices("cpu", "", "dp", 6)
    with pytest.raises(ValueError, match="-d is for"):
        launch.cli_devices("cpu", "0,1", "dp", 8)
    for spec in ("2d:2,2", "tp:2,4"):
        with pytest.raises(NotImplementedError, match="2-D"):
            launch.cli_devices("cpu", "", spec, 8)
        with pytest.raises(NotImplementedError, match="2-D"):
            train_cli.main(["--dataset_root", "unused", "--mesh", spec,
                            "--device", "cpu"])


_TORCHRUN_RANK = """
import torch
from rgbx_semantic_segmentation_tpu_torch.parallel import launch

def fn(world, x):
    t = world.all_reduce(torch.tensor([float(world.rank + x)]))
    return [world.rank, world.size, world.distributed, float(t.item()),
            world.host_max(world.rank)]

print(launch.run(fn, "cpu", launch.cli_devices("cpu", "", "dp:2", 8), (1,)))
"""


def test_torchrun_world_of_two():
    """The torchrun branch of launch.run: two processes given RANK,
    WORLD_SIZE and a localhost MASTER_ADDR/PORT (as torchrun sets them) join
    one gloo world through env://, each as its own rank."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _TORCHRUN_RANK], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=WORLD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert out.strip().splitlines()[-1] == str(
            [rank, 2, True, 3.0, 1]), out


@pytest.mark.parametrize("spec, batch, devices, want", [
    ("dp", 8, [0, 1, 2, 3], [0, 1, 2, 3]),
    ("dp", 6, [0, 1, 2, 3], [0, 1, 2]),
    ("", 7, [2, 3], [2]),
    ("dp:2", 8, [5, 6, 7], [5, 6]),
])
def test_mesh_spec(spec, batch, devices, want):
    """--mesh over the named devices, as the JAX make_mesh_from_spec: dp =
    the largest count that divides the batch, dp:N = the first N."""
    assert pdist.make_world_from_spec(spec, batch, devices) == want


def test_mesh_spec_raises():
    with pytest.raises(ValueError, match="does not divide"):
        pdist.make_world_from_spec("dp:3", 8, [0, 1, 2])
    with pytest.raises(ValueError, match="device"):
        pdist.make_world_from_spec("dp:4", 8, [0, 1])
    for spec in ("2d:2,2", "tp:2,4"):
        with pytest.raises(NotImplementedError, match="2-D"):
            pdist.make_world_from_spec(spec, 8, [0, 1, 2, 3])
    with pytest.raises(ValueError, match="unknown mesh"):
        pdist.make_world_from_spec("fsdp", 8, [0])
    with pytest.raises(ValueError, match="does not divide"):
        process_batch_slice(8, 0, 3)
    assert process_batch_slice(8, 3, 4) == slice(6, 8)
    assert pdist.world_devices("cpu", "0,1") == [0, 1]
    assert pdist.world_devices("cpu", "") == [0]
    with pytest.raises(ValueError, match="twice"):
        pdist.world_devices("cpu", "0,0")
