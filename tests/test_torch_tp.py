"""The data x model mesh of the port (`--mesh tp:D,M`, parallel/tensor.py) on
the CPU, over 2 and 4 gloo ranks, against one process and against the JAX
package.

- The split rules: parallel/tensor.split_dim on the cases of the JAX
  test_tp_spec_rules, and the set of parameters that
  EncoderDecoder.set_tensor_parallel splits equal to the leaves that JAX
  `mesh._tp_spec` splits on the converted variables, for mit_b0 (M = 2; and
  M = 5, where only stage 3's hidden width 640 divides), a narrow Swin and
  segnext_tiny (nothing splits: `ffn_*` must not match).
- mit_b0 + MLPDecoder at 32x32, batch 8, drop rates 0 (the geometry of
  the JAX tests/test_tensor_parallel.py), on tp:2,2 and tp:1,2: three fp32
  AdamW steps against one process and against the JAX Trainer on
  make_mesh_dp_tp(D, M) with JAX's bounds (losses 1e-4 relative,
  parameters 2e-5 as tests/test_torch_ddp.assert_params_close reads AdamW;
  BatchNorm running statistics after the first step 1e-5); the first-step
  gradients in float64 (1e-8 of each tensor's largest: fp32 summation
  orders move AdamW's later steps, tp and dp alike: dp:2 and tp:2,2 lie 9e-6
  and 3e-6 from one process's third loss); every rank ends with the same
  whole parameters, bit for bit. (At 64x64, batch 4, this seed's fp32
  gradients lie 1e-2 from float64 on stage 1's fusion weights,
  tests/test_torch_spatial.py, and the third loss moves by 1.3e-4.)
- On tp:2,2, in float64: an OHEM step (the k-th smallest over the data
  group), two LBFGS steps (the dot products over the model group: the same
  step sizes and evaluations, parameters 1e-10). On tp:1,2: a remat step at
  drop rates 0.1 (the recompute's model-group all-reduces and masks)
  against one process without remat.
- Checkpoints: a tp file is key- and shape-equal to one process's, and
  round-trips tp -> tp (bit-equal model and optimizer state), tp -> one
  process and one process -> tp.
- A narrow Swin (attention dropout 0.3, MLP dropout 0.1, drop path 0.2) on
  tp:1,2: the whole parameters bit-equal across the model ranks after 3
  steps, the first-step gradients (float64) and losses one process's;
  segnext_tiny trains on tp:1,2 as two replicas.
- train_cli --mesh tp:1,2 against --mesh dp:1.

The ranks' functions are module-level (spawned processes import this
file); JAX is imported only inside the tests that compare with it.
"""
import dataclasses
import hashlib
import os
import re

import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch import optim
from rgbx_semantic_segmentation_tpu_torch.checkpoint import CheckpointManager
from rgbx_semantic_segmentation_tpu_torch.models import builder
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.models.encoders import dual_swin
from rgbx_semantic_segmentation_tpu_torch.parallel import dist as pdist
from rgbx_semantic_segmentation_tpu_torch.parallel import launch, tensor
from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
    convert_sync_batchnorm)
from rgbx_semantic_segmentation_tpu_torch.train import (
    Trainer, make_train_step)

# Every process of these tests, the ranks too (launch.spawn gives a CPU rank
# cpu_count / ranks threads): the narrow Swin's window attention computes
# in fp32 even in a float64 step, so its float64 gradients depend on the
# thread count in their last ~1e-8 (32 threads a rank against the
# reference's 2: 1.9e-8 on the relative position bias table).
THREADS = 2
torch.set_num_threads(THREADS)
WORLD_TIMEOUT = 300
HW, BATCH, STEPS, LR = 32, 8, 3, 1e-3
MESHES = ("tp:2,2", "tp:1,2")
# Biases whose true gradient is 0 (a per-channel constant in front of a
# BatchNorm): their gradients are rounding noise (tests/test_torch_ddp.py).
ZERO_GRADIENT = re.compile(
    r"channel_embed\.[34]\.bias$|channel_emb\.norm\.bias$"
    r"|linear_c\d\.proj\.bias$|linear_fuse\.0\.bias$")
STATS = ("running_mean", "running_var")
# A narrow dual Swin (the swin_s layout at embed_dim 32) with every drop on.
SWIN_NARROW = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                   window_size=7, attn_drop_rate=0.3, drop_rate=0.1,
                   drop_path_rate=0.2)


def swin_narrow(**kw):
    return dual_swin.DualSwinTransformer(**{**SWIN_NARROW, **kw})


def register_swin_narrow(factories=None, channels=None):
    """Name the narrow Swin `swin_narrow` in the builder's registry (a
    rank's process; the test process passes monkeypatched dicts)."""
    (builder.SWIN_FACTORIES if factories is None else factories)[
        "swin_narrow"] = swin_narrow
    (dual_swin.CHANNELS if channels is None else channels)[
        "swin_narrow"] = (32, 64, 128, 256)


def mit_cfg(cfg_lib=tconfig, rates=0.0, backbone="mit_b0", **train):
    """mit_b0 + MLPDecoder at 32x32, batch 8, fp32, a warm-up epoch of 4
    steps (tests/test_train_step.tiny_cfg), drop-path and decoder dropout
    at `rates`; `train` overrides TrainConfig fields."""
    return cfg_lib.mfnet_config().replace(
        dataset=cfg_lib.DatasetConfig(num_classes=5, image_height=HW,
                                      image_width=HW,
                                      class_names=tuple("abcde")),
        model=cfg_lib.ModelConfig(
            backbone=backbone, decoder="MLPDecoder", decoder_embed_dim=64,
            use_mixed_precision=False, drop_path_rate=rates,
            decoder_dropout_ratio=rates),
        train=cfg_lib.TrainConfig(batch_size=BATCH, nepochs=2,
                                  niters_per_epoch=4, warm_up_epoch=1, lr=LR,
                                  **train))


def with_model(cfg, **kw):
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def step_batch(dtype=np.float32):
    """Host-normalised pairs; sample b ignores ~b/10 of its pixels."""
    rng = np.random.RandomState(0)
    label = rng.randint(0, 5, size=(BATCH, HW, HW))
    for b in range(BATCH):
        label[b][rng.rand(HW, HW) < 0.1 * b] = 255
    return {"rgb": rng.randn(BATCH, HW, HW, 3).astype(dtype),
            "modal_x": rng.randn(BATCH, HW, HW, 3).astype(dtype),
            "label": label.astype(np.int32)}


def images_of(world, batch):
    per = len(batch["label"]) // world.data_size
    rows = slice(world.data_rank * per, (world.data_rank + 1) * per)
    return {k: v[rows] for k, v in batch.items()}


def spawn(fn, mesh, *args):
    D, M = pdist.mesh_tp(mesh)
    return launch.spawn(fn, list(range(D * M)), "cpu", args,
                        timeout=WORLD_TIMEOUT, mesh=mesh)


def numpy_dict(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def whole_digest(model):
    """sha256 of each parameter and buffer that is whole on every model
    rank (the split ones' slices differ by design)."""
    split = tensor.split_params(model)
    return {k: hashlib.sha256(v.detach().numpy().tobytes()).hexdigest()
            for k, v in model.state_dict().items() if k not in split}


def equal_tree(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(equal_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(equal_tree(x, y) for x, y in zip(a, b)))
    return a == b


def float64_step(world, cfg, local, steps=1):
    """`steps` make_train_step steps of a float64 model from the seed's
    weights (split on a tp world, its BatchNorms synced in a world): the
    losses, the first step's gradients (split ones gathered whole), the
    final parameters (whole) and, for LBFGS, the line search's record."""
    model = build_model(cfg, device="cpu", seed=0)
    if world.model is not None:
        model.set_tensor_parallel(world.model)
    if world.distributed:
        convert_sync_batchnorm(model)
    model.double()
    opt = optim.build_optimizer(cfg, model)
    step = make_train_step(cfg, model, opt, seed=0, world=world)
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in local.items()}
    out = {"losses": [], "searches": []}
    for s in range(steps):
        out["losses"].append(float(step(s, batch)))
        if s == 0:
            out["grads"] = numpy_dict(tensor.full_grads(model))
        if getattr(opt, "last_step", None) is not None:
            out["searches"].append(dict(opt.last_step))
    out["params"] = {k: v for k, v in numpy_dict(
        tensor.full_state_dict(model)).items() if not k.endswith(
            ("num_batches_tracked",) + STATS)}
    return out


def adamw_run(world, cfg, local, steps=STEPS):
    """`steps` fp32 Trainer steps from the seed's weights: the losses, the
    BatchNorm statistics after the first, the final state (whole) and the
    Trainer."""
    trainer = Trainer(cfg, device="cpu", seed=0, world=world)
    out = {"losses": []}
    for s in range(steps):
        out["losses"].append(float(trainer.step(local)["loss"]))
        if s == 0:
            out["stats0"] = {k: v for k, v in numpy_dict(
                tensor.full_state_dict(trainer.model)).items()
                if k.endswith(STATS)}
    out["state"] = numpy_dict(tensor.full_state_dict(trainer.model))
    out["digest"] = whole_digest(trainer.model)
    out["dims"] = dict(trainer.model.tp_dims)
    return out, trainer


def mit_jobs(world, batch, ckpt_dir, one_dir):
    """Every mit_b0 job of one world (World.solo: the reference): AdamW,
    the float64 gradient, checkpoints, OHEM and LBFGS (data x model
    worlds with D > 1, and the reference), remat at rates 0.1 (D = 1, and
    the reference: one process's masks are data rank 0's)."""
    torch.set_num_threads(THREADS)
    local = images_of(world, batch)
    cfg = mit_cfg()
    out, trainer = adamw_run(world, cfg, local)
    out["float64"] = float64_step(world, cfg, local)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, trainer)
    if world.model is not None:
        fresh = Trainer(cfg, device="cpu", world=world, init_values=False)
        mgr.restore(fresh)
        out["tp_tp"] = (
            equal_tree(fresh.model.state_dict(), trainer.model.state_dict())
            and equal_tree(fresh.optimizer.state_dict(),
                           trainer.optimizer.state_dict()))
        fresh = Trainer(cfg, device="cpu", world=world, init_values=False)
        one = CheckpointManager(one_dir)
        one.restore(fresh)
        payload = one.load(1)
        out["dp_tp"] = (
            equal_tree(tensor.full_state_dict(fresh.model), payload["model"])
            and equal_tree(tensor.full_optimizer_state(
                fresh.optimizer, fresh.model), payload["optimizer"]))
    del trainer
    if world.model is None or world.data_size > 1:
        out["ohem"] = float64_step(world, mit_cfg(
            criterion="OhemCrossEntropy", ohem_min_kept=2000), local)
        out["lbfgs"] = float64_step(world, mit_cfg(optimizer="LBFGS"), local,
                                    steps=2)
    if world.model is None or world.data_size == 1:
        rated = mit_cfg(rates=0.1)
        out["rates"] = float64_step(world, rated, local)
        out["remat"] = float64_step(world, with_model(rated, remat=True),
                                    local)
    if world.rank:   # the other ranks' tensors are not compared
        out = {k: out[k] for k in ("losses", "digest", "tp_tp", "dp_tp")
               if k in out}
    return out


def family_jobs(world, batch):
    """The narrow Swin: 3 fp32 steps at its drop rates, and a float64 first
    step; segnext_tiny: one fp32 step (nothing splits)."""
    torch.set_num_threads(THREADS)
    register_swin_narrow()
    local = images_of(world, batch)
    cfg = with_model(mit_cfg(), backbone="swin_narrow", drop_path_rate=0.2)
    out = {}
    out["swin"], trainer = adamw_run(world, cfg, local)
    del trainer
    out["swin64"] = float64_step(world, cfg, local)
    out["segnext"], trainer = adamw_run(
        world, with_model(mit_cfg(), backbone="segnext_tiny"), local, 1)
    del trainer
    if world.rank:
        out = {k: {"losses": v["losses"], "digest": v.get("digest")}
               for k, v in out.items()}
    return out


# ----------------------------------------------------------- the rules --


def test_split_dim_rules():
    """The cases of the JAX test_tp_spec_rules in torch names and layouts:
    fc1 on its output rows, its bias, the depthwise conv on its channels,
    fc2 on its input columns; fc2's bias, attention and norms whole; a
    hidden width that does not divide stays whole; SegNeXt's ffn_* never
    split."""
    m, sd = 4, tensor.split_dim
    assert sd("b.mlp.fc1.weight", (128, 32), m) == 0
    assert sd("b.mlp.fc1.bias", (128,), m) == 0
    assert sd("b.mlp.dwconv.dwconv.weight", (128, 1, 3, 3), m) == 0
    assert sd("b.mlp.dwconv.dwconv.bias", (128,), m) == 0
    assert sd("b.mlp.fc2.weight", (32, 128), m) == 1
    assert sd("b.mlp.fc2.bias", (32,), m) is None
    assert sd("b.attn.q.weight", (32, 32), m) is None
    assert sd("b.norm2.weight", (32,), m) is None
    assert sd("b.mlp.fc1.weight", (30, 32), m) is None
    assert sd("b.mlp.fc2.weight", (32, 30), m) is None
    for name, shape in (("b.ffn_fc1.bias", (128,)),
                        ("b.ffn_fc1.weight", (128, 32, 1, 1)),
                        ("b.ffn_dwconv.weight", (128, 1, 3, 3)),
                        ("b.ffn_dwconv.bias", (128,))):
        assert sd(name, shape, m) is None, name


@pytest.mark.parametrize("backbone, M", [
    ("mit_b0", 2), ("mit_b0", 5), ("swin_narrow", 4), ("segnext_tiny", 2)])
def test_split_matches_jax_tp_spec(backbone, M, monkeypatch):
    """The parameters set_tensor_parallel splits are the leaves JAX
    _tp_spec splits on the converted variables, on the same dims (the
    local shapes are the whole ones over M there); mit_b0 at M = 5 splits
    only stage 3 (hidden 640), segnext_tiny nothing, though it has
    ffn_fc1 / ffn_dwconv / ffn_fc2 leaves."""
    import jax
    from jax.sharding import PartitionSpec as P

    from rgbx_semantic_segmentation_tpu.convert import (
        torch_to_flax_variables)
    from rgbx_semantic_segmentation_tpu.parallel import mesh as jmesh
    from rgbx_semantic_segmentation_tpu_torch.convert import (
        flax_to_torch_state_dict)

    factories, channels = dict(builder.SWIN_FACTORIES), dict(
        dual_swin.CHANNELS)
    register_swin_narrow(factories, channels)
    monkeypatch.setattr(builder, "SWIN_FACTORIES", factories)
    monkeypatch.setattr(dual_swin, "CHANNELS", channels)
    model = build_model(with_model(mit_cfg(), backbone=backbone),
                        device="cpu", seed=0)
    whole = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    var = torch_to_flax_variables(model.state_dict())
    marks = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), float(jmesh._tp_spec(
            jax.tree_util.keystr(path), leaf, M) != P()), np.float32), var)
    want = {k for k, v in flax_to_torch_state_dict(marks).items()
            if v.numel() and bool((v == 1).all())}
    model.set_tensor_parallel(tensor.ModelGroup(None, 0, M))
    assert set(model.tp_dims) == want
    local = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    for k, shape in whole.items():
        want_shape = list(shape)
        if k in model.tp_dims:
            want_shape[model.tp_dims[k]] //= M
        assert local[k] == tuple(want_shape), k
    if backbone == "segnext_tiny":
        assert not want and any(".ffn_fc1." in k for k in whole)
    elif backbone == "mit_b0" and M == 5:
        assert want and all(re.search(r"block3\.", k) for k in want)
    else:
        assert {k.rsplit(".", 2)[-2] for k in want} == {
            "fc1", "fc2", "dwconv"} - ({"dwconv"} if "swin" in backbone
                                       else set())


# ------------------------------------------------------ the mit_b0 runs --


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_checkpoints")


@pytest.fixture(scope="module")
def one_process(ckpt_root):
    """The reference: every job in one process; its checkpoint is the
    one-process file the tp ranks restore."""
    one_dir = str(ckpt_root / "one")
    return mit_jobs(pdist.World.solo("cpu"), step_batch(), one_dir, one_dir)


@pytest.fixture(scope="module")
def meshes(one_process, ckpt_root):
    batch = step_batch()
    return {mesh: spawn(mit_jobs, mesh, batch, str(ckpt_root / mesh),
                        str(ckpt_root / "one"))
            for mesh in MESHES}


def assert_params_close(got, want, atol, start=None):
    """Parameters after STEPS AdamW steps (tests/test_torch_ddp.py's
    reading): AdamW moves a coordinate by about the lr whatever its
    gradient, so where the gradient is rounding noise two summation orders
    part by up to 2 * lr * steps. Every coordinate within that; outside
    ZERO_GRADIENT at most 1e-3 of the coordinates beyond `atol`. The
    parameters only, as the JAX test compares them: the BatchNorm
    statistics of the later steps see those biases' noise (the decoder's
    fusing BatchNorm's running mean moves by 5e-3 through linear_c*'s
    biases); test_adamw_matches_one_process holds them after the first."""
    beyond = total = 0
    for k, w in want.items():
        if k.endswith(("num_batches_tracked",) + STATS):
            continue
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * LR * STEPS, (k, diff.max())
        if ZERO_GRADIENT.search(k):
            continue
        beyond += int((diff > atol).sum())
        total += diff.size
    assert beyond <= 1e-3 * total, (beyond, total)


def assert_grads_close(got, want, rtol):
    assert set(got) == set(want)
    for k, g in want.items():
        if ZERO_GRADIENT.search(k):
            continue
        err = np.abs(got[k] - g).max() / max(np.abs(g).max(), 1e-300)
        assert err <= rtol, (k, err)


@pytest.mark.parametrize("mesh", MESHES)
def test_adamw_matches_one_process(mesh, meshes, one_process):
    """Three fp32 AdamW steps: every rank's losses one process's within
    1e-4 relative and equal across ranks; the BatchNorm running statistics
    after the first step within 1e-5; the parameters (gathered whole) as
    assert_params_close reads them at 2e-5; the whole parameters and
    buffers bit-equal on every rank; the float64 first-step gradients
    within 1e-8 of each tensor's largest."""
    ranks, ref = meshes[mesh], one_process
    r0 = ranks[0]
    assert r0["dims"] and len(r0["dims"]) == 80   # 16 blocks x 5 leaves
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4)
        assert r["losses"] == r0["losses"]
        assert r["digest"] == r0["digest"]
    for k, v in ref["stats0"].items():
        np.testing.assert_allclose(r0["stats0"][k], v, atol=1e-5, rtol=0,
                                   err_msg=k)
    assert_params_close(r0["state"], ref["state"], 2e-5)
    assert r0["float64"]["losses"][0] == pytest.approx(
        ref["float64"]["losses"][0], rel=1e-12)
    assert_grads_close(r0["float64"]["grads"], ref["float64"]["grads"], 1e-8)


@pytest.mark.parametrize("mesh", MESHES)
def test_adamw_matches_jax_tp_trainer(mesh, meshes, one_process):
    """The same three steps against the JAX Trainer on make_mesh_dp_tp(D,
    M) (the 8 virtual CPU devices of conftest.py) from the same weights:
    losses 1e-4 relative, parameters 2e-5 (the bounds of JAX
    test_tp_train_matches_single_device, read as assert_params_close)."""
    import jax

    from rgbx_semantic_segmentation_tpu import config as jconfig
    from rgbx_semantic_segmentation_tpu import train as jtrain
    from rgbx_semantic_segmentation_tpu.convert import (
        torch_to_flax_variables)
    from rgbx_semantic_segmentation_tpu.parallel import mesh as jmesh
    from rgbx_semantic_segmentation_tpu_torch.convert import (
        flax_to_torch_state_dict)

    D, M = pdist.mesh_tp(mesh)
    var = torch_to_flax_variables(
        build_model(mit_cfg(), device="cpu", seed=0).state_dict())
    jm = jmesh.make_mesh_dp_tp(D, M)
    jt = jtrain.Trainer(mit_cfg(jconfig), mesh=jm, seed=0, init_values=False)
    jt.state = jt.state.replace(
        params=jmesh.shard_state_tp(jm, var["params"]),
        batch_stats=jmesh.replicate(jm, var["batch_stats"]))
    batch = step_batch()
    losses = [float(jt.step(batch)["loss"]) for _ in range(STEPS)]
    want = {k: v.numpy() for k, v in flax_to_torch_state_dict(
        {"params": jax.device_get(jt.state.params),
         "batch_stats": jax.device_get(jt.state.batch_stats)}).items()
        if not k.endswith("num_batches_tracked")}
    ours = meshes[mesh][0]
    np.testing.assert_allclose(ours["losses"], losses, rtol=1e-4)
    assert_params_close({k: ours["state"][k] for k in want}, want, 2e-5)


def test_ohem_and_lbfgs_match_one_process(meshes, one_process):
    """tp:2,2 in float64: OHEM (min_kept 2000 of the 4 images' pixels a
    data rank: the k-th smallest over the data group) loss 1e-12 relative
    and gradients 1e-8 of each tensor's largest; two LBFGS steps with the
    same line searches (step size 1e-9 relative, evaluations equal), losses
    1e-12 and parameters 1e-10."""
    got, ref = meshes["tp:2,2"][0], one_process
    np.testing.assert_allclose(got["ohem"]["losses"], ref["ohem"]["losses"],
                               rtol=1e-12)
    assert_grads_close(got["ohem"]["grads"], ref["ohem"]["grads"], 1e-8)
    a, b = got["lbfgs"], ref["lbfgs"]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-12)
    assert len(a["searches"]) == len(b["searches"]) == 2
    for s, t in zip(a["searches"], b["searches"]):
        assert s["evaluations"] == t["evaluations"]
        assert s["stepsize"] == pytest.approx(t["stepsize"], rel=1e-9)
    moved = max(np.abs(v - ref["float64"]["params"][k]).max()
                for k, v in b["params"].items())
    assert moved > 1e-6
    for k, v in b["params"].items():
        np.testing.assert_allclose(a["params"][k], v, atol=1e-10, rtol=0,
                                   err_msg=k)


def test_remat_matches_one_process(meshes, one_process):
    """tp:1,2 with remat at drop-path and decoder dropout 0.1 (float64):
    the loss and gradients one process's without remat (1e-12, 1e-8), and
    its own without remat."""
    got, ref = meshes["tp:1,2"][0], one_process
    for key in ("rates", "remat"):
        assert got[key]["losses"][0] == pytest.approx(
            ref["rates"]["losses"][0], rel=1e-12)
        assert_grads_close(got[key]["grads"], ref["rates"]["grads"], 1e-8)


def test_checkpoints_round_trip(meshes, one_process, ckpt_root):
    """A tp file holds the keys and shapes of one process's file (model
    and optimizer); restored on the same mesh it gives the saving ranks'
    state bit for bit (tp -> tp); one process restores it to the tp run's
    whole state (tp -> dp); a tp world restores one process's file to that
    file's state (dp -> tp)."""
    one = CheckpointManager(str(ckpt_root / "one")).load(1)
    for mesh in MESHES:
        got = CheckpointManager(str(ckpt_root / mesh)).load(1)
        assert {k: tuple(v.shape) for k, v in got["model"].items()} == {
            k: tuple(v.shape) for k, v in one["model"].items()}
        opt, ref = got["optimizer"], one["optimizer"]
        assert opt["param_groups"] == ref["param_groups"]
        assert set(opt["state"]) == set(ref["state"])
        for i, entry in ref["state"].items():
            assert {k: tuple(getattr(v, "shape", ())) for k, v in
                    opt["state"][i].items()} == {
                k: tuple(getattr(v, "shape", ())) for k, v in entry.items()}
        for r in meshes[mesh]:
            assert r["tp_tp"] and r["dp_tp"]
        trainer = Trainer(mit_cfg(), device="cpu", init_values=False)
        CheckpointManager(str(ckpt_root / mesh)).restore(trainer)
        state = trainer.model.state_dict()
        for k, v in meshes[mesh][0]["state"].items():
            assert np.array_equal(state[k].numpy(), v), k


# ------------------------------------------------ Swin and SegNeXt runs --


@pytest.fixture(scope="module")
def families():
    batch = step_batch()
    factories, channels = dict(builder.SWIN_FACTORIES), dict(
        dual_swin.CHANNELS)
    register_swin_narrow(factories, channels)
    saved = builder.SWIN_FACTORIES, dual_swin.CHANNELS
    builder.SWIN_FACTORIES, dual_swin.CHANNELS = factories, channels
    try:
        ref = family_jobs(pdist.World.solo("cpu"), batch)
    finally:
        builder.SWIN_FACTORIES, dual_swin.CHANNELS = saved
    return ref, spawn(family_jobs, "tp:1,2", batch)


def test_swin_and_segnext_on_tp(families):
    """The narrow Swin on tp:1,2 at attention dropout 0.3, MLP dropout 0.1
    (drawn at the whole hidden width) and drop path 0.2: the whole
    parameters bit-equal on both model ranks after 3 steps, the losses one
    process's (1e-4 relative), the float64 first-step gradients 1e-8 of
    each tensor's largest; its MLPs split (16 blocks x 3 leaves).
    segnext_tiny: nothing splits, the two ranks run as replicas, bit-equal
    and with one process's loss."""
    ref, ranks = families
    r0 = ranks[0]
    assert len(r0["swin"]["dims"]) == 2 * 8 * 3
    assert r0["segnext"]["dims"] == {}
    for r in ranks:
        for key in ("swin", "segnext"):
            assert r[key]["digest"] == r0[key]["digest"], key
            np.testing.assert_allclose(r[key]["losses"], ref[key]["losses"],
                                       rtol=1e-4, err_msg=key)
    assert r0["swin64"]["losses"][0] == pytest.approx(
        ref["swin64"]["losses"][0], rel=1e-12)
    assert_grads_close(r0["swin64"]["grads"], ref["swin64"]["grads"], 1e-8)


# --------------------------------------------------- the specs and CLI --


def test_mesh_tp_specs():
    """tp:D,M takes D x M devices (JAX make_mesh_dp_tp's grid); too few
    devices, a batch that does not divide by D and bad counts raise
    ValueError; tp and 2d are separate specs."""
    assert pdist.make_world_from_spec("tp:2,4", 8, range(8)) == list(
        range(8))
    assert pdist.make_world_from_spec("tp:1,2", 8, [3, 5, 7]) == [3, 5]
    assert pdist.mesh_tp("tp:2,4") == (2, 4) and pdist.mesh_tp("2d:2,4") is None
    assert pdist.mesh_2d("tp:2,4") is None
    with pytest.raises(ValueError, match="need 8 devices"):
        pdist.make_world_from_spec("tp:2,4", 8, range(4))
    with pytest.raises(ValueError, match="does not divide by 3"):
        pdist.make_world_from_spec("tp:3,1", 8, range(8))
    for spec in ("tp:2", "tp:0,2", "tp:a,b", "tp:2,4,1"):
        with pytest.raises(ValueError):
            pdist.make_world_from_spec(spec, 8, range(8))


def sums_and_eval(world, cfg, root):
    """World.all_reduce (every rank) and World.batch_sum (the data group)
    of rank + 1, and SegEvaluator's confusion matrix over the world (a
    whole model on every rank, as eval_cli builds it)."""
    from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
    from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator

    every = float(world.all_reduce(torch.tensor([world.rank + 1.0])))
    batch = float(world.batch_sum(torch.tensor([world.rank + 1.0])))
    ev = SegEvaluator(cfg, build_model(cfg, device="cpu", seed=0),
                      device="cpu")
    ev.evaluate(RGBXDataset(cfg.dataset, "val", root=root), eval_batch=1,
                world=world)
    return every, batch, ev.last_hist


def test_world_sums_and_eval_on_tp(tmp_path):
    """On tp:2,2 World.all_reduce sums over all 4 ranks and batch_sum over
    the 2 ranks of a model rank (each image once); the evaluator, which
    hands the items out over every rank and sums over every rank, gives
    one process's confusion matrix on every rank."""
    from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)
    from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator

    ds = make_synthetic_dataset(str(tmp_path), num_train=1, num_val=5,
                                hw=(HW, HW), num_classes=5, seed=4)
    cfg = mit_cfg().replace(dataset=ds, eval=tconfig.EvalConfig(
        eval_scale_array=(1.0,), eval_crop_size=(HW, HW)))
    ranks = spawn(sums_and_eval, "tp:2,2", cfg, str(tmp_path))
    ev = SegEvaluator(cfg, build_model(cfg, device="cpu", seed=0),
                      device="cpu")
    ev.evaluate(RGBXDataset(cfg.dataset, "val", root=str(tmp_path)),
                eval_batch=1)
    assert [r[0] for r in ranks] == [10.0] * 4
    assert [r[1] for r in ranks] == [4.0, 6.0, 4.0, 6.0]
    assert 0 < ev.last_hist.sum() <= 5 * HW * HW
    for _, _, hist in ranks:
        np.testing.assert_array_equal(hist, ev.last_hist)


def test_train_cli_tp_matches_dp1(tmp_path, monkeypatch):
    """train_cli --mesh tp:1,2 --device cpu -d 0,1 (mit_tiny at 64x64: at
    32x32 its stage-4 maps are 1x1, whose BatchNorm variance over 2 images
    is rounding noise)
    against --mesh dp:1 on the same synthetic set, one epoch of two steps
    at drop rates 0: the epoch loss within 1e-5 relative; the checkpoint
    rank 0 wrote holds one process's keys and shapes, within 1e-5 of its
    values; -c resumes it on dp:1."""
    from rgbx_semantic_segmentation_tpu_torch import train_cli
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)

    data = str(tmp_path / "data")
    ds = make_synthetic_dataset(data, num_train=4, num_val=2, hw=(64, 64),
                                num_classes=5, seed=3)
    base = tconfig.mfnet_config()
    cfg = base.replace(
        dataset=ds,
        model=tconfig.ModelConfig(backbone="mit_tiny", decoder_embed_dim=32,
                                  use_mixed_precision=False,
                                  drop_path_rate=0.0,
                                  decoder_dropout_ratio=0.0),
        train=dataclasses.replace(base.train, batch_size=2, num_workers=2))
    monkeypatch.setattr(tconfig, "get_config", lambda name: cfg)
    argv = ["--dataset_root", data, "--niters", "2", "--device", "cpu"]
    records = {}
    for run, extra in (("dp1", ["--mesh", "dp:1"]),
                       ("tp", ["--mesh", "tp:1,2", "-d", "0,1"])):
        os.makedirs(tmp_path / run)
        monkeypatch.chdir(tmp_path / run)
        records[run] = train_cli.main(argv + ["--epochs", "1"] + extra)
    assert records["tp"][0]["loss"] == pytest.approx(
        records["dp1"][0]["loss"], rel=1e-5)
    ckpt = {run: CheckpointManager(str(tmp_path / run / "logs" / cfg.tag()
                                       / "checkpoint")).load(1)
            for run in records}
    for k, v in ckpt["dp1"]["model"].items():
        assert ckpt["tp"]["model"][k].shape == v.shape, k
        assert torch.allclose(ckpt["tp"]["model"][k].float(), v.float(),
                              atol=1e-5, rtol=0), k
    monkeypatch.chdir(tmp_path / "tp")
    resumed = train_cli.main(argv + ["--epochs", "2", "-c", "--mesh",
                                     "dp:1"])
    assert [r["epoch"] for r in resumed] == [2]
