"""The data x spatial mesh of the port (`--mesh 2d:D,S`, parallel/spatial.py)
on the CPU, over 2 and 4 gloo ranks, against the whole image in one process
and against the JAX package.

- Each op of parallel/spatial.py and the halo conv (7x7/s4/p3, 3x3/s2/p1,
  3x3/s1/p1 depthwise, kernel = stride = r with blocks that do and do not
  line up with the windows) in float64 against the whole-image op, forward
  and backward, under the partial-sum rule (each rank's loss is its own
  rows'; the gradients of a replicated tensor are summed over the ranks):
  1e-12.
- The port's sr_attention_sharded on S row blocks against the JAX
  sr_attention_sharded on a (1, S) and a (2, 2) CPU mesh (its Pallas kernel
  in interpret mode, asked of the JAX side only): out and dq per block, the
  sum of the port's partial dk, dv against JAX's psum'd ones, 1e-5 (fp32).
- One train step of mit_b0 + MLPDecoder at 64x64, batch 4, drop rates 0
  (the geometry of tests/test_spatial_sharding.py) on 2d:2,2 and 2d:1,4
  (stage 4, 2 rows, runs whole there): against the port's one process, the
  fp32 loss 1e-5 relative and BatchNorm running statistics 1e-5; the
  gradients in float64, 1e-4 of each tensor's largest (in fp32 the one
  process itself lies 9.4e-3 of its largest from the float64 gradient on
  a few ReLU-gated weights at this seed, where the sharded steps lie within
  1e-4: a rounding at a kink, not the mesh); the kv projections' gradients
  not S times the one process's (the JAX psum must not be added to the
  gather's backward). Against JAX's unsharded loss and gradients (in
  float64, jax.enable_x64): loss 1e-5, gradients 2e-3 of the largest.
- At the preset's drop-path and Dropout2d rates the masks of an image's
  spatial ranks are equal, and the data ranks' differ.
- mit_b0pp (IFRM/IFFM) + MLPDecoder at 160x128, batch 2, drop rates 0, on
  2d:2,2 and 2d:1,4, held as mit_b0 above (the IFRM's BatchNorm statistics
  among them; stage 3 runs whole on 2d:1,4, stage 4 on both). Stage 1 has
  40 x 32 = 1,280 tokens: more keys than the SR kernel takes (1,024), so
  one process's stage-1 IFFM takes the flash attention's route (its plain
  versions here), while a rank's 640 or 320 query rows are under the
  flash gate's N >= 1024: each rank's calls take one process's route (the
  routes counted, not the losses compared: on the CPU every route is plain
  and agrees in fp32).
- `remat` on 2d:1,2 (mit_b0pp at the preset's drop rates and a MiT and
  IFFM attention dropout of 0.1, float64) equal to the same step without
  it, the blocks' attentions dispatched twice; at those rates the masks of
  an image's spatial ranks are the own rows of one process's masks, and
  the loss is one process's.
- The --mesh specs (JAX test_make_mesh_from_spec's cases) and train_cli
  --mesh 2d:1,2 against --mesh dp:1. (The dual Swin on the spatial axis:
  tests/test_torch_spatial_swin.py.)

The ranks' functions are module-level (spawned processes import this
file); JAX is imported only inside the tests that compare with it.
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch import optim
from rgbx_semantic_segmentation_tpu_torch.models import fusion
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_segformer)
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from rgbx_semantic_segmentation_tpu_torch.ops.attention import (
    multi_head_attention)
from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as SR
from rgbx_semantic_segmentation_tpu_torch.parallel import dist as pdist
from rgbx_semantic_segmentation_tpu_torch.parallel import launch
from rgbx_semantic_segmentation_tpu_torch.parallel import spatial
from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
    convert_sync_batchnorm)
from rgbx_semantic_segmentation_tpu_torch.train import (
    Trainer, make_train_step)

torch.set_num_threads(2)
WORLD_TIMEOUT = 180
HW, BATCH = 64, 4
# mit_b0pp: (H, W) and batch (see the module docstring)
PP_HW, PP_BATCH = (160, 128), 2
ATTN_DROP = 0.1
# Biases whose true gradient is 0 (a per-channel constant in front of a
# BatchNorm): their gradients are rounding noise (tests/test_torch_ddp.py).
ZERO_GRADIENT = re.compile(
    r"channel_embed\.[34]\.bias$|channel_emb\.norm\.bias$"
    r"|linear_c\d\.proj\.bias$|linear_fuse\.0\.bias$"
    r"|spatial_weights\.conv[12]\.bias$")   # the IFRM's, before its BNs
# the kv projections: of the MiT attentions and of the (I)FFM
# cross-attention
KV_WEIGHT = re.compile(r"attn\.kv\.weight$|cross_attn\.kv[12]\.weight$")
STATS = ("running_mean", "running_var")


def spawn(fn, n, mesh, *args):
    return launch.spawn(fn, list(range(n)), "cpu", args,
                        timeout=WORLD_TIMEOUT, mesh=mesh)


# ------------------------------------------------------------- the ops --

# (name, in channels, out channels, kernel, stride, padding, groups, H)
CONVS = [("7x7/s4/p3", 3, 8, 7, 4, 3, 1, 32),
         ("3x3/s2/p1", 4, 6, 3, 2, 1, 1, 16),
         ("3x3/s1/p1 depthwise", 5, 5, 3, 1, 1, 5, 8),
         ("k=s=r=4", 4, 6, 4, 4, 0, 1, 16),
         ("k=s=r=5, blocks off the windows", 3, 4, 5, 5, 0, 1, 44)]


def _whole(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


def _ops_rank(world):
    """Each op on this rank's rows; returns, per case, the largest
    difference from the whole-image op (forward, input gradient and, for
    the conv, the parameter gradients summed over the ranks)."""
    torch.set_num_threads(1)
    sp = world.spatial
    s, S = sp.rank, sp.size
    out = {}

    def rows(t, dim=2):
        return spatial.own_rows(t, sp, dim)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    # each rank's own cotangent of a replicated result: the whole image's
    # loss takes their sum
    cot = [_whole(100 + t, (2, 3, 8, 5)) for t in range(S)]
    X = _whole(1, (2, 3, 8, 5))
    x = leaf(rows(X))
    y = spatial.gather_rows(x, sp, 2)
    (y * cot[s]).sum().backward()
    out["gather_rows"] = max(float((y - X).abs().max()),
                             float((x.grad - rows(sum(cot))).abs().max()))

    Xr = leaf(X)
    y = spatial.own_rows(Xr, sp, 2)
    (y * rows(cot[s])).sum().backward()
    pad = torch.zeros_like(X)
    pad[:, :, s * 8 // S:(s + 1) * 8 // S] = rows(cot[s])
    out["own_rows"] = max(float((y - rows(X)).abs().max()),
                          float((Xr.grad - pad).abs().max()))

    Xw = leaf(X)
    want = Xw.sum(dim=(2, 3))
    (want * sum(c[:, :, 0, 0] for c in cot)).sum().backward()
    x = leaf(rows(X))
    y = spatial.spatial_sum(x.sum(dim=(2, 3)), sp)
    (y * cot[s][:, :, 0, 0]).sum().backward()
    out["spatial_sum"] = max(float((y - want).abs().max()),
                             float((x.grad - rows(Xw.grad)).abs().max()))

    # ties across the blocks: values on a grid of halves
    T = torch.round(_whole(2, (2, 3, 8, 5)) * 2) / 2
    Tw = leaf(T)
    want = Tw.amax(dim=(2, 3))
    (want * sum(c[:, :, 0, 0] for c in cot)).sum().backward()
    x = leaf(rows(T))
    y = spatial.spatial_amax(x, sp, (2, 3))
    (y * cot[s][:, :, 0, 0]).sum().backward()
    out["spatial_amax"] = max(float((y - want).abs().max()),
                              float((x.grad - rows(Tw.grad)).abs().max()))
    out["amax_ties"] = int((Tw.grad != 0).sum() > want.numel())

    for i, (name, cin, cout, k, st, p, groups, H) in enumerate(CONVS):
        torch.manual_seed(i)
        conv = torch.nn.Conv2d(cin, cout, k, stride=st, padding=p,
                               groups=groups).double()
        X = leaf(_whole(10 + i, (2, cin, H, 7)))
        Y = conv(X)
        G = _whole(20 + i, Y.shape)
        (Y * G).sum().backward()
        want_w, want_b = conv.weight.grad.clone(), conv.bias.grad.clone()
        conv.zero_grad()
        x = leaf(rows(X.detach()))
        y = spatial.conv2d_rows(x, conv, sp)
        (y * rows(G)).sum().backward()
        dw = world.all_reduce(conv.weight.grad.clone())
        db = world.all_reduce(conv.bias.grad.clone())
        out[name] = max(float((y - rows(Y.detach())).abs().max()),
                        float((x.grad - rows(X.grad)).abs().max()),
                        float((dw - want_w).abs().max()),
                        float((db - want_b).abs().max()))
    return out


@pytest.mark.parametrize("S", [2, 4])
def test_spatial_ops_match_whole_image(S):
    """Every op and conv case of parallel/spatial.py over S ranks against
    the whole-image op, float64, forward and backward: 1e-12 (sums in
    another order). The amax case holds ties that cross the blocks."""
    res = spawn(_ops_rank, S, f"2d:1,{S}")
    for r, got in enumerate(res):
        assert got.pop("amax_ties") == 1
        assert set(got) == ({"gather_rows", "own_rows", "spatial_sum",
                             "spatial_amax"} | {c[0] for c in CONVS})
        for name, err in got.items():
            assert err <= 1e-12, (r, name, err)


def test_conv_plan_halos_and_refusals():
    """The halo plan of the 7x7/s4/p3 patch embed over 4 blocks of 120
    input rows: 3 rows from above (none for the first), the image's zero
    padding at the first block only; windows that reach past the next
    block, or output rows that do not divide, raise."""
    sp = spatial.SpatialGroup(None, 0, 4)
    assert spatial.conv_rows_plan(480, 7, 4, 3, sp) == [
        (0, 0, 3, 0), (3, 0, 0, 0), (3, 0, 0, 0), (3, 0, 0, 0)]
    assert spatial.conv_rows_plan(16, 3, 1, 1, sp) == [
        (0, 1, 1, 0), (1, 1, 0, 0), (1, 1, 0, 0), (1, 0, 0, 1)]
    with pytest.raises(ValueError, match="reaches past"):
        spatial.conv_rows_plan(8, 7, 1, 3, sp)
    with pytest.raises(ValueError, match="does not shard"):
        spatial.conv_rows_plan(60, 3, 2, 1, sp)
    assert spatial.rows_ok(120, 300, sp) and not spatial.rows_ok(30, 300, sp)
    assert not spatial.rows_ok(16, 3, sp)
    assert spatial.row_range(120, spatial.SpatialGroup(None, 2, 4)) == (60,
                                                                        90)


# ---------------------------------------------- the attention vs JAX --


@pytest.mark.parametrize("data, S", [(1, 2), (1, 4), (2, 2)])
def test_sr_attention_sharded_matches_jax(data, S):
    """The port's sr_attention_sharded on each of S row blocks of q (the
    plain versions on the CPU) against the JAX sr_attention_sharded on a
    (data, S) CPU mesh with its Pallas kernels in interpret mode: out and
    dq per block, and the sum of the blocks' partial dk, dv against the
    JAX op's psum'd dk, dv: 1e-5 (fp32)."""
    import jax

    from rgbx_semantic_segmentation_tpu.ops import sr_attention as jsr
    from rgbx_semantic_segmentation_tpu.parallel import mesh as jmesh

    B, h, N, M, d = 2, 2, 96, 40, 16
    rng = np.random.RandomState(data * 10 + S)
    q, g = (rng.randn(B, h, N, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, h, M, d).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    mesh = jmesh.make_mesh_2d(data, S)

    def f(q, k, v):
        return jsr.sr_attention_sharded(q, k, v, scale, mesh, "data",
                                        "spatial", interpret=True)

    want, vjp = jax.vjp(f, q, k, v)
    dq_w, dk_w, dv_w = (np.asarray(t) for t in vjp(g))
    want = np.asarray(want)
    n = N // S
    dk = dv = 0.0
    for s in range(S):
        rows = slice(s * n, (s + 1) * n)
        qt = torch.tensor(q[:, :, rows], requires_grad=True)
        kt = torch.tensor(k, requires_grad=True)
        vt = torch.tensor(v, requires_grad=True)
        out = SR.sr_attention_sharded(qt, kt, vt, scale)
        out.backward(torch.from_numpy(g[:, :, rows]))
        np.testing.assert_allclose(out.detach().numpy(), want[:, :, rows],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(qt.grad.numpy(), dq_w[:, :, rows],
                                   atol=1e-5, rtol=0)
        dk, dv = dk + kt.grad.numpy(), dv + vt.grad.numpy()
    np.testing.assert_allclose(dk, dk_w, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dv, dv_w, atol=1e-5, rtol=0)


# ------------------------------------------------- a train step, 2d --


def step_cfg(cfg_lib=tconfig, rates=0.0):
    """tests/test_spatial_sharding.py's geometry (mit_b0 + MLPDecoder at
    64x64, batch 4, fp32), drop-path and decoder dropout at `rates`."""
    return cfg_lib.mfnet_config().replace(
        dataset=cfg_lib.DatasetConfig(num_classes=5, image_height=HW,
                                      image_width=HW,
                                      class_names=tuple("abcde")),
        model=cfg_lib.ModelConfig(
            backbone="mit_b0", decoder="MLPDecoder", decoder_embed_dim=64,
            use_mixed_precision=False, drop_path_rate=rates,
            decoder_dropout_ratio=rates),
        train=cfg_lib.TrainConfig(batch_size=BATCH, warm_up_epoch=0,
                                  nepochs=1, niters_per_epoch=2, lr=1e-3))


def pp_cfg(cfg_lib=tconfig, rates=0.0, remat=False):
    """step_cfg with mit_b0pp (IFRM/IFFM) at PP_HW, batch PP_BATCH."""
    cfg = step_cfg(cfg_lib, rates)
    return cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_height=PP_HW[0],
                                    image_width=PP_HW[1]),
        model=dataclasses.replace(cfg.model, backbone="mit_b0pp",
                                  remat=remat),
        train=dataclasses.replace(cfg.train, batch_size=PP_BATCH))


def step_batch(hw=(HW, HW), n=BATCH):
    """Host-normalised pairs; sample b ignores ~b/10 of its pixels."""
    rng = np.random.RandomState(0)
    label = rng.randint(0, 5, size=(n, *hw))
    for b in range(n):
        label[b][rng.rand(*hw) < 0.1 * b] = 255
    return {"rgb": rng.randn(n, *hw, 3).astype(np.float32),
            "modal_x": rng.randn(n, *hw, 3).astype(np.float32),
            "label": label.astype(np.int32)}


def pp_batch():
    return step_batch(PP_HW, PP_BATCH)


def _float64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def _grads(model):
    return {n: p.grad.detach().double().numpy().copy()
            for n, p in model.named_parameters()}


def _images_of(world, batch):
    per = len(batch["label"]) // world.data_size
    rows = slice(world.data_rank * per, (world.data_rank + 1) * per)
    return {k: v[rows] for k, v in batch.items()}


def _recorded_masks(model):
    """Record every keep mask the model's DropPath / Dropout / Dropout2d
    draw (the same draws, from a copy of the generator's state; a split
    mask as it is applied: the rank's slice), with the dim it is split
    along (None: whole)."""
    masks = []
    forward = tlayers._Stochastic.forward

    def recording(self, x, split=None, dim=-1):
        if self.training and self.rate > 0.0:
            state = self.generator.get_state()
            shape = list(self._mask_shape(x))
            if split is not None:
                shape[dim] *= split[1]
            u = torch.rand(shape, generator=self.generator)
            self.generator.set_state(state)
            if split is not None:
                w = shape[dim] // split[1]
                u = u.narrow(dim, split[0] * w, w)
            masks.append((type(self).__name__,
                          None if split is None else dim,
                          (u < 1.0 - self.rate).numpy()))
        return forward(self, x, split, dim)

    return masks, recording


def _train_steps(world, cfg, local):
    """One Trainer step of `cfg` in fp32 (loss, gradients, BatchNorm
    statistics, the attention routes its forward took) and one
    make_train_step step in float64 from the same weights (loss,
    gradients), on this world's images `local` (and rows)."""
    trainer = Trainer(cfg, device="cpu", seed=0, world=world)
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    multi_head_attention.routes.clear()
    out = {"loss": float(trainer.step(local)["loss"]),
           "routes": dict(multi_head_attention.routes),
           "grads": _grads(trainer.model),
           "stats": {k: v.numpy().copy() for k, v in
                     trainer.model.state_dict().items() if k.endswith(STATS)},
           "start": start}
    del trainer

    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(start)
    if world.distributed:
        convert_sync_batchnorm(model)
    model.double()
    step = make_train_step(cfg, model, optim.build_optimizer(cfg, model),
                           seed=0, world=world)
    out["loss64"] = float(step(0, _float64(local)))
    out["grads64"] = _grads(model)
    return out


def step_once(world, batch):
    """_train_steps of mit_b0, and one train-mode forward at the preset's
    drop rates with its masks recorded, on this world's images (and
    rows)."""
    torch.set_num_threads(1)
    local = _images_of(world, batch)
    out = _train_steps(world, step_cfg(), local)

    cfg = step_cfg(rates=0.1)
    model = build_model(cfg, device="cpu", seed=0)
    if world.distributed:
        convert_sync_batchnorm(model)
    step = make_train_step(cfg, model, optim.build_optimizer(cfg, model),
                           seed=0, world=world)
    masks, recording = _recorded_masks(model)
    forward = tlayers._Stochastic.forward
    tlayers._Stochastic.forward = recording
    try:
        step(0, local)
    finally:
        tlayers._Stochastic.forward = forward
    out["masks"] = masks
    if world.rank:   # only rank 0's tensors are compared
        out = {"masks": masks, "loss": out["loss"]}
    return out


@pytest.fixture(scope="module")
def one_process():
    # step_once runs on one thread; the test process keeps its own count
    # (later tests in the same worker hold 1-ulp bounds that depend on it).
    threads = torch.get_num_threads()
    try:
        return step_once(pdist.World.solo("cpu"), step_batch())
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    batch = step_batch()
    return {mesh: spawn(step_once, 4, mesh, batch)
            for mesh in ("2d:2,2", "2d:1,4")}


def hold_mesh_step(mesh, ranks, ref, n_kv):
    """A step on the mesh against one process on the whole batch: the fp32
    loss (every rank's) 1e-5 relative and BatchNorm statistics 1e-5; the
    float64 gradients 1e-4 of each tensor's largest; the `n_kv` kv
    projections' gradients the one process's, not S times them."""
    S = int(mesh.split(",")[1])
    r0 = ranks[0]
    for r in ranks:
        assert r["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert r0["loss64"] == pytest.approx(ref["loss64"], rel=1e-8)
    for k, want in ref["stats"].items():
        np.testing.assert_allclose(r0["stats"][k], want, atol=1e-5, rtol=0,
                                   err_msg=k)
    for k, want in ref["grads64"].items():
        if ZERO_GRADIENT.search(k):
            continue
        err = np.abs(r0["grads64"][k] - want).max() / np.abs(want).max()
        assert err <= 1e-4, (k, err)
    kv = [k for k in ref["grads64"] if KV_WEIGHT.search(k)]
    assert len(kv) == n_kv
    for k in kv:
        ratio = (np.linalg.norm(r0["grads64"][k])
                 / np.linalg.norm(ref["grads64"][k]))
        assert abs(ratio - 1.0) < 1e-4 and abs(ratio - S) > 0.5, (k, ratio)


@pytest.mark.parametrize("mesh", ["2d:2,2", "2d:1,4"])
def test_step_matches_one_process(mesh, meshes, one_process):
    """mit_b0: hold_mesh_step (16 MiT and 8 FFM kv projections)."""
    hold_mesh_step(mesh, meshes[mesh], one_process, 24)


def test_step_matches_jax_unsharded(meshes, one_process):
    """Both meshes' step against the JAX package's unsharded loss and
    gradients on the same weights and batch, in float64 (jax.enable_x64):
    the fp32 loss and the float64 loss 1e-5 relative, the float64
    gradients 2e-3 of each tensor's largest. (In fp32 the JAX step and the
    port's one process lie 1.2e-2 of their largest from the float64
    gradient on stage 1's fusion weights, bit-close to each other: their
    BatchNorm's E[x^2] - E[x]^2 cancels there; the sharded steps sum in
    another order and land elsewhere.)"""
    from rgbx_semantic_segmentation_tpu import config as jconfig

    hold_against_jax(meshes, step_cfg(jconfig), one_process["start"],
                     step_batch())


def hold_against_jax(meshes, jcfg, start, batch):
    """Each mesh's step (rank 0) against the JAX package's unsharded loss
    and gradients of `jcfg` on the weights `start` and `batch`, in float64
    (jax.enable_x64): the fp32 and float64 losses 1e-5 relative, the
    float64 gradients 2e-3 of each tensor's largest."""
    import jax

    from rgbx_semantic_segmentation_tpu import train as jtrain
    from rgbx_semantic_segmentation_tpu.convert import (
        torch_to_flax_variables)
    from rgbx_semantic_segmentation_tpu.models.builder import (
        EncoderDecoder as JaxEncoderDecoder)
    from rgbx_semantic_segmentation_tpu_torch.convert import (
        flax_params_to_torch)

    jmod = JaxEncoderDecoder(cfg=jcfg)
    loss_fn = jtrain.make_loss_fn(jcfg)
    rngs = {"droppath": jax.random.PRNGKey(0),
            "dropout": jax.random.PRNGKey(1)}
    with jax.enable_x64(True):
        var = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            torch_to_flax_variables(start))
        batch = _float64(batch)

        def loss(params):
            out, _ = jmod.apply({"params": params,
                                 "batch_stats": var["batch_stats"]},
                                batch["rgb"], batch["modal_x"], True,
                                rngs=rngs, mutable=["batch_stats"])
            return loss_fn(out, batch["label"])

        value, grads = jax.jit(jax.value_and_grad(loss))(var["params"])
        want = {k: v.numpy() for k, v in flax_params_to_torch(
            jax.device_get(grads)).items()}
    for mesh, ranks in meshes.items():
        got = ranks[0]
        for key in ("loss", "loss64"):
            assert got[key] == pytest.approx(float(value), rel=1e-5), mesh
        assert set(want) == set(got["grads64"])
        for k, w in want.items():
            if ZERO_GRADIENT.search(k):
                continue
            err = np.abs(got["grads64"][k] - w).max() / np.abs(w).max()
            assert err <= 2e-3, (mesh, k, err)


def test_drop_masks_equal_across_spatial_ranks(meshes, one_process):
    """At the preset's rates (drop-path 0.1, Dropout2d 0.1) the masks of an
    image's spatial ranks are equal, bit for bit; the two data ranks of
    2d:2,2 draw different ones; data rank 0 draws one process's masks of
    its images."""
    for mesh, ranks in meshes.items():
        S = int(mesh.split(",")[1])
        for r, got in enumerate(ranks):
            first = ranks[(r // S) * S]["masks"]
            assert len(got["masks"]) == len(first) > 0
            for (kind, _, a), (kind0, _, b) in zip(got["masks"], first):
                assert kind == kind0 and np.array_equal(a, b), (mesh, r, kind)
    d0, d1 = meshes["2d:2,2"][0]["masks"], meshes["2d:2,2"][2]["masks"]
    assert any(not np.array_equal(a, b)
               for (_, _, a), (_, _, b) in zip(d0, d1))
    kinds = {k for k, _, _ in d0}
    assert kinds == {"DropPath", "Dropout2d"}
    for (_, _, a), (_, _, b) in zip(meshes["2d:1,4"][0]["masks"],
                                    one_process["masks"]):
        assert np.array_equal(a, b)


# ------------------------------------- mit_b0pp (IFRM/IFFM), remat --


def pp_step_once(world, batch):
    """_train_steps of mit_b0pp on this world's images (and rows)."""
    torch.set_num_threads(1)
    out = _train_steps(world, pp_cfg(), _images_of(world, batch))
    if world.rank:   # only rank 0's tensors are compared
        out = {"loss": out["loss"], "routes": out["routes"]}
    return out


@pytest.fixture(scope="module")
def pp_one_process():
    threads = torch.get_num_threads()
    try:
        return pp_step_once(pdist.World.solo("cpu"), pp_batch())
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pp_meshes():
    batch = pp_batch()
    return {mesh: spawn(pp_step_once, 4, mesh, batch)
            for mesh in ("2d:2,2", "2d:1,4")}


@pytest.mark.parametrize("mesh", ["2d:2,2", "2d:1,4"])
def test_pp_step_matches_one_process(mesh, pp_meshes, pp_one_process):
    """mit_b0pp: hold_mesh_step (16 MiT and 8 IFFM kv projections); the
    statistics held include the IFRM spatial gates' BatchNorms, which run
    on a whole stage on every spatial rank of 2d:1,4 (stages 3-4) and of
    2d:2,2 (stage 4)."""
    assert any(".spatial_weights.norm1." in k for k in pp_one_process["stats"])
    hold_mesh_step(mesh, pp_meshes[mesh], pp_one_process, 24)


def test_pp_step_matches_jax_unsharded(pp_meshes, pp_one_process):
    """mit_b0pp on both meshes against the JAX package's unsharded step, by
    hold_against_jax's bounds."""
    from rgbx_semantic_segmentation_tpu import config as jconfig

    hold_against_jax(pp_meshes, pp_cfg(jconfig), pp_one_process["start"],
                     pp_batch())


@pytest.mark.parametrize("mesh", ["2d:2,2", "2d:1,4"])
def test_pp_routes_match_one_process(mesh, pp_meshes, pp_one_process):
    """Every rank's step dispatches its attentions as one process does
    (ops/attention.multi_head_attention.routes over the forward): the 16
    MiT attentions and the IFFMs of stages 2-4 to the SR route, the two
    stage-1 IFFM calls (1,280 keys) to the flash route, though a rank
    holds 640 (2d:2,2) or 320 (2d:1,4) of their query rows."""
    want = pp_one_process["routes"]
    assert want == {"sr": 22, "flash": 2}
    for r, got in enumerate(pp_meshes[mesh]):
        assert got["routes"] == want, (mesh, r)


def _set_attn_drop(model, rate):
    """Give every MiT attention and IFFM cross-attention of `model` the
    attention dropout `rate` (no config sets it)."""
    n = 0
    for m in model.modules():
        if isinstance(m, (dual_segformer.Attention,
                          fusion.ImprovedCrossAttention)):
            m.attn_drop = m.attn_dropout.rate = rate
            n += 1
    return n


def _pp_model(world, cfg, dtype=torch.float32):
    model = build_model(cfg, device="cpu", seed=0)
    assert _set_attn_drop(model, ATTN_DROP) == 20
    if world.distributed:
        convert_sync_batchnorm(model)
    return model.to(dtype)


def _remat_rank(world, batch):
    """A float64 step of mit_b0pp at the preset's drop rates and
    ATTN_DROP, without and with remat, on this rank's rows: loss,
    gradients and the MiT attentions' forward calls."""
    torch.set_num_threads(1)
    local = _float64(_images_of(world, batch))
    out = {}
    for remat in (False, True):
        cfg = pp_cfg(rates=0.1, remat=remat)
        model = _pp_model(world, cfg, torch.float64)
        calls = [0]

        def count(module, args):
            calls[0] += 1

        for m in model.modules():
            if isinstance(m, dual_segformer.Attention):
                m.register_forward_pre_hook(count)
        step = make_train_step(cfg, model, optim.build_optimizer(cfg, model),
                               seed=0, world=world)
        out[remat] = {"loss": float(step(0, local)), "grads": _grads(model),
                      "calls": calls[0]}
    return out


def test_remat_step_matches_without_remat():
    """remat on 2d:1,2 (mit_b0pp, drop-path and Dropout2d 0.1, MiT and IFFM
    attention dropout ATTN_DROP, float64) against the same step without
    remat on each rank: loss 1e-12 relative, gradients 1e-8 of each
    tensor's largest; the 16 MiT attentions run twice a step with remat
    (the recompute, on every rank), once without."""
    for r, got in enumerate(spawn(_remat_rank, 2, "2d:1,2", pp_batch())):
        plain, remat = got[False], got[True]
        assert (plain["calls"], remat["calls"]) == (16, 32), r
        assert remat["loss"] == pytest.approx(plain["loss"], rel=1e-12)
        for k, want in plain["grads"].items():
            scale = np.abs(want).max()
            err = np.abs(remat["grads"][k] - want).max()
            assert err <= 1e-8 * scale, (r, k, err)


def _dropout_rank(world, batch):
    """An fp32 step of mit_b0pp at the preset's drop rates and ATTN_DROP
    with its masks recorded, on this world's images (and rows)."""
    torch.set_num_threads(1)
    cfg = pp_cfg(rates=0.1)
    model = _pp_model(world, cfg)
    step = make_train_step(cfg, model, optim.build_optimizer(cfg, model),
                           seed=0, world=world)
    masks, recording = _recorded_masks(model)
    forward = tlayers._Stochastic.forward
    tlayers._Stochastic.forward = recording
    try:
        loss = float(step(0, _images_of(world, batch)))
    finally:
        tlayers._Stochastic.forward = forward
    return {"loss": loss, "masks": masks}


def test_attention_dropout_masks_are_one_process_rows():
    """At MiT and IFFM attention dropout ATTN_DROP (and the preset's other
    rates) on 2d:1,2: every mask a rank draws is one process's, whole
    where the rank holds the whole tensor (drop-path, Dropout2d, the
    stages that run whole) and the rank's rows of it where the rank holds
    its query rows (the attention probabilities: the q dim); the loss is
    one process's within 1e-5."""
    threads = torch.get_num_threads()
    try:
        one = _dropout_rank(pdist.World.solo("cpu"), pp_batch())
    finally:
        torch.set_num_threads(threads)
    ranks = spawn(_dropout_rank, 2, "2d:1,2", pp_batch())
    kinds = {(k, d) for k, d, _ in ranks[0]["masks"]}
    assert {("Dropout", -2), ("Dropout", None), ("DropPath", None),
            ("Dropout2d", None)} <= kinds
    for s, got in enumerate(ranks):
        assert got["loss"] == pytest.approx(one["loss"], rel=1e-5)
        assert len(got["masks"]) == len(one["masks"])
        for (kind, dim, a), (kind0, _, b) in zip(got["masks"], one["masks"]):
            assert kind == kind0
            if dim is not None:
                n = a.shape[dim]
                b = np.take(b, range(s * n, (s + 1) * n), axis=dim)
            assert np.array_equal(a, b), (s, kind, dim)


# --------------------------------------------------- the specs and CLI --


@pytest.mark.parametrize("spec, want", [
    ("dp", [0, 1, 2, 3, 4, 5, 6, 7]), ("dp:4", [0, 1, 2, 3]),
    ("2d:2,4", [0, 1, 2, 3, 4, 5, 6, 7]), ("2d:1,2", [0, 1]),
    ("tp:2,4", [0, 1, 2, 3, 4, 5, 6, 7])])
def test_mesh_specs(spec, want):
    """The cases of the JAX test_make_mesh_from_spec on 8 devices and a
    global batch of 8: dp, dp:4, 2d:2,4 and tp:2,4 take their devices;
    unknown or bad specs, and dp:N beyond the devices, raise ValueError."""
    assert pdist.make_world_from_spec(spec, 8, range(8)) == want
    assert pdist.mesh_2d(spec) == (
        tuple(int(x) for x in spec[3:].split(",")) if spec.startswith("2d")
        else None)


def test_mesh_spec_refusals():
    with pytest.raises(ValueError, match="need 8 devices"):
        pdist.make_world_from_spec("tp:2,4", 8, range(4))
    for spec in ("ring:3", "2d:banana", "2d:2", "2d:0,2", "dp:9", "dp:0",
                 "tp:banana", "tp:2", "tp:0,2"):
        with pytest.raises(ValueError):
            pdist.make_world_from_spec(spec, 8, range(8))
    with pytest.raises(ValueError, match="need 8 devices"):
        pdist.make_world_from_spec("2d:2,4", 8, range(4))
    with pytest.raises(ValueError, match="does not divide by 3"):
        pdist.make_world_from_spec("2d:3,1", 8, range(8))


@pytest.mark.parametrize("backbone, decoder, criterion, item", [
    ("swin_s", "UPernet", "CrossEntropyLoss", "5d"),
    ("swin_b", "MLPDecoder", "OhemCrossEntropy", "5d"),
    ("segnext_tiny", "MLPDecoder", "CrossEntropyLoss", "5d"),
    ("resnet50", "MLPDecoder", "CrossEntropyLoss", "5d"),
    ("mit_b0_w_aspp", "MLPDecoder", "CrossEntropyLoss", "5d"),
    ("mit_b0", "UPernet", "CrossEntropyLoss", "5d"),
    ("mit_b0pp", "deeplabv3+", "CrossEntropyLoss", "5d")])
def test_unported_models_raise_under_2d(backbone, decoder, criterion, item):
    """Every family, head and criterion but the MiT towers (FRM/FFM or
    IFRM/IFFM), the dual Swin towers (FRM/FFM), the MLPDecoder and the
    cross-entropy raises NotImplementedError on the spatial axis, naming
    its ROADMAP item."""
    from rgbx_semantic_segmentation_tpu_torch.models.builder import (
        spatial_support)

    cfg = step_cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, backbone=backbone,
                                                decoder=decoder),
                      train=dataclasses.replace(cfg.train,
                                                criterion=criterion))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        spatial_support(cfg)


def test_aux_head_preset_raises_under_2d():
    """The pst900 preset (mit_b2_w_aspp + UPernet with the aux head) raises
    on the spatial axis, naming item 5d."""
    from rgbx_semantic_segmentation_tpu_torch.models.builder import (
        AUX_DECODERS, spatial_support)

    cfg = tconfig.pst900_config()
    assert cfg.model.decoder in AUX_DECODERS
    with pytest.raises(NotImplementedError, match="item 5d"):
        spatial_support(cfg)


@pytest.mark.parametrize("backbone, frm, ffm, remat", [
    ("mit_b0pp", "FRM", "FFM", False), ("mit_b5pp", "FRM", "FFM", True),
    ("mit_b2", "IFRM", "IFFM", False), ("mit_b0", "FRM", "FFM", True)])
def test_mit_towers_run_under_2d(backbone, frm, ffm, remat):
    """The MiT towers with either fusion pair (mit_*pp hardwires IFRM/IFFM),
    with remat on or off, pass spatial_support."""
    from rgbx_semantic_segmentation_tpu_torch.models.builder import (
        spatial_support)

    cfg = step_cfg()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, backbone=backbone, feature_rectify_module=frm,
        feature_fusion_module=ffm, remat=remat))
    spatial_support(cfg)


def test_train_cli_2d_matches_dp1(tmp_path, monkeypatch):
    """train_cli --mesh 2d:1,2 --device cpu -d 0,1 (mit_tiny at 64x64:
    every stage's rows shard) against --mesh dp:1 on the same synthetic
    set, one epoch of two steps at drop rates 0: the epoch loss within
    1e-5 relative, and the checkpoint rank 0 wrote within 1e-5."""
    from rgbx_semantic_segmentation_tpu_torch import train_cli
    from rgbx_semantic_segmentation_tpu_torch.checkpoint import (
        CheckpointManager)
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)

    data = str(tmp_path / "data")
    ds = make_synthetic_dataset(data, num_train=4, num_val=2, hw=(HW, HW),
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
    argv = ["--dataset_root", data, "--epochs", "1", "--niters", "2",
            "--device", "cpu"]
    records = {}
    for run, extra in (("dp1", ["--mesh", "dp:1"]),
                       ("2d", ["--mesh", "2d:1,2", "-d", "0,1"])):
        os.makedirs(tmp_path / run)
        monkeypatch.chdir(tmp_path / run)
        records[run] = train_cli.main(argv + extra)
    assert records["2d"][0]["loss"] == pytest.approx(
        records["dp1"][0]["loss"], rel=1e-5)
    ckpt = {run: CheckpointManager(str(tmp_path / run / "logs" / cfg.tag()
                                       / "checkpoint")).load(1)["model"]
            for run in records}
    for k, v in ckpt["dp1"].items():
        assert torch.allclose(ckpt["2d"][k].float(), v.float(), atol=1e-5,
                              rtol=0), k
