"""The dual Swin on the data x spatial mesh of the port (`--mesh 2d:D,S`,
models/encoders/dual_swin.py, parallel/spatial.py) on the CPU, over 2 and
4 gloo ranks, against the whole image in one process and against the JAX
package.

- The row exchange of a Swin block (spatial.ring_rows and its transpose
  ring_rows_back) in float64 against the whole padded, rolled image, forward
  and summed backward, for every stage that spatial_layout shards of swin_s
  and swin_b at 480x640 on S = 2 and 4 (narrow channels) and of the test
  geometry, both shifts (the last rank's slab wraps round to rank 0's
  rows): 1e-12. The layout of the 480x640 table and the plans' refusals.
- The plain window attention with `window0` on every rank's window slab
  equals the whole call's windows, bit for bit: out, dqkv, db and the
  keep mask at rate 0.3; window0 = 0 on a later slab draws other masks.
  On the card (`cuda`, skipped here) the same of K3 and K4 at swin_s's and
  swin_b's rank slabs.
- A narrow dual Swin (tests/test_torch_tp.SWIN_NARROW's widths, window 7)
  + MLPDecoder at 128x64 (stage 1: 32 rows, padded to 35), drop rates 0:
  batch 4 on 2d:2,2 (stages 1-3 shard) and batch 2 on 2d:1,4 (stage 1
  shards), held as tests/test_torch_spatial.hold_mesh_step holds MiT (fp32
  loss 1e-5, BatchNorm statistics 1e-5, float64 gradients 1e-4 of each
  tensor's largest; the FFM kv projections' and the relative-position
  tables' gradients one process's, not S times it), and against the JAX
  package's unsharded step in float64 (hold_against_jax: 2e-3). The same
  at window 12 (shift 6) on 2d:1,2.
- `remat` with `ape`, and `frozen_stages` 2, at every drop rate on 2d:1,2,
  float64: one process's loss and gradients (the APE's gradient a partial
  sum that the world's sum completes: not S times one process's).
- At every drop rate (attention 0.3, proj / MLP / pos_drop 0.1, drop path
  0.2) on 2d:1,2, kernel path and plain composition: every mask a rank
  draws is one process's, whole or the rank's window slab or rows of it
  (the attention's keep masks by window0), and the loss one process's.
- spatial_support lets swin_s / swin_b with FRM/FFM, the MLPDecoder and
  the cross-entropy pass, with remat, ape and frozen stages.
- train_cli --mesh 2d:1,2 on the narrow Swin against --mesh dp:1.

The ranks' functions are module-level (spawned processes import this
file); JAX is imported only inside the tests that compare with it.
"""
import contextlib
import dataclasses
import functools
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch import optim
from rgbx_semantic_segmentation_tpu_torch.models import builder
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.models.encoders import dual_swin
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as WA
from rgbx_semantic_segmentation_tpu_torch.parallel import dist as pdist
from rgbx_semantic_segmentation_tpu_torch.parallel import launch
from rgbx_semantic_segmentation_tpu_torch.parallel import spatial
from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
    convert_sync_batchnorm)
from rgbx_semantic_segmentation_tpu_torch.train import make_train_step
from tests.test_torch_spatial import (
    ZERO_GRADIENT, _float64, _images_of, _train_steps,
    hold_against_jax, hold_mesh_step, spawn, step_batch, step_cfg)
from tests.test_torch_tp import SWIN_NARROW

torch.set_num_threads(2)
SW_HW = (128, 64)
# the narrow Swins by name: overrides of SWIN_NARROW (the builder passes
# the config's drop_path_rate)
NARROW = {"swin_narrow": {},
          "swin_narrow0": dict(attn_drop_rate=0.0, drop_rate=0.0),
          "swin_narrow12": dict(window_size=12, attn_drop_rate=0.0,
                                drop_rate=0.0)}
NARROW_CHANNELS = (32, 64, 128, 256)
TABLE = re.compile(r"relative_position_bias_table$")
APE = re.compile(r"absolute_pos_embed(_d)?$")


def register_narrow(factories=None, channels=None):
    """Name the narrow Swins in the port's builder registry (a rank's
    process; the test process passes copies, narrow_swins)."""
    factories = builder.SWIN_FACTORIES if factories is None else factories
    channels = dual_swin.CHANNELS if channels is None else channels
    for name, over in NARROW.items():
        factories[name] = functools.partial(
            lambda over, **kw: dual_swin.DualSwinTransformer(
                **{**SWIN_NARROW, **over, **kw}), over)
        channels[name] = NARROW_CHANNELS


@contextlib.contextmanager
def narrow_swins():
    """The narrow Swins in the port's registry, restored on exit."""
    factories = dict(builder.SWIN_FACTORIES)
    channels = dict(dual_swin.CHANNELS)
    register_narrow(factories, channels)
    saved = builder.SWIN_FACTORIES, dual_swin.CHANNELS
    builder.SWIN_FACTORIES, dual_swin.CHANNELS = factories, channels
    try:
        yield
    finally:
        builder.SWIN_FACTORIES, dual_swin.CHANNELS = saved


@pytest.fixture
def narrow():
    with narrow_swins():
        yield


def swin_cfg(cfg_lib=tconfig, backbone="swin_narrow0", batch=4, rates=0.0,
             hw=SW_HW, **model):
    """step_cfg (MLPDecoder, fp32, decoder dropout and drop path at `rates`)
    with a narrow Swin at `hw`, batch `batch`; `model` overrides
    ModelConfig fields."""
    cfg = step_cfg(cfg_lib, rates)
    return cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_height=hw[0],
                                    image_width=hw[1]),
        model=dataclasses.replace(cfg.model, backbone=backbone, **model),
        train=dataclasses.replace(cfg.train, batch_size=batch))


def _whole(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


# ------------------------------------------------------- the exchange --

# (H, window) of the stages spatial_layout shards: swin_s / swin_b at
# 480x640 and the narrow test geometry (128x64, windows 7 and 12)
RING_CASES = {2: [(120, 7), (60, 7), (30, 7), (120, 12), (60, 12), (30, 12),
                  (32, 7), (16, 7), (8, 7), (32, 12), (16, 12)],
              4: [(120, 7), (60, 7), (120, 12), (60, 12), (32, 7)]}


def _ring_rank(world, cases):
    """ring_rows and ring_rows_back on this rank's rows of each case, both
    shifts, float64; per case the largest difference from the whole
    padded, rolled image (forward and the gradient of the sum of the
    ranks' losses)."""
    torch.set_num_threads(1)
    sp = world.spatial
    s, S = sp.rank, sp.size
    out = {}
    for H, ws in cases:
        n = H // S
        for shift in (0, ws // 2):
            blocks, plan = spatial.window_slab_plan(H, ws, shift, S)
            Hp = -(-H // ws) * ws
            r0, r1 = blocks[s]
            shape = (2, H, 3, 4)
            X = _whole(H + ws + shift, shape)
            rolled = F.pad(X, (0, 0, 0, 0, 0, Hp - H)).roll(-shift, 1)
            x = X[:, s * n:(s + 1) * n].clone().requires_grad_(True)
            y = spatial.ring_rows(x, sp, plan, 1)
            cot = [_whole(500 + t, (2, (b - a) * ws, 3, 4))
                   for t, (a, b) in enumerate(blocks)]
            (y * cot[s]).sum().backward()
            full = torch.zeros(2, Hp, 3, 4, dtype=X.dtype)
            for (a, b), c in zip(blocks, cot):
                full[:, a * ws:b * ws] += c
            dX = full.roll(shift, 1)[:, :H]
            err = max(float((y - rolled[:, r0 * ws:r1 * ws]).abs().max()),
                      float((x.grad - dX[:, s * n:(s + 1) * n]).abs().max()))

            Y = _whole(900 + H + shift, (2, Hp, 3, 4))
            yb = Y[:, r0 * ws:r1 * ws].clone().requires_grad_(True)
            z = spatial.ring_rows_back(yb, sp, plan, 1, n)
            G = _whole(700 + H, shape)
            (z * G[:, s * n:(s + 1) * n]).sum().backward()
            dY = F.pad(G, (0, 0, 0, 0, 0, Hp - H)).roll(-shift, 1)
            err = max(err, float((z - Y.roll(shift, 1)[:, s * n:(s + 1) * n]
                                  ).abs().max()),
                      float((yb.grad - dY[:, r0 * ws:r1 * ws]).abs().max()))
            out[(H, ws, shift)] = err
    return out


@pytest.mark.parametrize("S", [2, 4])
def test_ring_rows_match_whole_image(S):
    """spatial.ring_rows / ring_rows_back over S ranks against the whole
    padded, rolled image, float64, forward and backward: 1e-12."""
    cases = RING_CASES[S]
    for r, got in enumerate(spawn(_ring_rank, S, f"2d:1,{S}", cases)):
        assert len(got) == 2 * len(cases)
        for case, err in got.items():
            assert err <= 1e-12, (r, case, err)


def _layout(factory, S, h=480, w=640):
    with torch.device("meta"):
        model = factory()
    return model.spatial_layout(h, w, spatial.SpatialGroup(None, 0, S))


def test_layout_table_and_plan_refusals():
    """The layout of swin_s and swin_b at 480x640 (stages 1-3 shard on S =
    2, stages 1-2 on S = 4: the rows of stage 3 (2d:.,2) or 2 (2d:.,4) on a
    rank are odd, so the rows are gathered before its downsample); the
    uneven window-row blocks; and the refusals: a need past a ring
    neighbour, fewer window rows than ranks, rows that do not divide."""
    for factory in (dual_swin.swin_s, dual_swin.swin_b):
        assert _layout(factory, 2) == [True, True, True, False]
        assert _layout(factory, 4) == [True, True, False, False]
        assert _layout(factory, 8) == [True, False, False, False]
        assert _layout(factory, 4, h=484) == [False] * 4
    assert spatial.window_slab_plan(30, 7, 3, 2)[0] == ((0, 2), (2, 5))
    assert spatial.window_row_blocks(30, 12, 2) == ((0, 1), (1, 3))
    assert spatial.window_row_blocks(120, 7, 4) == ((0, 4), (4, 9), (9, 13),
                                                    (13, 18))
    # the last rank's shifted slab: its rows, the padding, rank 0's first
    assert spatial.window_slab_plan(120, 7, 3, 4)[1][3] == (
        (3, 4, 30), (-1, 0, 6), (0, 0, 3))
    with pytest.raises(ValueError, match="past its ring neighbours"):
        spatial.ring_rows_plan(40, 40, [(0, 25), (10, 20), (20, 30),
                                        (30, 40)], 4)
    with pytest.raises(ValueError, match="do not spread"):
        spatial.window_row_blocks(15, 7, 4)
    with pytest.raises(ValueError, match="do not divide"):
        spatial.ring_rows_plan(30, 35, [(0, 7)] * 4, 4)
    with pytest.raises(ValueError, match="ring range"):
        spatial.ring_rows_plan(32, 35, [(35, 40), (0, 7)], 2)


# ------------------------------------------- the kernels' window0 --


@pytest.mark.parametrize("ws, R, S, dtype", [
    (7, 5, 2, torch.float32), (7, 5, 4, torch.float32),
    (12, 3, 2, torch.float32), (7, 5, 2, torch.bfloat16)])
def test_window_attention_slabs_match_whole_call(ws, R, S, dtype):
    """The plain window attention (what the kernels are held to) on each
    of S window-row slabs of a padded image of R window rows, with window0
    = the slab's first window and its windows of the shift mask + bias,
    at rate 0.3: out, dqkv, db and the keep mask equal the whole call's
    windows bit for bit; the last slab at window0 = 0 draws other masks."""
    B, h, d, cols = 2, 2, 8, 2
    N, C = ws * ws, h * d
    Hp, Wp = R * ws, cols * ws
    rng = np.random.RandomState(ws + S)
    qkv = torch.from_numpy(rng.randn(B, Hp, Wp, 3 * C)).to(dtype)
    mask = torch.from_numpy(dual_swin._shift_attn_mask(Hp, Wp, ws, ws // 2))
    bias = (mask[:, None] + torch.from_numpy(
        rng.randn(h, N, N).astype(np.float32))[None]).contiguous()
    g = torch.from_numpy(rng.randn(B, Hp, Wp, C)).to(dtype)
    seed = torch.tensor([12345], dtype=torch.int64)
    scale, rate = d ** -0.5, 0.3
    out = WA.window_attention(qkv, bias, seed, scale, rate, ws)
    dqkv, db = WA.window_attention_bwd(qkv, bias, seed, g, scale, rate, ws)
    keep = WA.keep_mask(seed, B, R * cols, h, N, rate)
    for r0, r1 in spatial.window_row_blocks(Hp, ws, S):
        rows = slice(r0 * ws, r1 * ws)
        w0, w1 = r0 * cols, r1 * cols
        args = (qkv[:, rows].contiguous(), bias[w0:w1], seed)
        got = WA.window_attention(*args, scale, rate, ws, w0)
        dq, dbs = WA.window_attention_bwd(*args, g[:, rows].contiguous(),
                                          scale, rate, ws, w0)
        assert torch.equal(got, out[:, rows])
        assert torch.equal(dq, dqkv[:, rows])
        assert torch.equal(dbs, db[w0:w1])
        assert torch.equal(WA.keep_mask(seed, B, w1 - w0, h, N, rate, w0),
                           keep[:, w0:w1])
    assert not torch.equal(WA.keep_mask(seed, B, w1 - w0, h, N, rate),
                           keep[:, w0:w1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# (B, Hp, Wp, h, d, ws, S): swin_s's stage 1 and swin_b's stages 1 and 3
# at 480x640 (batch 2), over the ranks of their 2d:.,S layouts
KERNEL_SLABS = [(2, 126, 161, 3, 32, 7, 2), (2, 126, 161, 3, 32, 7, 4),
                (2, 63, 84, 6, 32, 7, 4), (2, 120, 168, 4, 32, 12, 2),
                (2, 36, 48, 16, 32, 12, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("shape", KERNEL_SLABS)
def test_kernels_on_slabs_match_whole_call(cuda, shape, shifted):
    """K3 and K4 (bf16, rate 0.3) on each rank's window slab with window0
    equal the whole call's windows bit for bit (out, dqkv, db): each
    window is computed alone, whatever the launch's other windows."""
    B, Hp, Wp, h, d, ws, S = shape
    g = torch.Generator(device=cuda).manual_seed(ws + S)
    N, cols = ws * ws, Wp // ws
    nW = (Hp // ws) * cols
    qkv = torch.randn(B, Hp, Wp, 3 * h * d, device=cuda,
                      generator=g).bfloat16()
    bias = torch.randn(1, h, N, N, device=cuda, generator=g)
    if shifted:
        mask = torch.from_numpy(dual_swin._shift_attn_mask(Hp, Wp, ws,
                                                           ws // 2))
        bias = (mask.to(cuda)[:, None] + bias).contiguous()
    else:
        bias = bias.expand(nW, -1, -1, -1)
    cot = torch.randn(B, Hp, Wp, h * d, device=cuda, generator=g).bfloat16()
    seed = torch.tensor([777], device=cuda)
    args = (seed, d ** -0.5, 0.3, ws)
    out = WA.window_attention(qkv, bias, *args)
    dqkv, db = WA.window_attention_bwd(qkv, bias, seed, cot, *args[1:])
    for r0, r1 in spatial.window_row_blocks(Hp, ws, S):
        rows = slice(r0 * ws, r1 * ws)
        slab = qkv[:, rows].contiguous()
        b = bias[r0 * cols:r1 * cols]
        got = WA.window_attention(slab, b, *args, r0 * cols)
        dq, dbs = WA.window_attention_bwd(slab, b, seed,
                                          cot[:, rows].contiguous(),
                                          *args[1:], r0 * cols)
        torch.cuda.synchronize()
        assert torch.equal(got, out[:, rows]), (r0, r1)
        assert torch.equal(dq, dqkv[:, rows]), (r0, r1)
        assert torch.equal(dbs, db[r0 * cols:r1 * cols]), (r0, r1)


# ------------------------------------------------ a train step, 2d --


def swin_step_once(world, cfg, batch):
    """tests/test_torch_spatial._train_steps of `cfg` (a narrow Swin) on
    this world's images (and rows)."""
    torch.set_num_threads(1)
    register_narrow()
    out = _train_steps(world, cfg, _images_of(world, batch))
    if world.rank:   # only rank 0's tensors are compared
        out = {"loss": out["loss"]}
    return out


# name -> (config, batch, meshes)
STEPS = {"ws7": (swin_cfg(batch=4), ("2d:2,2",)),
         "ws7_b2": (swin_cfg(batch=2), ("2d:1,4",)),
         "ws12": (swin_cfg(backbone="swin_narrow12", batch=2), ("2d:1,2",))}


@pytest.fixture(scope="module")
def swin_steps():
    """Per STEPS entry: one process's step and each mesh's ranks'."""
    out = {}
    threads = torch.get_num_threads()
    for name, (cfg, meshes) in STEPS.items():
        batch = step_batch(SW_HW, cfg.train.batch_size)
        try:
            with narrow_swins():
                one = swin_step_once(pdist.World.solo("cpu"), cfg, batch)
        finally:
            torch.set_num_threads(threads)
        out[name] = (one, {m: spawn(swin_step_once, _ranks(m), m, cfg, batch)
                           for m in meshes})
    return out


def _ranks(mesh):
    d, s = mesh[3:].split(",")
    return int(d) * int(s)


def hold_swin_step(mesh, ranks, ref):
    """hold_mesh_step (the 8 FFM kv projections), and the 16 blocks'
    relative-position tables' gradients one process's, not S times it."""
    S = int(mesh.split(",")[1])
    hold_mesh_step(mesh, ranks, ref, 8)
    tables = [k for k in ref["grads64"] if TABLE.search(k)]
    assert len(tables) == 16
    for k in tables:
        ratio = (np.linalg.norm(ranks[0]["grads64"][k])
                 / np.linalg.norm(ref["grads64"][k]))
        assert abs(ratio - 1.0) < 1e-4 and abs(ratio - S) > 0.5, (k, ratio)


@pytest.mark.parametrize("name, mesh", [
    ("ws7", "2d:2,2"), ("ws7_b2", "2d:1,4"), ("ws12", "2d:1,2")])
def test_swin_step_matches_one_process(name, mesh, swin_steps):
    """The narrow Swin's step on the mesh against one process on the whole
    batch (hold_swin_step): window 7 at batch 4 on 2d:2,2 and batch 2 on
    2d:1,4, window 12 at batch 2 on 2d:1,2."""
    one, meshes = swin_steps[name]
    hold_swin_step(mesh, meshes[mesh], one)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_swin_step_matches_jax_unsharded(name, swin_steps, monkeypatch):
    """Each narrow Swin step against the JAX package's unsharded loss and
    gradients on the same weights and batch, in float64
    (hold_against_jax's bounds)."""
    from rgbx_semantic_segmentation_tpu import config as jconfig
    from rgbx_semantic_segmentation_tpu.models import builder as jbuilder
    from rgbx_semantic_segmentation_tpu.models.encoders import (
        dual_swin as jdual_swin)

    cfg, _ = STEPS[name]
    backbone = cfg.model.backbone
    monkeypatch.setitem(jbuilder.BACKBONES, backbone, (
        functools.partial(jdual_swin.DualSwinTransformer,
                          **{**SWIN_NARROW, **NARROW[backbone],
                             "drop_path_rate": 0.0}),
        NARROW_CHANNELS, {}))
    one, meshes = swin_steps[name]
    jcfg = swin_cfg(jconfig, backbone, cfg.train.batch_size)
    hold_against_jax(meshes, jcfg, one["start"],
                     step_batch(SW_HW, cfg.train.batch_size))


# ---------------------------------- remat, ape, frozen stages, masks --

KNOBS = {"remat_ape": dict(remat=True, swin_ape=True),
         "frozen2": dict(swin_frozen_stages=2)}


def _knobs_rank(world, batch):
    """A float64 step of the narrow Swin at every drop rate with each of
    KNOBS, on this world's images (and rows): loss and gradients."""
    torch.set_num_threads(1)
    register_narrow()
    local = _float64(_images_of(world, batch))
    out = {}
    for name, knobs in KNOBS.items():
        cfg = swin_cfg(backbone="swin_narrow", batch=2, rates=0.1, **knobs)
        model = build_model(cfg, device="cpu", seed=0)
        if world.distributed:
            convert_sync_batchnorm(model)
        model.double()
        step = make_train_step(cfg, model, optim.build_optimizer(cfg, model),
                               seed=0, world=world)
        # (frozen parameters get no gradient: zeros)
        out[name] = {"loss": float(step(0, local)), "grads": {
            n: (torch.zeros_like(p) if p.grad is None else p.grad
                ).detach().numpy().copy()
            for n, p in model.named_parameters()}}
    return out


def test_remat_ape_frozen_match_one_process(narrow):
    """remat with ape, and frozen_stages 2, at every drop rate on 2d:1,2
    (float64): the loss 1e-10 relative and the gradients 1e-4 of each
    tensor's largest against one process (the window attention computes
    in fp32); the APE's and the tables' gradients one process's, not twice
    it; frozen stage 0 gets none."""
    batch = step_batch(SW_HW, 2)
    threads = torch.get_num_threads()
    try:
        one = _knobs_rank(pdist.World.solo("cpu"), batch)
    finally:
        torch.set_num_threads(threads)
    ranks = spawn(_knobs_rank, 2, "2d:1,2", batch)
    assert any(APE.search(k) for k in one["remat_ape"]["grads"])
    for name in KNOBS:
        want = one[name]
        for r in ranks:
            got = r[name]
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-10)
        got = ranks[0][name]["grads"]
        for k, w in want["grads"].items():
            if ZERO_GRADIENT.search(k):
                continue
            scale = np.abs(w).max()
            if name == "frozen2" and (".layers.0." in k
                                      or ".layers_d.0." in k):
                assert scale == 0.0, k
            err = np.abs(got[k] - w).max()
            assert err <= 1e-4 * scale, (name, k, err, scale)
            if APE.search(k) or TABLE.search(k):
                if scale:
                    ratio = np.linalg.norm(got[k]) / np.linalg.norm(w)
                    assert abs(ratio - 1.0) < 1e-4, (name, k, ratio)


def _recorded_masks():
    """Record every keep mask of the model's DropPath / Dropout (the same
    draws, from a copy of the generator's state), as applied: (kind, None
    or (dim, start) of the rank's part of the whole mask, mask); and the
    keep masks of the window attention's forwards (kind "window", window0
    on dim 1; the backward, whose order autograd chooses, draws them
    again). Patches the module functions until the returned undo runs."""
    masks = []
    forward = tlayers._Stochastic.forward
    keep_mask, reference = WA.keep_mask, WA.window_attention_reference
    in_forward = [False]

    def recording(self, x, split=None, dim=-1, span=None):
        if self.training and self.rate > 0.0:
            state = self.generator.get_state()
            shape = list(self._mask_shape(x))
            dim = dim % len(shape)
            n = shape[dim]
            if split is not None:
                span = (split[0] * n, n * split[1])
            if span is not None:
                shape[dim] = span[1]
            u = torch.rand(shape, generator=self.generator)
            self.generator.set_state(state)
            if span is not None:
                u = u.narrow(dim, span[0], n)
            masks.append((type(self).__name__,
                          None if span is None else (dim, span[0]),
                          (u < 1.0 - self.rate).numpy()))
        return forward(self, x, split, dim, span)

    def recording_keep(seed, B, nW, h, N, rate, window0=0):
        got = keep_mask(seed, B, nW, h, N, rate, window0)
        if in_forward[0]:
            masks.append(("window", (1, window0), got.numpy()))
        return got

    def recording_reference(*args):
        in_forward[0] = True
        try:
            return reference(*args)
        finally:
            in_forward[0] = False

    def undo():
        tlayers._Stochastic.forward = forward
        WA.keep_mask, WA.window_attention_reference = keep_mask, reference

    tlayers._Stochastic.forward = recording
    WA.keep_mask = recording_keep
    WA.window_attention_reference = recording_reference
    return masks, undo


def _dropout_rank(world, batch):
    """An fp32 step of the narrow Swin at every drop rate, on the kernel
    path and the plain composition, with its masks recorded, on this
    world's images (and rows)."""
    torch.set_num_threads(1)
    register_narrow()
    out = {}
    for kernels in (True, False):
        cfg = swin_cfg(backbone="swin_narrow", batch=2, rates=0.1,
                       use_pallas_kernels=kernels)
        model = build_model(cfg, device="cpu", seed=0)
        if world.distributed:
            convert_sync_batchnorm(model)
        step = make_train_step(cfg, model, optim.build_optimizer(cfg, model),
                               seed=0, world=world)
        masks, undo = _recorded_masks()
        try:
            loss = float(step(0, _images_of(world, batch)))
        finally:
            undo()
        out[kernels] = {"loss": loss, "masks": masks}
    return out


def test_dropout_masks_are_one_process_windows_and_rows(narrow):
    """At every drop rate on 2d:1,2, on the kernel path (attention dropout
    inside the window attention, keep masks by window0) and on the plain
    composition (attention dropout a Dropout on the slab's windows): every
    mask a rank draws is one process's, whole (drop path, the decoder's
    Dropout2d, the stages run whole) or the rank's part of it (pos_drop and
    the MLP: its token rows; proj_drop: its slab's image rows or windows;
    the attention: its windows); the loss is one process's within 1e-5."""
    batch = step_batch(SW_HW, 2)
    threads = torch.get_num_threads()
    try:
        one = _dropout_rank(pdist.World.solo("cpu"), batch)
    finally:
        torch.set_num_threads(threads)
    ranks = spawn(_dropout_rank, 2, "2d:1,2", batch)
    for kernels in (True, False):
        kinds = {(k, None if p is None else p[0])
                 for k, p, _ in ranks[0][kernels]["masks"]}
        want_kinds = {("DropPath", None), ("Dropout", 1), ("Dropout", None),
                      ("Dropout2d", None)}
        want_kinds.add(("window", 1) if kernels else ("Dropout", 1))
        assert want_kinds <= kinds, (kernels, kinds)
        ref = one[kernels]
        for s, rank in enumerate(ranks):
            got = rank[kernels]
            assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
            assert len(got["masks"]) == len(ref["masks"])
            for (kind, part, a), (kind0, part0, b) in zip(got["masks"],
                                                          ref["masks"]):
                assert kind == kind0 and part0 in (None, (1, 0))
                if part is not None:
                    # (the plain composition's one process draws its masks
                    # on (B * nW, ...) windows)
                    dim, start = part
                    b = b.reshape(a.shape[:dim] + (-1,) + a.shape[dim + 1:])
                    b = np.take(b, range(start, start + a.shape[dim]),
                                axis=dim)
                assert np.array_equal(a, b), (kernels, s, kind, part)


# ------------------------------------------------- support and the CLI --


@pytest.mark.parametrize("backbone, remat, ape, frozen", [
    ("swin_s", False, False, -1), ("swin_b", True, True, 2),
    ("swin_s", True, False, 3)])
def test_swin_runs_under_2d(backbone, remat, ape, frozen):
    """swin_s and swin_b with FRM/FFM, the MLPDecoder and the cross-entropy
    pass spatial_support, with remat, ape and frozen stages."""
    cfg = step_cfg()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, backbone=backbone, remat=remat, swin_ape=ape,
        swin_frozen_stages=frozen))
    builder.spatial_support(cfg)


def _registered(fn, world, *args):
    register_narrow()
    return fn(world, *args)


def test_train_cli_2d_matches_dp1(tmp_path, monkeypatch, narrow):
    """train_cli --mesh 2d:1,2 --device cpu -d 0,1 on the narrow Swin at
    128x64 against --mesh dp:1 on the same synthetic set, one epoch of two
    steps at drop rates 0: the epoch loss within 1e-5 relative, and the
    checkpoint rank 0 wrote within 1e-5."""
    from rgbx_semantic_segmentation_tpu_torch import train_cli
    from rgbx_semantic_segmentation_tpu_torch.checkpoint import (
        CheckpointManager)
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)

    data = str(tmp_path / "data")
    ds = make_synthetic_dataset(data, num_train=4, num_val=2, hw=SW_HW,
                                num_classes=5, seed=3)
    base = tconfig.mfnet_config()
    cfg = base.replace(
        dataset=ds,
        model=tconfig.ModelConfig(backbone="swin_narrow0",
                                  decoder_embed_dim=32,
                                  use_mixed_precision=False,
                                  drop_path_rate=0.0,
                                  decoder_dropout_ratio=0.0),
        train=dataclasses.replace(base.train, batch_size=2, num_workers=2))
    monkeypatch.setattr(tconfig, "get_config", lambda name: cfg)
    run = launch.run
    monkeypatch.setattr(launch, "run", lambda fn, *a, **k: run(
        functools.partial(_registered, fn), *a, **k))
    argv = ["--dataset_root", data, "--epochs", "1", "--niters", "2",
            "--device", "cpu"]
    records = {}
    for name, extra in (("dp1", ["--mesh", "dp:1"]),
                        ("2d", ["--mesh", "2d:1,2", "-d", "0,1"])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        records[name] = train_cli.main(argv + extra)
    assert records["2d"][0]["loss"] == pytest.approx(
        records["dp1"][0]["loss"], rel=1e-5)
    ckpt = {name: CheckpointManager(str(tmp_path / name / "logs" / cfg.tag()
                                        / "checkpoint")).load(1)["model"]
            for name in records}
    for k, v in ckpt["dp1"].items():
        assert torch.allclose(ckpt["2d"][k].float(), v.float(), atol=1e-5,
                              rtol=0), k
