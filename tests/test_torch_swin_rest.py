"""The rest of the port's Swin (models/encoders/dual_swin.py) against the
JAX package on the CPU in fp32: the bicubic resize of the absolute
position embedding, a small dual Swin with `ape`, the frozen stages
(`frozen_stages` and optim.frozen_mask) through one forward, backward and
SGD step, the embedding's layout through the converter, and pretrained
single-tower loading.

The small Swin is tests/test_swin_flags.py's _TINY (embed 32, depths
(2, 2), heads (2, 4), window 7) with out_indices (0, 1) and
pretrain_img_size 64 (a 16x16 embedding grid), weights numpy from a seed
on the JAX tree (test_torch_layers.random_variables), carried over with
flax_to_torch_state_dict. Drop rates are 0 where the packages are compared
(their generators differ). Tolerances at each test.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import convert as jconvert
from rgbx_semantic_segmentation_tpu import optim as joptim
from rgbx_semantic_segmentation_tpu.models.encoders import dual_swin as jswin
from rgbx_semantic_segmentation_tpu.ops.resize import (
    resize_bicubic_torch as jresize)
from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch import convert as tconvert
from rgbx_semantic_segmentation_tpu_torch import optim as toptim
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_swin as tswin)
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from rgbx_semantic_segmentation_tpu_torch.ops.resize import (
    resize_bicubic_torch as tresize)
from tests.test_torch_ddp import ZERO_GRADIENT
from tests.test_torch_layers import nchw, nhwc, random_variables

torch.set_num_threads(2)
TINY = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), window_size=7,
            out_indices=(0, 1), pretrain_img_size=64)


@pytest.mark.parametrize("src,dst", [
    ((56, 56), (120, 160)), ((96, 96), (30, 40)), ((7, 9), (13, 5)),
    ((16, 16), (14, 14)), ((5, 11), (5, 11))])
def test_bicubic_resize_matches_jax(src, dst):
    """Up and down, odd sizes, and the identity: 1e-6 (+ 1e-6 relative) on
    values up to ~4.5 (the JAX matrix form in fp32 against the port's
    float64 resize rounded to fp32; read 9.5e-7 at most, 2 fp32 ulps)."""
    x = np.random.RandomState(0).randn(2, *src, 6).astype(np.float32)
    want = np.asarray(jresize(x, dst))
    got = tresize(nchw(x), dst)
    assert got.shape == (2, 6, *dst) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6, rtol=1e-6)


def _pair(fs=-1, ape=True, seed=0, hw=(56, 56), **kw):
    """(JAX module, its variables, the port module loaded from them,
    rgb, modal) of the small dual Swin (`kw` overrides TINY)."""
    rng = np.random.RandomState(seed)
    rgb = rng.randn(2, *hw, 3).astype(np.float32)
    mx = rng.randn(2, *hw, 3).astype(np.float32)
    arch = {**TINY, **kw}
    jmod = jswin.DualSwinTransformer(**arch, drop_path_rate=0.0, ape=ape,
                                     frozen_stages=fs)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), rgb, mx),
                           seed=seed)
    tmod = tswin.DualSwinTransformer(**arch, drop_path_rate=0.0, ape=ape,
                                     frozen_stages=fs)
    tmod.load_state_dict(tconvert.flax_to_torch_state_dict(var), strict=True)
    return jmod, var, tmod, rgb, mx


@pytest.mark.parametrize("hw", [(56, 56), (96, 78)])
def test_ape_forward_matches_jax(hw):
    """Eval-mode outputs with `ape` at token grids 14x14 (the 16x16
    embedding resized down) and 24x20 (up and down; the patch embed pads
    78 to 80): 2e-4 (fp32 through 8 blocks, as tests/test_torch_swin.py)."""
    jmod, var, tmod, rgb, mx = _pair(hw=hw)
    assert tmod.absolute_pos_embed.shape == (1, 32, 16, 16)
    ref = jmod.apply(var, rgb, mx)
    with torch.no_grad():
        got = tmod.eval()(nchw(rgb), nchw(mx))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=2e-4, rtol=0)
    # the embedding matters: without it the outputs move
    tmod.ape = False
    with torch.no_grad():
        off = tmod(nchw(rgb), nchw(mx))
    assert float((off[0] - got[0]).abs().max()) > 1e-2


def _swin_cfgs(fs):
    """A SGDM + PolyLR config of each package for optim.frozen_mask and
    build_optimizer (lr nonzero at step 0, weight decay on)."""
    out = []
    for lib in (jax_cfg_lib(), tconfig):
        cfg = lib.mfnet_config()
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, backbone="swin_s",
                                      swin_frozen_stages=fs, swin_ape=True),
            train=dataclasses.replace(cfg.train, optimizer="SGDM",
                                      lr_policy="PolyLR", lr=0.1,
                                      weight_decay=0.01)))
    return out


def jax_cfg_lib():
    from rgbx_semantic_segmentation_tpu import config as jconfig
    return jconfig


def _loss_weights(shapes, seed=9):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("fs", [0, 1, 2, 3])
def test_frozen_stages_train_step_matches_jax(fs):
    """One train-mode forward (rates 0) of the small dual Swin with one
    block a stage (each fs compiles the JAX gradient anew: 8 blocks took
    ~50 s a case), `ape` and frozen_stages fs, the loss sum(w_i * out_i),
    its gradient and one SGD step (lr 0.1, weight decay 0.01) in each
    package:

    - the port's frozen parameters are the JAX frozen_mask's leaves under
      the converter's names, require no gradient, get none and are
      bit-unchanged by the step;
    - every other gradient within 1e-5 + 2e-3 of its tensor's largest (the
      JAX gradient of a frozen leaf is exactly 0), of the model's largest
      for the biases whose true gradient is 0 (ZERO_GRADIENT: rounding
      noise);
    - the trainable parameters after the step within lr x that bound,
      plus 2e-7 (fp32 rounding of the step).
    A downsample that feeds only frozen stages (fs = 3: downsamples.0) gets
    no gradient; the Trainer gives such a parameter a zero one (JAX's), as
    here, and every_param_in_loss says so."""
    import optax

    jmod, var, tmod, rgb, mx = _pair(fs=fs, seed=fs, depths=(1, 1))
    jcfg, tcfg = _swin_cfgs(fs)
    outs = jax.eval_shape(lambda: jmod.apply(var, rgb, mx))
    ws = _loss_weights([o.shape for o in outs])

    def jloss(params):
        outs, _ = jmod.apply({"params": params["backbone"],
                              "batch_stats": var["batch_stats"]}, rgb, mx,
                             True, mutable=["batch_stats"])
        return sum(jax.numpy.sum(w * o) for w, o in zip(ws, outs))

    params = {"backbone": var["params"]}
    jgrads = jax.jit(jax.grad(jloss))(params)
    tx = joptim.build_optimizer(jcfg, params)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    model = torch.nn.ModuleDict({"backbone": tmod})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mask = joptim.frozen_mask(jcfg, params)
    want_frozen = {k: bool(v.all()) for k, v in tconvert.flax_params_to_torch(
        jax.tree_util.tree_map(lambda m, p: np.full(p.shape, bool(m)),
                               mask, params)).items()}
    frozen = toptim.frozen_mask(tcfg, model)
    assert frozen == want_frozen and any(frozen.values())
    opt = toptim.build_optimizer(tcfg, model)
    tmod.train()
    got = tmod(nchw(rgb), nchw(mx))
    loss = sum((torch.from_numpy(np.ascontiguousarray(
        w.transpose(0, 3, 1, 2))) * o).sum() for w, o in zip(ws, got))
    loss.backward()
    named = dict(model.named_parameters())
    dead = [n for n, p in named.items() if p.requires_grad and p.grad is None]
    assert bool(dead) == (fs >= 3) == (not tmod.every_param_in_loss)
    assert all(".downsamples" in n for n in dead)
    for p in named.values():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
    toptim.set_lr(opt, tcfg.train.lr)
    opt.step()
    ref_grads = tconvert.flax_params_to_torch(jgrads)
    ref_new = tconvert.flax_params_to_torch(jnew)
    top = max(float(np.abs(g.numpy()).max()) for g in ref_grads.values())
    after = model.state_dict()
    for n, p in named.items():
        if frozen[n]:
            assert not p.requires_grad and p.grad is None, n
            assert float(np.abs(ref_grads[n].numpy()).max()) == 0.0, n
            assert torch.equal(after[n], before[n]), n
            continue
        r = ref_grads[n].numpy()
        tol = 1e-5 + 2e-3 * (top if ZERO_GRADIENT.search(n)
                             else np.abs(r).max())
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=tol,
                                   err_msg=n)
        np.testing.assert_allclose(after[n].numpy(), ref_new[n].numpy(),
                                   rtol=0, atol=tcfg.train.lr * tol + 2e-7,
                                   err_msg=n)
        if np.abs(r).max() > 0:   # a gradient moves it (decay or not)
            assert not torch.equal(after[n], before[n]), n


def test_frozen_stage_ignores_the_seed():
    """With every drop rate above 0 (attention dropout 0.3 in the window
    attention's seed, DropPath 0.2, Dropout 0.1) and frozen_stages 2 in
    training, stage 0 runs in eval mode: its output (read by a hook) does
    not depend on the mask generator's seed, while stage 1's does; the
    frozen stage carries no autograd graph."""
    model = tswin.DualSwinTransformer(**TINY, ape=True, frozen_stages=2,
                                      attn_drop_rate=0.3, drop_path_rate=0.2,
                                      drop_rate=0.1, use_pallas=True)
    tlayers.init_weights(model, torch.Generator().manual_seed(0))
    gen = torch.Generator()
    tlayers.set_generator(model, gen)
    model.train()
    assert not model.layers[0].training and not model.pos_drop.training
    assert model.layers[1].training and model.FRMs[0].training
    seen = {}
    for i in (0, 1):
        model.layers[i].register_forward_hook(
            lambda m, a, out, i=i: seen.setdefault(i, []).append(out))
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 3, 56, 56).astype(np.float32))
    for seed in (1, 2):
        gen.manual_seed(seed)
        model(x, x)
    a, b = seen[0]   # the RGB tower's stage 0 under each seed
    assert torch.equal(a, b) and not a.requires_grad
    assert not torch.equal(*seen[1]) and seen[1][0].requires_grad


def test_ape_converter_round_trip():
    """A port Swin with `ape` through the JAX converter and back: the
    embedding is (1, C, h, w) here and (1, h, w, C) in flax, and every
    tensor comes back bit-equal."""
    model = tswin.DualSwinTransformer(**TINY, ape=True)
    tlayers.init_weights(model, torch.Generator().manual_seed(3))
    sd = model.state_dict()
    var = jconvert.torch_to_flax_variables(sd)
    assert var["params"]["absolute_pos_embed"].shape == (1, 16, 16, 32)
    np.testing.assert_array_equal(
        var["params"]["absolute_pos_embed_d"],
        sd["absolute_pos_embed_d"].numpy().transpose(0, 2, 3, 1))
    back = tconvert.flax_to_torch_state_dict(var)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    apes = [sd[k] for k in ("absolute_pos_embed", "absolute_pos_embed_d")]
    assert all(0.01 < float(a.std()) < 0.03 for a in apes)


def test_builder_passes_the_knobs_and_swin_b_grid():
    """The builder's swin_s / swin_b carry the embedding grids of their
    pretraining sizes (224 / 4 = 56, 384 / 4 = 96), the frozen stages and
    remat; every_param_in_loss follows the frozen stages."""
    cfg = tconfig.mfnet_config()
    for name, res in (("swin_s", 56), ("swin_b", 96)):
        for fs, remat in ((-1, False), (3, True)):
            c = cfg.replace(model=dataclasses.replace(
                cfg.model, backbone=name, swin_ape=True,
                swin_frozen_stages=fs, remat=remat))
            model = build_model(c, device="cpu", seed=None)
            bb = model.backbone
            assert bb.absolute_pos_embed.shape[2:] == (res, res)
            assert bb.frozen_stages == fs
            assert all(layer.remat == remat for layer in bb.layers)
            assert model.every_param_in_loss == (fs < 3)


def _single_tower(model):
    """A single-tower Swin checkpoint (the original's key space) from the
    first tower of a port dual Swin, plus keys no port module has."""
    sd = model.state_dict()
    out = {}
    for k, v in sd.items():
        if k.startswith(("patch_embed.", "layers.", "absolute_pos_embed")) \
                and not k.startswith("absolute_pos_embed_d"):
            out[k] = v.clone()
        elif k.startswith("downsamples."):
            i, rest = k[len("downsamples."):].split(".", 1)
            out[f"layers.{i}.downsample.{rest}"] = v.clone()
    out["norm.weight"] = torch.ones(64)
    out["head.weight"] = torch.randn(10, 64)
    out["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(
        49, 49, dtype=torch.long)
    return out


def test_load_dualpath_pretrained_swin_matches_jax(tmp_path):
    """A synthetic single-tower Swin .pth (with its APE) loaded into a built
    small dual Swin by both packages' load_dualpath_pretrained (family
    swin): the same tensors; both towers hold the file's weights, the APE
    included (the JAX package's fix of the original's duplicator, which
    drops it); the FRMs and FFMs stay at init."""
    jmod, var, tmod, _, _ = _pair(seed=4)
    src = tswin.DualSwinTransformer(**TINY, ape=True)
    tlayers.init_weights(src, torch.Generator().manual_seed(5))
    path = os.path.join(str(tmp_path), "swin_single.pth")
    torch.save({"model": _single_tower(src)}, path)

    init = {coll: {"backbone": tree} for coll, tree in var.items()}
    jloaded = jconvert.load_dualpath_pretrained(path, init, family="swin")
    want = tconvert.flax_to_torch_state_dict(jax.device_get(jloaded))
    model = torch.nn.ModuleDict({"backbone": tmod})
    start = {k: v.clone() for k, v in model.state_dict().items()}
    missing, unexpected = tconvert.load_dualpath_pretrained(
        path, model, family="swin")
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    ref = src.state_dict()
    for k in ("absolute_pos_embed", "layers.1.blocks.0.attn.qkv.weight",
              "downsamples.0.reduction.weight", "patch_embed.norm.bias"):
        dual = k.replace("layers.", "layers_d.").replace(
            "downsamples.", "downsamples_d.").replace(
            "patch_embed.", "patch_embed_d.").replace(
            "absolute_pos_embed", "absolute_pos_embed_d")
        assert torch.equal(got["backbone." + k], ref[k]), k
        assert torch.equal(got["backbone." + dual], ref[k]), dual
    assert all(k.startswith(("FRMs", "FFMs", "norm")) for k in missing)
    frm = "backbone.FRMs.0.channel_weights.mlp.0.weight"
    assert torch.equal(got[frm], start[frm])
    assert "head.weight" in unexpected


def test_train_cli_pretrained_takes_the_swin_family(tmp_path, monkeypatch):
    """train_cli --pretrained with a Swin backbone loads the file through
    the Swin duplicator into the built dual Swin (the loader itself is held
    to JAX above; here it stops the run once called)."""
    from rgbx_semantic_segmentation_tpu_torch import train_cli
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)
    from tests.test_torch_cli import cli_env, small_cfg

    class Loaded(Exception):
        pass

    seen = []

    def loader(path, model, family="mit", logger=None):
        seen.append((path, family, type(model.backbone).__name__))
        raise Loaded

    monkeypatch.setattr(tconvert, "load_dualpath_pretrained", loader)
    ds = make_synthetic_dataset(str(tmp_path / "data"), num_train=2,
                                num_val=1, hw=(32, 32), num_classes=5, seed=1)
    with cli_env(small_cfg(ds), tmp_path), pytest.raises(Loaded):
        train_cli.main(["--dataset_root", str(tmp_path / "data"),
                        "--backbone", "swin_s", "--pretrained", "w.pth",
                        "--epochs", "1", "--niters", "1", "--device", "cpu"])
    assert seen == [("w.pth", "swin", "DualSwinTransformer")]
