"""`remat` (activation checkpointing of every MiT Block and Swin block,
ops/layers.checkpointed) on the CPU.

- Gradients with remat on and off, with every drop rate above 0 (the MiT
  towers' Dropout, attention dropout and DropPath; the Swin towers'
  Dropout, DropPath and the window attention's kernel seed), the same
  weights and the same mask generator seed: equal to 1e-6 of each
  tensor's largest (read: bit-equal). The recompute must draw the masks of
  the first forward; torch.utils.checkpoint alone restores only torch's
  default generators, and the same comparison with it (the control) fails.
- The train-mode forward with remat against the JAX package's nn.remat
  modules (drop rates 0), fp32: 2e-4, as tests/test_torch_swin.py.
- One Trainer step with remat over 2 gloo ranks against one process
  without it.
"""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_segformer as tseg)
from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
    dual_swin as tswin)
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from rgbx_semantic_segmentation_tpu_torch.parallel import launch
from rgbx_semantic_segmentation_tpu_torch.parallel.multihost import (
    process_batch_slice)
from rgbx_semantic_segmentation_tpu_torch.train import Trainer
from tests.test_torch_ddp import ZERO_GRADIENT

torch.set_num_threads(2)
SWIN = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), window_size=7,
            out_indices=(0, 1))
RATES = {"mit": dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.2),
         "swin": dict(drop_rate=0.1, attn_drop_rate=0.3, drop_path_rate=0.2,
                      use_pallas=True)}


def _encoder(kind, remat, rates=True):
    if kind == "mit":
        m = tseg.mit_tiny(remat=remat, **(RATES["mit"] if rates else {}))
    else:
        m = tswin.DualSwinTransformer(
            **SWIN, remat=remat, **(RATES["swin"] if rates else {}))
    return tlayers.init_weights(m, torch.Generator().manual_seed(0))


def _grads(model, x, seed=7):
    """Train-mode forward from generator seed `seed`, the loss
    sum(w_i * out_i) with fixed w_i, backward: {name: gradient}."""
    gen = torch.Generator().manual_seed(seed)
    tlayers.set_generator(model, gen)
    model.train()
    model.zero_grad(set_to_none=True)
    outs = model(x, x)
    rng = np.random.RandomState(3)
    loss = sum((torch.from_numpy(rng.randn(*o.shape).astype(np.float32))
                * o).sum() for o in outs)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _x(kind):
    return torch.from_numpy(np.random.RandomState(1).randn(
        2, 3, 32 if kind == "mit" else 56, 32 if kind == "mit" else 56
    ).astype(np.float32))


def _assert_equal_grads(a, b):
    assert a.keys() == b.keys() and len(a) > 20
    for n in a:
        tol = 1e-6 * max(float(b[n].abs().max()), 1e-12)
        assert float((a[n] - b[n]).abs().max()) <= tol, n


@pytest.mark.parametrize("kind", ["mit", "swin"])
def test_remat_gradients_equal_with_dropout(kind):
    x = _x(kind)
    plain = _grads(_encoder(kind, False), x)
    remat = _grads(_encoder(kind, True), x)
    _assert_equal_grads(remat, plain)
    # another seed draws other masks: the rates are live
    other = _grads(_encoder(kind, False), x, seed=8)
    assert any(not torch.equal(other[n], plain[n]) for n in plain)


@pytest.mark.parametrize("kind", ["mit", "swin"])
def test_checkpoint_alone_draws_other_masks(kind, monkeypatch):
    """The control: blocks under torch.utils.checkpoint with nothing more
    recompute with the generator where the forward left it, and their
    gradients are wrong."""
    def naive(module, *args):
        return checkpoint(module, *args, use_reentrant=False)

    x = _x(kind)
    plain = _grads(_encoder(kind, False), x)
    monkeypatch.setattr(tseg, "checkpointed", naive)
    monkeypatch.setattr(tswin, "checkpointed", naive)
    wrong = _grads(_encoder(kind, True), x)
    assert any(float((wrong[n] - plain[n]).abs().max())
               > 1e-3 * float(plain[n].abs().max()) for n in plain)


def test_recompute_counts_the_forwards(monkeypatch):
    """With remat each block's forward runs twice in a train step (the
    recompute in the backward); in eval (or without autograd) once."""
    calls = []
    forward = tswin.SwinBlock.forward

    def counted(self, *args):
        calls.append(1)
        return forward(self, *args)

    monkeypatch.setattr(tswin.SwinBlock, "forward", counted)
    model = _encoder("swin", True)
    x = _x("swin")
    _grads(model, x)
    assert len(calls) == 2 * 8
    calls.clear()
    model.eval()
    with torch.no_grad():
        model(x, x)
    assert len(calls) == 8


@pytest.mark.parametrize("kind", ["mit", "swin"])
def test_remat_forward_and_gradients_match_jax(kind):
    """Train mode, drop rates 0, remat on in both packages (the JAX
    modules' nn.remat): the outputs within 2e-4 and every gradient within
    1e-5 + 2e-3 of its tensor's largest (of the model's largest for the
    biases whose true gradient is 0), fp32 through the blocks."""
    import jax

    from rgbx_semantic_segmentation_tpu.models.encoders import (
        dual_segformer as jseg)
    from rgbx_semantic_segmentation_tpu.models.encoders import (
        dual_swin as jswin)
    from rgbx_semantic_segmentation_tpu_torch.convert import (
        flax_params_to_torch, flax_to_torch_state_dict)
    from tests.test_torch_layers import nchw, nhwc, random_variables

    # 64x64: at 32x32 the stage-4 maps are 1x1 and train-mode BatchNorm
    # over their 2 values makes fp32 gradients ill-conditioned (the FFM's)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    if kind == "mit":
        jmod = jseg.mit_tiny(remat=True, drop_path_rate=0.0)
        tmod = tseg.mit_tiny(remat=True, drop_path_rate=0.0)
    else:
        jmod = jswin.DualSwinTransformer(**{**SWIN, "depths": (1, 1)},
                                         remat=True, drop_path_rate=0.0)
        tmod = tswin.DualSwinTransformer(**{**SWIN, "depths": (1, 1)},
                                         remat=True, drop_path_rate=0.0)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, x))
    tmod.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    shapes = jax.eval_shape(lambda: jmod.apply(var, x, x))
    rng = np.random.RandomState(4)
    ws = [rng.randn(*s.shape).astype(np.float32) for s in shapes]

    def jloss(params):
        outs, _ = jmod.apply({"params": params,
                              "batch_stats": var["batch_stats"]}, x, x, True,
                             mutable=["batch_stats"])
        return sum(jax.numpy.sum(w * o) for w, o in zip(ws, outs)), outs

    (_, jouts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        var["params"])
    tmod.train()
    outs = tmod(nchw(x), nchw(x))
    for o, r in zip(outs, jouts):
        np.testing.assert_allclose(nhwc(o), np.asarray(r), atol=2e-4, rtol=0)
    sum((torch.from_numpy(np.ascontiguousarray(w.transpose(0, 3, 1, 2)))
         * o).sum() for w, o in zip(ws, outs)).backward()
    ref = flax_params_to_torch(jgrads)
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    named = dict(tmod.named_parameters())
    assert set(ref) == set(named)
    for n, p in named.items():
        r = ref[n].numpy()
        scale = top if ZERO_GRADIENT.search(n) else np.abs(r).max()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-5 + 2e-3 * scale, err_msg=n)


def _cfg(remat):
    return tconfig.mfnet_config().replace(
        dataset=tconfig.DatasetConfig(num_classes=5, image_height=32,
                                      image_width=32,
                                      class_names=tuple("abcde")),
        model=tconfig.ModelConfig(
            backbone="mit_tiny", decoder="MLPDecoder", decoder_embed_dim=64,
            use_mixed_precision=False, drop_path_rate=0.0,
            decoder_dropout_ratio=0.0, remat=remat),
        train=tconfig.TrainConfig(batch_size=4, nepochs=2, niters_per_epoch=4,
                                  optimizer="SGDM", lr_policy="PolyLR",
                                  lr=1e-2))


def _batch():
    rng = np.random.RandomState(5)
    label = rng.randint(0, 5, size=(4, 32, 32))
    label[1][rng.rand(32, 32) < 0.3] = 255
    return {"rgb": rng.randn(4, 32, 32, 3).astype(np.float32),
            "modal_x": rng.randn(4, 32, 32, 3).astype(np.float32),
            "label": label.astype(np.int32)}


def _remat_rank(world, cfg, batch):
    torch.set_num_threads(1)
    trainer = Trainer(cfg, device="cpu", seed=0, world=world)
    rows = process_batch_slice(len(batch["label"]), world.rank, world.size)
    loss = float(trainer.step({k: v[rows] for k, v in batch.items()})["loss"])
    return {"loss": loss, "state": {k: v.numpy().copy() for k, v in
                                    trainer.model.state_dict().items()}}


def test_remat_step_over_two_gloo_ranks():
    """One SGDM step (drop rates 0) with remat over 2 gloo ranks, each half
    of the batch, against one process without remat on the whole batch:
    the loss within 1e-5 relative, each parameter within 1e-4 of the
    distance it moved (of the model's largest for ZERO_GRADIENT) plus 2
    fp32 ulps, the running statistics within 1e-5."""
    batch = _batch()
    r0, _ = launch.spawn(_remat_rank, [0, 1], "cpu", (_cfg(True), batch),
                         timeout=120)
    one = Trainer(_cfg(False), device="cpu", seed=0)
    start = {k: v.clone() for k, v in one.model.state_dict().items()}
    loss = float(one.step(batch)["loss"])
    assert r0["loss"] == pytest.approx(loss, rel=1e-5)
    want = one.model.state_dict()
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    top = max(float((want[k] - start[k]).abs().max()) for k in keys)
    assert top > 1e-4
    for k in keys:
        w = want[k]
        moved = (top if ZERO_GRADIENT.search(k)
                 else float((w - start[k]).abs().max()))
        tol = 1e-5 if k.endswith(("running_mean", "running_var")) else (
            1e-4 * moved + 2.4e-7 * float(w.abs().max()))
        np.testing.assert_allclose(r0["state"][k], w.numpy(), rtol=0,
                                   atol=tol, err_msg=k)
