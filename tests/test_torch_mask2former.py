"""The Mask2Former head (its pixel decoder, attention, decoder layer and the
head itself), its semantic inference, and whole mit_b0 models with the
Mask2Former and MLPDecoder++ heads, against the JAX package on the CPU in
fp32: eval outputs, one train step's loss and gradients, Trainer.step
against the JAX make_train_step, and the evaluator.

Weights: numpy from a seed on the JAX variable tree (test_torch_layers.
random_variables), carried over with flax_to_torch_state_dict; inputs numpy
from a seed. The JAX decoder layers hard-code dropout 0.1: where the two
packages are compared in train mode, flax's Dropout is the identity
(monkeypatched here, no JAX file changed) and the port's dropouts have rate
0. Each tolerance is stated at its test.
"""
import copy

import flax.linen
import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import train as jtrain
from rgbx_semantic_segmentation_tpu.config import (
    DatasetConfig, EvalConfig, ModelConfig, TrainConfig, mfnet_config)
from rgbx_semantic_segmentation_tpu.data.dataset import RGBXDataset
from rgbx_semantic_segmentation_tpu.data.synthetic import make_synthetic_dataset
from rgbx_semantic_segmentation_tpu.evaluator import SegEvaluator as JaxEvaluator
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu.models.decoders import mask2former as jm2f
from rgbx_semantic_segmentation_tpu_torch import train as ttrain
from rgbx_semantic_segmentation_tpu_torch.convert import (
    flax_params_to_torch, flax_to_torch_state_dict)
from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
from rgbx_semantic_segmentation_tpu_torch.models import builder as tbuilder
from rgbx_semantic_segmentation_tpu_torch.models.decoders import (
    mask2former as tm2f)
from rgbx_semantic_segmentation_tpu_torch.ops import layers as tlayers
from tests.test_torch_heads import _NoDropout, _cfg, _feats, _pair
from tests.test_torch_layers import nchw, nhwc, random_variables

torch.set_num_threads(2)

CHANNELS = (32, 64, 160, 256)                  # mit_tiny / mit_b0
NUM_CLASSES = 5


def _tokens(seed, n, batch=2, dim=tm2f.HIDDEN):
    return np.random.RandomState(seed).randn(batch, n, dim).astype(np.float32)


def _no_dropout(model):
    """`model` with every port dropout at rate 0 (in place)."""
    for m in model.modules():
        if isinstance(m, tlayers._Stochastic):
            m.rate = 0.0
    return model


# ------------------------------------------------------- each module alone --

MODULES = {
    # name: (JAX module, port module, inputs as JAX takes them, as the
    # port takes them)
    "PixelDecoder": lambda: (
        jm2f.PixelDecoder(CHANNELS), tm2f.PixelDecoder(CHANNELS),
        (_feats(),), ([nchw(f) for f in _feats()],)),
    "MHA_self": lambda: (
        jm2f._MHA(), tm2f.MHA(), (_tokens(1, 7),) * 3,
        (torch.from_numpy(_tokens(1, 7)),) * 3),
    "MHA_cross": lambda: (
        jm2f._MHA(), tm2f.MHA(), (_tokens(2, 7), _tokens(3, 6), _tokens(3, 6)),
        tuple(torch.from_numpy(t) for t in
              (_tokens(2, 7), _tokens(3, 6), _tokens(3, 6)))),
    "TransformerDecoderLayer": lambda: (
        jm2f.TransformerDecoderLayer(), tm2f.TransformerDecoderLayer(),
        (_tokens(4, 7), _tokens(5, 6)),
        (torch.from_numpy(_tokens(4, 7)), torch.from_numpy(_tokens(5, 6)))),
    "Mask2Former": lambda: (
        jm2f.Mask2Former(CHANNELS, NUM_CLASSES, num_queries=6,
                         num_decoder_layers=2),
        tm2f.Mask2Former(CHANNELS, NUM_CLASSES, num_queries=6,
                         num_decoder_layers=2),
        (_feats(),), ([nchw(f) for f in _feats()],)),
}


def _outputs(out, port):
    """A module's outputs as a flat list of NHWC-or-token numpy arrays."""
    if isinstance(out, dict):
        return [np.asarray(out[k].detach() if port else out[k])
                for k in ("pred_logits", "pred_masks")]
    if isinstance(out, tuple):
        return [nhwc(o) if port else np.asarray(o) for o in out]
    return [out.detach().numpy() if port else np.asarray(out)]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    """Eval-mode forward of each module alone: 1e-5 of each output's
    largest magnitude. The Mask2Former head at 2 layers and 6 queries; its
    masks (B, Q, H, W) and logits come out fp32 on both sides."""
    jmod, tmod, jx, tx = MODULES[name]()
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), *jx),
                           seed=3)
    ref = _outputs(jmod.apply(var, *jx), port=False)
    res = tmod.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    with torch.no_grad():
        got = _outputs(tmod.eval()(*tx), port=True)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0)


def test_layer_norms_take_flax_eps():
    """The decoder's LayerNorms run at flax's default eps 1e-6 (torch's
    default is 1e-5), its BatchNorms at 1e-5 whatever the config says."""
    head = tm2f.Mask2Former(CHANNELS, NUM_CLASSES, num_decoder_layers=2)
    norms = [m for m in head.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2 * 3 + 1 and {m.eps for m in norms} == {1e-6}
    bns = [m for m in head.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 5 and {m.eps for m in bns} == {1e-5}
    with torch.device("meta"):
        model = tbuilder.EncoderDecoder(_cfg("mit_b0", "mask2former"))
    assert len(model.decode_head.layers) == 9
    assert {m.eps for m in model.decode_head.modules()
            if isinstance(m, torch.nn.BatchNorm2d)} == {1e-5}


def test_init_of_bare_parameters():
    """init_weights: the queries normal(0.02) (JAX nn.initializers.normal),
    the mask temperature 20."""
    cfg = _cfg("mit_tiny", "mask2former")
    model = tbuilder.build_model(cfg, device="cpu", seed=0)
    head = model.decode_head
    assert head.scale.shape == (1,) and float(head.scale.detach()) == 20.0
    q = head.query_embed.detach()
    assert q.shape == (100, tm2f.HIDDEN)
    assert abs(float(q.std()) - 0.02) < 0.001 and abs(float(q.mean())) < 0.001
    other = tbuilder.build_model(cfg, device="cpu", seed=1).decode_head
    assert not torch.equal(other.query_embed, head.query_embed)


@pytest.mark.parametrize("seed", [0, 1])
def test_semantic_inference_matches_jax(seed):
    """log(sum_q softmax(logits)[..., :-1] * sigmoid(masks) + 1e-8) in NHWC:
    1e-6 of the largest magnitude, with saturated mask logits (|x| up to
    30) among them."""
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(2, 7, NUM_CLASSES + 1)).astype(np.float32)
    masks = (10 * rng.randn(2, 7, 6, 5)).astype(np.float32)
    masks[0, :, 0, 0] = -30.0
    ref = np.asarray(jm2f.semantic_inference(logits, masks))
    got = tm2f.semantic_inference(torch.from_numpy(logits),
                                  torch.from_numpy(masks)).numpy()
    assert got.shape == ref.shape == (2, 6, 5, NUM_CLASSES)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(),
                               rtol=0)


def test_converter_keeps_a_bare_scale():
    """A flax `scale` beside a `bias` is a norm's and becomes `weight`; the
    Mask2Former temperature `decode_head/scale` stays `scale`, and the
    queries pass as they are."""
    tree = {"params": {"decode_head": {
        "scale": np.full((1,), 20.0, np.float32),
        "query_embed": np.zeros((3, 4), np.float32),
        "decoder_norm": {"scale": np.ones(4, np.float32),
                         "bias": np.zeros(4, np.float32)}}}}
    assert set(flax_to_torch_state_dict(tree)) == {
        "decode_head.scale", "decode_head.query_embed",
        "decode_head.decoder_norm.weight", "decode_head.decoder_norm.bias"}


# ----------------------------------------------------------- whole models --
# The checks below take the decoder's name: tests/test_torch_mlp_decoderpp.py
# runs them on MLPDecoder++ (each file on its own xdist worker).


def whole_model(decoder):
    """(cfg, JAX model, its variables, the port's model loaded from them,
    rgb, modal_x) of mit_b0 with `decoder` at 64x80, batch 2."""
    cfg = _cfg("mit_b0", decoder, drop_path_rate=0.0)
    rgb, mx = _pair(1)
    jmod = JaxEncoderDecoder(cfg=cfg)
    var = random_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), rgb, mx), seed=5)
    model = tbuilder.build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    return cfg, jmod, var, model, rgb, mx


def check_model_eval(case):
    """Eval-mode output of the whole model (mask2former: the resized
    log-scores of its semantic inference): atol 2e-4 x max(1, the
    output's largest magnitude)."""
    cfg, jmod, var, model, rgb, mx = case
    ref = np.asarray(jax.jit(lambda v, a, b: jmod.apply(v, a, b, False))(
        var, rgb, mx))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(rgb), torch.from_numpy(mx))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == ref.shape == (2, 64, 80, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-4 * max(1.0, np.abs(ref).max()))


def check_train_step(case, monkeypatch):
    """One train-mode step of the whole model in fp32, dropouts off on both
    sides: the loss (mask2former: its own loss on the dict, whose masks
    come resized to the input, fp32) at rtol 1e-5; every gradient within
    1e-5 + 2e-3 of its tensor's largest. fp32 holds here (measured: the
    worst tensor at 0.11 of that bound, Mask2Former's temperature; 0.004
    for MLPDecoder++), so no float64 run is needed, unlike
    tests/test_torch_heads.py's UPerNet. Returns the port's output."""
    cfg, jmod, var, model, rgb, mx = case
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    rng = np.random.RandomState(2)
    label = rng.randint(0, NUM_CLASSES, (2, 64, 80))
    label[rng.rand(2, 64, 80) < 0.05] = 255
    loss_fn = jtrain.make_loss_fn(cfg)

    def jloss(params):
        out, _ = jmod.apply({"params": params,
                             "batch_stats": var["batch_stats"]},
                            rgb, mx, True, mutable=["batch_stats"])
        return loss_fn(out, label)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(var["params"])
    model = _no_dropout(copy.deepcopy(model).train())
    out = model(torch.from_numpy(rgb), torch.from_numpy(mx))
    loss = ttrain.make_loss_fn(cfg)(out, torch.from_numpy(label))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = {k: np.asarray(v) for k, v in flax_params_to_torch(ref_grads).items()}
    grads = dict(model.named_parameters())
    assert set(ref) == set(grads)
    for k, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[k], rtol=0,
                                   atol=1e-5 + 2e-3 * np.abs(ref[k]).max(),
                                   err_msg=k)
    return out


def check_trainer_steps(decoder, monkeypatch):
    """3 steps of Trainer.step against the jitted JAX make_train_step from
    the same weights, tests/test_torch_train.py's geometry (mit_tiny,
    32x32, batch 4) without warm-up, dropouts off: losses rtol 1e-3 (that
    file's trajectory bound); every parameter within the 2 * lr * steps
    AdamW can move it, and the parameters moved."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    cfg = mfnet_config().replace(
        dataset=DatasetConfig(num_classes=NUM_CLASSES, image_height=32,
                              image_width=32, class_names=tuple("abcde")),
        model=ModelConfig(backbone="mit_tiny", decoder=decoder,
                          decoder_embed_dim=64, use_mixed_precision=False,
                          drop_path_rate=0.0, decoder_dropout_ratio=0.0),
        train=TrainConfig(batch_size=4, nepochs=2, niters_per_epoch=4,
                          warm_up_epoch=0, lr=1e-3))
    rng = np.random.RandomState(1)
    label = rng.randint(0, NUM_CLASSES, (4, 32, 32))
    label[rng.rand(4, 32, 32) < 0.05] = 255
    batch = {"rgb": rng.randn(4, 32, 32, 3).astype(np.float32),
             "modal_x": rng.randn(4, 32, 32, 3).astype(np.float32),
             "label": label.astype(np.int32)}
    var = random_variables(lambda: JaxEncoderDecoder(cfg=cfg).init(
        jax.random.PRNGKey(0), batch["rgb"][:1], batch["modal_x"][:1]),
        seed=9)
    # The structure-only state (its AdamW moments are zeros either way),
    # then the weights.
    state = jtrain.create_eval_state(cfg).replace(
        params=var["params"], batch_stats=var["batch_stats"])
    jstep = jtrain.make_train_step(cfg)
    trainer = ttrain.Trainer(cfg, device="cpu", seed=0, init_values=False)
    start = flax_to_torch_state_dict(var)
    trainer.model.load_state_dict(start, strict=True)
    _no_dropout(trainer.model)
    steps = 3
    jl = []
    for _ in range(steps):
        state, metrics = jstep(state, batch)
        jl.append(float(metrics["loss"]))
    tl = [float(trainer.step(batch)["loss"]) for _ in range(steps)]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    end = flax_to_torch_state_dict({"params": jax.device_get(state.params)})
    sd = trainer.model.state_dict()
    lr = cfg.train.lr
    for k, want in end.items():
        assert (sd[k] - want).abs().max().item() <= 2 * lr * steps, k
    assert max((sd[k] - start[k]).abs().max().item() for k in end) > lr


def check_evaluate(decoder, root):
    """SegEvaluator.evaluate (whole-image batched path, the exp-and-sum of
    the model's scores; mask2former's are log-probabilities) against the
    JAX evaluator with the same weights on 4 synthetic 64x64 items:
    pixel predictions agree > 0.999, mIoU and pixel accuracy within 0.5
    points (tests/test_torch_eval.py's bounds)."""
    ds = make_synthetic_dataset(str(root), num_train=1, num_val=4,
                                hw=(64, 64), num_classes=NUM_CLASSES, seed=5)
    cfg = mfnet_config().replace(
        dataset=ds,
        model=ModelConfig(backbone="mit_tiny", decoder=decoder,
                          decoder_embed_dim=64, use_mixed_precision=False),
        eval=EvalConfig(eval_scale_array=(1.0,), eval_flip=False,
                        eval_crop_size=(64, 64)))
    dataset = RGBXDataset(ds, "val")
    jmod = JaxEncoderDecoder(cfg=cfg)
    x = np.zeros((1, 64, 64, 3), np.float32)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, x),
                           seed=7)
    jev = JaxEvaluator(cfg, lambda v, r, m, train: jmod.apply(v, r, m, train))
    model = tbuilder.build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    tev = SegEvaluator(cfg, model, device="cpu")
    jscores, _ = jev.evaluate(var, dataset, eval_batch=4)
    tscores, line = tev.evaluate(dataset, eval_batch=4)
    assert "mean_IoU" in line
    assert abs(tscores.mean_iou - jscores.mean_iou) * 100 < 0.5
    assert abs(tscores.pixel_acc - jscores.pixel_acc) * 100 < 0.5
    group = [dataset[j] for j in range(4)]
    jp = np.stack(jev._batched_whole_image(var, group))
    tp = tev._batched_whole_image(group).numpy()
    assert (jp == tp).mean() > 0.999


@pytest.fixture(scope="module")
def mask2former_case():
    return whole_model("mask2former")


def test_model_matches_jax(mask2former_case):
    check_model_eval(mask2former_case)


def test_train_step_matches_jax(mask2former_case, monkeypatch):
    out = check_train_step(mask2former_case, monkeypatch)
    assert isinstance(out, dict)
    assert out["pred_masks"].shape == (2, 100, 64, 80)
    assert out["pred_logits"].shape == (2, 100, NUM_CLASSES + 1)
    assert {v.dtype for v in out.values()} == {torch.float32}


def test_trainer_steps_match_jax(monkeypatch):
    check_trainer_steps("mask2former", monkeypatch)


def test_evaluate_matches_jax(tmp_path):
    check_evaluate("mask2former", tmp_path)
