"""The port's runtime modules on the CPU: checkpoints (format, atomic write,
restore onto the trainer), the engine (cadence against the JAX
should_checkpoint, preemption save and re-raise, device choice, profiling),
the checkpoint loaders of convert.py against the JAX package's, and the
evaluator's output side (saved predictions, composites, epoch specs,
checkpoint sweeps).

Weights and inputs are numpy from a seed; where the two packages load the
same file, the JAX result is carried over with flax_to_torch_state_dict and
the tensors must be equal.
"""
import dataclasses
import logging
import os
import re
import signal
import types

import jax
import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import convert as jconvert
from rgbx_semantic_segmentation_tpu import engine as jengine
from rgbx_semantic_segmentation_tpu import evaluator as jevaluator
from rgbx_semantic_segmentation_tpu.config import (
    Config as JConfig, TrainConfig as JTrainConfig, mfnet_config as jmfnet)
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu_torch import checkpoint as tckpt
from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch import convert as tconvert
from rgbx_semantic_segmentation_tpu_torch import engine as tengine
from rgbx_semantic_segmentation_tpu_torch import evaluator as tevaluator
from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
    make_synthetic_dataset)
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.train import Trainer

torch.set_num_threads(2)


def tiny_cfg(log_dir="logs", **train_kw):
    kw = dict(batch_size=2, nepochs=3, niters_per_epoch=2, warm_up_epoch=0,
              lr=1e-3)
    kw.update(train_kw)
    return tconfig.mfnet_config().replace(
        dataset=tconfig.DatasetConfig(num_classes=5, image_height=32,
                                      image_width=32,
                                      class_names=tuple("abcde")),
        model=tconfig.ModelConfig(backbone="mit_tiny", decoder_embed_dim=32,
                                  use_mixed_precision=False),
        train=tconfig.TrainConfig(**kw), log_dir=str(log_dir))


def trained(cfg, steps=2, seed=0):
    tr = Trainer(cfg, device="cpu", seed=seed)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        tr.step({"rgb": rng.randint(0, 255, (2, 32, 32, 3)).astype(np.uint8),
                 "modal_x": rng.randint(0, 255, (2, 32, 32, 3)).astype(
                     np.uint8),
                 "label": rng.randint(0, 5, (2, 32, 32)).astype(np.uint8)})
    return tr


def assert_same_trainer(a, b):
    assert a.global_step == b.global_step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


# ----------------------------------------------------------- checkpoints --


def test_checkpoint_save_restore_resumes_at_next_epoch(tmp_path):
    cfg = tiny_cfg()
    tr = trained(cfg)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_epoch() is None and mgr.all_epochs() == []
    path = mgr.save(3, tr)
    assert os.path.basename(path) == "epoch-3.pth"
    last = tmp_path / "ck" / tckpt.LAST
    assert os.readlink(last) == "epoch-3.pth"
    payload = torch.load(str(last), weights_only=True)
    # the original repo's format (engine/engine.py:84-126)
    assert set(payload) == {"model", "optimizer", "epoch", "iteration"}
    assert (payload["epoch"], payload["iteration"]) == (3, 2)
    fresh = Trainer(cfg, device="cpu", init_values=False)
    assert mgr.restore(fresh) == 4
    assert_same_trainer(tr, fresh)
    for st in fresh.optimizer.state.values():
        assert st["step"].device.type == "cpu"
        assert st["step"].dtype == torch.float32 and st["step"].dim() == 0
    mgr.save(5, tr)
    assert mgr.all_epochs() == [3, 5] and mgr.latest_epoch() == 5
    assert os.readlink(last) == "epoch-5.pth"
    assert mgr.load(3)["epoch"] == 3
    # the same file through the reference-format loader
    sd = tconvert.load_torch_checkpoint(str(last))
    assert all(torch.equal(sd[k], v) for k, v in
               tr.model.state_dict().items())


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the previous epoch-last.pth
    readable, no torn epoch file and no temporary file."""
    tr = trained(tiny_cfg(), steps=1)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, tr)
    real_save = torch.save

    def dies_mid_write(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"PK\x03\x04 torn")
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.torch, "save", dies_mid_write)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, tr)
    monkeypatch.setattr(tckpt.torch, "save", real_save)
    assert sorted(os.listdir(tmp_path)) == ["epoch-1.pth", tckpt.LAST]
    assert mgr.latest_epoch() == 1
    assert torch.load(str(tmp_path / tckpt.LAST),
                      weights_only=True)["epoch"] == 1
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).load()


def test_resolve_checkpoint_spec_and_epoch_specs(tmp_path):
    tr = trained(tiny_cfg(), steps=0)
    d = str(tmp_path / "ck")
    mgr = tckpt.CheckpointManager(d)
    for e in (2, 5, 9):
        mgr.save(e, tr)
    for spec, want in (("last", [9]), ("5", [5]), ("3-9", [5, 9]),
                       ("5-", [5, 9]), ("", [9])):
        m, epochs = tckpt.resolve_checkpoint_spec(spec or "last", d)
        assert epochs == want and m.directory == d
    m, epochs = tckpt.resolve_checkpoint_spec(d, str(tmp_path / "other"))
    assert epochs == [9] and m.directory == d
    for bad in ("7", "10-"):
        with pytest.raises(SystemExit):
            tckpt.resolve_checkpoint_spec(bad, d)
    with pytest.raises(SystemExit):
        tckpt.resolve_checkpoint_spec("last", str(tmp_path / "missing"))
    os.makedirs(tmp_path / "none")
    with pytest.raises(SystemExit):
        tckpt.resolve_checkpoint_spec(str(tmp_path / "none"), d)


@pytest.mark.parametrize("form", ["epochs", "directory", "pth"])
def test_resolve_weights(tmp_path, form):
    """eval_cli's and predict_cli's `-e`: an epoch spec over the default
    <log_dir>/<tag>/checkpoint, a checkpoint directory, or a whole-model
    .pth (erf GELU forced); each load puts those weights into a model."""
    cfg = tiny_cfg(log_dir=tmp_path / "logs")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                gelu_approximate=True))
    mgr = tckpt.CheckpointManager(os.path.join(cfg.log_dir, cfg.tag(),
                                               "checkpoint"))
    saved = {}
    for e in (2, 5, 9):
        tr = trained(cfg, steps=0, seed=e)
        mgr.save(e, tr)
        saved[e] = tr.model.state_dict()
    spec, want = {"epochs": ("5-", ["epoch 5", "epoch 9"]),
                  "directory": (mgr.directory, ["epoch 9"]),
                  "pth": (mgr.path(2), ["epoch-2.pth"])}[form]
    out_cfg, targets = tckpt.resolve_weights(cfg, spec)
    assert [label for label, _ in targets] == want
    assert out_cfg.model.gelu_approximate == (form != "pth")
    for label, load in targets:
        model = build_model(cfg, device="cpu", seed=0)
        load(model)
        epoch = int(re.search(r"\d+", label).group())
        for k, v in saved[epoch].items():
            assert torch.equal(model.state_dict()[k], v), (label, k)


@pytest.mark.parametrize("available", [[], [3], [1, 5, 7, 300, 400],
                                       [400, 250, 300]])
def test_parse_epoch_spec_matches_jax(available):
    for spec in ("last", "", "300", "5", "250-400", "250-", "2-6", "0-"):
        assert (tevaluator.parse_epoch_spec(spec, available)
                == jevaluator.parse_epoch_spec(spec, available)), spec


# ---------------------------------------------------------------- engine --


@pytest.mark.parametrize("train_kw", [
    {}, dict(nepochs=200, checkpoint_start_epoch=150, checkpoint_step=25),
    dict(nepochs=500, checkpoint_start_epoch=1, checkpoint_step=7)])
def test_should_checkpoint_matches_jax(train_kw):
    jcfg = JConfig(train=JTrainConfig(**train_kw))
    tcfg = tconfig.Config(train=tconfig.TrainConfig(**train_kw))
    got = [tengine.should_checkpoint(tcfg, e) for e in range(1, 501)]
    assert got == [jengine.should_checkpoint(jcfg, e) for e in range(1, 501)]
    assert any(got)


def test_preemption_handler_saves_and_reraises(tmp_path, monkeypatch):
    """SIGTERM is only recorded by the handler; drain_preemption saves a
    checkpoint that restores at epoch + 1 and re-raises the signal with its
    default disposition (mirrors tests/test_utils_misc.py's JAX test). The
    previous handlers are back after the engine."""
    cfg = tiny_cfg(tmp_path)
    tr = trained(cfg, steps=1)
    before = signal.getsignal(signal.SIGTERM)
    raised = []
    monkeypatch.setattr(signal, "raise_signal", raised.append)
    with tengine.Engine(cfg, types.SimpleNamespace(device="cpu")) as engine:
        engine.install_preemption_handler()
        assert not engine.drain_preemption(1, tr)
        os.kill(os.getpid(), signal.SIGTERM)
        assert engine.preempted
        assert engine.drain_preemption(7, tr)
        assert raised == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
        assert not engine.preempted
        assert engine.checkpoints.latest_epoch() == 7
        fresh = Trainer(cfg, device="cpu", init_values=False)
        assert engine.restore_checkpoint(fresh) == 8
        assert_same_trainer(tr, fresh)
    assert signal.getsignal(signal.SIGTERM) == before
    assert os.path.isfile(os.path.join(
        str(tmp_path), cfg.tag(), "checkpoint", "epoch-7.pth"))


def test_engine_checkpoint_cadence(tmp_path):
    cfg = tiny_cfg(tmp_path, nepochs=4, checkpoint_start_epoch=2,
                   checkpoint_step=5)
    tr = trained(cfg, steps=0)
    with tengine.Engine(cfg, types.SimpleNamespace(device="cpu")) as engine:
        saved = [e for e in range(1, 5)
                 if engine.save_checkpoint_if_due(e, tr)]
    assert saved == [2, 4]
    assert engine.checkpoints.all_epochs() == [2, 4]


def test_engine_device_and_mesh():
    cfg = tiny_cfg()
    with pytest.raises(NotImplementedError, match="2-D"):
        tengine.Engine(cfg, types.SimpleNamespace(device="cpu", mesh="tp:2,4"))
    assert tengine.select_device("cpu", "") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tengine.Engine(cfg, types.SimpleNamespace(mesh="dp"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tengine.select_device("cuda", "0,1")


def test_engine_profile_and_device_busy(tmp_path):
    cfg = tiny_cfg(tmp_path)
    args = types.SimpleNamespace(device="cpu", profile_dir=str(tmp_path / "p"))
    with tengine.Engine(cfg, args) as engine:
        with engine.profile("train"):
            with engine.step_trace("train", 3):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "p" / "train.json") > 0
    prof = engine.last_profile
    assert prof["wall_ms"] > 0 and prof["device_busy_ms"] is None
    cuda = torch.autograd.DeviceType.CUDA

    def ev(start, end, name="k", device=cuda):
        return types.SimpleNamespace(
            time_range=types.SimpleNamespace(start=start, end=end),
            device_type=device, name=name, is_user_annotation=False)

    fake = types.SimpleNamespace(events=lambda: [
        ev(0, 1000), ev(500, 2000), ev(3000, 3500),
        ev(0, 9000, "Optimizer.step#AdamW.step"),
        ev(0, 9000, device=torch.autograd.DeviceType.CPU)])
    assert tengine.device_busy_ms(fake) == pytest.approx(2.5)


# --------------------------------------------------------------- convert --


def _single_tower_dict(seed=0):
    rng = np.random.RandomState(seed)
    keys = ["patch_embed1.proj.weight", "block1.0.attn.q.weight",
            "block2.1.mlp.fc1.bias", "norm1.weight", "norm4.bias",
            "head.weight", "layers.0.downsample.reduction.weight",
            "layers.1.blocks.0.attn.qkv.weight", "absolute_pos_embed",
            "stem.0.weight", "stages.1.conv.weight", "downsample.2.weight",
            "conv1.weight", "fc.weight", "layer1.0.bn1.running_mean",
            "backbone.layer2.0.conv2.weight"]
    return {k: rng.randn(3, 2).astype(np.float32) for k in keys}


@pytest.mark.parametrize("family", ["mit", "swin", "resnet", "segnext"])
def test_duplicators_match_jax(family):
    sd = _single_tower_dict()
    want = jconvert._DUPLICATORS[family](sd)
    got = tconvert._DUPLICATORS[family](sd)
    assert list(got) == list(want)
    assert all(got[k] is want[k] for k in want)
    assert len(got) > len(sd) - 2
    for name in ("mit_b2", "mit_b2pp", "swin_s", "resnet50", "segnext_b",
                 "mit_b0_w_aspp"):
        assert (tconvert.family_for_backbone(name)
                == jconvert.family_for_backbone(name))


@pytest.fixture(scope="module")
def jax_tiny(tmp_path_factory):
    """A JAX mit_tiny EncoderDecoder's variables (numpy, from a seed), the
    port model holding the same, and a single-tower .pth of other weights
    (the port backbone's first-tower keys and a classifier head, under
    "state_dict")."""
    from tests.test_torch_layers import random_variables

    tcfg = tiny_cfg()
    jcfg = jmfnet().replace(model=dataclasses.replace(
        jmfnet().model, **dataclasses.asdict(tcfg.model)),
        dataset=dataclasses.replace(jmfnet().dataset,
                                    **dataclasses.asdict(tcfg.dataset)))
    jmod = JaxEncoderDecoder(cfg=jcfg)
    x = np.zeros((1, 32, 32, 3), np.float32)
    var = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, x),
                           seed=3)
    other = build_model(tcfg, device="cpu", seed=9).backbone.state_dict()
    single = {k: v for k, v in other.items()
              if not k.startswith(("extra_", "FRMs", "FFMs"))}
    single["head.weight"] = torch.randn(1000, 256)
    path = tmp_path_factory.mktemp("pretrained") / "mit_tiny.pth"
    torch.save({"state_dict": single}, str(path))
    return tcfg, var, str(path), other


def test_load_dualpath_pretrained_matches_jax(jax_tiny):
    """Both ways from the same start: the JAX loader on the flax variables,
    carried across, equals the port loader on the port model, tensor for
    tensor; both towers hold the file's weights, the FRMs/FFMs stay at
    init."""
    tcfg, var, path, other = jax_tiny
    jloaded = jconvert.load_dualpath_pretrained(path, var, family="mit")
    want = tconvert.flax_to_torch_state_dict(jax.device_get(jloaded))
    model = build_model(tcfg, device="cpu", seed=None)
    model.load_state_dict(tconvert.flax_to_torch_state_dict(var), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    log = []
    missing, unexpected = tconvert.load_dualpath_pretrained(
        path, model, family="mit",
        logger=types.SimpleNamespace(info=lambda *a: log.append(a)))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert unexpected == ["head.weight"] and log
    assert missing and all(k.startswith(("FRMs", "FFMs")) for k in missing)
    for k in ("patch_embed1.proj.weight", "block1.0.attn.q.weight",
              "norm2.weight"):
        assert torch.equal(got["backbone." + k], other[k])
        assert torch.equal(got["backbone.extra_" + k], other[k])
    frm = "backbone.FRMs.0.channel_weights.mlp.0.weight"
    assert torch.equal(got[frm], start[frm])


def test_load_full_model_checkpoint(jax_tiny, tmp_path):
    tcfg, var, _, _ = jax_tiny
    src = build_model(tcfg, device="cpu", seed=4)
    sd = {"module." + k: v for k, v in src.state_dict().items()}
    torch.save({"model": sd, "epoch": 3, "iteration": 6},
               str(tmp_path / "full.pth"))
    model = build_model(tcfg, device="cpu", seed=0)
    tconvert.load_full_model_checkpoint(str(tmp_path / "full.pth"), model)
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    partial = dict(list(src.state_dict().items())[:-12])
    torch.save(partial, str(tmp_path / "partial.pth"))
    with pytest.raises(KeyError, match="12 model tensors missing"):
        tconvert.load_full_model_checkpoint(str(tmp_path / "partial.pth"),
                                            model)


# -------------------------------------------------------- evaluator output --


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_out"))
    ds = make_synthetic_dataset(os.path.join(root, "data"), num_train=1,
                                num_val=5, hw=(32, 32), num_classes=5, seed=6)
    cfg = tiny_cfg().replace(dataset=ds, eval=tconfig.EvalConfig(
        eval_scale_array=(1.0,), eval_crop_size=(32, 32)))
    model = build_model(cfg, device="cpu", seed=2)
    return root, cfg, model, RGBXDataset(ds, "val")


def test_evaluate_saves_predictions_and_composites(eval_setup, caplog):
    """evaluate(save_path, show_image_dir, verbose): raw PNGs hold the
    argmax maps, palettised and composite PNGs are byte-equal to the JAX
    evaluator's for the same maps; verbose logs each image; the hist is
    the same with or without the output side."""
    from PIL import Image

    root, cfg, model, dataset = eval_setup
    ev = tevaluator.SegEvaluator(cfg, model, device="cpu")
    plain, _ = ev.evaluate(dataset, eval_batch=2)
    hist = ev.last_hist.copy()
    out, show = os.path.join(root, "t_pred"), os.path.join(root, "t_show")
    logger = logging.getLogger("test_torch_runtime")
    with caplog.at_level(logging.INFO, logger="test_torch_runtime"):
        scores, _ = ev.evaluate(dataset, logger=logger, eval_batch=2,
                                save_path=out, show_image_dir=show,
                                verbose=True)
    np.testing.assert_array_equal(ev.last_hist, hist)
    assert hist.sum() > 0 and scores.mean_iou == plain.mean_iou
    assert sum("running mIoU" in r.getMessage() for r in caplog.records) == 5
    jev = jevaluator.SegEvaluator.__new__(jevaluator.SegEvaluator)
    jev.cfg = jmfnet().replace(dataset=dataclasses.replace(
        jmfnet().dataset, **dataclasses.asdict(cfg.dataset)))
    jout, jshow = os.path.join(root, "j_pred"), os.path.join(root, "j_show")
    for i in range(len(dataset)):
        item = dataset[i]
        want = ev.sliding_eval_rgbx(item["rgb"], item["modal_x"]).numpy()
        name = item["fn"] + ".png"
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(out, name))), want)
        jev._save_prediction(want, item["fn"], jout)
        jev._save_composite(want, item, jshow)
        for a, b in ((out, jout), (out + "_color", jout + "_color"),
                     (show, jshow)):
            with open(os.path.join(a, name), "rb") as fa, \
                    open(os.path.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), (a, name)


def test_evaluate_checkpoints(eval_setup, tmp_path):
    root, cfg, model, dataset = eval_setup
    tr = Trainer(cfg, device="cpu", seed=0)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, tr)
    tr.model.load_state_dict(model.state_dict())
    mgr.save(2, tr)
    log = str(tmp_path / "val.log")
    res = tevaluator.evaluate_checkpoints(cfg, dataset, [1, 2],
                                          str(tmp_path / "ck"), val_log=log,
                                          device="cpu")
    want, _ = tevaluator.SegEvaluator(cfg, model, device="cpu").evaluate(
        dataset)
    assert sorted(res) == [1, 2] and res[2].mean_iou == want.mean_iou
    np.testing.assert_array_equal(res[2].iou, want.iou)
    text = open(log).read()
    assert "epoch 1" in text and "epoch 2" in text and "mean_IoU" in text
