"""The port's own copies of the host-side modules against the JAX package's:
`config` field by field (so the copies cannot drift unnoticed), the numpy
`cv_ops` functions, `RGBXDataset`, the public names of the copied runtime
modules (their behaviour: tests/test_torch_data.py, test_torch_runtime.py)
and the device default of the entry points."""
import dataclasses
import importlib
import inspect
import types

import numpy as np
import pytest
import torch

from rgbx_semantic_segmentation_tpu import config as jconfig
from rgbx_semantic_segmentation_tpu.data import cv_ops as jcv
from rgbx_semantic_segmentation_tpu.data import dataset as jdataset
from rgbx_semantic_segmentation_tpu.data.synthetic import make_synthetic_dataset
from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch.data import cv_ops as tcv
from rgbx_semantic_segmentation_tpu_torch.data import dataset as tdataset
from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
from rgbx_semantic_segmentation_tpu_torch.models.builder import build_model
from rgbx_semantic_segmentation_tpu_torch.train import Trainer

CLASSES = ["DatasetConfig", "ModelConfig", "TrainConfig", "EvalConfig",
           "Config"]


def _same(a, b, path=""):
    """Field-by-field equality of two dataclass instances of different
    classes (recursing into nested configs)."""
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)], path
    for name in fa:
        x, y = getattr(a, name), getattr(b, name)
        if dataclasses.is_dataclass(x):
            _same(x, y, f"{path}{name}.")
        else:
            assert x == y, f"{path}{name}: {x!r} != {y!r}"


@pytest.mark.parametrize("cls", CLASSES)
def test_dataclass_fields_and_defaults_match(cls):
    jc, tc = getattr(jconfig, cls), getattr(tconfig, cls)
    jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
    assert [(f.name, f.type) for f in jf] == [(f.name, f.type) for f in tf]
    _same(jc(), tc())


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_presets_match(preset):
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    j, t = jconfig.get_config(preset), tconfig.get_config(preset)
    _same(j, t)
    assert j.tag() == t.tag()
    assert (j.train.total_iters, j.train.warmup_iters) == (
        t.train.total_iters, t.train.warmup_iters)
    assert (j.num_classes, j.background) == (t.num_classes, t.background)


def test_mfnet_config_and_overrides():
    _same(jconfig.mfnet_config(), tconfig.mfnet_config())
    _same(jconfig.mfnet_config(log_dir="x"), tconfig.mfnet_config(log_dir="x"))
    assert (tconfig.IMAGENET_MEAN, tconfig.IMAGENET_STD) == (
        jconfig.IMAGENET_MEAN, jconfig.IMAGENET_STD)
    with pytest.raises(KeyError):
        tconfig.get_config("nope")


def test_torch_dtype_follows_compute_dtype():
    import jax.numpy as jnp

    for mixed, want, jwant in ((True, torch.bfloat16, jnp.bfloat16),
                               (False, torch.float32, jnp.float32)):
        assert tconfig.torch_dtype(
            tconfig.ModelConfig(use_mixed_precision=mixed)) == want
        assert jconfig.ModelConfig(
            use_mixed_precision=mixed).compute_dtype == jwant


def test_cv_ops_match():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    mean, std = jconfig.IMAGENET_MEAN, jconfig.IMAGENET_STD
    # the JAX package may run its native library here: 1 fp32 ulp of an
    # O(1) value (it multiplies by 1/std)
    np.testing.assert_allclose(tcv.normalize(img, mean, std),
                               jcv.normalize(img, mean, std), atol=5e-7)
    for arr in (img, img[:, :, 0]):
        for shape in ((20, 24), (13, 17), (8, 30)):
            t, tm = tcv.pad_to_shape(arr, shape, value=7)
            j, jm = jcv.pad_to_shape(arr, shape, value=7)
            np.testing.assert_array_equal(t, j)
            np.testing.assert_array_equal(tm, jm)


def test_dataset_matches(tmp_path):
    ds_cfg = make_synthetic_dataset(str(tmp_path), num_train=3, num_val=2,
                                    hw=(16, 24), num_classes=9, seed=1)
    tcfg = tconfig.DatasetConfig(**dataclasses.asdict(ds_cfg))
    for split in ("train", "val"):
        j = jdataset.RGBXDataset(ds_cfg, split, file_length=5)
        t = tdataset.RGBXDataset(tcfg, split, file_length=5)
        j.set_epoch(2)
        t.set_epoch(2)
        assert len(j) == len(t) == 5
        for i in range(5):
            a, b = j[i], t[i]
            assert a["fn"] == b["fn"] and a["n"] == b["n"]
            for key in ("rgb", "modal_x", "label"):
                np.testing.assert_array_equal(a[key], b[key])
    assert (tdataset.RGBXDataset.get_class_colors("PST900")
            == jdataset.RGBXDataset.get_class_colors("PST900"))
    assert (tdataset.RGBXDataset.get_class_colors()
            == jdataset.RGBXDataset.get_class_colors())


# The JAX names a port module leaves out, and why.
_NOT_COPIED = {
    "engine": {"default_parser"},   # unused by the CLIs of either package
    # flax layout code: the port's loaders work in torch key space
    "convert": {"merge_variables", "missing_leaves", "torch_key_to_path",
                "torch_to_flax_variables"},
}


@pytest.mark.parametrize("name", [
    "data.cv_ops", "data.transforms", "data.preprocess", "data.loader",
    "data.synthetic", "utils.fs", "metrics_writer", "visualize", "checkpoint",
    "engine", "convert", "evaluator"])
def test_copied_modules_have_the_jax_names(name):
    """Every public function and class the JAX module defines is in the
    port's module of the same name (signatures may add a device)."""
    j = importlib.import_module("rgbx_semantic_segmentation_tpu." + name)
    t = importlib.import_module("rgbx_semantic_segmentation_tpu_torch." + name)
    defined = {n for n, v in vars(j).items() if not n.startswith("_")
               and (inspect.isfunction(v) or inspect.isclass(v))
               and v.__module__ == j.__name__}
    assert defined, name
    missing = defined - set(vars(t)) - _NOT_COPIED.get(name, set())
    assert not missing, (name, sorted(missing))


def _tiny():
    return tconfig.mfnet_config().replace(
        dataset=tconfig.DatasetConfig(image_height=32, image_width=32),
        model=tconfig.ModelConfig(backbone="mit_tiny", decoder_embed_dim=32,
                                  use_mixed_precision=False))


@pytest.mark.parametrize("entry", ["build_model", "SegEvaluator", "Trainer",
                                   "Engine", "evaluate_checkpoints"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """device=None means cuda: without a CUDA device it raises; the CPU
    only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cfg = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "build_model":
            build_model(cfg)
        elif entry == "SegEvaluator":
            SegEvaluator(cfg, build_model(cfg, device="cpu"))
        elif entry == "Engine":
            from rgbx_semantic_segmentation_tpu_torch.engine import Engine

            Engine(cfg.replace(log_dir=str(tmp_path)),
                   types.SimpleNamespace(devices=""))
        elif entry == "evaluate_checkpoints":
            from rgbx_semantic_segmentation_tpu_torch.evaluator import (
                evaluate_checkpoints)

            evaluate_checkpoints(cfg, [], [1], str(tmp_path))
        else:
            Trainer(cfg)
