"""The port's data pipeline against the JAX package's on the CPU: the numpy
image ops, the native C++ library, the transforms, TrainPre / ValPre, the
threaded TrainLoader and the copied host helpers (synthetic dataset, fs,
visualize, metrics writer).

Like is compared with like. The JAX cv_ops dispatch to their native
library whenever it is loaded, and its uint8 results may differ from the
numpy path's by 1 LSB (tests/test_native_ops.py). So the port's numpy ops
are held bit-equal to the JAX numpy path (its native dispatch switched off
for the call, on the test's side), the port's native library bit-equal to
the JAX package's own build of its source (native/libcvops.so, built with
the JAX package's build when absent), and the port's pipeline on its
native library bit-equal to the JAX pipeline on the JAX build. The port's
native ops against its own numpy ops: the JAX package's bounds.
"""
import contextlib
import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import rgbx_semantic_segmentation_tpu.native as jnative
from rgbx_semantic_segmentation_tpu import metrics_writer as jwriter
from rgbx_semantic_segmentation_tpu import visualize as jvis
from rgbx_semantic_segmentation_tpu.config import (
    TrainConfig as JTrainConfig, mfnet_config as jmfnet)
from rgbx_semantic_segmentation_tpu.data import cv_ops as jcv
from rgbx_semantic_segmentation_tpu.data import loader as jloader
from rgbx_semantic_segmentation_tpu.data import preprocess as jpre
from rgbx_semantic_segmentation_tpu.data import synthetic as jsyn
from rgbx_semantic_segmentation_tpu.data import transforms as jtf
from rgbx_semantic_segmentation_tpu.utils import fs as jfs
from rgbx_semantic_segmentation_tpu_torch import config as tconfig
from rgbx_semantic_segmentation_tpu_torch import metrics as tmetrics
from rgbx_semantic_segmentation_tpu_torch import metrics_writer as twriter
from rgbx_semantic_segmentation_tpu_torch import visualize as tvis
from rgbx_semantic_segmentation_tpu_torch.data import cv_ops as tcv
from rgbx_semantic_segmentation_tpu_torch.data import loader as tloader
from rgbx_semantic_segmentation_tpu_torch.data import preprocess as tpre
from rgbx_semantic_segmentation_tpu_torch.data import synthetic as tsyn
from rgbx_semantic_segmentation_tpu_torch.data import transforms as ttf
from rgbx_semantic_segmentation_tpu_torch.native import build as tbuild
from rgbx_semantic_segmentation_tpu_torch.native import cv_ops as tnat
from rgbx_semantic_segmentation_tpu_torch.utils import fs as tfs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def jax_native(lib):
    """Point the JAX cv_ops' native dispatch at `lib` (None: numpy only)
    for the block (as tests/test_native_ops.py's _numpy_only does)."""
    saved = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = lib, True
    try:
        yield
    finally:
        jnative._lib, jnative._tried = saved


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's own native library (its build, its flags)."""
    lib = jnative.ensure_built()
    assert lib is not None, "the JAX package's native/libcvops.so: g++ failed"
    return lib


def _u8(rng, shape):
    return rng.randint(0, 256, shape).astype(np.uint8)


# -------------------------------------------------------------- cv_ops --


@pytest.mark.parametrize("case", range(4))
def test_numpy_cv_ops_bit_equal_to_jax(case):
    rng = np.random.RandomState(case)
    img = _u8(rng, (23 + case, 31, 3))
    gray = img[:, :, 0]
    f32 = rng.rand(19, 27, 3).astype(np.float32)
    with jax_native(None):
        for fn, args in [
                ("resize_linear", (img, (40, 17))),
                ("resize_linear", (gray, (11, 50))),
                ("resize_linear", (f32, (30, 30))),
                ("resize_nearest", (img, (45, 61))),
                ("resize_nearest", (gray, (7, 9))),
                ("resize_by_factor", (img, 0.75, 1.5)),
                ("resize_by_factor", (gray, 1.25, 0.5, True)),
                ("bgr_to_hsv_u8", (img,)),
                ("hsv_to_bgr_u8", (jcv.bgr_to_hsv_u8(img).astype(np.uint8),)),
                ("hsv_jitter", (img, 1.1, 0.85, 12.0)),
                ("gaussian_blur", (img, (5, 5), 1.0)),
                ("gaussian_blur", (gray, (3, 3), 0.0)),
                ("normalize", (img, (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)))]:
            want = getattr(jcv, fn)(*args)
            got = getattr(tcv, fn)(*args)
            assert got.dtype == want.dtype, fn
            np.testing.assert_array_equal(got, want, err_msg=fn)
        np.testing.assert_array_equal(tcv._gaussian_kernel_1d(5, 1.0),
                                      jcv._gaussian_kernel_1d(5, 1.0))


def test_native_source_is_the_jax_source():
    """The port's cv_ops.cpp is the JAX package's, code for code (the
    header comment aside)."""
    def code(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("#include"):]

    assert code(tbuild.HOST_SRC) == code(os.path.join(
        REPO, "rgbx_semantic_segmentation_tpu", "native", "cv_ops.cpp"))


@pytest.mark.parametrize("case", range(3))
def test_native_lib_bit_equal_to_the_jax_build(jax_lib, case):
    """The port's library against the JAX package's build of the same
    source, on the same inputs: every op, bit for bit (fp32 included)."""
    rng = np.random.RandomState(20 + case)
    img = _u8(rng, (37 + case, 53, 3))
    f32 = rng.rand(29, 41 + case, 3).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    with jax_native(jax_lib):
        for fn, args in [
                ("resize_linear", (img, (20 + case, 31))),
                ("resize_linear", (img, (74, 106 - case))),
                ("resize_linear", (img[:, :, 1], (15, 70 + case))),
                ("resize_linear", (f32, (58, 30 + case))),
                ("resize_nearest", (img, (45, 61 + case))),
                ("resize_nearest", (img[:, :, 2], (9 + case, 13))),
                ("hsv_jitter", (img, 1.1 - 0.1 * case, 0.9, 10.0 - 7 * case)),
                ("gaussian_blur", (img, (5, 5), 1.0 + 0.5 * case)),
                ("gaussian_blur", (img, (3, 3), 0.0)),
                ("normalize", (img, mean, std))]:
            want = getattr(jcv, fn)(*args)
            got = getattr(tnat, fn)(*args)
            assert got.dtype == want.dtype and got.shape == want.shape, fn
            np.testing.assert_array_equal(got, want, err_msg=fn)


@pytest.mark.parametrize("op", ["resize_linear_u8", "resize_linear_gray",
                                "resize_linear_f32", "resize_nearest",
                                "hsv_jitter", "gaussian_blur", "normalize"])
def test_native_ops_against_numpy(op):
    """The JAX package's own bounds (tests/test_native_ops.py): uint8
    resize, jitter and blur within 1 LSB, nearest exact, fp32 1e-5."""
    rng = np.random.RandomState(7)
    img = _u8(rng, (37, 53, 3))
    if op == "resize_linear_u8":
        a, b = tnat.resize_linear(img, (20, 31)), tcv.resize_linear(img, (20, 31))
    elif op == "resize_linear_gray":
        a = tnat.resize_linear(img[:, :, 1], (15, 70))
        b = tcv.resize_linear(img[:, :, 1], (15, 70))
    elif op == "resize_linear_f32":
        f = rng.rand(37, 53, 3).astype(np.float32)
        np.testing.assert_allclose(tnat.resize_linear(f, (74, 106)),
                                   tcv.resize_linear(f, (74, 106)), atol=1e-5)
        return
    elif op == "resize_nearest":
        np.testing.assert_array_equal(tnat.resize_nearest(img, (45, 61)),
                                      tcv.resize_nearest(img, (45, 61)))
        return
    elif op == "hsv_jitter":
        a, b = (tnat.hsv_jitter(img, 1.1, 0.9, 10.0),
                tcv.hsv_jitter(img, 1.1, 0.9, 10.0))
    elif op == "gaussian_blur":
        a, b = tnat.gaussian_blur(img), tcv.gaussian_blur(img)
    else:
        mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
        np.testing.assert_allclose(tnat.normalize(img, mean, std),
                                   tcv.normalize(img, mean, std), atol=1e-5)
        return
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_native_build_failure_raises_with_the_compiler_message(
        tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tbuild, "HOST_SRC", str(bad))
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="error"):
        tbuild.build_host()
    assert not any(n.endswith(".so") for n in os.listdir(tmp_path / "_build"))


# ----------------------------------------------------------- transforms --


def test_transforms_match_jax():
    rng = np.random.RandomState(3)
    img = _u8(rng, (30, 40, 3))
    gt = rng.randint(0, 9, (30, 40)).astype(np.uint8)
    assert ttf.get_2dshape(5) == jtf.get_2dshape(5) == (5, 5)
    cases = [
        ("generate_random_crop_pos", ((30, 40), (20, 25)), True),
        ("random_crop_pad_to_shape", (img, (5, 7), (32, 48), 3), False),
        ("pad_image_size_to_multiples_of", (img, 16, 0), False),
        ("resize_ensure_shortest_edge", (img, 24), False),
        ("random_scale", (img, gt, (0.5, 1.25)), True),
        ("random_scale_rgbx", (img, gt, img[:, ::-1], (0.75, 1.5)), True),
        ("random_scale_with_length", (img, gt, (24, 36)), True),
        ("random_mirror", (img, gt), True),
        ("random_rotation", (img, gt), True),
        ("center_crop", (img, (20, 20)), False),
        ("random_crop", (img, gt, (16, 30)), True)]
    with jax_native(None):
        for name, args, takes_rng in cases:
            for seed in range(3):
                kw = ({"rng": np.random.RandomState(seed)} if takes_rng
                      else {})
                want = getattr(jtf, name)(*args, **kw)
                kw = ({"rng": np.random.RandomState(seed)} if takes_rng
                      else {})
                got = getattr(ttf, name)(*args, **kw)
                if not isinstance(want, tuple):
                    got, want = (got,), (want,)
                assert len(got) == len(want), name
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w, err_msg=name)


# ------------------------------------------------------------ preprocess --


def _pair(seed, hw=(48, 64)):
    rng = np.random.RandomState(seed)
    return (_u8(rng, hw + (3,)), rng.randint(0, 12, hw).astype(np.uint8),
            _u8(rng, hw + (3,)))


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_train_pre_matches_jax(jax_lib, native, normalize):
    """Same inputs and per-sample rng seed: equal outputs, on the numpy ops
    (JAX dispatch off) and on the native library (the port's build against
    the JAX package's own)."""
    kw = dict(norm_mean=(0.485, 0.456, 0.406), norm_std=(0.229, 0.224, 0.225),
              image_hw=(40, 56), num_classes=9,
              train_scale_array=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
              normalize=normalize)
    jp = jpre.TrainPre(**kw)
    tp = tpre.TrainPre(**kw, ops=tnat if native else tcv)
    with jax_native(jax_lib if native else None):
        for seed in range(8):
            rgb, gt, x = _pair(seed)
            want = jp(rgb, gt, x, rng=np.random.RandomState(seed))
            got = tp(rgb, gt, x, rng=np.random.RandomState(seed))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def test_val_pre_matches_jax():
    kw = dict(norm_mean=(0.485, 0.456, 0.406), norm_std=(0.229, 0.224, 0.225),
              image_hw=(40, 56))
    rgb, gt, x = _pair(1)
    with jax_native(None):
        for want, got in zip(jpre.ValPre(**kw)(rgb, gt, x),
                             tpre.ValPre(**kw)(rgb, gt, x)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- loader --


@pytest.fixture(scope="module")
def loader_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader_data"))
    ds = jsyn.make_synthetic_dataset(root, num_train=5, num_val=2,
                                     hw=(40, 48), num_classes=9, seed=2)
    jcfg = jmfnet().replace(
        dataset=dataclasses.replace(ds, image_height=32, image_width=40),
        train=JTrainConfig(batch_size=3, niters_per_epoch=3, num_workers=2,
                           seed=77))
    tcfg = tconfig.mfnet_config().replace(
        dataset=tconfig.DatasetConfig(**dataclasses.asdict(jcfg.dataset)),
        train=tconfig.TrainConfig(**dataclasses.asdict(jcfg.train)))
    return root, jcfg, tcfg


def _jax_batches(jcfg, root, epoch, workers, lib):
    """The JAX loader's batches of `epoch` and its oversampled name list."""
    with jax_native(lib):
        ld = jloader.TrainLoader(jcfg, root=root, num_workers=workers)
        return list(ld.epoch(epoch)), list(ld.dataset._names())


@pytest.mark.parametrize("workers", [0, 2])
def test_train_loader_bit_equal_to_jax(loader_data, jax_lib, workers):
    """Two epochs of batches (names by way of the pixels, order, augmented
    uint8 pixels, labels) equal the JAX TrainLoader's for the same seed,
    with 0 and 2 workers; the port on its native library by default, the
    JAX loader on the JAX package's build."""
    root, jcfg, tcfg = loader_data
    tl = tloader.TrainLoader(tcfg, root=root, num_workers=workers)
    assert tl.niters == 3
    for epoch in (1, 2):
        want, names = _jax_batches(jcfg, root, epoch, workers, jax_lib)
        got = list(tl.epoch(epoch))
        assert list(tl.dataset._names()) == names and len(names) == 9
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == {"rgb", "modal_x", "label"}
            for k in g:
                assert g[k].dtype == torch.uint8
                np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
    # the epochs differ, and the batch order follows the seed
    assert not np.array_equal(list(tl.epoch(1))[0]["rgb"].numpy(),
                              list(tl.epoch(2))[0]["rgb"].numpy())


def test_train_loader_numpy_ops_bit_equal_to_jax(loader_data):
    root, jcfg, tcfg = loader_data
    tl = tloader.TrainLoader(tcfg, root=root, num_workers=2, ops=tcv)
    want, _ = _jax_batches(jcfg, root, 3, 2, None)
    for g, w in zip(tl.epoch(3), want):
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)


def _live_workers():
    return [t for t in threading.enumerate()
            if t is not threading.current_thread() and t.daemon
            and getattr(t, "_target", None) is not None
            and t._target.__qualname__.endswith("epoch.<locals>.worker")]


def test_train_loader_closed_early_stops_its_workers(loader_data):
    """A consumer that stops after one batch (a should_stop break) closes
    the generator: no worker is left alive, even with the queue full."""
    root, _, tcfg = loader_data
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train,
                                                  niters_per_epoch=8))
    tl = tloader.TrainLoader(tcfg, root=root, num_workers=3, prefetch=1)
    gen = tl.epoch(1)
    first = next(gen)
    assert first["rgb"].shape == (3, 32, 40, 3)
    assert _live_workers()
    gen.close()
    assert not _live_workers()
    with contextlib.closing(tl.epoch(2)) as gen:
        next(gen)
    assert not _live_workers()


def test_train_loader_raises_a_worker_error(loader_data, monkeypatch):
    root, _, tcfg = loader_data
    tl = tloader.TrainLoader(tcfg, root=root, num_workers=2)

    def broken(self, index):
        raise ValueError(f"sample {index} is broken")

    monkeypatch.setattr(type(tl.dataset), "__getitem__", broken)
    with pytest.raises(ValueError, match="broken"):
        list(tl.epoch(1))
    assert not _live_workers()


def test_val_loader_matches_jax(loader_data):
    root, jcfg, tcfg = loader_data
    for pre in (False, True):
        with jax_native(None):
            j = list(jloader.ValLoader(jcfg, root=root, preprocess=pre))
        t = list(tloader.ValLoader(tcfg, root=root, preprocess=pre))
        assert len(t) == len(j) == 2
        for a, b in zip(t, j):
            assert a["fn"] == b["fn"]
            for k in ("rgb", "modal_x", "label"):
                np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------- host helpers --


def test_synthetic_dataset_matches_jax(tmp_path):
    j = jsyn.make_synthetic_dataset(str(tmp_path / "j"), num_train=3,
                                    num_val=2, hw=(20, 24), num_classes=5,
                                    seed=4)
    t = tsyn.make_synthetic_dataset(str(tmp_path / "t"), num_train=3,
                                    num_val=2, hw=(20, 24), num_classes=5,
                                    seed=4)
    assert isinstance(t, tconfig.DatasetConfig)
    ja, ta = dataclasses.asdict(j), dataclasses.asdict(t)
    assert ja.pop("dataset_path") != ta.pop("dataset_path")
    assert ja == ta
    for sub, names in (("", ["train.txt", "test.txt"]),
                       ("RGB", os.listdir(tmp_path / "j" / "RGB")),
                       ("Thermal", os.listdir(tmp_path / "j" / "Thermal")),
                       ("Label", os.listdir(tmp_path / "j" / "Label"))):
        assert names
        for n in names:
            assert ((tmp_path / "t" / sub / n).read_bytes()
                    == (tmp_path / "j" / sub / n).read_bytes()), (sub, n)


def test_fs_helpers_match_jax(tmp_path):
    for spec in ("0,2-5", "*", "", "3", " 1 , 2 "):
        assert tfs.parse_devices(spec, 8) == jfs.parse_devices(spec, 8)
    with pytest.raises(ValueError, match="out of range"):
        tfs.parse_devices("4", 2)
    if not torch.cuda.is_available():
        assert tfs.parse_devices("*") == []
    d = tfs.ensure_dir(str(tmp_path / "a" / "b"))
    assert os.path.isdir(d) and tfs.ensure_dir(d) == d
    (tmp_path / "x").write_text("1")
    (tmp_path / "y").write_text("2")
    link = str(tmp_path / "last")
    tfs.link_file("x", link)
    tfs.link_file("y", link)   # re-pointed in place
    assert os.readlink(link) == "y" and open(link).read() == "2"


def test_visualize_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    img = _u8(rng, (12, 16, 3))
    pred = rng.randint(0, 5, (12, 16))
    gt = rng.randint(0, 5, (12, 16)).astype(np.uint8)
    gt[0, :4] = 255
    colors = jvis.get_colors(5)
    assert tvis.get_colors(5) == colors
    np.testing.assert_array_equal(
        tvis.show_prediction(colors, 255, img, pred, gt),
        jvis.show_prediction(colors, 255, img, pred, gt))
    np.testing.assert_array_equal(
        tvis.show_img(colors, 255, img, None, gt, pred, pred[::-1]),
        jvis.show_img(colors, 255, img, None, gt, pred, pred[::-1]))
    tvis.save_palette_png(pred, colors, str(tmp_path / "t.png"))
    jvis.save_palette_png(pred, colors, str(tmp_path / "j.png"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    assert tvis.print_iou is tmetrics.print_iou


def test_metrics_writer_schema_matches_jax(tmp_path):
    for mod, sub in ((jwriter, "j"), (twriter, "t")):
        w = mod.MetricsWriter(str(tmp_path / sub), use_tensorboard=False)
        w.scalar("train/epoch_loss", 1.5, 3)
        w.scalar("train/learning_rate", np.float32(2e-5), 12)
        w.close()
    rows = {}
    for sub in ("j", "t"):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            rows[sub] = [json.loads(line) for line in f]
        for r in rows[sub]:
            r.pop("ts")
    assert rows["t"] == rows["j"] and len(rows["t"]) == 2
