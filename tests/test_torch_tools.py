"""The port's tools (rgbx_semantic_segmentation_tpu_torch/tools/) against
the JAX package's on the CPU: each pair runs on its own copy of one
synthetic folder of small PNGs, and the written trees must be equal file
for file and byte for byte, the printed reports equal (the copies' roots
replaced by one name), and the exit codes and returned results equal.
resize_images, check_labels, compare_labels with detect_border_padding,
visualize_labels, copy_split, clean_logs, split_rgbt and fetch_mfnet (its
conversion of a synthetic ir_seg_dataset layout and its rejection of a bad
source). The JAX resize_images runs its numpy image ops (its native
library, when one is built, is switched off for the call): the port's
resize_images runs the numpy versions of data/cv_ops, which define the
semantics there as here.

bench_input runs at a tiny n and size; its two op sets (numpy and the
native library) must agree within 1 LSB on every op of a sample's chain.
check_gpu has its tests
in tests/test_torch_check_gpu.py, which imports no jax."""
import filecmp
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from rgbx_semantic_segmentation_tpu import native as jax_native
from rgbx_semantic_segmentation_tpu.tools import check_labels as j_check_labels
from rgbx_semantic_segmentation_tpu.tools import clean_logs as j_clean_logs
from rgbx_semantic_segmentation_tpu.tools import compare_labels as j_compare
from rgbx_semantic_segmentation_tpu.tools import copy_split as j_copy_split
from rgbx_semantic_segmentation_tpu.tools import fetch_mfnet as j_fetch_mfnet
from rgbx_semantic_segmentation_tpu.tools import resize_images as j_resize
from rgbx_semantic_segmentation_tpu.tools import split_rgbt as j_split_rgbt
from rgbx_semantic_segmentation_tpu.tools import visualize_labels as j_visualize
from rgbx_semantic_segmentation_tpu_torch.tools import (
    bench_input, check_labels, clean_logs, compare_labels,
    copy_split, fetch_mfnet, resize_images, split_rgbt, visualize_labels)

ROOT = "<root>"


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _dataset(root, seed=0):
    """RGB/Thermal/Label triples: a good pair at 12x16, a pair whose RGB has
    a black border the thermal lacks, a size mismatch, a lonely RGB, an
    out-of-range and an ignore-only label, a palettised label, a text file."""
    rng = np.random.RandomState(seed)
    for name, hw in (("a", (12, 16)), ("b", (10, 14)), ("c", (9, 7))):
        _png(os.path.join(root, "RGB", f"{name}.png"),
             rng.randint(1, 255, hw + (3,), dtype=np.uint8))
        _png(os.path.join(root, "Thermal", f"{name}.png"),
             rng.randint(1, 255, hw, dtype=np.uint8))
        _png(os.path.join(root, "Label", f"{name}.png"),
             rng.randint(0, 4, hw).astype(np.uint8))
    padded = np.zeros((12, 16, 3), np.uint8)
    padded[:, 7:] = 200
    _png(os.path.join(root, "RGB", "pad.png"), padded)
    _png(os.path.join(root, "Thermal", "pad.png"),
         np.full((12, 16), 90, np.uint8))
    _png(os.path.join(root, "Label", "pad.png"),
         np.full((12, 16), 255, np.uint8))
    _png(os.path.join(root, "RGB", "mis.png"),
         rng.randint(1, 255, (8, 8, 3), dtype=np.uint8))
    _png(os.path.join(root, "Thermal", "mis.png"),
         rng.randint(1, 255, (6, 8), dtype=np.uint8))
    _png(os.path.join(root, "Label", "mis.png"),
         np.full((8, 8), 7, np.uint8))
    _png(os.path.join(root, "RGB", "lonely.png"),
         rng.randint(1, 255, (8, 8, 3), dtype=np.uint8))
    pal = Image.fromarray(rng.randint(0, 3, (7, 9)).astype(np.uint8), "P")
    pal.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0] + [0] * 759)
    pal.save(os.path.join(root, "Label", "pal.png"))
    with open(os.path.join(root, "Label", "notes.txt"), "w") as f:
        f.write("not an image\n")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("a\nmissing\nb\n")


def _copies(tmp_path, make):
    """Two equal copies of the folder `make(root)` writes: (jax, port)."""
    src = str(tmp_path / "src")
    make(src)
    out = []
    for tag in ("jax", "port"):
        dst = str(tmp_path / tag)
        shutil.copytree(src, dst)
        out.append(dst)
    return out


def _assert_same_tree(a, b):
    files = []
    for base in (a, b):
        found = []
        for dirpath, _, names in os.walk(base):
            found += [os.path.relpath(os.path.join(dirpath, n), base)
                      for n in names]
        files.append(sorted(found))
    assert files[0] == files[1]
    for rel in files[0]:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel


def _jax_main(module, argv):
    """A JAX tool's main() under `argv` (it reads sys.argv); its exit code
    (None when it returns, SystemExit's code when it raises one)."""
    old = sys.argv
    sys.argv = [module.__name__] + list(argv)
    try:
        module.main()
        return None
    except SystemExit as e:
        return e.code
    finally:
        sys.argv = old


def _port_main(module, argv):
    try:
        module.main(list(argv))
        return None
    except SystemExit as e:
        return e.code


def _run_pair(capsys, jmod, pmod, jroot, proot, argv):
    """Both mains on their own root (`argv` with {root} in it); returns the
    two (exit code, stdout with the root replaced)."""
    out = []
    for run, mod, root in ((_jax_main, jmod, jroot), (_port_main, pmod, proot)):
        capsys.readouterr()
        code = run(mod, [a.format(root=root) for a in argv])
        out.append((code, capsys.readouterr().out.replace(root, ROOT)))
    return out


def test_resize_images_matches_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)
    jroot, proot = _copies(tmp_path, _dataset)
    for argv in (["--input_dir", "{root}", "--width", "9", "--height", "5"],
                 ["--input_dir", "{root}", "--width", "31", "--height", "23",
                  "--output_dir", "{root}/up"],
                 ["--input_dir", "{root}", "--x_folder", "nope",
                  "--output_dir", "{root}/skip"]):
        jres, pres = _run_pair(capsys, j_resize, resize_images, jroot,
                               proot, argv)
        assert pres == jres
    _assert_same_tree(jroot, proot)
    _assert_same_tree(jroot + "_resized", proot + "_resized")
    lab = np.asarray(Image.open(os.path.join(proot + "_resized", "Label",
                                             "a.png")))
    assert lab.shape == (5, 9) and set(np.unique(lab)) <= {0, 1, 2, 3}


def test_check_labels_matches_jax(tmp_path, capsys):
    jroot, proot = _copies(tmp_path, _dataset)
    want = j_check_labels.check_labels(os.path.join(jroot, "Label"), 4)
    got = check_labels.check_labels(os.path.join(proot, "Label"), 4)
    assert got == want == [("mis.png", [7])]
    assert check_labels.check_labels(os.path.join(proot, "Label"), 4,
                                     ignore=7) == \
        j_check_labels.check_labels(os.path.join(jroot, "Label"), 4, ignore=7)
    for argv in (["--label_dir", "{root}/Label", "--num_classes", "4"],
                 ["--label_dir", "{root}/Label", "--num_classes", "9"]):
        jres, pres = _run_pair(capsys, j_check_labels, check_labels, jroot,
                               proot, argv)
        assert pres == jres
    assert [r[0] for r in (jres, pres)] == [0, 0]


def test_compare_labels_matches_jax(tmp_path, capsys):
    jroot, proot = _copies(tmp_path, _dataset)
    want = j_compare.compare(jroot)
    assert compare_labels.compare(proot) == want
    assert {k for _, k, _ in want} == {"missing pair", "size mismatch",
                                       "padding mismatch"}
    jres, pres = _run_pair(capsys, j_compare, compare_labels, jroot, proot,
                           ["--dataset_dir", "{root}"])
    assert pres == jres and pres[0] == 1
    clean = str(tmp_path / "clean")
    _png(os.path.join(clean, "RGB", "x.png"), np.full((4, 4, 3), 9, np.uint8))
    _png(os.path.join(clean, "Thermal", "x.png"), np.full((4, 4), 9, np.uint8))
    _png(os.path.join(clean, "Label", "x.png"), np.zeros((4, 4), np.uint8))
    jres, pres = _run_pair(capsys, j_compare, compare_labels, clean, clean,
                           ["--dataset_dir", "{root}"])
    assert pres == jres == (0, "no mismatches found\n")


@pytest.mark.parametrize("seed", range(3))
def test_detect_border_padding_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for shape in ((10, 12), (9, 7, 3), (1, 5), (6, 1, 3)):
        arr = rng.randint(0, 3, shape).astype(np.uint8)
        t, b, l_, r = (int(n) for n in rng.randint(0, 4, 4))
        arr[:t] = 0
        arr[arr.shape[0] - b:] = 0
        arr[:, :l_] = 0
        arr[:, arr.shape[1] - r:] = 0
        for thresh in (1.0, 0.5):
            assert compare_labels.detect_border_padding(arr, thresh) == \
                j_compare.detect_border_padding(arr, thresh)
    zeros = np.zeros((3, 4), np.uint8)
    assert compare_labels.detect_border_padding(zeros) == \
        j_compare.detect_border_padding(zeros) == (3, 3, 4, 4)


def test_visualize_labels_matches_jax(tmp_path, capsys):
    jroot, proot = _copies(tmp_path, _dataset)
    for argv in (["--label_dir", "{root}/Label", "--out_dir", "{root}/viz",
                  "--dataset_name", "mfnet"],
                 ["--label_dir", "{root}/Label", "--out_dir", "{root}/pst",
                  "--dataset_name", "PST900", "--limit", "2"]):
        jres, pres = _run_pair(capsys, j_visualize, visualize_labels, jroot,
                               proot, argv)
        assert pres == jres
    _assert_same_tree(jroot, proot)
    assert len(os.listdir(os.path.join(proot, "pst"))) == 2


def test_copy_split_matches_jax(tmp_path, capsys):
    jroot, proot = _copies(tmp_path, _dataset)
    for argv in (["--dataset_dir", "{root}", "--split", "train.txt",
                  "--src_folder", "Thermal", "--dst_folder", "ssl/train"],
                 ["--dataset_dir", "{root}", "--split", "{root}/train.txt",
                  "--src_folder", "Label", "--dst_folder", "L2",
                  "--ext", ".txt"]):
        jres, pres = _run_pair(capsys, j_copy_split, copy_split, jroot,
                               proot, argv)
        assert pres == jres
    _assert_same_tree(jroot, proot)
    assert sorted(os.listdir(os.path.join(proot, "ssl", "train"))) == \
        ["a.png", "b.png"]


def _logs(root):
    for name, size in (("empty_run", 10), ("real_run", 5000), ("mid", 3071),
                       ("edge", 3072)):
        os.makedirs(os.path.join(root, name, "sub"))
        with open(os.path.join(root, name, "sub", "events"), "wb") as f:
            f.write(b"x" * size)
    os.makedirs(os.path.join(root, "bare"))
    with open(os.path.join(root, "loose.log"), "w") as f:
        f.write("x")


def test_clean_logs_matches_jax(tmp_path, capsys):
    jroot, proot = _copies(tmp_path, _logs)
    for argv in (["--log_dir", "{root}", "--dry_run"],
                 ["--log_dir", "{root}", "--min_bytes", "100"],
                 ["--log_dir", "{root}"]):
        jres, pres = _run_pair(capsys, j_clean_logs, clean_logs, jroot, proot,
                               argv)
        assert pres == jres
        _assert_same_tree(jroot, proot)
    assert sorted(os.listdir(proot)) == ["edge", "loose.log", "real_run"]
    assert clean_logs.dir_size(os.path.join(proot, "real_run")) == \
        j_clean_logs.dir_size(os.path.join(jroot, "real_run")) == 5000


def _fused(root):
    rng = np.random.RandomState(1)
    _png(os.path.join(root, "im.png"),
         rng.randint(0, 255, (5, 7, 4), dtype=np.uint8))
    _png(os.path.join(root, "three.png"),
         rng.randint(0, 255, (6, 4, 3), dtype=np.uint8))
    _png(os.path.join(root, "gray.png"),
         rng.randint(0, 255, (3, 3), dtype=np.uint8))
    with open(os.path.join(root, "readme.txt"), "w") as f:
        f.write("x")


def test_split_rgbt_matches_jax(tmp_path, capsys):
    jroot, proot = _copies(tmp_path, _fused)
    jres, pres = _run_pair(capsys, j_split_rgbt, split_rgbt, jroot, proot,
                           ["--input_dir", "{root}", "--output_dir",
                            "{root}/out"])
    assert pres == jres
    _assert_same_tree(jroot, proot)
    assert sorted(os.listdir(os.path.join(proot, "out", "RGB"))) == \
        ["im.png", "three.png"]


def _raw_mfnet(root):
    rng = np.random.RandomState(2)
    names = ["00001D", "00002D", "00003N", "00004N"]
    for n in names:
        _png(os.path.join(root, "images", f"{n}.png"),
             rng.randint(0, 255, (10, 12, 4), dtype=np.uint8))
        _png(os.path.join(root, "labels", f"{n}.png"),
             rng.randint(0, 9, (10, 12), dtype=np.uint8))
    _png(os.path.join(root, "images", "bad.png"),
         rng.randint(0, 255, (10, 12, 3), dtype=np.uint8))
    _png(os.path.join(root, "labels", "rgb_coded.png"),
         rng.randint(0, 9, (10, 12, 3), dtype=np.uint8))
    for split, part in (("train", names[:2]), ("val", names[2:3]),
                        ("test", names[3:])):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(part) + "\n\n")


def test_fetch_mfnet_convert_matches_jax(tmp_path, capsys):
    jroot, proot = _copies(tmp_path, _raw_mfnet)
    reports = []
    for mod, root in ((j_fetch_mfnet, jroot), (fetch_mfnet, proot)):
        capsys.readouterr()
        summary = mod.convert(root, os.path.join(root, "MFNet"))
        reports.append((summary, capsys.readouterr().out.replace(root, ROOT)))
    assert reports[1] == reports[0]
    assert reports[0][0] == {"images": 4, "labels": 5, "train_val": 3,
                             "test": 1}
    _assert_same_tree(jroot, proot)

    from rgbx_semantic_segmentation_tpu_torch.config import mfnet_config
    from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset

    ds = RGBXDataset(mfnet_config().dataset, "val",
                     root=os.path.join(proot, "MFNet"))
    item = ds[0]
    assert item["rgb"].shape == (10, 12, 3) and item["label"].shape == (10, 12)


def test_fetch_mfnet_rejects_bad_source_as_jax(tmp_path, capsys):
    messages = []
    for mod in (j_fetch_mfnet, fetch_mfnet):
        with pytest.raises(SystemExit) as e:
            mod.convert(str(tmp_path / "nope"), str(tmp_path / "out"))
        messages.append(str(e.value.code))
    assert all(m.startswith("error:") and "ir_seg_dataset" in m
               for m in messages)
    src = str(tmp_path / "no_split")
    _raw_mfnet(src)
    os.remove(os.path.join(src, "val.txt"))
    for mod in (j_fetch_mfnet, fetch_mfnet):
        with pytest.raises(SystemExit, match="missing split file"):
            mod.convert(src, str(tmp_path / f"out_{mod.__name__}"))
    assert not os.path.exists(tmp_path / "out")


class _BothOps:
    """Image ops that run every call through the numpy versions and the
    native library on the same input, keep each op's largest difference
    and return the numpy result."""

    def __init__(self, numpy_ops, native_ops):
        self.ops = numpy_ops, native_ops
        self.worst = {}

    def __getattr__(self, name):
        def call(*args, **kw):
            a, b = (getattr(ops, name)(*args, **kw) for ops in self.ops)
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
            diff = int(np.abs(a.astype(int) - b.astype(int)).max())
            self.worst[name] = max(self.worst.get(name, 0), diff)
            return a
        return call


def test_bench_input_runs_and_op_sets_agree():
    """run() at n = 2; then the pipeline's samples with both op sets: every
    op of the chain within 1 LSB on the same input, the labels equal and the
    modal X (resizes only) within 1 LSB. The RGB of a whole sample is not
    held to 1 LSB: the HSV jitter turns a 1-LSB difference of its input
    into several of its output (a hue step of a grey-ish pixel)."""
    from rgbx_semantic_segmentation_tpu_torch.data import cv_ops
    from rgbx_semantic_segmentation_tpu_torch.native import cv_ops as native

    res = bench_input.run(n=2, hw=(24, 32))
    assert sorted(res) == ["native_ms", "numpy_ms", "speedup"]
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    both = _BothOps(cv_ops, native)
    for seed in range(6):
        bench_input.sample(both, seed, hw=(48, 64))
        _, gt, mx = bench_input.sample(cv_ops, seed, hw=(48, 64))
        _, ngt, nmx = bench_input.sample(native, seed, hw=(48, 64))
        np.testing.assert_array_equal(ngt, gt)
        assert np.abs(nmx.astype(int) - mx.astype(int)).max() <= 1
    assert set(both.worst) == {"resize_linear", "resize_nearest",
                               "hsv_jitter", "gaussian_blur"}
    assert max(both.worst.values()) <= 1, both.worst
