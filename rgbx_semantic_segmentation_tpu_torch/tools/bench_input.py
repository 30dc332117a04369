"""Input-pipeline time: the native C++ image ops against their numpy
versions (the port's counterpart of
rgbx_semantic_segmentation_tpu/tools/bench_input.py).

Times the TrainPre augmentation chain of one sample as the TrainLoader
builds it (MFNet geometry, the preset's scales, uint8 out: the train step
normalises on the device), first with ops=data.cv_ops (numpy), then with
ops=native.cv_ops (native/cv_ops.cpp, built with g++ at first use; a
failed build raises). Host time only: no card is used.

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.tools.bench_input \
        [--n 50]

Prints numpy_ms, native_ms (per sample) and speedup (numpy over native).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)


def pipeline(ops, hw=(480, 640)):
    """(TrainPre with `ops`, its seeded rgb, gt and modal_x inputs)."""
    from rgbx_semantic_segmentation_tpu_torch.data.preprocess import TrainPre

    rng = np.random.RandomState(0)
    h, w = hw
    rgb = rng.randint(0, 255, (h, w, 3), np.uint8)
    gt = rng.randint(0, 9, (h, w), np.uint8)
    mx = rng.randint(0, 255, (h, w, 3), np.uint8)
    pre = TrainPre(norm_mean=(0.485, 0.456, 0.406),
                   norm_std=(0.229, 0.224, 0.225), image_hw=hw,
                   num_classes=9, train_scale_array=SCALES, normalize=False,
                   ops=ops)
    return pre, (rgb, gt, mx)


def sample(ops, seed: int, hw=(480, 640)):
    """One sample (rgb, gt, modal_x) of the pipeline with `ops`, drawn from
    RandomState(seed)."""
    pre, args = pipeline(ops, hw)
    return pre(*args, rng=np.random.RandomState(seed))


def bench(ops, n: int, hw) -> float:
    """ms per sample over `n` samples after one warm-up."""
    pre, args = pipeline(ops, hw)
    pre(*args, rng=np.random.RandomState(0))
    t0 = time.perf_counter()
    for i in range(n):
        pre(*args, rng=np.random.RandomState(i))
    return (time.perf_counter() - t0) / n * 1e3


def run(n: int = 50, hw=(480, 640)) -> dict:
    """{numpy_ms, native_ms, speedup} over `n` samples at `hw`."""
    from rgbx_semantic_segmentation_tpu_torch.data import cv_ops
    from rgbx_semantic_segmentation_tpu_torch.native import cv_ops as native

    native.lib()   # build first: the build is not timed
    numpy_ms = bench(cv_ops, n, hw)
    native_ms = bench(native, n, hw)
    return {"numpy_ms": numpy_ms, "native_ms": native_ms,
            "speedup": numpy_ms / native_ms}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=50)
    args = p.parse_args(argv)
    for k, v in run(args.n).items():
        print(f"{k}: {v:.2f}")


if __name__ == "__main__":
    main()
