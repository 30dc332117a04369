#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root, one card

It builds the port's CUDA kernel from csrc/ with nvcc, holds it against its
plain PyTorch version at the shapes the flagship model gives it, then drives
the port's main path — whole-image evaluation (SegEvaluator.evaluate) of the
MFNet preset, CMX mit_b2 + MLPDecoder at full width, 480x640, batch 8, bf16,
seeded random weights — over in-memory image pairs, counts the kernel's
launches in that run, and holds the model's logits on the kernel path against
the same model on the plain attention path: in bf16, which runs the
tensor-core kernel, and in fp32, which runs the scalar kernel. Any failed
check raises
and the exit code is non-zero. Without a CUDA device it fails; it never
falls back to the CPU.

Output: human-readable lines, then a JSON line with the kernel's numbers,
then the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# (B, h, N, M, d) of the mit_b2 SR attentions at 480x640, batch 8, and the
# number of calls of each in one forward (2 towers x depths (3, 4, 6, 3)).
FLAGSHIP = [(8, 1, 19200, 300, 64), (8, 2, 4800, 300, 64),
            (8, 5, 1200, 300, 64), (8, 8, 300, 300, 64)]
CALLS_PER_FORWARD = [6, 8, 12, 6]
# tests/test_sr_attention.py SHAPES: M = 1, ragged N and M.
RAGGED = [(2, 1, 480, 300, 64), (2, 2, 300, 300, 64), (1, 5, 96, 24, 32),
          (2, 1, 8, 1, 64), (1, 8, 75, 19, 64)]
FP32_ATOL = 1e-5
# Share of bf16 outputs that may differ from the plain version at all: the
# tensor-core kernel's fp32 summation order flips ~0.1% of the roundings,
# while a kernel that fed p into p @ v unrounded differs in ~40%.
BF16_MISMATCH_MAX = 0.01
N_IMAGES, EVAL_BATCH, HW = 32, 8, (480, 640)
# bf16 logits, tensor-core kernel path vs plain path: bf16 ulps at the
# logit scale (max |plain logit|). Measured 2 on the H100 (PERF.md).
BF16_LOGITS_ULPS = 4


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bf16_atol(ref, ulps=2) -> float:
    """`ulps` bf16 ulps at the reference's largest magnitude."""
    mag = float(ref.float().abs().max())
    return ulps * 2.0 ** (np.floor(np.log2(mag)) - 7) if mag > 0 else 0.0


def unrounded_reference(q, k, v, scale):
    """The plain version with the wrong rounding point: p stays fp32 into
    p @ v. A kernel must sit closer to the plain version than to this."""
    import torch

    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, -1), v.float()).to(v.dtype)


def median_ms(fn, *args, warmup=3, iters=20, reps=1) -> float:
    """Median over `iters` CUDA-event windows of the time per call, each
    window `reps` calls back to back (reps > 1 hides the host's own time
    per call behind the device's)."""
    import torch

    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def kernel_phase(S):
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, h, N, M, d, dtype):
        """q, k, v as the model hands them over: head-split views of the
        (B, N, h*d) q tokens and of the (B, M, 2, h, d) kv projection."""
        x = torch.randn(B, N, h * d, device="cuda", generator=g).to(dtype)
        kv = torch.randn(B, M, 2, h, d, device="cuda", generator=g).to(dtype)
        return (x.reshape(B, N, h, d).transpose(1, 2),
                kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2))

    flagship_err = 0.0
    cases = [(s, torch.bfloat16) for s in FLAGSHIP + RAGGED] + \
            [(s, torch.float32) for s in RAGGED]
    for (B, h, N, M, d), dtype in cases:
        q, k, v = inputs(B, h, N, M, d, dtype)
        ref = S.sr_attention_reference(q, k, v, d ** -0.5)
        got = S.sr_attention(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        tol = bf16_atol(ref) if dtype == torch.bfloat16 else FP32_ATOL
        print(f"kernel {str(dtype)[6:]:8s} (B,h,N,M,d)={(B, h, N, M, d)}: "
              f"max_abs_err {err:.3e} (tol {tol:.3e})")
        check(err <= tol and bool(torch.isfinite(got).all()),
              f"kernel vs plain at {(B, h, N, M, d)} {dtype}: {err} > {tol}")
        if dtype == torch.bfloat16 and M > 1:  # M = 1: p is exactly 1
            wrong = unrounded_reference(q, k, v, d ** -0.5)
            right_frac = float((got != ref).float().mean())
            wrong_frac = float((got != wrong).float().mean())
            print(f"  outputs differing from plain {right_frac:.5f} "
                  f"(<= {BF16_MISMATCH_MAX}), from unrounded-p plain "
                  f"{wrong_frac:.5f}")
            check(right_frac <= BF16_MISMATCH_MAX and right_frac < wrong_frac,
                  f"bf16 kernel at {(B, h, N, M, d)} does not round p as the "
                  f"plain version does: {right_frac} vs {wrong_frac}")
        if (B, h, N, M, d) in FLAGSHIP:
            flagship_err = max(flagship_err, err)

    ms, plain_ms = [], []
    for (B, h, N, M, d) in FLAGSHIP:
        q, k, v = inputs(B, h, N, M, d, torch.bfloat16)
        sc = d ** -0.5
        # plain, kernel, kernel, plain: compare within one window. Device
        # time per call: windows of 10 calls back to back.
        p1 = median_ms(S.sr_attention_reference, q, k, v, sc, reps=10)
        k1 = median_ms(S.sr_attention, q, k, v, sc, reps=10)
        k2 = median_ms(S.sr_attention, q, k, v, sc, reps=10)
        p2 = median_ms(S.sr_attention_reference, q, k, v, sc, reps=10)
        ms.append((k1 + k2) / 2)
        plain_ms.append((p1 + p2) / 2)
        print(f"time bf16 (B,h,N,M,d)={(B, h, N, M, d)}: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    per_fwd = sum(c * t for c, t in zip(CALLS_PER_FORWARD, ms))
    plain_per_fwd = sum(c * t for c, t in zip(CALLS_PER_FORWARD, plain_ms))
    print(f"SR attention per forward (32 calls): kernel {per_fwd:.3f} ms, "
          f"plain {plain_per_fwd:.3f} ms")
    return flagship_err, per_fwd, plain_per_fwd


def synthetic_items(n, hw, num_classes, seed=0):
    """MFNet-shaped uint8 pairs with structured labels, made in memory
    (class bands, thermal tracking the label, 2% ignore pixels)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    band = h // num_classes
    base = np.repeat(np.arange(h) // band, w).reshape(h, w)
    base = np.minimum(base, num_classes - 1).astype(np.uint8)
    colors = rng.randint(0, 256, (num_classes, 3)).astype(np.int32)
    items = []
    for i in range(n):
        label = np.roll(base, rng.randint(0, h), axis=0)
        rgb = np.clip(colors[label] + rng.randint(-20, 20, (h, w, 3)), 0,
                      255).astype(np.uint8)
        thermal = np.clip(label.astype(np.int32) * (255 // num_classes)
                          + rng.randint(-15, 15, (h, w)), 0, 255).astype(np.uint8)
        label = label.copy()
        label[rng.rand(h, w) < 0.02] = 255
        items.append({"rgb": rgb, "modal_x": thermal, "label": label,
                      "fn": f"smoke_{i:04d}"})
    return items


def slice_phase(S, cfg_lib, builder, evaluator_lib, dual_segformer):
    import torch

    cfg = cfg_lib.mfnet_config()
    check(cfg.model.backbone == "mit_b2" and cfg.model.use_mixed_precision,
          "mfnet preset is mit_b2 in bf16")
    items = synthetic_items(N_IMAGES, HW, cfg.dataset.num_classes)
    model = builder.build_model(cfg, device="cuda", seed=0)
    ev = evaluator_lib.SegEvaluator(cfg, model, device="cuda")
    ev.evaluate(items[:EVAL_BATCH], eval_batch=EVAL_BATCH)  # warm-up

    S.sr_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, line = ev.evaluate(items, eval_batch=EVAL_BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = S.sr_attention.launches
    forwards = N_IMAGES // EVAL_BATCH
    print(f"eval: {N_IMAGES} images, {forwards} forwards of batch "
          f"{EVAL_BATCH}, {launches} kernel launches "
          f"(expected {32 * forwards}), {N_IMAGES / dt:.2f} img/s "
          f"({dt:.3f} s, host normalisation included)")
    check(launches == 32 * forwards, f"{launches} launches != 32 x {forwards}")
    print("eval mIoU line (synthetic data, random weights):")
    print(line.splitlines()[-1])
    check(np.isfinite(scores.pixel_acc), "pixel_acc is finite")

    pairs = [ev._normalize_pair(it["rgb"], ev._three_channel(it["modal_x"]))
             for it in items[:EVAL_BATCH]]
    rgb_t = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    mx_t = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    with torch.no_grad():
        logits = model(rgb_t, mx_t)
        with dual_segformer.plain_attention(model):
            plain_bf16 = model(rgb_t, mx_t)
    check(logits.shape == (EVAL_BATCH, *HW, cfg.dataset.num_classes)
          and logits.dtype == torch.bfloat16, f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "bf16 logits are finite")
    agree_bf16 = float((logits.argmax(-1) == plain_bf16.argmax(-1))
                       .float().mean())
    err_bf16 = float((logits.float() - plain_bf16.float()).abs().max())
    tol_bf16 = bf16_atol(plain_bf16, BF16_LOGITS_ULPS)
    # bf16 runs the tensor-core kernel (the path the eval above took). It
    # differs from the plain version by at most ~1 bf16 ulp in ~0.1% of its
    # outputs, and 32 calls through a bf16 network move the logits by a few
    # bf16 ulps and flip near-tied pixels; >= 0.99 of them must agree.
    print(f"bf16 logits {tuple(logits.shape)} finite; kernel vs plain "
          f"attention path (bf16): max_abs_err {err_bf16:.3e} "
          f"(tol {tol_bf16:.3e}), argmax agreement {agree_bf16:.6f} (>= 0.99)")
    check(err_bf16 <= tol_bf16 and agree_bf16 >= 0.99,
          "bf16 kernel path vs plain path")
    fwd, plain_fwd = [], []
    with torch.no_grad():  # kernel, plain, plain, kernel: one window
        for runs in (fwd, plain_fwd, plain_fwd, fwd):
            with contextlib.ExitStack() as stack:
                if runs is plain_fwd:
                    stack.enter_context(dual_segformer.plain_attention(model))
                runs.append(median_ms(model, rgb_t, mx_t, iters=10))
    fwd_ms, plain_fwd_ms = np.mean(fwd), np.mean(plain_fwd)
    print(f"model forward alone, batch {EVAL_BATCH} bf16 (CUDA events, host "
          f"dispatch included): {fwd[0]:.3f}/{fwd[1]:.3f} ms "
          f"({EVAL_BATCH * 1e3 / fwd_ms:.2f} img/s); on the plain attention "
          f"path {plain_fwd[0]:.3f}/{plain_fwd[1]:.3f} ms "
          f"({EVAL_BATCH * 1e3 / plain_fwd_ms:.2f} img/s)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    del model, ev, logits, plain_bf16

    # fp32, TF32 off: the kernel path against the plain path, same weights.
    # fp32 runs the scalar kernel (sr_attention_fwd_kernel<float>) only; the
    # tensor-core kernel is held by the bf16 checks above.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  use_mixed_precision=False))
    model32 = builder.build_model(cfg32, device="cuda", seed=0)
    with torch.no_grad():
        k32 = model32(rgb_t, mx_t)
        with dual_segformer.plain_attention(model32):
            p32 = model32(rgb_t, mx_t)
    err = float((k32 - p32).abs().max())
    agree = float((k32.argmax(-1) == p32.argmax(-1)).float().mean())
    # Both paths fp32 with TF32 off; only summation order differs (~1e-6
    # relative per op), compounded over ~40 layers: 1e-4 of the logit scale.
    tol = 1e-4 * max(1.0, float(p32.abs().max()))
    print(f"fp32 logits, kernel vs plain attention: max_abs_err {err:.3e} "
          f"(tol {tol:.3e}), argmax agreement {agree:.6f} (>= 0.999), "
          f"logit range {float(p32.min()):.3f}..{float(p32.max()):.3f}")
    check(err <= tol and agree >= 0.999, "fp32 kernel path vs plain path")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port is not run on the CPU",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    from rgbx_semantic_segmentation_tpu_torch import config as cfg_lib
    from rgbx_semantic_segmentation_tpu_torch import evaluator as evaluator_lib
    from rgbx_semantic_segmentation_tpu_torch.models import builder
    from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
        dual_segformer)
    from rgbx_semantic_segmentation_tpu_torch.native import build
    from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    lib = build.build("sr_attention_fwd")
    print(f"kernel build/load: {time.perf_counter() - t0:.2f} s ({lib})")
    with open(lib + ".log") as f:
        for ln in f:
            if "entry function" in ln or "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())

    err, ms, plain_ms = kernel_phase(S)
    launches = slice_phase(S, cfg_lib, builder, evaluator_lib, dual_segformer)

    print(json.dumps({"kernels": [{
        "name": "sr_attention_fwd", "route": "cuda",
        "source": "rgbx_semantic_segmentation_tpu_torch/csrc/sr_attention_fwd.cu",
        "replaces": "rgbx_semantic_segmentation_tpu/ops/sr_attention.py:104",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
