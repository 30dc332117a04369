#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root, one card

It builds the port's CUDA kernels from csrc/ with nvcc (one process per
source, started together) and holds each against its plain PyTorch version
at the shapes the models give it: the SR-attention forward and backward
(dq, dk, dv) of the MiT towers and the window-attention forward and backward
(dqkv, db; with and without the in-kernel dropout, whose mask must be the
plain version's bit for bit) of the Swin towers, on the models' layouts,
with their times beside the plain version's, a library call's
(F.scaled_dot_product_attention, a yardstick only: the port never calls it)
and the card's bound for the same work. Then it drives the port's paths
through the entry points a user would call, at the full width and depth of
the MFNet preset (480x640, batch 8, bf16, seeded random weights, synthetic
pairs made in memory), once with the preset's CMX mit_b2 + MLPDecoder and
once with backbone swin_s:

  * whole-image evaluation (SegEvaluator.evaluate), counting the forward
    kernel's launches, and holding the model's logits on the kernel path
    against the same model on the plain attention path, in bf16 (tensor-core
    kernel) and in fp32 (scalar kernel);
  * training (Trainer.fit_epoch): a few steps, counting the launches of the
    forward and the backward kernel, checking that the loss falls and that
    parameters and BatchNorm statistics move, and holding one step's loss
    and gradients on the kernel path against the plain attention path, in
    bf16 and in fp32 (for swin_s the bias tables' gradients among them).

Any failed check raises and the exit code is non-zero. Without a CUDA device
it fails; it never falls back to the CPU.

Output: human-readable lines, then a JSON line with the kernels' numbers,
then the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
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
N_IMAGES, EVAL_BATCH, HW = 16, 8, (480, 640)
# Peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate
# and device-memory rate.
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# Backward kernel against its plain version. fp32: summation order only,
# 2e-5 of the gradient's largest magnitude. bf16: 4 bf16 ulps of the
# gradient's largest magnitude; an element is a sum over up to N (dk, dv) or
# M (dq) products whose bf16 factors p and dl may each round the other way
# when fp32 summation order moves them across a rounding boundary. No
# atomics: the kernel's result is the same from run to run.
BWD_FP32_RTOL, BWD_BF16_ULPS = 2e-5, 4
TRAIN_STEPS = 4
# Calls of the window attention at each swin_s stage in one forward (2
# towers x depths (2, 2, 18, 2)); every second call is shifted (a bias block
# per window), the others share one block. The stage shapes, the window, the
# head dim, the preset's attention dropout and the input builder are those
# of tools/bench_window_attention.py (`T` below: STAGES, WS, D, RATE,
# window_inputs).
SWIN_CALLS = [4, 4, 36, 4]
# (B, Hp, Wp, h, d, ws): window 12 (swin_b, N = 144), d = 64, one image, a
# single window, a head dim the tensor-core kernels do not take, N = 256.
WINDOW_RAGGED = [(2, 24, 36, 4, 32, 12), (2, 14, 21, 2, 64, 7),
                 (1, 21, 14, 3, 32, 7), (3, 7, 7, 1, 16, 7),
                 (1, 14, 14, 2, 24, 7), (1, 16, 16, 1, 128, 16)]
# Window-attention backward against its plain version. dqkv as the SR
# backward above. db is fp32 in both versions but sums B * N products of
# bf16 inputs whose factor dl depends on bf16-rounded pd: 1e-3 of its
# largest magnitude in bf16, 2e-5 in fp32. No atomics: same bits every run.
DB_BF16_RTOL = 1e-3
SWIN_GRAD_NAMES = [
    "backbone.patch_embed.proj.weight",
    "backbone.layers.0.blocks.0.attn.qkv.weight",
    "backbone.layers.0.blocks.1.attn.relative_position_bias_table",
    "backbone.layers_d.1.blocks.0.attn.relative_position_bias_table",
    "backbone.layers.2.blocks.17.attn.relative_position_bias_table",
    "backbone.layers_d.3.blocks.1.attn.relative_position_bias_table",
    "backbone.layers.3.blocks.1.mlp.fc2.weight",
    "decode_head.linear_pred.weight"]
# swin_s, one step, kernel path against the plain composition: the plain
# path rounds q * scale to bf16 before the product and drops fp32 probs, and
# 96 window attentions lie upstream of the first stage's gradients. Two
# bounds on the gradients. Weights: 5% (predicted 1-5%; read 1.5-3.6% on the
# H100, PERF.md). Relative-position bias tables: a table's gradient is a
# small sum of B * nW * N * N cancelling terms (|g| ~ 1e-3 at the first
# stage), so rounding differences show there first; 20%, a bound taken from
# the reading (4-14%), not from the prediction (up to 10%).
SWIN_BF16_LOSS_RTOL = 5e-3
SWIN_BF16_GRAD_RTOL, SWIN_BF16_TABLE_RTOL = 0.05, 0.2
# fp32 (TF32 off): the fp32 kernels sum in another order than the plain
# composition (they are not bit-equal to it, as the SR kernels are), and a
# bias table's gradient is a small sum of B * nW * N * N cancelling terms
# behind up to 24 blocks; measured 6e-4 on the first stage's tables.
SWIN_FP32_GRAD_RTOL = 2e-3
# One train step, kernel path against plain attention path, same weights and
# batch, drop rates 0: |loss difference| / loss, and the relative L2 error of
# the gradients of the named parameters (first stage, last stage, decoder).
# bf16: the two attention paths round at different points (PERF.md section
# 2) and 32 attentions of both towers lie upstream of the first stage's
# gradients. fp32 (TF32 off): summation order only.
GRAD_NAMES = ["backbone.patch_embed1.proj.weight",
              "backbone.block1.0.attn.q.weight",
              "backbone.extra_block1.0.attn.kv.weight",
              "backbone.block4.2.attn.kv.weight",
              "backbone.block4.2.mlp.fc2.weight",
              "decode_head.linear_c1.proj.weight",
              "decode_head.linear_pred.weight"]
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 5e-3, 0.15
FP32_LOSS_RTOL, FP32_GRAD_RTOL = 1e-5, 1e-3
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

    rows = []
    for (B, h, N, M, d) in FLAGSHIP:
        q, k, v = inputs(B, h, N, M, d, torch.bfloat16)
        sc = d ** -0.5
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # plain, kernel, kernel, plain: compare within one window. Device
        # time per call: windows of 10 calls back to back.
        with torch.no_grad():
            p1 = median_ms(S.sr_attention_reference, q, k, v, sc, reps=10)
            k1 = median_ms(S.sr_attention, q, k, v, sc, reps=10)
            k2 = median_ms(S.sr_attention, q, k, v, sc, reps=10)
            p2 = median_ms(S.sr_attention_reference, q, k, v, sc, reps=10)
            lib = median_ms(lambda: sdpa(q, k, v, scale=sc), reps=10)
        bound, by = bound_ms(4 * B * h * N * M * d,
                             2 * (2 * B * h * N * d + 2 * B * h * M * d))
        rows.append({"shape": [B, h, N, M, d], "ms": (k1 + k2) / 2,
                     "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                     "bound_ms": bound, "bound_by": by})
        print(f"time bf16 fwd (B,h,N,M,d)={(B, h, N, M, d)}: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, SDPA "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return flagship_err, rows


def bound_ms(operations: float, nbytes: float):
    """Least time the card could take for bf16 work: operations at the dense
    tensor-core rate against bytes (each input read once, each output written
    once) at the device-memory rate; (ms, which one binds)."""
    t_ops = operations / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def per_step(rows, key, calls=None):
    """A per-shape reading summed over the calls of one forward (or one
    backward) of the model: the 32 SR attentions of mit_b2 by default."""
    return sum(c * r[key] for c, r in zip(calls or CALLS_PER_FORWARD, rows))


def bwd_kernel_phase(S):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(B, h, N, M, d, dtype):
        """q, k, v as the model hands them over and the cotangent as
        autograd hands it back: head-split views of (B, N, h*d) tensors and
        of the (B, M, 2, h, d) kv projection; the cotangent is non-uniform."""
        x = torch.randn(B, N, h * d, device="cuda", generator=gen).to(dtype)
        kv = torch.randn(B, M, 2, h, d, device="cuda", generator=gen).to(dtype)
        w = torch.randn(B, N, h * d, device="cuda", generator=gen).to(dtype)
        return (x.reshape(B, N, h, d).transpose(1, 2),
                kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2),
                w.reshape(B, N, h, d).transpose(1, 2))

    flagship_err = 0.0
    cases = [(s, torch.bfloat16) for s in FLAGSHIP + RAGGED] + \
            [(s, torch.float32) for s in RAGGED]
    for (B, h, N, M, d), dtype in cases:
        q, k, v, w = inputs(B, h, N, M, d, dtype)
        ref = S.sr_attention_bwd_reference(q, k, v, w, d ** -0.5)
        got = S.sr_attention_bwd(q, k, v, w, d ** -0.5)
        torch.cuda.synchronize()
        line = []
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            err = float((a.float() - b.float()).abs().max())
            tol = (bf16_atol(b, BWD_BF16_ULPS) if dtype == torch.bfloat16
                   else BWD_FP32_RTOL * max(1.0, float(b.abs().max())))
            line.append(f"{name} {err:.3e} (tol {tol:.3e})")
            check(err <= tol and bool(torch.isfinite(a).all()),
                  f"backward kernel vs plain, {name} at {(B, h, N, M, d)} "
                  f"{dtype}: {err} > {tol}")
            if (B, h, N, M, d) in FLAGSHIP:
                flagship_err = max(flagship_err, err)
        print(f"bwd kernel {str(dtype)[6:]:8s} (B,h,N,M,d)={(B, h, N, M, d)}: "
              "max_abs_err " + ", ".join(line))

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (B, h, N, M, d) in FLAGSHIP:
        q, k, v, w = inputs(B, h, N, M, d, torch.bfloat16)
        sc = d ** -0.5
        p1 = median_ms(S.sr_attention_bwd_reference, q, k, v, w, sc, reps=5)
        k1 = median_ms(S.sr_attention_bwd, q, k, v, w, sc, reps=5)
        k2 = median_ms(S.sr_attention_bwd, q, k, v, w, sc, reps=5)
        p2 = median_ms(S.sr_attention_bwd_reference, q, k, v, w, sc, reps=5)
        # The library's backward: forward + backward through autograd, minus
        # the forward alone.
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))

        def fwd_bwd():
            torch.autograd.grad(sdpa(lq, lk, lv, scale=sc), (lq, lk, lv), w)

        with torch.no_grad():
            lib_fwd = median_ms(lambda: sdpa(q, k, v, scale=sc), reps=5)
        lib = median_ms(fwd_bwd, reps=5) - lib_fwd
        bound, by = bound_ms(10 * B * h * N * M * d,
                             2 * (3 * B * h * N * d + 4 * B * h * M * d))
        rows.append({"shape": [B, h, N, M, d], "ms": (k1 + k2) / 2,
                     "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                     "bound_ms": bound, "bound_by": by})
        print(f"time bf16 bwd (B,h,N,M,d)={(B, h, N, M, d)}: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, SDPA "
              f"backward {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return flagship_err, rows


def window_bytes_and_ops(shape, shifted, backward):
    """Bytes a window attention must move (qkv and the bias read once, out
    written once; the backward also reads g and writes dqkv and db) and its
    operations (2 products forward, 5 backward)."""
    B, Hp, Wp, h, d, ws = shape
    N, nW = ws * ws, (Hp // ws) * (Wp // ws)
    pixels, C = B * Hp * Wp, h * d
    bias = (nW if shifted else 1) * h * N * N * 4
    if backward:
        nbytes = 2 * pixels * (3 * C + C + 3 * C) + bias + nW * h * N * N * 4
    else:
        nbytes = 2 * pixels * (3 * C + C) + bias
    return nbytes, (10 if backward else 4) * B * nW * h * N * N * d


def kernel_mask(W, shape, seed, rate):
    """The keep mask the forward KERNEL drew, read off its outputs: with
    q = k = 0 and a zero bias every probability is 1 / N > 0, and with v
    one-hot over d keys at a time, out[row, e] > 0 iff key e of the chunk
    was kept. bool (B, nW, h, N, N), to be equal to W.keep_mask."""
    import torch

    B, Hp, Wp, h, d, ws = shape
    N, nW = ws * ws, (Hp // ws) * (Wp // ws)
    bias = torch.zeros(1, h, N, N, device="cuda").expand(nW, -1, -1, -1)
    kept = torch.zeros(B, nW, h, N, N, dtype=torch.bool, device="cuda")
    for c0 in range(0, N, d):
        x = torch.zeros(B, nW, 3, h, N, d, device="cuda", dtype=torch.bfloat16)
        keys = torch.arange(c0, min(c0 + d, N), device="cuda")
        x[:, :, 2, :, keys, keys - c0] = 1.0
        out = W.window_attention(W._merge_windows(x, ws, Hp, Wp), bias, seed,
                                 1.0, rate, ws)
        out = W._split_windows(out, ws, 1, h)[:, :, 0]    # (B, nW, h, N, d)
        kept[..., c0:c0 + len(keys)] = out[..., :len(keys)] > 0
    return kept


def sdpa_window_inputs(W, qkv, bias, shape):
    """What the library yardstick takes: q, k, v partitioned into contiguous
    (B * nW, h, N, d) windows and the bias as a bf16 additive mask of shape
    (B * nW, h, N, N). SDPA then runs with its own dropout; the partition
    and reverse copies a library path would need are not in its time."""
    import torch

    B, _, _, h, d, ws = shape
    x = W._split_windows(qkv, ws, 3, h)
    q, k, v = (x[:, :, i].reshape(-1, h, ws * ws, d).contiguous()
               for i in range(3))
    mask = bias.to(torch.bfloat16)[None].expand(B, -1, -1, -1, -1)
    return q, k, v, mask.reshape(-1, h, ws * ws, ws * ws).contiguous()


def window_cases(T):
    import torch

    full = [(*s, T.D, T.WS) for s in T.STAGES]
    return ([(s, torch.bfloat16) for s in full + WINDOW_RAGGED]
            + [(s, torch.float32) for s in full[2:] + WINDOW_RAGGED])


def window_kernel_phase(W, T):
    """K3 against its plain version: every swin_s stage and the ragged
    shapes, unshifted and masked bias, rate 0 and 0.3; then its times,
    with the model's own shift mask in the shifted bias."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    stage_err = 0.0
    for shape, dtype in window_cases(T):
        d, ws = shape[4], shape[5]
        for shifted in (False, True):
            qkv, bias, _, seed = T.window_inputs(
                shape, dtype, "masked" if shifted else "unshifted", gen)
            line = []
            for rate in (0.0, T.RATE):
                ref = W.window_attention_reference(qkv, bias, seed, d ** -0.5,
                                                   rate, ws)
                got = W.window_attention(qkv, bias, seed, d ** -0.5, rate, ws)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                tol = bf16_atol(ref) if dtype == torch.bfloat16 else FP32_ATOL
                frac = float((got != ref).float().mean())
                line.append(f"rate {rate}: err {err:.3e} (tol {tol:.3e}), "
                            f"differing {frac:.5f}")
                check(err <= tol and bool(torch.isfinite(got).all()),
                      f"window kernel vs plain at {shape} {dtype} shifted="
                      f"{shifted} rate={rate}: {err} > {tol}")
                # Rounding points and mask in one number: a kernel that fed
                # unrounded p into p @ v, or drew another mask, differs in
                # far more of its outputs.
                if dtype == torch.bfloat16:
                    check(frac <= BF16_MISMATCH_MAX,
                          f"bf16 window kernel at {shape} rate={rate}: "
                          f"{frac} of the outputs differ from plain")
                if shape[:4] in T.STAGES and dtype == torch.bfloat16:
                    stage_err = max(stage_err, err)
            if dtype == torch.bfloat16 and shifted:
                x = W._split_windows(qkv, ws, 3, shape[3])
                _, _, v, pf, _ = W._probs(x, bias, None, d ** -0.5, 0.0)
                wrong = W._merge_windows(
                    torch.matmul(pf, v).to(dtype)[:, :, None], ws, *shape[1:3])
                got = W.window_attention(qkv, bias, None, d ** -0.5, 0.0, ws)
                right_frac = float((got != W.window_attention_reference(
                    qkv, bias, None, d ** -0.5, 0.0, ws)).float().mean())
                wrong_frac = float((got != wrong).float().mean())
                line.append(f"differing from unrounded-p plain {wrong_frac:.5f}")
                check(right_frac < wrong_frac, f"window kernel at {shape} "
                      "does not round p as the plain version does")
            print(f"window fwd {str(dtype)[6:]:8s} (B,Hp,Wp,h,d,ws)={shape} "
                  f"shifted={shifted}: " + "; ".join(line))
    # The kernel's mask, read off its outputs, against the plain mask.
    for shape in [(*T.STAGES[2], T.D, T.WS), WINDOW_RAGGED[0],
                  WINDOW_RAGGED[3], WINDOW_RAGGED[4]]:
        seed = torch.empty(1, dtype=torch.int64, device="cuda").random_(
            generator=gen)
        B, Hp, Wp, h, d, ws = shape
        want = W.keep_mask(seed, B, (Hp // ws) * (Wp // ws), h, ws * ws,
                           T.RATE)
        got = kernel_mask(W, shape, seed, T.RATE)
        share = float(got.float().mean())
        print(f"window dropout mask (B,Hp,Wp,h,d,ws)={shape}: kernel == plain "
              f"{bool(torch.equal(got, want))}, kept share {share:.4f}")
        check(bool(torch.equal(got, want)), f"kernel mask != plain at {shape}")
        # four standard deviations of a share of independent bits
        slack = 4 * (T.RATE * (1 - T.RATE) / got.numel()) ** 0.5
        check(abs(share - (1 - T.RATE)) < slack,
              f"kept share {share} not within {slack} of {1 - T.RATE}")

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for stage in T.STAGES:
        shape = (*stage, T.D, T.WS)
        B, Hp, Wp, h, d, ws = shape
        sc = d ** -0.5
        t = {}
        with torch.no_grad():
            for shifted in (True, False):
                qkv, bias, _, seed = T.window_inputs(
                    shape, torch.bfloat16,
                    "shifted" if shifted else "unshifted", gen)
                args = (qkv, bias, seed, sc, T.RATE, ws)
                # plain, kernel, kernel, plain in one window (the plain
                # version only for the shifted bias: it is slow).
                if shifted:
                    p1 = median_ms(W.window_attention_reference, *args,
                                   warmup=1, iters=3)
                k1 = median_ms(W.window_attention, *args, reps=10)
                k2 = median_ms(W.window_attention, *args, reps=10)
                if shifted:
                    p2 = median_ms(W.window_attention_reference, *args,
                                   warmup=1, iters=3)
                t[shifted] = (k1 + k2) / 2
                t[shifted, 0.0] = median_ms(W.window_attention, qkv, bias,
                                            None, sc, 0.0, ws, reps=10)
            lq, lk, lv, mask = sdpa_window_inputs(W, qkv, bias, shape)
            lib = median_ms(lambda: sdpa(lq, lk, lv, attn_mask=mask,
                                         dropout_p=T.RATE, scale=sc),
                            reps=5)
        bounds = [bound_ms(*reversed(window_bytes_and_ops(shape, sh, False)))
                  for sh in (True, False)]
        rows.append({"shape": list(shape), "ms": (t[True] + t[False]) / 2,
                     "ms_shifted": t[True], "ms_unshifted": t[False],
                     "ms_rate0": (t[True, 0.0] + t[False, 0.0]) / 2,
                     "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                     "bound_ms": (bounds[0][0] + bounds[1][0]) / 2,
                     "bound_by": bounds[0][1]})
        print(f"time bf16 window fwd (B,Hp,Wp,h,d,ws)={shape}, rate "
              f"{T.RATE}: kernel shifted {t[True]:.4f} ms, unshifted "
              f"{t[False]:.4f} ms (rate 0: {t[True, 0.0]:.4f} / "
              f"{t[False, 0.0]:.4f}), plain {p1:.3f}/{p2:.3f} ms, SDPA "
              f"{lib:.4f} ms, bound {bounds[0][0]:.4f} / {bounds[1][0]:.4f} ms "
              f"({bounds[0][1]})")
    return stage_err, rows


def window_bwd_kernel_phase(W, T):
    """K4 against its plain version (dqkv and db), same cases; two runs give
    the same bits; then its times, with the model's own shift mask."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    stage_err = 0.0
    for shape, dtype in window_cases(T):
        d, ws = shape[4], shape[5]
        for shifted in (False, True):
            qkv, bias, cot, seed = T.window_inputs(
                shape, dtype, "masked" if shifted else "unshifted", gen)
            line = []
            for rate in (0.0, T.RATE):
                args = (qkv, bias, seed, cot, d ** -0.5, rate, ws)
                ref = W.window_attention_bwd_reference(*args)
                got = W.window_attention_bwd(*args)
                again = W.window_attention_bwd(*args)
                torch.cuda.synchronize()
                for name, a, b, c in zip(("dqkv", "db"), got, ref, again):
                    err = float((a.float() - b.float()).abs().max())
                    mag = max(1.0, float(b.abs().max()))
                    if dtype == torch.float32:
                        tol = BWD_FP32_RTOL * mag
                    elif name == "dqkv":
                        tol = bf16_atol(b, BWD_BF16_ULPS)
                    else:
                        tol = DB_BF16_RTOL * float(b.abs().max())
                    line.append(f"rate {rate} {name} {err:.3e} (tol {tol:.3e})")
                    check(err <= tol and bool(torch.isfinite(a).all()),
                          f"window backward kernel vs plain, {name} at {shape} "
                          f"{dtype} shifted={shifted} rate={rate}: {err} > "
                          f"{tol}")
                    check(bool(torch.equal(a, c)),
                          f"window backward {name} differs between two runs")
                    if (shape[:4] in T.STAGES and dtype == torch.bfloat16
                            and name == "dqkv"):
                        stage_err = max(stage_err, err)
                if dtype == torch.bfloat16:
                    frac = float((got[0] != ref[0]).float().mean())
                    line.append(f"dqkv differing {frac:.4f}")
            print(f"window bwd {str(dtype)[6:]:8s} (B,Hp,Wp,h,d,ws)={shape} "
                  f"shifted={shifted}: max_abs_err " + ", ".join(line))

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for stage in T.STAGES:
        shape = (*stage, T.D, T.WS)
        B, Hp, Wp, h, d, ws = shape
        sc = d ** -0.5
        t = {}
        for shifted in (True, False):
            qkv, bias, cot, seed = T.window_inputs(
                shape, torch.bfloat16, "shifted" if shifted else "unshifted",
                gen)
            args = (qkv, bias, seed, cot, sc, T.RATE, ws)
            if shifted:
                p1 = median_ms(W.window_attention_bwd_reference, *args,
                               warmup=1, iters=3)
            k1 = median_ms(W.window_attention_bwd, *args, reps=5)
            k2 = median_ms(W.window_attention_bwd, *args, reps=5)
            if shifted:
                p2 = median_ms(W.window_attention_bwd_reference, *args,
                               warmup=1, iters=3)
            t[shifted] = (k1 + k2) / 2
        # The library's backward: forward + backward through autograd (the
        # mask's gradient too: it is the bias), minus the forward alone.
        lq, lk, lv, mask = (t.requires_grad_() for t in
                            sdpa_window_inputs(W, qkv, bias, shape))
        w = W._split_windows(cot, ws, 1, h)[:, :, 0].reshape(lq.shape)

        def fwd():
            return sdpa(lq, lk, lv, attn_mask=mask, dropout_p=T.RATE,
                        scale=sc)

        def fwd_bwd():
            torch.autograd.grad(fwd(), (lq, lk, lv, mask), w)

        with torch.no_grad():
            lib_fwd = median_ms(fwd, reps=5)
        lib = median_ms(fwd_bwd, reps=5) - lib_fwd
        bounds = [bound_ms(*reversed(window_bytes_and_ops(shape, sh, True)))
                  for sh in (True, False)]
        rows.append({"shape": list(shape), "ms": (t[True] + t[False]) / 2,
                     "ms_shifted": t[True], "ms_unshifted": t[False],
                     "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                     "bound_ms": (bounds[0][0] + bounds[1][0]) / 2,
                     "bound_by": bounds[0][1]})
        print(f"time bf16 window bwd (B,Hp,Wp,h,d,ws)={shape}, rate "
              f"{T.RATE}: kernel shifted {t[True]:.4f} ms, unshifted "
              f"{t[False]:.4f} ms, plain {p1:.3f}/{p2:.3f} ms, SDPA backward "
              f"{lib:.4f} ms, bound {bounds[0][0]:.4f} / {bounds[1][0]:.4f} ms "
              f"({bounds[0][1]})")
    return stage_err, rows


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
    model = builder.build_model(cfg, seed=0)   # device=None: the card
    ev = evaluator_lib.SegEvaluator(cfg, model)
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

    pairs = [ev.prepare(it["rgb"], it["modal_x"])
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
    model32 = builder.build_model(cfg32, seed=0)
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
    del model32, k32, p32
    torch.cuda.empty_cache()
    return launches, items


def uint8_batches(items, batch):
    """The trainer's input: uint8 NHWC batches (modal_x replicated to three
    channels, as the dataset does), normalised on the device by the step."""
    out = []
    for i in range(0, len(items), batch):
        group = items[i:i + batch]
        out.append({
            "rgb": np.stack([it["rgb"] for it in group]),
            "modal_x": np.stack([np.stack([it["modal_x"]] * 3, axis=-1)
                                 for it in group]),
            "label": np.stack([it["label"] for it in group])})
    return out


class LossLog:
    """A logger for fit_epoch that keeps the losses it is told."""

    def __init__(self):
        self.losses = []

    def info(self, fmt, *args):
        self.losses.append(float(args[3]))
        print("  " + fmt % args)


def cycle(batches):
    while True:
        yield from batches


def one_step_losses_and_grads(train_lib, encoder, cfg, batch, names,
                              prepare=None):
    """One Trainer.step from seed-0 weights on the kernel path and one on
    the plain attention path (`encoder.plain_attention`): (loss, {name:
    gradient}) of each. The step leaves its gradients in .grad. `prepare`
    is applied to each fresh model first."""
    import torch

    out = []
    for plain in (False, True):
        trainer = train_lib.Trainer(cfg, seed=0)
        if prepare is not None:
            prepare(trainer.model)
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(encoder.plain_attention(trainer.model))
            loss = float(trainer.step(batch)["loss"])
        named = dict(trainer.model.named_parameters())
        out.append((loss, {n: named[n].grad.float().clone() for n in names}))
        del trainer, named
        torch.cuda.empty_cache()
    return out


def profile_steps(trainer, data, steps=2, top=12):
    """Device kernels and device time of one step, by the profiler (its
    host overhead makes its wall time meaningless; the counts and device
    times hold). Returns (kernels per step, device ms per step) or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.fit_epoch(data, steps)
        torch.cuda.synchronize()
    # Kernels and copies only: ranges such as Optimizer.step are mirrored
    # onto the device timeline as annotations spanning their kernels.
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)
          and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    if not ev or sum(e.device_time_total for e in ev) <= 0:
        print("profiler: no device time recorded")
        return None
    total = sum(e.device_time_total for e in ev) / (steps * 1e3)
    count = sum(e.count for e in ev) // steps
    print(f"profiler: {count} device kernels and {total:.2f} ms of device "
          "time per step; by device time:")
    for e in sorted(ev, key=lambda e: -e.device_time_total)[:top]:
        print(f"  {e.device_time_total / (steps * 1e3):8.3f} ms "
              f"{e.count // steps:5d}x {e.key[:90]}")
    return count, total


def compare_step(tag, kernel, plain, loss_rtol, grad_rtol, names=None,
                 table_rtol=None):
    """`table_rtol`, where given, is the bound of the relative-position bias
    tables among `names`; `grad_rtol` bounds the others."""
    names = names or GRAD_NAMES
    (lk, gk), (lp, gp) = kernel, plain
    rel = abs(lk - lp) / abs(lp)
    print(f"{tag} one step, kernel path vs plain attention path: loss "
          f"{lk:.6f} vs {lp:.6f} (rel {rel:.2e}, bound {loss_rtol:.0e})")
    check(np.isfinite(lk) and rel <= loss_rtol, f"{tag} step loss")
    worst = 0.0
    for name in names:
        err = float((gk[name] - gp[name]).norm() / gp[name].norm())
        worst = max(worst, err)
        bound = grad_rtol
        if table_rtol and name.endswith("relative_position_bias_table"):
            bound = table_rtol
        print(f"  grad {name}: rel L2 err {err:.3e} (bound {bound:.0e}), "
              f"|g| {float(gp[name].norm()):.3e}")
        check(np.isfinite(err) and err <= bound,
              f"{tag} gradient of {name}: {err} > {bound}")
    return rel, worst


def train_phase(S, cfg_lib, train_lib, dual_segformer, items):
    import torch

    cfg = cfg_lib.mfnet_config()
    # No warm-up: WarmUpPolyLR is 0 at step 0, and these few steps should
    # move the weights at the preset's lr.
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, warm_up_epoch=0))
    batches = uint8_batches(items, cfg.train.batch_size)
    check(len(batches) == 2 and batches[0]["rgb"].shape == (8, *HW, 3),
          "two synthetic uint8 batches of 8")
    trainer = train_lib.Trainer(cfg, seed=0)   # device=None: the card
    model = trainer.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    data = cycle(batches)
    log = LossLog()
    print("train: warm-up, 2 steps")
    trainer.fit_epoch(data, 2, log_every=1, logger=log)

    S.sr_attention.launches = 0
    S.sr_attention_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    mean_loss = trainer.fit_epoch(data, TRAIN_STEPS)
    b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches = S.sr_attention.launches
    bwd_launches = S.sr_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ev_ms = a.elapsed_time(b) / TRAIN_STEPS
    bs = cfg.train.batch_size
    print(f"train: {TRAIN_STEPS} steps of batch {bs} at {HW}, bf16: "
          f"{ev_ms:.2f} ms/step (CUDA events), {wall * 1e3 / TRAIN_STEPS:.2f} "
          f"ms/step (wall), {bs * TRAIN_STEPS / wall:.2f} img/s, mean loss "
          f"{mean_loss:.4f}, peak memory {peak:.2f} GiB; kernel launches "
          f"forward {fwd_launches}, backward {bwd_launches} "
          f"(expected {32 * TRAIN_STEPS} each)")
    check(fwd_launches == 32 * TRAIN_STEPS and bwd_launches == 32 * TRAIN_STEPS,
          f"launches {fwd_launches}/{bwd_launches} != 32 x {TRAIN_STEPS}")
    check(np.isfinite(mean_loss), "mean loss is finite")
    print("train: 2 more steps")
    trainer.fit_epoch(data, 2, log_every=1, logger=log)
    check(all(np.isfinite(x) for x in log.losses), "every loss is finite")
    # Steps 0 and 8 both see batch 0.
    print(f"train: loss on batch 0 at step 0 {log.losses[0]:.4f}, at step "
          f"{TRAIN_STEPS + 2} {log.losses[2]:.4f}")
    check(log.losses[2] < log.losses[0], "the loss fell on the repeated batch")
    after = model.state_dict()
    moved = [k for k, v in after.items() if v.is_floating_point()
             and not torch.equal(v, before[k])]
    stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    n_float = sum(v.is_floating_point() for v in after.values())
    print(f"train: {len(moved)} of {n_float} float tensors changed, "
          f"{len(stats)} of them BatchNorm running statistics")
    # A bias in front of a BatchNorm has a zero true gradient and may stay.
    check(len(moved) >= 0.95 * n_float and len(stats) == 18,
          "the parameters and every BatchNorm statistic moved")

    # Kernel path against plain path, same trainer: windows of 2 steps,
    # kernel, plain, plain, kernel; peak memory of the plain path.
    def steps_ms(n=2):
        x = torch.cuda.Event(enable_timing=True)
        y = torch.cuda.Event(enable_timing=True)
        x.record()
        trainer.fit_epoch(data, n)
        y.record()
        y.synchronize()
        return x.elapsed_time(y) / n

    k1 = steps_ms()
    torch.cuda.reset_peak_memory_stats()
    with dual_segformer.plain_attention(model):
        steps_ms(1)
        p1, p2 = steps_ms(), steps_ms()
    plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k2 = steps_ms()
    step_ms, plain_step_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"train step (CUDA events, host dispatch included): kernel path "
          f"{k1:.2f}/{k2:.2f} ms ({bs * 1e3 / step_ms:.2f} img/s, peak "
          f"{peak:.2f} GiB); plain attention path {p1:.2f}/{p2:.2f} ms "
          f"({bs * 1e3 / plain_step_ms:.2f} img/s, peak {plain_peak:.2f} GiB)")

    profile_steps(trainer, data)
    del trainer, model, before, after
    torch.cuda.empty_cache()

    # One step with drop rates 0, kernel path against plain path.
    cfg0 = cfg.replace(model=dataclasses.replace(
        cfg.model, drop_path_rate=0.0, decoder_dropout_ratio=0.0))
    bf16 = compare_step(
        "bf16", *one_step_losses_and_grads(train_lib, dual_segformer, cfg0,
                                           batches[0], GRAD_NAMES),
        BF16_LOSS_RTOL, BF16_GRAD_RTOL)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg0.replace(model=dataclasses.replace(
        cfg0.model, use_mixed_precision=False))
    fp32 = compare_step(
        "fp32 (TF32 off)", *one_step_losses_and_grads(
            train_lib, dual_segformer, cfg32, batches[0], GRAD_NAMES),
        FP32_LOSS_RTOL, FP32_GRAD_RTOL)
    return {"fwd_launches": fwd_launches, "bwd_launches": bwd_launches,
            "step_ms": step_ms, "plain_step_ms": plain_step_ms,
            "img_per_s": bs * 1e3 / step_ms, "peak_gib": peak,
            "plain_peak_gib": plain_peak, "bf16_loss_rel": bf16[0],
            "bf16_grad_rel": bf16[1], "fp32_loss_rel": fp32[0],
            "fp32_grad_rel": fp32[1]}


def swin_cfg(cfg_lib):
    cfg = cfg_lib.mfnet_config()
    return cfg.replace(model=dataclasses.replace(cfg.model, backbone="swin_s"))


def swin_eval_phase(S, W, T, cfg_lib, builder, evaluator_lib, dual_swin, items):
    """SegEvaluator.evaluate on swin_s + MLPDecoder at full width and depth,
    counting K3's launches (48 per forward; no SR attention runs), and the
    logits of the kernel path against the plain composition in bf16."""
    import torch

    cfg = swin_cfg(cfg_lib)
    model = builder.build_model(cfg, seed=0)
    blocks = [m for m in model.modules() if isinstance(m, dual_swin.SwinBlock)]
    check(len(blocks) == 48 and blocks[0].attn.attn_drop.rate == T.RATE
          and blocks[0].attn.qkv.in_features == 96
          and blocks[-1].attn.num_heads == 24, "swin_s at full width and depth")
    ev = evaluator_lib.SegEvaluator(cfg, model)
    ev.evaluate(items[:EVAL_BATCH], eval_batch=EVAL_BATCH)  # warm-up

    W.window_attention.launches = 0
    W.window_attention_bwd.launches = 0
    S.sr_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, line = ev.evaluate(items, eval_batch=EVAL_BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = W.window_attention.launches
    forwards = N_IMAGES // EVAL_BATCH
    print(f"swin_s eval: {N_IMAGES} images, {forwards} forwards of batch "
          f"{EVAL_BATCH}, {launches} window-attention launches (expected "
          f"{48 * forwards}), {N_IMAGES / dt:.2f} img/s ({dt:.3f} s, host "
          "normalisation included)")
    check(launches == 48 * forwards and W.window_attention_bwd.launches == 0
          and S.sr_attention.launches == 0,
          f"{launches} window launches != 48 x {forwards}")
    print(line.splitlines()[-1])
    check(np.isfinite(scores.pixel_acc), "pixel_acc is finite")

    pairs = [ev.prepare(it["rgb"], it["modal_x"])
             for it in items[:EVAL_BATCH]]
    rgb_t = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    mx_t = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    with torch.no_grad():
        logits = model(rgb_t, mx_t)
        with dual_swin.plain_attention(model):
            plain = model(rgb_t, mx_t)
    check(logits.shape == (EVAL_BATCH, *HW, cfg.dataset.num_classes)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()), f"logits {logits.shape}")
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    err = float((logits.float() - plain.float()).abs().max())
    # The plain composition rounds q * scale to bf16 before q k^T; the
    # kernel scales the fp32 logits. 48 attentions a tower: a few more bf16
    # ulps at the logit scale than the MiT paths, same argmax bound.
    tol = bf16_atol(plain, 2 * BF16_LOGITS_ULPS)
    print(f"swin_s bf16 logits {tuple(logits.shape)} finite; kernel vs plain "
          f"composition: max_abs_err {err:.3e} (tol {tol:.3e}), argmax "
          f"agreement {agree:.6f} (>= 0.99)")
    check(err <= tol and agree >= 0.99, "swin_s bf16 kernel vs plain path")
    fwd, plain_fwd = [], []
    with torch.no_grad():  # kernel, plain, plain, kernel: one window
        for runs in (fwd, plain_fwd, plain_fwd, fwd):
            with contextlib.ExitStack() as stack:
                if runs is plain_fwd:
                    stack.enter_context(dual_swin.plain_attention(model))
                runs.append(median_ms(model, rgb_t, mx_t, iters=6))
    print(f"swin_s forward alone, batch {EVAL_BATCH} bf16 (CUDA events, host "
          f"dispatch included): {fwd[0]:.3f}/{fwd[1]:.3f} ms "
          f"({EVAL_BATCH * 1e3 / np.mean(fwd):.2f} img/s); on the plain "
          f"composition {plain_fwd[0]:.3f}/{plain_fwd[1]:.3f} ms; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, ev, logits, plain
    torch.cuda.empty_cache()
    return {"launches": launches, "img_per_s": N_IMAGES / dt,
            "forward_ms": float(np.mean(fwd)),
            "plain_forward_ms": float(np.mean(plain_fwd))}


def swin_train_phase(S, W, T, cfg_lib, train_lib, dual_swin, items):
    """Trainer.fit_epoch on swin_s with the preset's drop rates (attention
    dropout 0.3 inside K3 and K4, drop-path 0.1), counting the launches of
    both kernels; then one step with every drop rate 0 on the kernel path
    against the plain composition, in bf16 and in fp32."""
    import torch

    cfg = swin_cfg(cfg_lib)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, warm_up_epoch=0))
    batches = uint8_batches(items, cfg.train.batch_size)
    trainer = train_lib.Trainer(cfg, seed=0)
    model = trainer.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    data = cycle(batches)
    log = LossLog()
    print("swin_s train: warm-up, 2 steps")
    trainer.fit_epoch(data, 2, log_every=1, logger=log)

    W.window_attention.launches = 0
    W.window_attention_bwd.launches = 0
    S.sr_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    mean_loss = trainer.fit_epoch(data, TRAIN_STEPS)
    b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches = W.window_attention.launches
    bwd_launches = W.window_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ev_ms = a.elapsed_time(b) / TRAIN_STEPS
    bs = cfg.train.batch_size
    print(f"swin_s train: {TRAIN_STEPS} steps of batch {bs} at {HW}, bf16, "
          f"attention dropout {T.RATE}: {ev_ms:.2f} ms/step (CUDA events), "
          f"{wall * 1e3 / TRAIN_STEPS:.2f} ms/step (wall), "
          f"{bs * TRAIN_STEPS / wall:.2f} img/s, mean loss {mean_loss:.4f}, "
          f"peak memory {peak:.2f} GiB; window-attention launches forward "
          f"{fwd_launches}, backward {bwd_launches} (expected "
          f"{48 * TRAIN_STEPS} each)")
    check(fwd_launches == 48 * TRAIN_STEPS and bwd_launches == 48 * TRAIN_STEPS
          and S.sr_attention.launches == 0,
          f"launches {fwd_launches}/{bwd_launches} != 48 x {TRAIN_STEPS}")
    check(np.isfinite(mean_loss), "mean loss is finite")
    print("swin_s train: 2 more steps")
    trainer.fit_epoch(data, 2, log_every=1, logger=log)
    check(all(np.isfinite(x) for x in log.losses), "every loss is finite")
    print(f"swin_s train: loss on batch 0 at step 0 {log.losses[0]:.4f}, at "
          f"step {TRAIN_STEPS + 2} {log.losses[2]:.4f}")
    check(log.losses[2] < log.losses[0], "the loss fell on the repeated batch")
    after = model.state_dict()
    moved = [k for k, v in after.items() if v.is_floating_point()
             and not torch.equal(v, before[k])]
    tables = [k for k in after if k.endswith("relative_position_bias_table")]
    n_float = sum(v.is_floating_point() for v in after.values())
    print(f"swin_s train: {len(moved)} of {n_float} float tensors changed, "
          f"{len(set(tables) & set(moved))} of {len(tables)} bias tables")
    check(len(moved) >= 0.95 * n_float and len(tables) == 48
          and set(tables) <= set(moved),
          "the parameters and every relative-position bias table moved")

    def steps_ms(n=2):
        x = torch.cuda.Event(enable_timing=True)
        y = torch.cuda.Event(enable_timing=True)
        x.record()
        trainer.fit_epoch(data, n)
        y.record()
        y.synchronize()
        return x.elapsed_time(y) / n

    k1 = steps_ms()
    torch.cuda.reset_peak_memory_stats()
    with dual_swin.plain_attention(model):
        steps_ms(1)
        p1, p2 = steps_ms(), steps_ms()
    plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k2 = steps_ms()
    step_ms, plain_step_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"swin_s train step (CUDA events, host dispatch included): kernel "
          f"path {k1:.2f}/{k2:.2f} ms ({bs * 1e3 / step_ms:.2f} img/s, peak "
          f"{peak:.2f} GiB); plain composition {p1:.2f}/{p2:.2f} ms "
          f"({bs * 1e3 / plain_step_ms:.2f} img/s, peak {plain_peak:.2f} GiB)")
    prof = profile_steps(trainer, data)
    del trainer, model, before, after
    torch.cuda.empty_cache()

    def no_drop(m):
        for mod in m.modules():
            if isinstance(mod, dual_swin.WindowAttention):
                mod.attn_drop.rate = 0.0

    cfg0 = cfg.replace(model=dataclasses.replace(
        cfg.model, drop_path_rate=0.0, decoder_dropout_ratio=0.0))
    bf16 = compare_step(
        "swin_s bf16", *one_step_losses_and_grads(
            train_lib, dual_swin, cfg0, batches[0], SWIN_GRAD_NAMES, no_drop),
        SWIN_BF16_LOSS_RTOL, SWIN_BF16_GRAD_RTOL, SWIN_GRAD_NAMES,
        SWIN_BF16_TABLE_RTOL)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg0.replace(model=dataclasses.replace(
        cfg0.model, use_mixed_precision=False))
    fp32 = compare_step(
        "swin_s fp32 (TF32 off)", *one_step_losses_and_grads(
            train_lib, dual_swin, cfg32, batches[0], SWIN_GRAD_NAMES, no_drop),
        FP32_LOSS_RTOL, SWIN_FP32_GRAD_RTOL, SWIN_GRAD_NAMES)
    return {"fwd_launches": fwd_launches, "bwd_launches": bwd_launches,
            "step_ms": step_ms, "plain_step_ms": plain_step_ms,
            "img_per_s": bs * 1e3 / step_ms, "peak_gib": peak,
            "plain_peak_gib": plain_peak,
            "device_kernels": prof[0] if prof else None,
            "device_ms": prof[1] if prof else None,
            "bf16_loss_rel": bf16[0], "bf16_grad_rel": bf16[1],
            "fp32_loss_rel": fp32[0], "fp32_grad_rel": fp32[1]}


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
    from rgbx_semantic_segmentation_tpu_torch import train as train_lib
    from rgbx_semantic_segmentation_tpu_torch.models import builder
    from rgbx_semantic_segmentation_tpu_torch.models.encoders import (
        dual_segformer, dual_swin)
    from rgbx_semantic_segmentation_tpu_torch.native import build
    from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S
    from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as W
    from rgbx_semantic_segmentation_tpu_torch.tools import (
        bench_window_attention as T)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {name}: {lib}")
        with open(lib + ".log") as f:
            text = f.read()
        regs = sorted(int(n) for n in re.findall(r"Used (\d+) registers", text))
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", text))
        print(f"  ptxas: {len(regs)} kernels, registers {regs}, "
              f"{spills} bytes of spills")

    fwd_err, fwd_rows = kernel_phase(S)
    bwd_err, bwd_rows = bwd_kernel_phase(S)
    for tag, rows in (("forward", fwd_rows), ("backward", bwd_rows)):
        print(f"SR attention {tag}, the 32 calls of a step: kernel "
              f"{per_step(rows, 'ms'):.3f} ms, plain "
              f"{per_step(rows, 'plain_ms'):.3f} ms, SDPA "
              f"{per_step(rows, 'library_ms'):.3f} ms, bound "
              f"{per_step(rows, 'bound_ms'):.3f} ms")
    wfwd_err, wfwd_rows = window_kernel_phase(W, T)
    wbwd_err, wbwd_rows = window_bwd_kernel_phase(W, T)
    for tag, rows in (("forward", wfwd_rows), ("backward", wbwd_rows)):
        print(f"window attention {tag}, the 48 calls of a step at rate "
              f"{T.RATE}: kernel {per_step(rows, 'ms', SWIN_CALLS):.3f} ms, "
              f"plain {per_step(rows, 'plain_ms', SWIN_CALLS):.3f} ms, SDPA "
              f"{per_step(rows, 'library_ms', SWIN_CALLS):.3f} ms, bound "
              f"{per_step(rows, 'bound_ms', SWIN_CALLS):.3f} ms")
    eval_launches, items = slice_phase(S, cfg_lib, builder, evaluator_lib,
                                       dual_segformer)
    train = train_phase(S, cfg_lib, train_lib, dual_segformer, items)
    swin_eval = swin_eval_phase(S, W, T, cfg_lib, builder, evaluator_lib,
                                dual_swin, items)
    swin_train = swin_train_phase(S, W, T, cfg_lib, train_lib, dual_swin,
                                  items)
    print(card)

    def kernel_entry(name, replaces, launches, err, rows, calls):
        # Times are those of the calls of one forward (backward) of the
        # model that runs the kernel (32 for mit_b2, 48 for swin_s);
        # `per_call` has them per shape.
        return {"name": name, "route": "cuda",
                "source": f"rgbx_semantic_segmentation_tpu_torch/csrc/{name}.cu",
                "replaces": f"rgbx_semantic_segmentation_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err,
                "ms": per_step(rows, "ms", calls),
                "plain_ms": per_step(rows, "plain_ms", calls),
                "bound_ms": per_step(rows, "bound_ms", calls),
                "bound_by": max(("operations", "bytes"), key=lambda by: sum(
                    c * r["bound_ms"] for c, r in zip(calls, rows)
                    if r["bound_by"] == by)),
                "library_ms": per_step(rows, "library_ms", calls),
                "per_call": rows}

    print(json.dumps({"kernels": [
        kernel_entry("sr_attention_fwd", "sr_attention.py:104",
                     eval_launches + train["fwd_launches"], fwd_err, fwd_rows,
                     CALLS_PER_FORWARD),
        kernel_entry("sr_attention_bwd", "sr_attention.py:123",
                     train["bwd_launches"], bwd_err, bwd_rows,
                     CALLS_PER_FORWARD),
        kernel_entry("window_attention_fwd", "window_attention.py:179",
                     swin_eval["launches"] + swin_train["fwd_launches"],
                     wfwd_err, wfwd_rows, SWIN_CALLS),
        kernel_entry("window_attention_bwd", "window_attention.py:205",
                     swin_train["bwd_launches"], wbwd_err, wbwd_rows,
                     SWIN_CALLS)],
        "eval_launches": eval_launches, "train": train,
        "swin_eval": swin_eval, "swin_train": swin_train, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
