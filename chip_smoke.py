#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --ddp 4    # the data-parallel part alone, 4 cards

It builds the port's CUDA kernels from csrc/ with nvcc (one process per
source, started together) and holds each against its plain PyTorch version
at the shapes the models give it: the SR-attention forward and backward
(dq, dk, dv) of the MiT towers and the window-attention forward and backward
(dqkv, db; with and without the in-kernel dropout, whose mask must be the
plain version's bit for bit) of the Swin towers, and the long-kv flash
attention (forward, dk/dv and dq kernels) of the IFFM cross-attention of
the mit_*pp family and of SegNeXt (its narrow heads: segnext_b's d = 8, 16,
40, segnext_large's 12, 24, 48, and the padded route of d = 4, 12 and 20;
K1/K2 at segnext_tiny's and segnext_large's stage 4, d = 32 and 96), on the
models' layouts,
with their times beside the plain version's, a library call's
(F.scaled_dot_product_attention, a yardstick only: the port never calls it)
and the card's bound for the same work. Then it drives the port's paths
through the entry points a user would call, at the full width and depth of
the MFNet preset (480x640, batch 8, bf16, seeded random weights, synthetic
pairs made in memory), with the preset's CMX mit_b2 + MLPDecoder, with
backbone swin_s and with backbone mit_b2pp (IFRM/IFFM), then the pst900
and nyu presets:

  * whole-image evaluation (SegEvaluator.evaluate), counting the forward
    kernel's launches, and holding the model's logits on the kernel path
    against the same model on the plain attention path, in bf16 (tensor-core
    kernel) and in fp32 (scalar kernel);
  * training (Trainer.fit_epoch): a few steps, counting the launches of the
    forward and the backward kernel, checking that the loss falls and that
    parameters and BatchNorm statistics move, and holding one step's loss
    and gradients on the kernel path against the plain attention path, in
    bf16 and in fp32 (for swin_s the bias tables' gradients among them;
    for mit_b2pp the IFFM projections' among them, its fp32 runs at batch 2:
    the fp32 flash kernels are scalar and N does not depend on the batch);
  * the CLIs, with the preset's mit_b2 on a synthetic MFNet-shaped dataset
    written to a temporary directory (16 train and 8 val PNG triples at
    480x640): the TrainLoader alone (native and numpy image ops, pinned
    batches or not) and feeding Trainer.fit_epoch (against the same trainer
    on batches held in memory), over epochs of 16 batches, each rate read
    steady over batches 2..16 and over the whole epoch; a checkpoint's
    write and restore (the optimizer's moments on the card, its step
    counters fp32 CPU scalars), train_cli for 2 epochs of 3 steps then -c
    to 3 with the last epoch under torch.profiler (the device's idle
    share), two uninterrupted 3-epoch runs (the resumed run must lie as
    close to one as the two lie to each other: the step is not
    bit-reproducible on the card), one train_cli epoch of 16 steps (its
    steady rate over steps 2..16 and the device's idle share estimated
    from it), eval_cli -e last (its confusion matrix equal to evaluate()'s on
    the same weights) and predict_cli -e last (its PNGs equal to the
    eval's argmax), counting the forward and backward kernels' launches
    over the CLI calls;
  * the pst900 preset (mit_b2_w_aspp: an ASPP on each stage's fused map;
    UPernet with the aux FCNHead, whose loss weighs 0.4; 5 classes) at full
    width and depth: the same eval and train checks as the mit_b2 preset
    (its named gradients include the ASPP, the UPerHead and the aux head;
    both paths draw the same ASPP dropout masks from the step's generator),
    and the decode and aux heads' device time against the forward's;
  * the nyu preset's protocol with flip (scales 0.75, 1, 1.25, the sliding
    grid; mit_b2 + MLPDecoder, 40 classes, 3-channel X) on 480x640 and
    720x960 items: evaluate(eval_batch=8)'s maps equal per-image
    sliding_eval_rgbx's, K1's launches equal 32 x the forwards the grid
    predicts, argmax agreement of the kernel and the plain attention path;
    eval_cli --compat-stride-swap against an in-process evaluator;
  * train_cli --config pst900 for one short epoch on a synthetic 5-class
    PNG dataset, then eval_cli -e last (its confusion matrix equal to
    evaluate()'s);
  * the preset's mit_b2 with the mask2former head (100 queries, the FPN
    pixel decoder, 9 decoder layers; its own loss on the query dict in
    training, its semantic inference's fp32 log-scores in evaluation): the
    eval and train checks above, the bf16 kernel path held to the fp32
    plain path (its loss assigns pixels to queries by an argmax), the
    head's share of the forward's device time, then train_cli --decoder
    mask2former for one short epoch and eval_cli (its confusion matrix
    equal to evaluate()'s); with the MLPDecoderpp head: the eval and train
    checks (2 counted steps);
  * segnext_b + MLPDecoder (MSCA towers, IFRM/IFFM at every stage: K5 6
    and K1/K2 2 a forward and backward), through the eval and train
    checks of mit_b2pp: evaluate() on 16 images, K5 on the model's own
    activations and cotangents, the bf16 logits held to the fp32 plain
    path, 4 counted train steps with their launches, the loss falling,
    every BatchNorm statistic and IFRM/IFFM tensor moving, step ms on
    both paths, peak, the profiler's device time and top operations, one
    step's loss and gradients in bf16 held to the fp32 plain path, fp32
    paths at batch 2; then resnet50 + UPernet (the preset's FRM/FFM: no
    attention kernel): evaluate(), 3 counted steps with no launch, the
    main and aux losses, the device time, and the card's fp32 forward
    (TF32 off, batch 1) held to the CPU's on the same weights;
  * segnext_tiny and segnext_large: evaluate() and 2 counted steps each,
    K1/K2 2 and K5 6 launches a forward / backward;
  * the tools: tools/check_gpu as a program (rc 0, its exact matmul line),
    ops/resize.resize_nearest on the card equal to the CPU on (8, 480,
    640) uint8 labels, tools/bench_input's host ms (read, not held);
  * every criterion name of build_criterion and the Mask2Former loss on
    (8, 480, 640, 9) logits (masks (8, 100, 480, 640)) against the same
    function on the CPU: loss and gradient, OHEM and the Mask2Former loss
    twice bit-equal, their device time forward + backward, the component
    count's rounds;
  * swin_b end to end (window 12) with the absolute position embedding
    (its 96x96 grid bicubic-resized to the 120x160 tokens), frozen stages
    2 (the patch embeds, the embeddings and stage 0 of both towers) and
    SGD with momentum under CyclicLR: K3 and K4 at swin_b's four stage
    shapes against their plain versions (K4 on its cluster kernel for
    bf16 N = 144, its mask and route checked; time, SDPA, bound),
    evaluate() (K3 48 a forward), 3
    train steps (K3 48 and K4 44 a step: stage 0 launches no backward; the
    optimizer's lr and momentum the schedule's at each step; frozen
    parameters bit-unchanged, the others moved), step and device time,
    peak memory, and one step with drop rates 0 on the kernel path, bf16,
    held to the fp32 plain composition;
  * remat (activation checkpointing of every block) off and on for mit_b2
    and swin_s: launches a step (K1 64 with remat: the recompute; swin_s
    K3 96), step ms and peak memory of both, and the first step's loss and
    gradients with every preset drop rate on held to the spread of two
    runs without remat;
  * L-BFGS (the port's optax.lbfgs with its zoom line search) on mit_b2:
    2 steps, the line search's evaluations a step (K1 and K2 launching
    32 x (1 + evaluations)), the loss falling along each step, the
    BatchNorm running statistics equal to one forward's, step ms, the
    optimizer's memory and the peak;
  * data parallelism at world 1: Trainer through the launcher
    (parallel/launch.py) as one NCCL rank, with the synced BatchNorm and
    the summed gradient all-reduce, 3 steps of mit_b2 at global batch 8
    against two plain one-process Trainers from the same seed (held to the
    resume bound: the card's step is not bit-reproducible), K1 and K2
    launching 32 times a step in the rank; OHEM and berHu through their
    over-ranks functions (NCCL all-gather, all-reduce MAX and its
    backward) against the same criteria in one process.

`--ddp N` runs only the N-card part, and fails when fewer cards are
visible: K1-K4 at the shapes a rank hands them (8 / N images) against their
plain versions; train_cli over the N cards (one rank a card) at global
batch 8 and 32 against one card at 8, drop rates 0 (steady img/s, each
rank's peak memory, its K1/K2 launches; fp32 epochs too, whose loss is
held within the spread of three one-card runs), eval_cli over the N cards
(one image a forward) against one card (the same confusion matrix), the
NCCL all-reduce's share of a mit_b2 step's device time on rank 0
(torch.profiler), swin_s steps at attention
dropout 0.3 (K3/K4 launches per rank, ranks 0 and 1 drawing different
masks), OHEM and berHu over the N ranks (their order statistics gathered
across the cards; the largest residual tied across ranks in one case)
against one card on the global batch, and the first-step gradient over the
N ranks against one card on a
batch whose ranks ignore different counts of pixels (fp32; bounded by
one-card readings, which DDP's default per-rank mean must miss).

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
import shutil
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
# The first mit_b2 stage of a whole 720x1280 frame: M = 22 * 40 = 880, the
# two-pass tensor-core forward. Checked, not timed.
LARGE_FRAME = [(2, 1, 57600, 880, 64)]
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
# pst900 (mit_b2_w_aspp + UPernet + the aux FCNHead): gradients of the
# towers, the per-stage ASPPs, the UPerHead and the aux head. At seeded
# weights its bf16 step is ill-conditioned: the bf16 plain path itself lies
# 0.10-0.18 (relative L2) from the fp32 plain path on the towers' and the
# aux head's gradients (read on the H100, PERF.md section 6), so two bf16
# paths cannot be held to BF16_GRAD_RTOL of each other; its bf16 kernel
# path is held to the fp32 plain path as mit_b2pp's is (PP_TRUTH_FACTOR).
# fp32 keeps the mit_b2 bounds.
PST_GRAD_NAMES = ["backbone.patch_embed1.proj.weight",
                  "backbone.block1.0.attn.q.weight",
                  "backbone.block4.2.mlp.fc2.weight",
                  "backbone.aspp_modules.0.b1.block.0.weight",
                  "backbone.aspp_modules.3.project.0.weight",
                  "decode_head.psp_modules.3.1.weight",
                  "decode_head.fpn_bottleneck.0.weight",
                  "decode_head.conv_seg.weight",
                  "aux_head.conv.0.weight",
                  "aux_head.classifier.weight"]
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 5e-3, 0.15
FP32_LOSS_RTOL, FP32_GRAD_RTOL = 1e-5, 1e-3
# bf16 logits, tensor-core kernel path vs plain path: bf16 ulps at the
# logit scale (max |plain logit|). Measured 2 on the H100 (PERF.md).
BF16_LOGITS_ULPS = 4


# Long-kv flash attention (K5) against its plain version. The ragged cases:
# N and M not multiples of the tiles, M = 1025, d = 32 / 40 / 128, h > 1,
# B = 1, a single tile, N, M one row either side of the forward's blocks of
# 192 (d = 128: 128) q rows and kv tiles of 128 (64) rows, and kv walks of
# 33 tiles or more, which the forward splits across a cluster of blocks
# (d = 128 too). bf16 forward: the online softmax rounds p against the
# running max, the plain version against the row max, so each p_j carries
# another rounding error of <= 2^-9 p_j in the two. Over a row these errors
# add up like noise of size 2^-9 R, R = sqrt(sum_j p_j^2 v_j^2) (about |out|
# itself where v has random signs), and the output's own rounding adds an ulp.
# Bound of every output element: FLASH_FWD_ULPS bf16 ulps of the element
# itself plus FLASH_FWD_NOISE * 2^-8 * R of its row and column (13 sigma of
# that noise), so the bound scales with the outputs (0.01 at the first
# mit_b2pp stage, where sum_j p_j |v_j| is 0.8); and of the whole tensor:
# relative L2 error <= FLASH_REL_L2 (a model of the two roundings on the CPU
# gives 0.0014-0.0025 and element errors up to half the bound; an output 2%
# off fails both). That holds where q, k, v are independent draws. On the
# model's own activations at seeded weights the logits are nearly flat, every
# p_j of a row is nearly the same number and is rounded the same way, so the
# errors add up in line, not like noise: there only the worst case holds,
# 2^-9 A for each of the two, A = sum_j p_j |v_j| (2-4 times |out| there),
# and the row term of the bound is 2^-8 A. Everywhere the kernel may lie at
# most FLASH_EXACT_FACTOR times as far (relative L2, + 1e-4) from the fp32
# attention with unrounded p as the plain version does. Backward (the same
# residual into both): 2 bf16 ulps of
# each gradient's largest magnitude and the same relative L2 bound. fp32:
# 1e-5 forward, BWD_FP32_RTOL backward. lse: 1e-5. No atomics anywhere: two
# runs give the same bits.
FLASH_RAGGED = [(1, 2, 200, 130, 32), (2, 1, 77, 1025, 64),
                (1, 3, 1030, 65, 40), (2, 2, 64, 64, 128),
                (1, 1, 130, 300, 64), (1, 2, 191, 127, 64),
                (1, 1, 193, 129, 32), (2, 3, 385, 257, 64),
                (1, 1, 257, 385, 128), (1, 1, 200, 4100, 64),
                (2, 2, 130, 4097, 32), (1, 1, 130, 2100, 128),
                (2, 2, 130, 4097, 128)]
FLASH_FWD_ULPS, FLASH_BWD_ULPS, LSE_ATOL = 2, 2, 1e-5
# Runs of the stage-1 backward that must give the same bits.
FLASH_REPEATS = 5
FLASH_FWD_NOISE, FLASH_REL_L2, FLASH_EXACT_FACTOR = 4, 5e-3, 1.25
# On inputs whose row max lies in the first kv tile the kernel and the plain
# version round p alike: at most this share of the outputs may differ, and a
# kernel that left p unrounded must differ in more than the second share.
FLASH_MISMATCH_MAX, FLASH_UNROUNDED_MIN = 0.01, 0.05
# mit_b2pp: K5 serves the IFFM of stages 1-3 (two calls each); stage 4's
# two calls are short-kv and go to K1/K2 beside the 32 of the towers.
PP_FLASH_CALLS, PP_SR_CALLS = 6, 34
PP_GRAD_NAMES = [
    "backbone.patch_embed1.proj.weight",
    "backbone.block1.0.attn.q.weight",
    "backbone.FRMs.0.channel_weights.mlp.0.weight",
    "backbone.FFMs.0.cross.cross_attn.q1.weight",
    "backbone.FFMs.0.cross.cross_attn.kv2.weight",
    "backbone.FFMs.2.cross.cross_attn.proj1.weight",
    "backbone.block4.2.mlp.fc2.weight",
    "decode_head.linear_pred.weight"]
PP_FP32_BATCH = 2
# mit_b2pp at seeded random weights is ill-conditioned in bf16: each IFRM
# (unbounded spatial gates, then a LayerNorm) multiplies the relative
# rounding error of its input by 2-3 (PERF.md section 6), so the bf16
# plain path itself lies ~10% (L2) from the fp32 model at the logits, and
# two bf16 paths that round at different points half as far from each
# other, far beyond a few bf16 ulps. Its bf16 kernel path is
# therefore held to the fp32 plain path ("truth") beside the bf16 plain
# path: it may be at most this factor further from the truth than the bf16
# plain path is (the two are samples of the same rounding noise), plus a
# floor for quantities both paths get nearly right; its argmax may agree
# with the truth's at most PP_ARGMAX_SLACK less often than the plain path's.
# The two bf16 paths may lie at most PP_PATHS_FACTOR times as far from each
# other as the plain path lies from the truth, plus the floor (two
# independent samples of one noise lie sqrt(2) apart; read: 0.4-1.6). What
# holds the tensor-core K5 kernels tightly inside the model is another
# check: flash_in_model_phase, on the model's own activations and
# cotangents, by the kernel phase's bounds.
PP_TRUTH_FACTOR, PP_TRUTH_FLOOR, PP_ARGMAX_SLACK = 1.5, 0.01, 0.02
PP_PATHS_FACTOR = 2.0
# The last two heads on the preset's mit_b2. Mask2Former's eval
# output is fp32 log-scores (its semantic inference), its train output the
# query dict, whose loss assigns each pixel to a query by an argmax: two
# bf16 attention paths can flip assignments, so its bf16 kernel path is
# held to the fp32 plain path (PP_TRUTH_FACTOR), as mit_b2pp's and
# pst900's are; fp32 keeps the mit_b2 bounds. Its mask temperature is not
# among the named gradients: at its init 20 the sigmoid is exactly 1 in fp32
# and bf16, so its gradient is exactly 0 (in the JAX package too).
# MLPDecoder++ keeps the mit_b2 bounds throughout, over MLPPP_TRAIN_STEPS
# counted steps.
M2F_GRAD_NAMES = ["backbone.patch_embed1.proj.weight",
                  "backbone.block1.0.attn.q.weight",
                  "backbone.block4.2.mlp.fc2.weight",
                  "decode_head.pixel_decoder.mask_features.0.weight",
                  "decode_head.layers.0.cross_attn.q_proj.weight",
                  "decode_head.layers.8.ffn.3.weight",
                  "decode_head.query_embed",
                  "decode_head.class_embed.weight"]
MLPPP_GRAD_NAMES = ["backbone.patch_embed1.proj.weight",
                    "backbone.block1.0.attn.q.weight",
                    "backbone.block4.2.mlp.fc2.weight",
                    "decode_head.linear_c1.weight",
                    "decode_head.linear_fuse.0.weight",
                    "decode_head.attention.1.weight",
                    "decode_head.attention.3.weight",
                    "decode_head.linear_pred.weight"]
MLPPP_TRAIN_STEPS = 2
NEW_HEADS = ("mask2former", "MLPDecoderpp")


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


def sr_inputs(gen, shape, dtype, cotangent=False):
    """q, k, v as the model hands them over: head-split views of the
    (B, N, h*d) q tokens and of the (B, M, 2, h, d) kv projection; with
    `cotangent` also the cotangent as autograd hands it back (a non-uniform
    (B, N, h*d) tensor, head-split)."""
    import torch

    B, h, N, M, d = shape
    x = torch.randn(B, N, h * d, device="cuda", generator=gen).to(dtype)
    kv = torch.randn(B, M, 2, h, d, device="cuda", generator=gen).to(dtype)
    out = [x.reshape(B, N, h, d).transpose(1, 2),
           kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)]
    if cotangent:
        w = torch.randn(B, N, h * d, device="cuda", generator=gen).to(dtype)
        out.append(w.reshape(B, N, h, d).transpose(1, 2))
    return out


def hold_sr_fwd(S, q, k, v, shape, dtype) -> float:
    """K1 against its plain version on q, k, v (fp32: FP32_ATOL; bf16: 2
    ulps, and p rounded where the plain version rounds it); returns the
    largest error."""
    import torch

    d = shape[4]
    ref = S.sr_attention_reference(q, k, v, d ** -0.5)
    got = S.sr_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    tol = bf16_atol(ref) if dtype == torch.bfloat16 else FP32_ATOL
    print(f"kernel {str(dtype)[6:]:8s} (B,h,N,M,d)={shape}: "
          f"max_abs_err {err:.3e} (tol {tol:.3e})")
    check(err <= tol and bool(torch.isfinite(got).all()),
          f"kernel vs plain at {shape} {dtype}: {err} > {tol}")
    if dtype == torch.bfloat16 and shape[3] > 1:  # M = 1: p is exactly 1
        wrong = unrounded_reference(q, k, v, d ** -0.5)
        right_frac = float((got != ref).float().mean())
        wrong_frac = float((got != wrong).float().mean())
        print(f"  outputs differing from plain {right_frac:.5f} "
              f"(<= {BF16_MISMATCH_MAX}), from unrounded-p plain "
              f"{wrong_frac:.5f}")
        check(right_frac <= BF16_MISMATCH_MAX and right_frac < wrong_frac,
              f"bf16 kernel at {shape} does not round p as the plain "
              f"version does: {right_frac} vs {wrong_frac}")
    return err


def kernel_phase(S):
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    flagship_err = 0.0
    cases = [(s, torch.bfloat16) for s in FLAGSHIP + RAGGED + LARGE_FRAME] + \
            [(s, torch.float32) for s in RAGGED]
    for shape, dtype in cases:
        err = hold_sr_fwd(S, *sr_inputs(g, shape, dtype), shape, dtype)
        if shape in FLAGSHIP:
            flagship_err = max(flagship_err, err)

    rows = [time_sr_fwd(S, g, shape) for shape in FLAGSHIP]
    return flagship_err, rows


def time_sr_fwd(S, g, shape):
    """K1's timing row at one bf16 shape: kernel, plain, SDPA, bound."""
    import torch

    B, h, N, M, d = shape
    q, k, v = sr_inputs(g, shape, torch.bfloat16)
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
    ops = 4 * B * h * N * M * d
    bound, by = bound_ms(ops, 2 * (2 * B * h * N * d + 2 * B * h * M * d))
    print(f"time bf16 fwd (B,h,N,M,d)={shape}: kernel "
          f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, SDPA "
          f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return timing_row(list(shape), (k1 + k2) / 2, (p1 + p2) / 2, lib, bound,
                      by, ops)


def timing_row(shape, ms, plain_ms, library_ms, bound, by, ops):
    """One timed shape: times, bound, the kernel's share of its bound and
    its achieved rate (the function's operations over its time)."""
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms, "tflops": ops / ms * 1e-9}


def bound_ms(operations: float, nbytes: float):
    """Least time the card could take for bf16 work: operations at the dense
    tensor-core rate against bytes (each input read once, each output written
    once) at the device-memory rate; (ms, which one binds)."""
    t_ops = operations / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def per_step(rows, key, calls=None):
    """A per-shape reading summed over the calls of one forward (or one
    backward) of the model: the 32 SR attentions of mit_b2 by default; None
    where a shape's reading is None."""
    if any(r[key] is None for r in rows):
        return None
    return sum(c * r[key] for c, r in zip(calls or CALLS_PER_FORWARD, rows))


def device_reading(dev):
    """The mean of the shifted and unshifted device times of a shape, None
    where torch.profiler lost a kernel's events (bench_window_attention.
    kernel_ms): no time is then reported rather than a low one."""
    if dev[True] is None or dev[False] is None:
        return None
    return (dev[True] + dev[False]) / 2


def ms_text(ms):
    return "not read" if ms is None else f"{ms:.4f}"


def hold_sr_bwd(S, q, k, v, w, shape, dtype) -> float:
    """K2 against its plain version on q, k, v and the cotangent w (dq, dk,
    dv; fp32 BWD_FP32_RTOL, bf16 BWD_BF16_ULPS), two runs bit-equal;
    returns the largest error."""
    import torch

    d = shape[4]
    ref = S.sr_attention_bwd_reference(q, k, v, w, d ** -0.5)
    # The residual as autograd keeps it: the forward kernel's lse2 (None
    # on the scalar route, whose backward recomputes its statistics).
    lse = S._forward(q, k, v, d ** -0.5, with_lse=True)[1]
    got = S.sr_attention_bwd(q, k, v, w, d ** -0.5, lse=lse)
    again = S.sr_attention_bwd(q, k, v, w, d ** -0.5, lse=lse)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"backward kernel differs between two runs at {shape} {dtype}")
    line, worst = [], 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err = float((a.float() - b.float()).abs().max())
        tol = (bf16_atol(b, BWD_BF16_ULPS) if dtype == torch.bfloat16
               else BWD_FP32_RTOL * max(1.0, float(b.abs().max())))
        line.append(f"{name} {err:.3e} (tol {tol:.3e})")
        check(err <= tol and bool(torch.isfinite(a).all()),
              f"backward kernel vs plain, {name} at {shape} {dtype}: "
              f"{err} > {tol}")
        worst = max(worst, err)
    print(f"bwd kernel {str(dtype)[6:]:8s} (B,h,N,M,d)={shape}: "
          "max_abs_err " + ", ".join(line) + "; two runs bit-equal")
    return worst


def bwd_kernel_phase(S):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    flagship_err = 0.0
    cases = [(s, torch.bfloat16) for s in FLAGSHIP + RAGGED + LARGE_FRAME] + \
            [(s, torch.float32) for s in RAGGED]
    for shape, dtype in cases:
        err = hold_sr_bwd(S, *sr_inputs(gen, shape, dtype, cotangent=True),
                          shape, dtype)
        if shape in FLAGSHIP:
            flagship_err = max(flagship_err, err)

    rows = [time_sr_bwd(S, gen, shape) for shape in FLAGSHIP]
    return flagship_err, rows


def time_sr_bwd(S, gen, shape):
    """K2's timing row at one bf16 shape: kernel, plain, SDPA's backward,
    bound."""
    import torch

    B, h, N, M, d = shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, w = sr_inputs(gen, shape, torch.bfloat16, cotangent=True)
    sc = d ** -0.5
    lse = S._forward(q, k, v, sc, with_lse=True)[1]

    def kernel():
        S.sr_attention_bwd(q, k, v, w, sc, lse=lse)

    p1 = median_ms(S.sr_attention_bwd_reference, q, k, v, w, sc, reps=5)
    k1 = median_ms(kernel, reps=5)
    k2 = median_ms(kernel, reps=5)
    p2 = median_ms(S.sr_attention_bwd_reference, q, k, v, w, sc, reps=5)
    # The library's backward: forward + backward through autograd, minus
    # the forward alone.
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        torch.autograd.grad(sdpa(lq, lk, lv, scale=sc), (lq, lk, lv), w)

    with torch.no_grad():
        lib_fwd = median_ms(lambda: sdpa(q, k, v, scale=sc), reps=5)
    lib = median_ms(fwd_bwd, reps=5) - lib_fwd
    ops = 10 * B * h * N * M * d
    bound, by = bound_ms(ops, 2 * (3 * B * h * N * d + 4 * B * h * M * d))
    print(f"time bf16 bwd (B,h,N,M,d)={shape}: kernel "
          f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, SDPA "
          f"backward {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return timing_row(list(shape), (k1 + k2) / 2, (p1 + p2) / 2, lib, bound,
                      by, ops)


# K1/K2 at the stage-4 IFFM attentions of segnext_tiny (d = 32) and
# segnext_large (d = 96) at 480x640, batch 8: 8 heads over 15 x 20 tokens
# (fp32 at batch 1). d = 96 fills two of the tensor-core kernels' 64-wide
# panels of the head dim, the second half zeros.
SEGNEXT_SR_SHAPES = [(8, 8, 300, 300, 32), (8, 8, 300, 300, 96)]


def segnext_sr_kernel_phase(S):
    """K1 and K2 at SEGNEXT_SR_SHAPES in bf16 (the tensor-core route, the
    route checked) and at batch 1 in fp32 (the scalar route) against their
    plain versions (hold_sr_fwd, hold_sr_bwd: their bounds, the backward's
    two runs bit-equal, and the forward's); then the bf16 times (kernel,
    plain, SDPA, bound). Returns ({fwd, bwd: worst bf16 error}, {fwd, bwd:
    rows})."""
    import torch

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(8)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape in SEGNEXT_SR_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            sh = shape if bf16 else (1, *shape[1:])
            q, k, v, w = sr_inputs(g, sh, dtype, cotangent=True)
            route = S.route(q, k, v)
            passes = S._kernel().sr_attention_fwd_tc_passes(sh[3], sh[4])
            print(f"segnext K1/K2 {str(dtype)[6:]} {sh}: route {route}"
                  + (f", {passes}-pass forward" if bf16 else ""))
            check(route == ("tensor_cores" if bf16 else "scalar"),
                  f"K1/K2 route at {sh} {dtype}: {route}")
            err = hold_sr_fwd(S, q, k, v, sh, dtype)
            sc = sh[4] ** -0.5
            same = torch.equal(S.sr_attention(q, k, v, sc),
                               S.sr_attention(q, k, v, sc))
            print(f"  forward: two runs bit-equal: {same}")
            check(same, f"K1 differs between two runs at {sh} {dtype}")
            berr = hold_sr_bwd(S, q, k, v, w, sh, dtype)
            if bf16:
                worst = {"fwd": max(worst["fwd"], err),
                         "bwd": max(worst["bwd"], berr)}
            del q, k, v, w
    rows = {"fwd": [time_sr_fwd(S, g, sh) for sh in SEGNEXT_SR_SHAPES],
            "bwd": [time_sr_bwd(S, g, sh) for sh in SEGNEXT_SR_SHAPES]}
    torch.cuda.empty_cache()
    print(f"segnext K1/K2 phase: {time.perf_counter() - t0:.1f} s")
    return worst, rows


def window_cases(T):
    import torch

    full = [(*s, T.D, T.WS) for s in T.STAGES]
    return ([(s, torch.bfloat16) for s in full + WINDOW_RAGGED]
            + [(s, torch.float32) for s in full[2:] + WINDOW_RAGGED])


def hold_window_fwd(W, T, shape, dtype, shifted, gen) -> float:
    """K3 against its plain version at one (B, Hp, Wp, h, d, ws), the bias
    unshifted or masked (`shifted`), rate 0 and T.RATE (fp32 FP32_ATOL;
    bf16 2 ulps, at most BF16_MISMATCH_MAX of the outputs differing, p
    rounded where the plain version rounds it); returns the largest
    error."""
    import torch

    d, ws = shape[4], shape[5]
    qkv, bias, _, seed = T.window_inputs(
        shape, dtype, "masked" if shifted else "unshifted", gen)
    line, worst = [], 0.0
    for rate in (0.0, T.RATE):
        ref = W.window_attention_reference(qkv, bias, seed, d ** -0.5, rate,
                                           ws)
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
        # unrounded p into p @ v, or drew another mask, differs in far more
        # of its outputs.
        if dtype == torch.bfloat16:
            check(frac <= BF16_MISMATCH_MAX,
                  f"bf16 window kernel at {shape} rate={rate}: {frac} of "
                  "the outputs differ from plain")
        worst = max(worst, err)
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
        check(right_frac < wrong_frac, f"window kernel at {shape} does not "
              "round p as the plain version does")
    print(f"window fwd {str(dtype)[6:]:8s} (B,Hp,Wp,h,d,ws)={shape} "
          f"shifted={shifted}: " + "; ".join(line))
    return worst


def window_kernel_phase(W, T):
    """K3 against its plain version: every swin_s stage and the ragged
    shapes, unshifted and masked bias, rate 0 and 0.3; then its times,
    with the model's own shift mask in the shifted bias."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    stage_err = 0.0
    for shape, dtype in window_cases(T):
        for shifted in (False, True):
            err = hold_window_fwd(W, T, shape, dtype, shifted, gen)
            if shape[:4] in T.STAGES and dtype == torch.bfloat16:
                stage_err = max(stage_err, err)
    # The kernel's mask, read off its outputs, against the plain mask.
    for shape in [(*T.STAGES[2], T.D, T.WS), WINDOW_RAGGED[0],
                  WINDOW_RAGGED[3], WINDOW_RAGGED[4]]:
        seed = torch.empty(1, dtype=torch.int64, device="cuda").random_(
            generator=gen)
        B, Hp, Wp, h, d, ws = shape
        want = W.keep_mask(seed, B, (Hp // ws) * (Wp // ws), h, ws * ws,
                           T.RATE)
        got = T.kernel_mask(shape, seed, T.RATE)
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
        t, dev = {}, {}
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
                # Device time (torch.profiler): the events above also hold
                # the host's time a call where it exceeds the kernel's.
                dev[shifted] = T.kernel_ms(lambda: W.window_attention(*args))
            blocks = T.launch_blocks(lambda: W.window_attention(*args))
            lq, lk, lv, mask = T.sdpa_inputs(qkv, bias, shape)
            lib = median_ms(lambda: sdpa(lq, lk, lv, attn_mask=mask,
                                         dropout_p=T.RATE, scale=sc),
                            reps=5)
        bounds = [bound_ms(*reversed(T.work(shape, sh, False)))
                  for sh in (True, False)]
        rows.append({"shape": list(shape), "ms": (t[True] + t[False]) / 2,
                     "ms_shifted": t[True], "ms_unshifted": t[False],
                     "ms_rate0": (t[True, 0.0] + t[False, 0.0]) / 2,
                     "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                     "bound_ms": (bounds[0][0] + bounds[1][0]) / 2,
                     "bound_by": bounds[0][1],
                     "device_ms": device_reading(dev),
                     "device_ms_shifted": dev[True],
                     "device_ms_unshifted": dev[False], "blocks": blocks,
                     "images_per_block": -(-B * T.units(shape) // blocks)
                     if blocks else None})
        row = rows[-1]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        # The operations do not depend on the shift.
        row["tflops"] = (T.work(shape, True, False)[1]
                         / row["ms"] * 1e-9)
        print(f"time bf16 window fwd (B,Hp,Wp,h,d,ws)={shape}, rate "
              f"{T.RATE}: kernel shifted {t[True]:.4f} ms, unshifted "
              f"{t[False]:.4f} ms (rate 0: {t[True, 0.0]:.4f} / "
              f"{t[False, 0.0]:.4f}), device {ms_text(dev[True])} / "
              f"{ms_text(dev[False])} ms, {blocks} blocks of "
              f"{row['images_per_block']} images, plain {p1:.3f}/{p2:.3f} ms, "
              f"SDPA {lib:.4f} ms, bound {bounds[0][0]:.4f} / "
              f"{bounds[1][0]:.4f} ms ({bounds[0][1]})")
    return stage_err, rows


def hold_window_bwd(W, T, shape, dtype, shifted, gen) -> float:
    """K4 against its plain version at one shape, as hold_window_fwd: dqkv
    (fp32 BWD_FP32_RTOL, bf16 BWD_BF16_ULPS) and db (fp32 BWD_FP32_RTOL,
    bf16 DB_BF16_RTOL), two runs bit-equal; returns dqkv's largest
    error."""
    import torch

    d, ws = shape[4], shape[5]
    qkv, bias, cot, seed = T.window_inputs(
        shape, dtype, "masked" if shifted else "unshifted", gen)
    line, worst = [], 0.0
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
                  f"{dtype} shifted={shifted} rate={rate}: {err} > {tol}")
            check(bool(torch.equal(a, c)),
                  f"window backward {name} differs between two runs")
            if name == "dqkv":
                worst = max(worst, err)
        if dtype == torch.bfloat16:
            frac = float((got[0] != ref[0]).float().mean())
            line.append(f"dqkv differing {frac:.4f}")
    print(f"window bwd {str(dtype)[6:]:8s} (B,Hp,Wp,h,d,ws)={shape} "
          f"shifted={shifted}: max_abs_err " + ", ".join(line))
    return worst


def window_bwd_kernel_phase(W, T):
    """K4 against its plain version (dqkv and db), same cases; two runs give
    the same bits; then its times, with the model's own shift mask."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    stage_err = 0.0
    for shape, dtype in window_cases(T):
        for shifted in (False, True):
            err = hold_window_bwd(W, T, shape, dtype, shifted, gen)
            if shape[:4] in T.STAGES and dtype == torch.bfloat16:
                stage_err = max(stage_err, err)
    return stage_err, time_window_bwd(W, T, T.STAGES, T.WS, gen)


def time_window_bwd(W, T, stages, ws, gen):
    """K4's rows at the `stages` (B, Hp, Wp, h) with window ws, bf16, rate
    T.RATE: CUDA-event ms (plain, kernel, kernel, plain), device ms
    (torch.profiler), shifted and unshifted, blocks per launch, SDPA's
    backward and the bound."""
    import torch

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for stage in stages:
        shape = (*stage, T.D, ws)
        B, Hp, Wp, h, d, ws = shape
        sc = d ** -0.5
        t, dev = {}, {}
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
            dev[shifted] = T.kernel_ms(lambda: W.window_attention_bwd(*args))
        blocks = T.launch_blocks(lambda: W.window_attention_bwd(*args))
        # The library's backward: forward + backward through autograd (the
        # mask's gradient too: it is the bias), minus the forward alone.
        lq, lk, lv, mask = (t.requires_grad_() for t in
                            T.sdpa_inputs(qkv, bias, shape))
        w = W._split_windows(cot, ws, 1, h)[:, :, 0].reshape(lq.shape)

        def fwd():
            return sdpa(lq, lk, lv, attn_mask=mask, dropout_p=T.RATE,
                        scale=sc)

        def fwd_bwd():
            torch.autograd.grad(fwd(), (lq, lk, lv, mask), w)

        with torch.no_grad():
            lib_fwd = median_ms(fwd, reps=5)
        lib = median_ms(fwd_bwd, reps=5) - lib_fwd
        del lq, lk, lv, mask, w
        bounds = [bound_ms(*reversed(T.work(shape, sh, True)))
                  for sh in (True, False)]
        rows.append({"shape": list(shape), "ms": (t[True] + t[False]) / 2,
                     "ms_shifted": t[True], "ms_unshifted": t[False],
                     "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                     "bound_ms": (bounds[0][0] + bounds[1][0]) / 2,
                     "bound_by": bounds[0][1],
                     "device_ms": device_reading(dev),
                     "device_ms_shifted": dev[True],
                     "device_ms_unshifted": dev[False], "blocks": blocks,
                     "images_per_block": -(-B * T.units(shape) // blocks)
                     if blocks else None})
        row = rows[-1]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        # The operations do not depend on the shift.
        row["tflops"] = (T.work(shape, True, True)[1]
                         / row["ms"] * 1e-9)
        print(f"time bf16 window bwd (B,Hp,Wp,h,d,ws)={shape}, rate "
              f"{T.RATE}: kernel shifted {t[True]:.4f} ms, unshifted "
              f"{t[False]:.4f} ms, device {ms_text(dev[True])} / "
              f"{ms_text(dev[False])} ms, {blocks} blocks of "
              f"{row['images_per_block']} (unit, image) pairs, plain "
              f"{p1:.3f}/{p2:.3f} ms, SDPA backward {lib:.4f} ms, bound "
              f"{bounds[0][0]:.4f} / {bounds[1][0]:.4f} ms ({bounds[0][1]})")
    return rows


def bf16_ulp(x):
    """The bf16 ulp at each element's magnitude."""
    import torch

    return 2.0 ** (torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def first_tile_max_inputs(T5, shape, gen):
    """bf16 q, k, v (the model's layouts) whose every row's largest logits
    belong to keys 0-3: q and those keys share a large first component. The
    running max of the kernel is then the row max from the first kv tile on,
    so kernel and plain version round the same p, and the four comparable
    probabilities make the rounding of p show in the output."""
    import torch

    B, h, N, M, d = shape
    q, k, v, _ = T5.inputs(shape, torch.float32, gen)
    q[..., 0] = 16.0
    k[..., 0] = 0.0
    k[:, :, :4, 0] = torch.tensor([4.0, 3.9, 3.8, 3.7], device=k.device)
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def flash_row_noise(FA, q, k, v, lse, scale):
    """R = sqrt(sum_j p_j^2 v_j^2) per output element, in fp32, from the
    plain version: p_j^2 is the softmax at twice the scale times
    exp(lse_2 - 2 lse)."""
    import torch

    out2, lse2 = FA.flash_attention_reference(q.float(), k.float(),
                                              v.float().square(), 2 * scale)
    return (out2 * torch.exp(lse2 - 2 * lse).unsqueeze(-1)).sqrt()


def hold_flash_case(FA, label, q, k, v, w, sc, independent=True):
    """K5's three kernels against their plain versions on one set of inputs
    (q, k, v and the cotangent w where they lie), by the bounds above
    (`independent`: the inputs are independent draws, so the noise term
    bounds a row; else the worst case does); two runs bit-equal. Returns the
    largest absolute errors {fwd, dkv, dq}."""
    import torch

    bf16 = q.dtype == torch.bfloat16
    ref, lse_ref = FA.flash_attention_reference(q, k, v, sc)
    got, lse = FA._forward(q, k, v, sc)
    again, _ = FA._forward(q, k, v, sc)
    torch.cuda.synchronize()
    gf, rf = got.float(), ref.float()
    err = (gf - rf).abs()
    rel = float(err.norm() / rf.norm())
    if bf16:
        f32 = (q.float(), k.float(), v.float())
        if independent:
            row = FLASH_FWD_NOISE * flash_row_noise(FA, q, k, v, lse_ref, sc)
        else:
            row = FA.flash_attention_reference(f32[0], f32[1], f32[2].abs(),
                                               sc)[0]
        tol = (FLASH_FWD_ULPS * bf16_ulp(torch.maximum(gf.abs(), rf.abs()))
               + 2.0 ** -8 * row)
        share = float((err / tol).max())
        exact = FA.flash_attention_reference(*f32, sc)[0]
        far_k, far_p = (float((t - exact).norm() / exact.norm())
                        for t in (gf, rf))
        ok = (share <= 1.0 and rel <= FLASH_REL_L2
              and far_k <= FLASH_EXACT_FACTOR * far_p + 1e-4)
        bound = (f"{share:.3f} of the element bound ({FLASH_FWD_ULPS} ulps + "
                 + (f"{FLASH_FWD_NOISE} * 2^-8 R" if independent else "2^-8 A")
                 + f"; <= 1), rel L2 {rel:.2e} (<= {FLASH_REL_L2:.0e}), from "
                 f"unrounded-p fp32 {far_k:.2e} (kernel, <= "
                 f"{FLASH_EXACT_FACTOR} x plain + 1e-4) and {far_p:.2e} "
                 f"(plain), mean |out| {float(rf.abs().mean()):.2e}")
        del tol, row, exact, f32
    else:
        ok, bound = float(err.max()) <= FP32_ATOL, f"tol {FP32_ATOL:.0e}"
    lse_err = float((lse - lse_ref).abs().max())
    worst = {"fwd": float(err.max()), "dkv": 0.0, "dq": 0.0}
    print(f"flash fwd {str(q.dtype)[6:]:8s} {label}: max_abs_err "
          f"{worst['fwd']:.3e}, {bound}; lse err {lse_err:.2e}; "
          f"differing {float((got != ref).float().mean()):.4f}")
    check(ok and lse_err <= LSE_ATOL and bool(torch.isfinite(got).all()),
          f"flash forward kernel vs plain at {label} {q.dtype}")
    check(bool(torch.equal(got, again)), "flash forward differs between "
          f"two runs at {label}")
    del err, again, gf, rf
    dref = FA.flash_attention_bwd_reference(q, k, v, ref, lse_ref, w, sc)
    dgot = FA.flash_attention_bwd(q, k, v, ref, lse_ref, w, sc)
    dagain = FA.flash_attention_bwd(q, k, v, ref, lse_ref, w, sc)
    torch.cuda.synchronize()
    line = []
    for name, a, b, c in zip(("dq", "dk", "dv"), dgot, dref, dagain):
        e = float((a.float() - b.float()).abs().max())
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        tol = (bf16_atol(b, FLASH_BWD_ULPS) if bf16
               else BWD_FP32_RTOL * max(1.0, float(b.abs().max())))
        line.append(f"{name} {e:.3e} (tol {tol:.3e}), rel L2 {rel:.2e}")
        check(e <= tol and bool(torch.isfinite(a).all())
              and (rel <= FLASH_REL_L2 or not bf16),
              f"flash backward kernel vs plain, {name} at {label} {q.dtype}: "
              f"{e} > {tol} or rel L2 {rel} > {FLASH_REL_L2}")
        check(bool(torch.equal(a, c)),
              f"flash backward {name} differs between two runs at {label}")
        key = "dq" if name == "dq" else "dkv"
        worst[key] = max(worst[key], e)
    print(f"flash bwd {str(q.dtype)[6:]:8s} {label}: max_abs_err "
          + ", ".join(line) + (f" (rel L2 <= {FLASH_REL_L2:.0e})" if bf16
                               else "") + "; two runs bit-equal")
    return worst


def flash_kernel_phase(FA, T5):
    """K5 against its plain version: the forward kernel, the dk/dv kernel
    and the dq kernel at the three mit_b2pp shapes and the ragged cases, in
    bf16 and (the full shapes at batch 1) in fp32; two runs bit-equal (the
    stage-1 backward FLASH_REPEATS runs); the rounding point of p; then their
    times. Returns ({kernel: worst error at the full bf16 shapes}, {kernel:
    rows})."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    cases = [(s, torch.bfloat16) for s in T5.SHAPES + FLASH_RAGGED] + \
            [((1, *s[1:]), torch.float32) for s in T5.SHAPES] + \
            [(s, torch.float32) for s in FLASH_RAGGED]
    for shape, dtype in cases:
        q, k, v, w = T5.inputs(shape, dtype, gen)
        errs = hold_flash_case(FA, f"(B,h,N,M,d)={shape}", q, k, v, w,
                               shape[4] ** -0.5)
        if dtype == torch.bfloat16 and shape in T5.SHAPES:
            worst = {key: max(worst[key], e) for key, e in errs.items()}
    # The backward at stage 1, repeated: every run the same bits (no atomics,
    # every sum in a fixed order).
    q, k, v, w = T5.inputs(T5.SHAPES[0], torch.bfloat16, gen)
    sc = q.shape[3] ** -0.5
    out, lse = FA._forward(q, k, v, sc)
    first = FA.flash_attention_bwd(q, k, v, out, lse, w, sc)
    same = [all(torch.equal(a, b) for a, b in zip(
        first, FA.flash_attention_bwd(q, k, v, out, lse, w, sc)))
        for _ in range(FLASH_REPEATS - 1)]
    print(f"flash bwd bf16 {T5.SHAPES[0]}: {FLASH_REPEATS} runs, the same "
          f"bits: {same}")
    check(all(same), f"flash backward differs between runs at {T5.SHAPES[0]}")
    del q, k, v, w, out, lse, first
    # The rounding point of p, where kernel and plain round the same p.
    for shape in (T5.SHAPES[2], (2, 2, 1100, 1300, 32)):
        q, k, v = first_tile_max_inputs(T5, shape, gen)
        sc = shape[4] ** -0.5
        ref, _ = FA.flash_attention_reference(q, k, v, sc)
        wrong, _ = FA.flash_attention_reference(q, k, v, sc, round_p=False)
        got, _ = FA._forward(q, k, v, sc)
        right_frac = float((got != ref).float().mean())
        wrong_frac = float((got != wrong).float().mean())
        print(f"flash fwd, row max in the first kv tile, {shape}: outputs "
              f"differing from plain {right_frac:.5f} (<= {FLASH_MISMATCH_MAX})"
              f", from unrounded-p plain {wrong_frac:.5f} "
              f"(> {FLASH_UNROUNDED_MIN})")
        check(right_frac <= FLASH_MISMATCH_MAX
              and wrong_frac > FLASH_UNROUNDED_MIN,
              f"bf16 flash kernel at {shape} does not round p as the plain "
              f"version does: {right_frac} vs {wrong_frac}")
    torch.cuda.empty_cache()
    rows = {"fwd": [], "dkv": [], "dq": []}
    for shape in T5.SHAPES:
        timed = T5.time_shape(shape, gen)
        T5.print_rows(shape, timed)
        for which, row in timed.items():
            rows[which].append(row)
    torch.cuda.empty_cache()
    return worst, rows


def synthetic_items(n, hw, num_classes, seed=0, x_channels=1):
    """MFNet-shaped uint8 pairs with structured labels, made in memory
    (class bands, thermal tracking the label, 2% ignore pixels); with
    x_channels=3 the modal image has three channels (an HHA-like X)."""
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
        if x_channels == 3:
            thermal = np.stack([thermal, 255 - thermal, thermal // 2], axis=-1)
        items.append({"rgb": rgb, "modal_x": thermal, "label": label,
                      "fn": f"smoke_{i:04d}"})
    return items


def pp_cfg(cfg_lib):
    cfg = cfg_lib.mfnet_config()
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 backbone="mit_b2pp"))


def flash_in_model_phase(FA, model, rgb_t, mx_t, flash_calls):
    """K5 on the model's own activations: one bf16 forward and backward of
    the model (kernel path) with ImprovedCrossAttention._attend watched
    (`flash_calls` long-kv calls), then every long-kv call's q, k, v (the strided views the projections
    give) and the cotangent autograd handed it go through the three kernels
    and their plain versions, by the kernel phase's bounds. Returns the
    largest absolute errors {fwd, dkv, dq} over the calls."""
    import torch

    from rgbx_semantic_segmentation_tpu_torch.models import fusion

    calls = []
    attend = fusion.ImprovedCrossAttention._attend

    def watched(self, q, k, v, scale):
        out = attend(self, q, k, v, scale)
        if FA.supported(q.shape, k.shape):
            call = {"qkv": (q.detach(), k.detach(), v.detach()),
                    "scale": scale}
            out.register_hook(
                lambda g, call=call: call.__setitem__("g", g.detach()))
            calls.append(call)
        return out

    fusion.ImprovedCrossAttention._attend = watched
    try:
        model(rgb_t, mx_t).float().logsumexp(-1).mean().backward()
    finally:
        fusion.ImprovedCrossAttention._attend = attend
    model.zero_grad(set_to_none=True)
    check(len(calls) == flash_calls and all("g" in c for c in calls),
          f"{len(calls)} long-kv attention calls watched in the model")
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for i, call in enumerate(calls):
        q, k, v = call["qkv"]
        B, h, N, d = q.shape
        check(q.dtype == torch.bfloat16, "the model's attention runs in bf16")
        w = call["g"].reshape(B, N, h, d).transpose(1, 2)
        errs = hold_flash_case(
            FA, f"in the model, stage {i // 2 + 1} call {i % 2 + 1}, (B,h,N,M,"
            f"d)={(B, h, N, k.shape[2], d)}, max |cotangent| "
            f"{float(w.abs().max()):.2e}", q, k, v, w, call["scale"],
            independent=False)
        worst = {key: max(worst[key], e) for key, e in errs.items()}
    del calls
    torch.cuda.empty_cache()
    return worst


def stage_outputs(model, rgb_t, mx_t):
    """One forward; {name: fp32 copy of the RGB tower's output before each
    fusion stage, of each rectify module's RGB output and of each fusion
    module's output}, in the order they run."""
    import torch

    outs, handles = {}, []

    def keep(name):
        def hook(_module, _args, out):
            out = out[0] if isinstance(out, tuple) else out
            outs[name] = out.detach().float()
        return hook

    for s in range(4):
        norm = (f"norm{s + 1}" if hasattr(model.backbone, f"norm{s + 1}")
                else f"norm.{s}")   # MiT; SegNeXt
        for name in (norm, f"FRMs.{s}", f"FFMs.{s}"):
            module = model.backbone.get_submodule(name)
            handles.append(module.register_forward_hook(keep(name)))
    try:
        with torch.no_grad():
            outs["logits"] = model(rgb_t, mx_t).float()
    finally:
        for handle in handles:
            handle.remove()
    return outs


def phase_tag(cfg) -> str:
    """The backbone, and the head where it is one of NEW_HEADS."""
    m = cfg.model
    return m.backbone + (f" + {m.decoder}" if m.decoder in NEW_HEADS else "")


def slice_phase(S, FA, cfg, builder, evaluator_lib, dual_segformer, items,
                sr_calls=32, flash_calls=0, fp32_batch=EVAL_BATCH,
                vs_truth=False):
    """SegEvaluator.evaluate on a MiT-family model at full width and depth,
    counting the launches of K1 (`sr_calls` per forward) and of K5's forward
    (`flash_calls`), and the logits of the kernel path against the plain
    attention path in bf16 and (the first `fp32_batch` images) in fp32.
    `vs_truth`: the bf16 kernel path is held to the fp32 plain path beside
    the bf16 plain path (see PP_TRUTH_FACTOR), not to the bf16 plain path."""
    import torch

    tag = phase_tag(cfg)
    check(cfg.model.use_mixed_precision and cfg.model.use_pallas_kernels,
          "the preset runs bf16 on the kernels")
    model = builder.build_model(cfg, seed=0)   # device=None: the card
    ev = evaluator_lib.SegEvaluator(cfg, model)
    ev.evaluate(items[:EVAL_BATCH], eval_batch=EVAL_BATCH)  # warm-up

    FA.flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    S.sr_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, line = ev.evaluate(items, eval_batch=EVAL_BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = S.sr_attention.launches
    flash_launches = FA.flash_attention.launches
    forwards = N_IMAGES // EVAL_BATCH
    print(f"{tag} eval: {N_IMAGES} images, {forwards} forwards of batch "
          f"{EVAL_BATCH}, {launches} SR kernel launches "
          f"(expected {sr_calls * forwards}), {flash_launches} flash forward "
          f"launches (expected {flash_calls * forwards}), "
          f"{N_IMAGES / dt:.2f} img/s "
          f"({dt:.3f} s, host normalisation included)")
    check(launches == sr_calls * forwards
          and flash_launches == flash_calls * forwards,
          f"{launches} / {flash_launches} launches != ({sr_calls}, "
          f"{flash_calls}) x {forwards}")
    print("eval mIoU line (synthetic data, random weights):")
    print(line.splitlines()[-1])
    check(np.isfinite(scores.pixel_acc), "pixel_acc is finite")

    pairs = [ev.prepare(it["rgb"], it["modal_x"])
             for it in items[:EVAL_BATCH]]
    rgb_t = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    mx_t = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    logits_of = builder.main_logits   # the logits of an (logits, aux) pair
    with torch.no_grad():
        logits = logits_of(model(rgb_t, mx_t))
        with dual_segformer.plain_attention(model):
            plain_bf16 = logits_of(model(rgb_t, mx_t))
    # mask2former: the fp32 log-scores of its semantic inference.
    out_dtype = (torch.float32 if cfg.model.decoder == "mask2former"
                 else torch.bfloat16)
    check(logits.shape == (EVAL_BATCH, *HW, cfg.dataset.num_classes)
          and logits.dtype == out_dtype, f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "bf16 logits are finite")
    agree_bf16 = float((logits.argmax(-1) == plain_bf16.argmax(-1))
                       .float().mean())
    err_bf16 = float((logits.float() - plain_bf16.float()).abs().max())
    tol_bf16 = bf16_atol(plain_bf16, BF16_LOGITS_ULPS)
    # bf16 runs the tensor-core kernel (the path the eval above took). It
    # differs from the plain version by at most ~1 bf16 ulp in ~0.1% of its
    # outputs, and 32 calls through a bf16 network move the logits by a few
    # bf16 ulps and flip near-tied pixels; >= 0.99 of them must agree.
    print(f"{tag} bf16 logits {tuple(logits.shape)} finite; kernel vs plain "
          f"attention path (bf16): max_abs_err {err_bf16:.3e} "
          f"(tol {tol_bf16:.3e}), argmax agreement {agree_bf16:.6f} (>= 0.99)"
          + ("; not checked: held to the fp32 model below" if vs_truth else ""))
    check(vs_truth or (err_bf16 <= tol_bf16 and agree_bf16 >= 0.99),
          f"{tag} bf16 kernel path vs plain path")
    fwd, plain_fwd = [], []
    with torch.no_grad():  # kernel, plain, plain, kernel: one window
        for runs in (fwd, plain_fwd, plain_fwd, fwd):
            with contextlib.ExitStack() as stack:
                if runs is plain_fwd:
                    stack.enter_context(dual_segformer.plain_attention(model))
                runs.append(median_ms(model, rgb_t, mx_t,
                                      iters=10 if flash_calls == 0 else 4))
    fwd_ms, plain_fwd_ms = np.mean(fwd), np.mean(plain_fwd)
    print(f"{tag} forward alone, batch {EVAL_BATCH} bf16 (CUDA events, host "
          f"dispatch included): {fwd[0]:.3f}/{fwd[1]:.3f} ms "
          f"({EVAL_BATCH * 1e3 / fwd_ms:.2f} img/s); on the plain attention "
          f"path {plain_fwd[0]:.3f}/{plain_fwd[1]:.3f} ms "
          f"({EVAL_BATCH * 1e3 / plain_fwd_ms:.2f} img/s)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"peak device memory {peak:.2f} GiB (eval and both forward paths)")
    heads = (head_share(model, rgb_t, mx_t)
             if model.aux_head is not None or cfg.model.decoder in NEW_HEADS
             else {})
    if flash_calls:
        in_model = flash_in_model_phase(FA, model, rgb_t, mx_t, flash_calls)
        print(f"{tag}: K5 on the model's activations and cotangents, "
              f"{flash_calls} calls, within the kernel phase's bounds; largest "
              f"errors {in_model}")
    logits, plain_bf16 = (t[:fp32_batch].float() for t in (logits, plain_bf16))
    if vs_truth:
        by_stage = [stage_outputs(model, rgb_t[:fp32_batch], mx_t[:fp32_batch])]
        with dual_segformer.plain_attention(model):
            by_stage.append(stage_outputs(model, rgb_t[:fp32_batch],
                                          mx_t[:fp32_batch]))
    del model, ev

    # fp32, TF32 off: the kernel path against the plain path, same weights.
    # fp32 runs the scalar kernels only; the tensor-core kernels are held by
    # the bf16 checks above.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  use_mixed_precision=False))
    model32 = builder.build_model(cfg32, seed=0)
    rgb_t, mx_t = rgb_t[:fp32_batch], mx_t[:fp32_batch]
    with torch.no_grad():
        k32 = logits_of(model32(rgb_t, mx_t))
        with dual_segformer.plain_attention(model32):
            p32 = logits_of(model32(rgb_t, mx_t))
    err = float((k32 - p32).abs().max())
    agree = float((k32.argmax(-1) == p32.argmax(-1)).float().mean())
    # Both paths fp32 with TF32 off; only summation order differs (~1e-6
    # relative per op), compounded over ~40 layers: 1e-4 of the logit scale.
    tol = 1e-4 * max(1.0, float(p32.abs().max()))
    print(f"{tag} fp32 logits, batch {fp32_batch}, kernel vs plain attention: "
          f"max_abs_err {err:.3e} "
          f"(tol {tol:.3e}), argmax agreement {agree:.6f} (>= 0.999), "
          f"logit range {float(p32.min()):.3f}..{float(p32.max()):.3f}")
    check(err <= tol and agree >= 0.999,
          f"{tag} fp32 kernel path vs plain path")
    if vs_truth:
        # Where the bf16 paths leave the fp32 model (printed, not checked).
        with dual_segformer.plain_attention(model32):
            truth = stage_outputs(model32, rgb_t, mx_t)
        print(f"{tag}: rel L2 distance from the fp32 plain path, batch "
              f"{fp32_batch}, bf16 kernel path / bf16 plain path:")
        for name, t in truth.items():
            far = [float((o[name] - t).norm() / t.norm()) for o in by_stage]
            print(f"  {name:8s} {far[0]:.4f} / {far[1]:.4f}")
        del truth, by_stage
        rel_k, rel_p = (float((t - p32).norm() / p32.norm())
                        for t in (logits, plain_bf16))
        agree_k, agree_p = (float((t.argmax(-1) == p32.argmax(-1))
                                  .float().mean()) for t in (logits, plain_bf16))
        bound = PP_TRUTH_FACTOR * rel_p + PP_TRUTH_FLOOR
        rel_kp = float((logits - plain_bf16).norm() / p32.norm())
        apart = PP_PATHS_FACTOR * rel_p + PP_TRUTH_FLOOR
        print(f"{tag} bf16 logits against the fp32 plain path, batch "
              f"{fp32_batch}: kernel path rel L2 {rel_k:.4f} (bound {bound:.4f}"
              f"), plain path {rel_p:.4f}, kernel vs plain {rel_kp:.4f} (bound "
              f"{apart:.4f}); argmax agreement with fp32 "
              f"{agree_k:.4f} (kernel, >= plain - {PP_ARGMAX_SLACK}), "
              f"{agree_p:.4f} (plain)")
        check(rel_k <= bound and rel_kp <= apart
              and agree_k >= agree_p - PP_ARGMAX_SLACK,
              f"{tag} bf16 kernel path is further from the fp32 model than "
              "the bf16 plain path allows")
    del model32, k32, p32, logits, plain_bf16
    torch.cuda.empty_cache()
    return {"launches": launches, "flash_launches": flash_launches,
            "img_per_s": N_IMAGES / dt, "forward_ms": float(fwd_ms),
            "plain_forward_ms": float(plain_fwd_ms), "peak_gib": peak,
            **heads}


def device_ms(fn, floor_ms=0.0, reps=3, tries=3):
    """Device time of one call of `fn` (torch.profiler, kernels and
    copies), over `reps` calls after one untimed. A reading at or below
    `floor_ms` (the work's bound: the profiler lost kernel events) is
    retaken; None after `tries` such readings."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
        if total / (reps * 1e3) > floor_ms:
            return total / (reps * 1e3)
    return None


def conv_flops(module, *args):
    """Operations (2 per multiply-add) of the Conv2d layers of one call of
    `module`, from the output shapes its convs give."""
    import torch

    flops, handles = [0], []

    def hook(m, _args, out):
        kh, kw = m.kernel_size
        flops[0] += (2 * kh * kw * m.in_channels // m.groups * out.numel())

    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            handles.append(m.register_forward_hook(hook))
    try:
        with torch.no_grad():
            module(*args)
    finally:
        for h in handles:
            h.remove()
    return flops[0]


def head_share(model, rgb_t, mx_t):
    """Device time of the eval forward, of its decode head and of its aux
    head, if any (each run alone on the backbone's features), with the
    heads' conv operations: the heads' share of the forward."""
    import torch

    x, e = rgb_t.permute(0, 3, 1, 2), mx_t.permute(0, 3, 1, 2)
    bound_ms = lambda ops: ops / PEAK_BF16_FLOPS * 1e3
    aux_head = model.aux_head
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        feats = model.backbone(x, e)
        head_ops = conv_flops(model.decode_head, feats)
        whole = device_ms(lambda: model(rgb_t, mx_t), bound_ms(head_ops))
        head = device_ms(lambda: model.decode_head(feats), bound_ms(head_ops))
        if aux_head is not None:
            aux_ops = conv_flops(aux_head, feats)
            aux = device_ms(lambda: aux_head(feats), bound_ms(aux_ops))
    ok = None not in (whole, head)
    text = (f"{model.cfg.model.decoder} eval forward, batch {x.shape[0]}, "
            f"device time (torch.profiler): whole {whole} ms, decode head "
            f"alone {head} ms ({head_ops / 1e12:.3f} TFLOP of convs"
            + (f", {100 * head / whole:.1f}% of the forward, "
               f"{head_ops / head / 1e9:.0f} TFLOP/s" if ok else "") + ")")
    out = {"forward_device_ms": whole, "head_device_ms": head,
           "head_share": head / whole if ok else None,
           "head_tflop": head_ops / 1e12}
    if aux_head is not None:
        text += (f", aux head alone {aux} ms ({aux_ops / 1e12:.4f} TFLOP"
                 + (f", {100 * aux / whole:.1f}%" if ok and aux else "") + ")")
        out.update(aux_device_ms=aux, aux_tflop=aux_ops / 1e12)
    print(text)
    return out


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
                              prepare=None, paths=(False, True)):
    """One Trainer.step from seed-0 weights on the kernel path and one on
    the plain attention path (`encoder.plain_attention`): (loss, {name:
    gradient}) of each (`paths`: plain or not, in turn). The step leaves its
    gradients in .grad. `prepare` is applied to each fresh model first."""
    import torch

    out = []
    for plain in paths:
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
    times hold). Returns (kernels per step, device ms per step, {the port's
    kernel: device ms per step}) or None."""
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
    # The port's own kernels, wherever they rank.
    own = re.compile(r"\b((?:sr|window_attention|flash_attention|flash_bwd)_"
                     r"\w+(?:<[^>]*>)?)")
    mine = sorted(((m, e) for m, e in ((own.search(e.key), e) for e in ev)
                   if m), key=lambda x: x[0].group(1))
    print("  the port's kernels: " + ", ".join(
        f"{m.group(1)} {e.device_time_total / (steps * 1e3):.3f} ms "
        f"({e.count // steps}x)" for m, e in mine))
    return count, total, {m.group(1): e.device_time_total / (steps * 1e3)
                          for m, e in mine}


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


def compare_step_to_truth(tag, kernel, plain, truth, names):
    """One bf16 step on the kernel path and on the plain path against the
    fp32 plain path: the kernel path's loss and named gradients may lie at
    most PP_TRUTH_FACTOR times as far from the truth as the plain path's,
    plus PP_TRUTH_FLOOR of the truth, and at most PP_PATHS_FACTOR times that
    distance (plus the floor) from the plain path's. Returns the worst ratio
    (kernel error) / (plain error) and the worst kernel error."""
    (lk, gk), (lp, gp), (lt, gt) = kernel, plain, truth
    ek, ep = abs(lk - lt) / abs(lt), abs(lp - lt) / abs(lt)
    print(f"{tag} one step against the fp32 plain path: loss {lk:.6f} "
          f"(kernel), {lp:.6f} (plain), {lt:.6f} (fp32): rel {ek:.2e} vs "
          f"{ep:.2e}")
    check(np.isfinite(lk) and ek <= PP_TRUTH_FACTOR * ep + PP_TRUTH_FLOOR,
          f"{tag} step loss")
    worst_ratio = worst = 0.0
    for name in names:
        norm = float(gt[name].norm())
        ek = float((gk[name] - gt[name]).norm()) / norm
        ep = float((gp[name] - gt[name]).norm()) / norm
        ekp = float((gk[name] - gp[name]).norm()) / norm
        bound = PP_TRUTH_FACTOR * ep + PP_TRUTH_FLOOR
        worst, worst_ratio = max(worst, ek), max(worst_ratio, ek / ep)
        apart = PP_PATHS_FACTOR * ep + PP_TRUTH_FLOOR
        print(f"  grad {name}: rel L2 err to fp32 {ek:.3e} (kernel, bound "
              f"{bound:.3e}), {ep:.3e} (plain); kernel vs plain {ekp:.3e} "
              f"(bound {apart:.3e}); |g| {norm:.3e}")
        check(np.isfinite(ek) and ek <= bound and ekp <= apart,
              f"{tag} gradient of {name}: {ek} > {bound} or {ekp} > {apart}")
    return worst_ratio, worst


def train_phase(S, FA, cfg, train_lib, dual_segformer, items, sr_calls=32,
                flash_calls=0, grad_names=None, fp32_batch=None,
                vs_truth=False, steps=TRAIN_STEPS):
    """Trainer.fit_epoch on a MiT-family model: `steps` counted steps with the
    launches of K1, K2 (`sr_calls` per step each) and of K5's three kernels
    (`flash_calls` each), the loss and the parameters moving; then one step
    with drop rates 0 on the kernel path against the plain attention path,
    in bf16 and (at `fp32_batch`, default the preset's) in fp32. `vs_truth`:
    the bf16 step is held to an fp32 step on the plain path instead (see
    PP_TRUTH_FACTOR)."""
    import torch

    tag = phase_tag(cfg)
    grad_names = grad_names or GRAD_NAMES
    check(steps % 2 == 0, "an even number of counted steps")
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
    print(f"{tag} train: warm-up, 2 steps")
    trainer.fit_epoch(data, 2, log_every=1, logger=log)

    counters = {"fwd": S.sr_attention, "bwd": S.sr_attention_bwd,
                "flash_fwd": FA.flash_attention,
                "flash_dkv": FA.flash_attention_dkv,
                "flash_dq": FA.flash_attention_dq}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    mean_loss = trainer.fit_epoch(data, steps)
    b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    fwd_launches, bwd_launches = counts["fwd"], counts["bwd"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ev_ms = a.elapsed_time(b) / steps
    bs = cfg.train.batch_size
    print(f"{tag} train: {steps} steps of batch {bs} at {HW}, bf16: "
          f"{ev_ms:.2f} ms/step (CUDA events), {wall * 1e3 / steps:.2f} "
          f"ms/step (wall), {bs * steps / wall:.2f} img/s, mean loss "
          f"{mean_loss:.4f}, peak memory {peak:.2f} GiB; SR kernel launches "
          f"forward {fwd_launches}, backward {bwd_launches} "
          f"(expected {sr_calls * steps} each); flash launches forward "
          f"{counts['flash_fwd']}, dk/dv {counts['flash_dkv']}, dq "
          f"{counts['flash_dq']} (expected {flash_calls * steps} each)")
    check(fwd_launches == sr_calls * steps
          and bwd_launches == sr_calls * steps
          and all(counts[k] == flash_calls * steps
                  for k in ("flash_fwd", "flash_dkv", "flash_dq")),
          f"launches {counts} != ({sr_calls}, {flash_calls}) x {steps}")
    check(np.isfinite(mean_loss), "mean loss is finite")
    print(f"{tag} train: 2 more steps")
    trainer.fit_epoch(data, 2, log_every=1, logger=log)
    check(all(np.isfinite(x) for x in log.losses), "every loss is finite")
    # Steps 0 and steps + 2 both see batch 0 (steps is even).
    print(f"{tag} train: loss on batch 0 at step 0 {log.losses[0]:.4f}, at step "
          f"{steps + 2} {log.losses[2]:.4f}")
    check(log.losses[2] < log.losses[0], "the loss fell on the repeated batch")
    after = model.state_dict()
    moved = [k for k, v in after.items() if v.is_floating_point()
             and not torch.equal(v, before[k])]
    stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    n_float = sum(v.is_floating_point() for v in after.values())
    n_stats = 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                      for m in model.modules())
    print(f"{tag} train: {len(moved)} of {n_float} float tensors changed, "
          f"{len(stats)} of them BatchNorm running statistics (of {n_stats})")
    # A bias in front of a BatchNorm has a zero true gradient and may stay.
    check(len(moved) >= 0.95 * n_float and len(stats) == n_stats,
          "the parameters and every BatchNorm statistic moved")
    fusion_params = [k for k in after if ".FRMs." in k or ".FFMs." in k]
    lambdas = [k for k in after if k.endswith(("lambda_channel",
                                               "lambda_spatial"))]
    if flash_calls:
        still = [k for k in fusion_params if after[k].is_floating_point()
                 and k not in moved and not k.endswith(".bias")]
        print(f"{tag} train: {len(lambdas)} lambdas, all moved: "
              f"{set(lambdas) <= set(moved)} (FRMs.0: "
              f"{float(after['backbone.FRMs.0.lambda_channel']):.6f}, "
              f"{float(after['backbone.FRMs.0.lambda_spatial']):.6f}); IFRM/"
              f"IFFM tensors that stayed (biases aside): {still}")
        check(len(lambdas) == 8 and set(lambdas) <= set(moved) and not still,
              "the IFRM/IFFM parameters and both lambdas of every stage moved")

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
    print(f"{tag} train step (CUDA events, host dispatch included): kernel path "
          f"{k1:.2f}/{k2:.2f} ms ({bs * 1e3 / step_ms:.2f} img/s, peak "
          f"{peak:.2f} GiB); plain attention path {p1:.2f}/{p2:.2f} ms "
          f"({bs * 1e3 / plain_step_ms:.2f} img/s, peak {plain_peak:.2f} GiB)")

    prof = profile_steps(trainer, data)
    del trainer, model, before, after
    torch.cuda.empty_cache()

    # One step with drop rates 0, kernel path against plain path.
    cfg0 = cfg.replace(model=dataclasses.replace(
        cfg.model, drop_path_rate=0.0, decoder_dropout_ratio=0.0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg0.replace(model=dataclasses.replace(
        cfg0.model, use_mixed_precision=False))
    both = one_step_losses_and_grads(train_lib, dual_segformer, cfg0,
                                     batches[0], grad_names)
    if vs_truth:
        truth = one_step_losses_and_grads(
            train_lib, dual_segformer, cfg32, batches[0], grad_names,
            paths=(True,))[0]
        bf16 = compare_step_to_truth(f"{tag} bf16", *both, truth, grad_names)
    else:
        bf16 = compare_step(f"{tag} bf16", *both, BF16_LOSS_RTOL,
                            BF16_GRAD_RTOL, grad_names)
    batch32 = batches[0]
    if fp32_batch:
        cfg32 = cfg32.replace(train=dataclasses.replace(
            cfg32.train, batch_size=fp32_batch))
        batch32 = {k: v[:fp32_batch] for k, v in batch32.items()}
    fp32 = compare_step(
        f"{tag} fp32 (TF32 off, batch {cfg32.train.batch_size})",
        *one_step_losses_and_grads(train_lib, dual_segformer, cfg32, batch32,
                                   grad_names),
        FP32_LOSS_RTOL, FP32_GRAD_RTOL, grad_names)
    return {"fwd_launches": fwd_launches, "bwd_launches": bwd_launches,
            "flash_launches": [counts["flash_fwd"], counts["flash_dkv"],
                               counts["flash_dq"]],
            "device_kernels": prof[0] if prof else None,
            "device_ms": prof[1] if prof else None,
            "step_ms": step_ms, "plain_step_ms": plain_step_ms,
            "img_per_s": bs * 1e3 / step_ms, "peak_gib": peak,
            "plain_peak_gib": plain_peak,
            **({"bf16_worst_kernel_to_plain_error_ratio": bf16[0],
                "bf16_grad_rel_to_fp32": bf16[1]} if vs_truth else
               {"bf16_loss_rel": bf16[0], "bf16_grad_rel": bf16[1]}),
            "fp32_loss_rel": fp32[0], "fp32_grad_rel": fp32[1]}


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
            "kernel_device_ms": prof[2] if prof else None,
            "bf16_loss_rel": bf16[0], "bf16_grad_rel": bf16[1],
            "fp32_loss_rel": fp32[0], "fp32_grad_rel": fp32[1]}


# swin_b end to end: the mfnet preset with backbone swin_b (window
# 12, N = 144), the absolute position embedding (its 96x96 grid resized to
# the 120x160 tokens), frozen_stages 2 (the patch embeds, the embeddings and
# stage 0 of both towers frozen: stage 0 runs in eval mode, K3 at rate 0,
# no K4) and SGD with momentum under CyclicLR. One epoch a step (3-epoch
# cycles, no warm-up), so the lr and the momentum change every step; lr
# 1e-3, an SGD-sized lr (the preset's 6e-5 is AdamW's). K3 48 launches a
# forward, K4 44 a step (stage 0's 2 blocks x 2 towers launch no backward).
# The kernel path against the plain composition: one step, every drop rate
# 0, on parameters the step trains. Two bf16 paths of swin_b lie further
# apart than swin_s's bounds allow (the last stage's fc2 5.6% against 5%,
# read on the H100), so, as mit_b2pp's and pst900's, its bf16 kernel path
# is held to the fp32 plain path (TF32 off): at most PP_TRUTH_FACTOR times
# as far from it as the bf16 plain path is (see compare_step_to_truth).
SWIN_B_STEPS = 3
SWIN_B_LR = 1e-3
SWIN_B_GRAD_NAMES = [
    "backbone.layers.1.blocks.0.attn.qkv.weight",
    "backbone.layers.1.blocks.1.attn.relative_position_bias_table",
    "backbone.layers_d.2.blocks.17.attn.relative_position_bias_table",
    "backbone.layers.3.blocks.1.mlp.fc2.weight",
    "backbone.downsamples.0.reduction.weight",
    "backbone.FRMs.0.channel_weights.mlp.0.weight",
    "decode_head.linear_pred.weight"]
# remat: first-step loss and named gradients with remat on against
# off, every drop rate of the preset on (mit_b2: drop-path 0.1 and the
# decoder's Dropout2d 0.1; swin_s: + attention dropout 0.3 in K3/K4), the
# same seed: within REMAT_FACTOR x the distance between two remat-off runs
# (the card's step is not bit-reproducible: cuDNN's weight gradients and
# the resize backward use atomics) plus REMAT_FLOOR (relative L2). A
# recompute that drew other masks lands ~1e-1 away (another sample's
# residual branch dropped).
REMAT_FACTOR, REMAT_FLOOR = 4.0, 1e-3
REMAT_STEPS = 3


def swin_b_cfg(cfg_lib):
    cfg = cfg_lib.mfnet_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, backbone="swin_b",
                                  swin_ape=True, swin_frozen_stages=2),
        train=dataclasses.replace(cfg.train, optimizer="SGDM",
                                  lr_policy="CyclicLR", lr=SWIN_B_LR,
                                  warm_up_epoch=0, niters_per_epoch=1,
                                  cycle_epochs=3))


def swin_b_kernel_phase(W, T):
    """K3 and K4 at swin_b's four stage shapes (window 12, N = 144, d 32,
    heads 4/8/16/32; bf16 K4 takes its cluster kernel, 56 < N <= 144)
    against their plain versions with the swin_s bounds, unshifted and
    masked, rate 0 and 0.3, each backward twice bit-equal; the masks of
    both kernels read off their outputs against the plain mask; the
    backward's route by the profiler's kernel name (bf16: the cluster
    kernel, fp32: the scalar one); then K3's device time a call
    (torch.profiler, shifted and unshifted) and SDPA's forward (CUDA
    events), and K4's rows as the swin_s backward's (time_window_bwd)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(13)
    fwd_err = bwd_err = 0.0
    shapes = [(*s, T.D, T.SWIN_B_WS) for s in T.SWIN_B_STAGES]
    for shape in shapes:
        for shifted in (False, True):
            fwd_err = max(fwd_err, hold_window_fwd(W, T, shape, torch.bfloat16,
                                                   shifted, gen))
            bwd_err = max(bwd_err, hold_window_bwd(W, T, shape, torch.bfloat16,
                                                   shifted, gen))
    seed = torch.empty(1, dtype=torch.int64, device="cuda").random_(
        generator=gen)
    B, Hp, Wp, h, d, ws = shapes[2]
    want = W.keep_mask(seed, B, (Hp // ws) * (Wp // ws), h, ws * ws, T.RATE)
    check(bool(torch.equal(T.kernel_mask(shapes[2], seed, T.RATE), want)),
          f"forward kernel mask != plain at {shapes[2]}")
    check(bool(torch.equal(T.kernel_bwd_mask(shapes[2], seed, T.RATE), want)),
          f"backward kernel mask != plain at {shapes[2]}")
    routes = {}
    for dtype, want_name in ((torch.bfloat16, "window_attention_bwd_cluster"),
                             (torch.float32, "window_attention_bwd_scalar")):
        small = (2, 24, 36, 4, T.D, T.SWIN_B_WS)
        qkv, bias, cot, seed = T.window_inputs(small, dtype, "shifted", gen)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            W.window_attention_bwd(qkv, bias, seed, cot, T.D ** -0.5, T.RATE,
                                   T.SWIN_B_WS)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if "window_attention" in e.key]
        routes[str(dtype)[6:]] = names
        check(len(names) == 1 and want_name in names[0],
              f"{dtype} window-12 backward launched {names}, not {want_name}")
    print(f"swin_b window-12 backward routes: {routes}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for shape in shapes:
        B, Hp, Wp, h, d, ws = shape
        sc = d ** -0.5
        dev = {}
        for shifted in (True, False):
            qkv, bias, cot, seed = T.window_inputs(
                shape, torch.bfloat16, "shifted" if shifted else "unshifted",
                gen)
            fargs = (qkv, bias, seed, sc, T.RATE, ws)
            with torch.no_grad():
                dev[shifted] = T.kernel_ms(lambda: W.window_attention(*fargs))
        lq, lk, lv, mask = T.sdpa_inputs(qkv, bias, shape)
        with torch.no_grad():
            lib_fwd = median_ms(lambda: sdpa(lq, lk, lv, attn_mask=mask,
                                             dropout_p=T.RATE, scale=sc),
                                reps=5)
        del lq, lk, lv, mask
        bf = [bound_ms(*reversed(T.work(shape, sh, False)))
              for sh in (True, False)]
        row = {"shape": list(shape), "fwd_device_ms": device_reading(dev),
               "sdpa_fwd_ms": lib_fwd,
               "fwd_bound_ms": (bf[0][0] + bf[1][0]) / 2,
               "bound_by": bf[0][1]}
        rows.append(row)
        print(f"swin_b window attention forward (B,Hp,Wp,h,d,ws)={shape}, "
              f"rate {T.RATE}: K3 device {ms_text(row['fwd_device_ms'])} ms; "
              f"SDPA forward {lib_fwd:.4f} ms (CUDA events); bound "
              f"{row['fwd_bound_ms']:.4f} ms ({row['bound_by']})")
    bwd_rows = time_window_bwd(W, T, T.SWIN_B_STAGES, T.SWIN_B_WS, gen)
    per = {}
    for key, calls in (("fwd_device_ms", SWIN_CALLS),
                       ("sdpa_fwd_ms", SWIN_CALLS),
                       ("fwd_bound_ms", SWIN_CALLS)):
        per[key] = per_step(rows, key, calls)
    for key in ("ms", "device_ms", "library_ms", "bound_ms"):
        per[f"bwd_{key}"] = per_step(bwd_rows, key, T.SWIN_B_BWD_CALLS)
    print("swin_b window attention a step (48 forward calls, 44 backward): "
          + ", ".join(f"{k} {ms_text(v)}" for k, v in per.items()))
    return {"fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err,
            "routes": routes, "per_call": rows, "bwd_per_call": bwd_rows,
            "per_step": per}


def swin_b_phase(S, W, T, cfg_lib, builder, evaluator_lib, train_lib,
                 dual_swin, items):
    """swin_b with the absolute position embedding, frozen stages 2, SGDM
    and CyclicLR at full width and depth: evaluate() (K3 48 a forward),
    SWIN_B_STEPS counted train steps (K3 48, K4 44 a step; the optimizer's
    lr and momentum those of the schedule at each step; frozen parameters
    bit-unchanged, the others moved), the step's time, device time and
    peak memory, and one step with drop rates 0 on the kernel path against
    the plain composition (bf16, held to the fp32 plain path)."""
    import torch

    from rgbx_semantic_segmentation_tpu_torch import lr_schedules, optim

    cfg = swin_b_cfg(cfg_lib)
    model = builder.build_model(cfg, seed=0)
    blocks = [m for m in model.modules() if isinstance(m, dual_swin.SwinBlock)]
    check(len(blocks) == 48 and blocks[0].window_size == 12
          and blocks[0].attn.qkv.in_features == 128
          and blocks[-1].attn.num_heads == 32
          and tuple(model.backbone.absolute_pos_embed.shape) == (1, 128, 96,
                                                                 96),
          "swin_b at full width and depth with its 96x96 embedding")
    ev = evaluator_lib.SegEvaluator(cfg, model)
    ev.evaluate(items[:EVAL_BATCH], eval_batch=EVAL_BATCH)  # warm-up
    W.window_attention.launches = 0
    W.window_attention_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, _ = ev.evaluate(items, eval_batch=EVAL_BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eval_launches = W.window_attention.launches
    forwards = N_IMAGES // EVAL_BATCH
    print(f"swin_b eval: {N_IMAGES} images, {eval_launches} K3 launches "
          f"(expected {48 * forwards}), {N_IMAGES / dt:.2f} img/s")
    check(eval_launches == 48 * forwards
          and W.window_attention_bwd.launches == 0
          and np.isfinite(scores.pixel_acc), "swin_b eval launches")
    del model, ev
    torch.cuda.empty_cache()

    batches = uint8_batches(items, cfg.train.batch_size)
    trainer = train_lib.Trainer(cfg, seed=0)
    model = trainer.model
    frozen = optim.frozen_mask(cfg, model)
    named = dict(model.named_parameters())
    check(sum(frozen.values()) > 0
          and all(named[n].requires_grad != f for n, f in frozen.items()),
          "frozen parameters require no gradient")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lr_s, mom_s = lr_schedules.cyclic_schedules(cfg.train)
    counters = (W.window_attention, W.window_attention_bwd, S.sr_attention)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for step in range(SWIN_B_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(float(trainer.step(batches[step % 2])["loss"]))
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        lr, mom = optim.applied_lr(trainer.optimizer), \
            optim.applied_momentum(trainer.optimizer)
        print(f"swin_b step {step}: loss {losses[-1]:.4f}, lr {lr:.6g} "
              f"(schedule {lr_s(step):.6g}), momentum {mom:.6g} (schedule "
              f"{mom_s(step):.6g}), {step_ms[-1]:.1f} ms (CUDA events)")
        check(lr == lr_s(step) and mom == mom_s(step),
              "the optimizer's lr and momentum are the schedule's")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd, bwd = W.window_attention.launches, W.window_attention_bwd.launches
    print(f"swin_b train: {SWIN_B_STEPS} steps, K3 {fwd} launches (expected "
          f"{48 * SWIN_B_STEPS}), K4 {bwd} (expected {44 * SWIN_B_STEPS}), "
          f"peak {peak:.2f} GiB, losses {losses}")
    check(fwd == 48 * SWIN_B_STEPS and bwd == 44 * SWIN_B_STEPS
          and S.sr_attention.launches == 0, f"swin_b launches {fwd}/{bwd}")
    check(all(np.isfinite(losses)), "swin_b losses finite")
    check(len({round(mom_s(s), 9) for s in range(SWIN_B_STEPS)}) > 1,
          "the momentum schedule moves over the steps")
    after = model.state_dict()
    changed = {k for k, v in after.items() if v.is_floating_point()
               and not torch.equal(v, before[k])}
    still = [n for n, f in frozen.items() if f and n in changed]
    trainable = [n for n, f in frozen.items() if not f]
    moved = [n for n in trainable if n in changed]
    print(f"swin_b train: {sum(frozen.values())} frozen tensors, "
          f"{len(still)} of them changed; {len(moved)} of {len(trainable)} "
          "trainable tensors moved")
    check(not still, f"frozen parameters changed: {still[:4]}")
    # A bias in front of a BatchNorm has a zero true gradient and may stay.
    check(len(moved) >= 0.95 * len(trainable), "the trainable ones moved")
    prof = profile_steps(trainer, cycle(batches))
    del trainer, model, before, after
    torch.cuda.empty_cache()

    def no_drop(m):
        for mod in m.modules():
            if isinstance(mod, dual_swin.WindowAttention):
                mod.attn_drop.rate = 0.0

    cfg0 = cfg.replace(model=dataclasses.replace(
        cfg.model, drop_path_rate=0.0, decoder_dropout_ratio=0.0))
    both = one_step_losses_and_grads(train_lib, dual_swin, cfg0, batches[0],
                                     SWIN_B_GRAD_NAMES, no_drop)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg0.replace(model=dataclasses.replace(
        cfg0.model, use_mixed_precision=False))
    truth = one_step_losses_and_grads(train_lib, dual_swin, cfg32,
                                      batches[0], SWIN_B_GRAD_NAMES, no_drop,
                                      paths=(True,))[0]
    bf16 = compare_step_to_truth("swin_b bf16", *both, truth,
                                 SWIN_B_GRAD_NAMES)
    torch.cuda.empty_cache()
    return {"eval_launches": eval_launches, "fwd_launches": fwd,
            "bwd_launches": bwd, "eval_img_per_s": N_IMAGES / dt,
            "step_ms": step_ms, "losses": losses, "peak_gib": peak,
            "device_kernels": prof[0] if prof else None,
            "device_ms": prof[1] if prof else None,
            "kernel_device_ms": prof[2] if prof else None,
            "bf16_worst_kernel_to_plain_error_ratio": bf16[0],
            "bf16_grad_rel_to_fp32": bf16[1]}


def remat_launches(remat, i):
    """Launches of counter i (K1, K2, K3, K4) over remat_phase's counted
    steps, both models, remat off and on."""
    return sum(r[on]["launches"][i] for r in remat.values()
               for on in ("off", "on"))


def _first_step(train_lib, cfg, batch, names):
    """Loss and named gradients of one Trainer step from seed-0 weights."""
    import torch

    trainer = train_lib.Trainer(cfg, seed=0)
    loss = float(trainer.step(batch)["loss"])
    named = dict(trainer.model.named_parameters())
    grads = {n: named[n].grad.float().clone() for n in names}
    del trainer, named
    torch.cuda.empty_cache()
    return loss, grads


def _rel(a, b, names):
    """Worst relative L2 distance between two (loss, gradients) readings."""
    (la, ga), (lb, gb) = a, b
    return max([abs(la - lb) / abs(lb)]
               + [float((ga[n] - gb[n]).norm() / gb[n].norm())
                  for n in names])


def remat_phase(S, W, cfg_lib, train_lib, items):
    """remat off and on for mit_b2 and swin_s with the preset's drop rates:
    REMAT_STEPS steps each (1 warm-up, the rest counted: K1 64 forward
    launches a step with remat, 32 without; K2 32; swin_s K3 96 / 48 and K4
    48), step ms and peak GiB; the first step's loss and named gradients
    with remat held to two remat-off runs' spread."""
    import torch

    out = {}
    for tag, cfg, names in (("mit_b2", cfg_lib.mfnet_config(), GRAD_NAMES),
                            ("swin_s", swin_cfg(cfg_lib), SWIN_GRAD_NAMES)):
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    warm_up_epoch=0))
        batches = uint8_batches(items, cfg.train.batch_size)
        res = {}
        for remat in (False, True):
            c = cfg.replace(model=dataclasses.replace(cfg.model, remat=remat))
            trainer = train_lib.Trainer(c, seed=0)
            data = cycle(batches)
            trainer.fit_epoch(data, 1)
            counters = (S.sr_attention, S.sr_attention_bwd,
                        W.window_attention, W.window_attention_bwd)
            for fn in counters:
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            steps = REMAT_STEPS - 1
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            trainer.fit_epoch(data, steps)
            b.record()
            b.synchronize()
            counts = [fn.launches // steps for fn in counters]
            res[remat] = {"step_ms": a.elapsed_time(b) / steps,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30,
                          "launches_per_step": counts,
                          "launches": [fn.launches for fn in counters]}
            print(f"{tag} remat={remat}: {res[remat]['step_ms']:.1f} ms a "
                  f"step (CUDA events, {steps} steps), peak "
                  f"{res[remat]['peak_gib']:.2f} GiB; launches a step K1 "
                  f"{counts[0]}, K2 {counts[1]}, K3 {counts[2]}, K4 "
                  f"{counts[3]}")
            del trainer
            torch.cuda.empty_cache()
        want = ({False: [32, 32, 0, 0], True: [64, 32, 0, 0]}
                if tag == "mit_b2" else
                {False: [0, 0, 48, 48], True: [0, 0, 96, 48]})
        check(all(res[r]["launches_per_step"] == want[r] for r in res),
              f"{tag} launches a step {res}")
        off1 = _first_step(train_lib, cfg, batches[0], names)
        off2 = _first_step(train_lib, cfg, batches[0], names)
        on = _first_step(train_lib, cfg.replace(model=dataclasses.replace(
            cfg.model, remat=True)), batches[0], names)
        spread, dist = _rel(off2, off1, names), _rel(on, off1, names)
        bound = REMAT_FACTOR * spread + REMAT_FLOOR
        print(f"{tag} first step with dropout on: remat vs off {dist:.3e} "
              f"(bound {bound:.3e}), two remat-off runs {spread:.3e} apart; "
              f"losses {off1[0]:.6f} / {off2[0]:.6f} / {on[0]:.6f}")
        check(np.isfinite(dist) and dist <= bound, f"{tag} remat gradients")
        out[tag] = {"off": res[False], "on": res[True], "spread": spread,
                    "remat_vs_off": dist}
    return out


def lbfgs_phase(S, cfg_lib, train_lib, items):
    """mit_b2 with LBFGS (the preset's lr): 2 steps on one batch; the
    line search's evaluations a step, K1 and K2 launching 32 x (1 + those)
    times a step, the loss falling along each step's line (the accepted
    point's loss below the step's first, on the step's own masks), the
    BatchNorm running statistics after each step those one train-mode
    forward with the step's masks gives, step ms and peak memory beside
    the optimizer's memory."""
    import copy

    import torch

    from rgbx_semantic_segmentation_tpu_torch.ops.layers import (
        set_generator)

    cfg = cfg_lib.mfnet_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, optimizer="LBFGS"))
    batch = uint8_batches(items, cfg.train.batch_size)[0]
    trainer = train_lib.Trainer(cfg, seed=0)
    model = trainer.model
    mean = torch.tensor(cfg.dataset.norm_mean, device="cuda")
    std = torch.tensor(cfg.dataset.norm_std, device="cuda")
    rgb = (torch.from_numpy(batch["rgb"]).cuda().float() / 255 - mean) / std
    mx = (torch.from_numpy(batch["modal_x"]).cuda().float() / 255 - mean) / std
    stats = [n for n, _ in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    losses, rows = [], []
    torch.cuda.reset_peak_memory_stats()
    trainer_gen = next(m.generator for m in model.modules()
                       if getattr(m, "generator", None) is not None)
    for step in range(2):
        # the step's first forward, on a copy: the Trainer's seed (0) and
        # step fix its masks
        set_generator(model, None)
        ref = copy.deepcopy(model).train()
        set_generator(model, trainer_gen)
        gen = torch.Generator(device="cuda").manual_seed(
            train_lib.step_seed(0, step))
        set_generator(ref, gen)
        with torch.no_grad():
            ref(rgb, mx)
        want = dict(ref.named_buffers())
        del ref
        S.sr_attention.launches = S.sr_attention_bwd.launches = 0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(float(trainer.step(batch)["loss"]))
        b.record()
        b.synchronize()
        info = dict(trainer.optimizer.last_step)
        got = dict(model.named_buffers())
        err = max(float((got[n] - want[n]).abs().max()
                        / want[n].abs().max().clamp_min(1e-12))
                  for n in stats)
        k1, k2 = S.sr_attention.launches, S.sr_attention_bwd.launches
        evals = info["evaluations"]
        rows.append({"step_ms": a.elapsed_time(b), "evaluations": evals,
                     "stepsize": info["stepsize"], "k1": k1, "k2": k2,
                     "bn_rel_err": err, "value_after": info["value"]})
        print(f"LBFGS step {step}: loss {losses[-1]:.5f} -> "
              f"{info['value']:.5f} at step size {info['stepsize']:.4g}, "
              f"{evals} line-search evaluations, K1 {k1} / K2 {k2} "
              f"launches (expected {32 * (1 + evals)} each), "
              f"{rows[-1]['step_ms']:.1f} ms (CUDA events); BatchNorm "
              f"statistics against one forward: {err:.2e} of their largest")
        # the line search's accepted point, on the step's own masks
        check(info["value"] < losses[-1], f"LBFGS step {step}: the loss "
              "did not fall")
        check(k1 == k2 == 32 * (1 + evals), "K1/K2 launches a step")
        check(err <= 1e-5, "BatchNorm statistics from one forward only")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    opt = trainer.optimizer
    st = opt.state[opt.param_groups[0]["params"][0]]
    mem = sum(v.numel() * v.element_size() for v in st.values()
              if torch.is_tensor(v)) / 2 ** 30
    n_params = sum(p.numel() for p in model.parameters())
    print(f"LBFGS: {n_params / 1e6:.2f} M parameters, optimizer memory "
          f"{mem:.2f} GiB, peak {peak:.2f} GiB; losses {losses}")
    check(all(np.isfinite(losses)), "LBFGS losses finite")
    del trainer, model
    torch.cuda.empty_cache()
    return {"steps": rows, "losses": losses, "peak_gib": peak,
            "optimizer_gib": mem, "params_m": n_params / 1e6,
            "k1": sum(r["k1"] for r in rows),
            "k2": sum(r["k2"] for r in rows)}


# The CLI phase: a synthetic MFNet-shaped dataset on disk (PNG triples),
# CLI_TRAIN train and CLI_VAL val pairs at 480x640, epochs of CLI_NITERS
# steps of batch 8. The preset's warm-up (10 epochs) covers every step, so
# the lr does not depend on --epochs and a resumed run takes the steps of an
# uninterrupted one. CLI_STEADY_NITERS batches an epoch for the loader
# alone, the loader feeding Trainer.fit_epoch and one more train_cli run:
# their steady rates are read over batches (steps) 2..N, without the
# workers' start-up.
CLI_TRAIN, CLI_VAL, CLI_NITERS, CLI_STEADY_NITERS = 16, 8, 3, 16
# Resume on the card: the step is not bit-reproducible (atomics in cuDNN's
# weight gradients, the bilinear resize backward and the loss), so the
# resumed run is held to the spread of two uninterrupted runs: its distance
# (relative L2 per group of tensors) from one uninterrupted run may be at
# most RESUME_FACTOR times the distance between the two uninterrupted runs,
# plus RESUME_FLOOR. A resume that lost the optimizer moments or the step
# moves every weight by about the lr (1e-5 here), orders beyond that.
RESUME_FACTOR, RESUME_FLOOR = 4.0, 1e-6


def _state_groups(payload):
    """A checkpoint's tensors in groups: weights, BatchNorm statistics and
    the two AdamW moments, each flattened into one fp32 vector."""
    import torch

    model = payload["model"]
    stats = [k for k in model if k.endswith(("running_mean", "running_var"))]
    weights = [k for k in model if model[k].is_floating_point()
               and k not in stats]
    opt = payload["optimizer"]["state"]
    cat = lambda ts: torch.cat([t.float().flatten() for t in ts])
    return {"weights": cat(model[k] for k in weights),
            "bn_stats": cat(model[k] for k in stats),
            "exp_avg": cat(opt[i]["exp_avg"] for i in sorted(opt)),
            "exp_avg_sq": cat(opt[i]["exp_avg_sq"] for i in sorted(opt))}


def cli_phase(S, cfg_lib, train):
    """The port's CLIs on the card, through the entry points a user calls:
    the loader alone (native and numpy image ops, pinned or not), the feed
    into Trainer.fit_epoch pinned or not or from batches held in memory,
    train_cli for 2 epochs, -c to 3 (a profiled last epoch), two
    uninterrupted 3-epoch runs, one epoch of CLI_STEADY_NITERS steps (its
    steady rate), eval_cli -e last against SegEvaluator.evaluate
    in-process, predict_cli -e last against the eval's PNGs; K1/K2 launches
    counted over the CLI calls. `train` is the train phase's record (its
    in-memory rate and device time a step)."""
    import tempfile

    import torch
    from PIL import Image

    from rgbx_semantic_segmentation_tpu_torch import (
        eval_cli, predict_cli, train_cli)
    from rgbx_semantic_segmentation_tpu_torch.checkpoint import (
        CheckpointManager)
    from rgbx_semantic_segmentation_tpu_torch.data import cv_ops
    from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
    from rgbx_semantic_segmentation_tpu_torch.data.loader import TrainLoader
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)
    from rgbx_semantic_segmentation_tpu_torch.evaluator import SegEvaluator
    from rgbx_semantic_segmentation_tpu_torch.models.builder import (
        build_model)
    from rgbx_semantic_segmentation_tpu_torch.native import cv_ops as native
    from rgbx_semantic_segmentation_tpu_torch.train import Trainer

    out = {}
    cfg = cfg_lib.mfnet_config()
    bs = cfg.train.batch_size
    launches = {"fwd": 0, "bwd": 0}

    def counted(tag, fn, argv, fwd, bwd):
        """Run a CLI's main(argv) with K1/K2's counts from 0; check them
        against `fwd` / `bwd` forwards / backwards of 32 calls each."""
        S.sr_attention.launches = S.sr_attention_bwd.launches = 0
        result = fn(argv)
        got = (S.sr_attention.launches, S.sr_attention_bwd.launches)
        print(f"  {tag}: K1 {got[0]}, K2 {got[1]} launches (expected "
              f"{32 * fwd}, {32 * bwd})")
        check(got == (32 * fwd, 32 * bwd), f"{tag} launches {got}")
        launches["fwd"] += got[0]
        launches["bwd"] += got[1]
        torch.cuda.empty_cache()
        return result

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        make_synthetic_dataset(data, num_train=CLI_TRAIN, num_val=CLI_VAL,
                               hw=HW, num_classes=cfg.dataset.num_classes,
                               seed=0)
        print(f"CLI phase: synthetic dataset, {CLI_TRAIN} + {CLI_VAL} PNG "
              f"triples at {HW}, written in {time.perf_counter() - t0:.2f} s")
        lcfg = cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, train_source="train.txt"),
            train=dataclasses.replace(cfg.train,
                                      niters_per_epoch=CLI_STEADY_NITERS))
        n = CLI_STEADY_NITERS

        def rates(t0, stamps, t_end):
            """img/s over the whole epoch (from t0, the workers' start-up
            included) and steady, over batches 2..N (from the second
            batch's stamp)."""
            return {"epoch": n * bs / (t_end - t0),
                    "steady": (n - 1) * bs / (t_end - stamps[1])}

        def stamped(batches, stamps):
            for batch in batches:
                stamps.append(time.perf_counter())
                yield batch

        # The loader alone: one epoch, no step, in turns, after an untimed
        # epoch (the files in the page cache, scipy imported).
        cv_ops.gaussian_blur(np.zeros((8, 8, 3), np.uint8))
        for _ in TrainLoader(lcfg, root=data).epoch(0):
            pass
        alone = {}
        for tag, ops, pin in (("native, pinned", native, True),
                              ("native", native, False),
                              ("numpy", cv_ops, False),
                              ("numpy, pinned", cv_ops, True),
                              ("native, pinned", native, True),
                              ("native", native, False)):
            loader = TrainLoader(lcfg, root=data, ops=ops, pin_memory=pin)
            stamps = []
            t0 = time.perf_counter()
            for batch in stamped(loader.epoch(1), stamps):
                check(batch["rgb"].is_pinned() == pin
                      and batch["rgb"].shape == (bs, *HW, 3),
                      f"loader batch ({tag})")
            check(len(stamps) == n, f"loader epoch of {n} batches ({tag})")
            alone.setdefault(tag, []).append(
                rates(t0, stamps, stamps[-1]))
        out["loader_img_per_s"] = alone
        rates_text = lambda d: "; ".join(
            "%s %s img/s" % (k, ", ".join(
                "%.1f (epoch %.1f)" % (r["steady"], r["epoch"]) for r in v))
            for k, v in d.items())
        print(f"loader alone, one epoch of {n} batches of {bs} "
              f"({loader.num_workers} threads), steady over batches 2..{n} "
              f"(whole epoch with the workers' start-up): {rates_text(alone)}")

        # The feed: TrainLoader into Trainer.fit_epoch, pinned or not, and
        # the same trainer on the batches of one loader epoch held in pinned
        # memory, in turns after a warm-up epoch; then the checkpoint write
        # of that trainer.
        memory = list(TrainLoader(lcfg, root=data).epoch(0))
        trainer = Trainer(lcfg, seed=0)
        feed = {}
        for epoch, kind in enumerate(
                ("pinned", "pinned", "pageable", "in memory", "pageable",
                 "pinned", "in memory"), start=1):
            loader = TrainLoader(lcfg, root=data,
                                 pin_memory=kind != "pageable")
            stamps = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.closing(
                    (b for b in memory) if kind == "in memory"
                    else loader.epoch(epoch)) as batches:
                trainer.fit_epoch(stamped(batches, stamps), n)
            torch.cuda.synchronize()
            if epoch > 1:   # the first is the warm-up
                feed.setdefault(kind, []).append(
                    rates(t0, stamps, time.perf_counter()))
        del memory
        out["feed_img_per_s"] = feed
        print(f"TrainLoader -> fit_epoch, {n} steps an epoch (after a "
              f"warm-up epoch), steady over steps 2..{n} (whole epoch): "
              f"{rates_text(feed)}")
        mgr = CheckpointManager(os.path.join(tmp, "ck"))
        writes = []
        for epoch in (1, 2):
            t0 = time.perf_counter()
            path = mgr.save(epoch, trainer)
            writes.append(time.perf_counter() - t0)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        fresh = Trainer(lcfg, init_values=False)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(mgr.restore(fresh) == 3, "restore resumes at epoch + 1")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        moments = [st[k] for st in fresh.optimizer.state.values()
                   for k in ("exp_avg", "exp_avg_sq")]
        steps = [st["step"] for st in fresh.optimizer.state.values()]
        check(all(m.is_cuda for m in moments)
              and all(not t.is_cuda and t.dtype == torch.float32
                      and t.dim() == 0 for t in steps)
              and all(p.is_cuda for p in fresh.model.parameters()),
              "restored: moments on the card, AdamW steps fp32 CPU scalars")
        check(fresh.global_step == trainer.global_step, "restored global step")
        out["checkpoint"] = {"bytes": size, "write_s": writes,
                             "restore_s": restore_s}
        print(f"checkpoint (mit_b2 + AdamW): {size / 1e6:.1f} MB, written in "
              f"{', '.join('%.2f' % w for w in writes)} s, restored in "
              f"{restore_s:.2f} s (model build {build_s:.2f} s); moments on "
              "the card, AdamW step counters fp32 CPU scalars")
        del trainer, fresh, moments, steps
        shutil.rmtree(os.path.join(tmp, "ck"))
        torch.cuda.empty_cache()

        # train_cli: 2 epochs, -c to 3 with the last epoch profiled; two
        # uninterrupted 3-epoch runs in other directories.
        argv = ["--config", "mfnet", "--dataset_root", data,
                "--train_source", "train.txt", "--niters", str(CLI_NITERS)]
        for run in ("A", "B", "C"):
            os.makedirs(os.path.join(tmp, run))
        with contextlib.chdir(os.path.join(tmp, "A")):
            first = counted("train_cli --epochs 2", train_cli.main,
                            argv + ["--epochs", "2"], 2 * CLI_NITERS,
                            2 * CLI_NITERS)
            resumed = counted("train_cli -c --epochs 3 -p", train_cli.main,
                              argv + ["--epochs", "3", "-c", "-p",
                                      os.path.join(tmp, "prof")],
                              CLI_NITERS, CLI_NITERS)
        whole = {}
        for run in ("B", "C"):
            with contextlib.chdir(os.path.join(tmp, run)):
                whole[run] = counted(f"train_cli --epochs 3 ({run})",
                                     train_cli.main, argv + ["--epochs", "3"],
                                     3 * CLI_NITERS, 3 * CLI_NITERS)
        # train_cli's steady rate: one epoch of n steps, the steps' entries
        # and the end of fit_epoch (which reads the mean loss: a sync)
        # stamped on the host clock.
        stamps = []
        step, fit_epoch = Trainer.step, Trainer.fit_epoch

        def timed_step(self, batch):
            stamps.append(time.perf_counter())
            return step(self, batch)

        def timed_fit_epoch(self, *a, **kw):
            result = fit_epoch(self, *a, **kw)
            stamps.append(time.perf_counter())
            return result

        os.makedirs(os.path.join(tmp, "D"))
        Trainer.step, Trainer.fit_epoch = timed_step, timed_fit_epoch
        try:
            with contextlib.chdir(os.path.join(tmp, "D")):
                long_run = counted(
                    f"train_cli --epochs 1 --niters {n}", train_cli.main,
                    argv[:-2] + ["--niters", str(n), "--epochs", "1"], n, n)
        finally:
            Trainer.step, Trainer.fit_epoch = step, fit_epoch
        check(len(stamps) == n + 1 and np.isfinite(long_run[0]["loss"]),
              f"train_cli ran {n} steps")
        steady = (n - 1) * bs / (stamps[-1] - stamps[1])
        # The device's busy time a step, from the train phase's profile of
        # the same step on in-memory batches.
        idle = (None if train["device_ms"] is None
                else 1.0 - train["device_ms"] * steady / (bs * 1e3))
        shutil.rmtree(os.path.join(tmp, "D"))
        records = first + resumed
        check([r["epoch"] for r in records] == [1, 2, 3]
              and all(np.isfinite(r["loss"]) for r in records),
              "train_cli epochs 1, 2, then 3 after -c, finite losses")
        prof = resumed[-1].get("profile")
        check(prof is not None and prof["device_busy_ms"] is not None,
              "the profiled epoch recorded device time")
        out["train_cli"] = {"epochs": records, "uninterrupted": whole["B"],
                            "profile": prof,
                            "steady": {"steps": n, "img_per_s": steady,
                                       "epoch_img_per_s":
                                           long_run[0]["img_per_s"],
                                       "idle_share_estimate": idle}}
        rate_text = lambda recs: ", ".join(
            "%.1f" % r["img_per_s"] for r in recs)
        print(f"train_cli img/s per epoch of {CLI_NITERS} steps (workers' "
              f"start-up included): {rate_text(records)} (2 epochs, then "
              f"-c); uninterrupted {rate_text(whole['B'])}")
        print(f"train_cli, one epoch of {n} steps: steady over steps 2..{n} "
              f"{steady:.1f} img/s, whole epoch "
              f"{long_run[0]['img_per_s']:.1f} img/s; in-memory batches "
              f"(train phase, 2-step readings) {train['img_per_s']:.1f} "
              f"img/s; device idle share at the steady rate {idle} "
              f"(estimated: 1 - the train phase's device time a step, "
              f"{train['device_ms']} ms, over the steady step)")
        print(f"train_cli, profiled epoch 3 ({CLI_NITERS} steps): wall "
              f"{prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle share "
              f"{prof['idle_share']:.3f} (under the profiler)")

        tag = cfg.tag()
        ck = {run: CheckpointManager(os.path.join(tmp, run, "logs", tag,
                                                  "checkpoint"))
              for run in ("A", "B", "C")}
        check(ck["A"].all_epochs() == [2, 3] and ck["B"].all_epochs() == [3],
              "checkpoints at the cadence: the last epoch of each run")
        pa, pb, pc = (ck[r].load(3) for r in ("A", "B", "C"))
        check(pa["iteration"] == pb["iteration"] == 3 * CLI_NITERS
              and pa["epoch"] == pb["epoch"] == 3, "resumed epoch and step")
        check(pa["optimizer"]["param_groups"]
              == pb["optimizer"]["param_groups"], "optimizer lr and groups")
        check(all(torch.equal(pa["optimizer"]["state"][i]["step"],
                              pb["optimizer"]["state"][i]["step"])
                  for i in pb["optimizer"]["state"]), "AdamW step counters")
        check(all(torch.equal(pa["model"][k], pb["model"][k])
                  for k in pb["model"] if k.endswith("num_batches_tracked")),
              "BatchNorm batch counters")
        ga, gb, gc = (_state_groups(p) for p in (pa, pb, pc))
        resume = {}
        for name in gb:
            norm = float(gb[name].norm())
            d_ab = float((ga[name] - gb[name]).norm()) / norm
            d_cb = float((gc[name] - gb[name]).norm()) / norm
            resume[name] = {"resumed": d_ab, "two_runs": d_cb,
                            "bit_equal": bool(torch.equal(ga[name], gb[name]))}
            print(f"  resume {name}: rel L2 from an uninterrupted run "
                  f"{d_ab:.3e}, between two uninterrupted runs {d_cb:.3e} "
                  f"(bound {RESUME_FACTOR:g}x + {RESUME_FLOOR:g}); bit-equal "
                  f"{resume[name]['bit_equal']}")
            check(d_ab <= RESUME_FACTOR * d_cb + RESUME_FLOOR,
                  f"resume {name}: {d_ab} vs {d_cb}")
        out["resume"] = resume
        del pb, pc, gb, gc

        # eval_cli -e last against SegEvaluator.evaluate on the same weights
        with contextlib.chdir(os.path.join(tmp, "A")):
            res = counted("eval_cli -e last", eval_cli.main,
                          ["--config", "mfnet", "--dataset_root", data,
                           "-e", "last", "-p", "eval_out"],
                          CLI_VAL // bs, 0)
            names = counted("predict_cli -e last", predict_cli.main,
                            ["--config", "mfnet", "--dataset_root", data,
                             "-e", "last", "-p", "pred_out"], CLI_VAL // bs, 0)
        check(list(res) == ["epoch 3"], "eval_cli evaluated epoch 3")
        scores, hist = res["epoch 3"]
        model = build_model(cfg, seed=None)
        model.load_state_dict(pa["model"], strict=True)
        del pa, ga
        ev = SegEvaluator(cfg, model)
        ref, _ = ev.evaluate(RGBXDataset(cfg.dataset, "val", root=data),
                             eval_batch=8)
        check(np.array_equal(hist, ev.last_hist) and hist.sum() > 0,
              "eval_cli's confusion matrix is evaluate()'s")
        print(f"eval_cli -e last: mIoU {scores.mean_iou:.4f}, pixel acc "
              f"{scores.pixel_acc:.4f}, confusion matrix equal to evaluate() "
              f"in-process ({int(hist.sum())} pixels)")
        same = 0
        for name in names:
            a = np.asarray(Image.open(os.path.join(tmp, "A", "pred_out",
                                                   name + ".png")))
            b = np.asarray(Image.open(os.path.join(tmp, "A", "eval_out",
                                                   name + ".png")))
            check(a.shape == HW, f"predict PNG {name} shape")
            same += int(np.array_equal(a, b))
        check(same == len(names) == CLI_VAL,
              f"predict_cli PNGs equal the eval's argmax ({same} of "
              f"{len(names)})")
        print(f"predict_cli -e last: {len(names)} PNGs, all equal to the "
              "eval's argmax maps")
        out["eval"] = {"mean_iou": scores.mean_iou,
                       "pixel_acc": scores.pixel_acc}
        del model, ev
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# The nyu protocol (scales 0.75, 1, 1.25 at the crop 480x640, stride 2/3)
# with flip, on (size, count) items with a 3-channel X: 480x640 (one-shot at
# 0.75 and 1, the 2x2 grid at 1.25) and 720x960 (a grid at every scale:
# 2x2, 2x2, 3x3). Kernel path vs plain attention path: argmax agreement.
PROTO_ITEMS = (((480, 640), 3), ((720, 960), 2))
PROTO_AGREE = 0.99
# pst900 through the CLIs: train and val PNG triples, steps of the epoch.
PST_CLI_TRAIN, PST_CLI_VAL, PST_CLI_NITERS = 16, 8, 3


def forwards_of(evaluator_lib, ev, hw):
    """Windows of each scale's forward for a raw image of size `hw` under
    evaluator `ev` (1 where the scaled image fits the crop on one side)."""
    ch, cw = ev.crop
    out = []
    for s in ev.scales:
        h, w = round(hw[0] * s), round(hw[1] * s)
        out.append(1 if h <= ch or w <= cw else len(evaluator_lib._window_grid(
            h, w, ev.crop, ev.stride_rate)))
    return out


def write_nyu_dataset(root, items):
    """`items` on disk in the nyu preset's layout: RGB/*.jpg, HHA/*.jpg,
    Label/*.png (class + 1: the preset's gt_transform subtracts 1, 0
    becoming the ignore label), test.txt."""
    from PIL import Image

    for sub in ("RGB", "HHA", "Label"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for it in items:
        # the pipeline's images are BGR (cv2 order): back to RGB for PIL
        Image.fromarray(it["rgb"][:, :, ::-1]).save(
            os.path.join(root, "RGB", it["fn"] + ".jpg"), quality=95)
        Image.fromarray(it["modal_x"][:, :, ::-1]).save(
            os.path.join(root, "HHA", it["fn"] + ".jpg"), quality=95)
        label = np.where(it["label"] == 255, 0, it["label"] + 1)
        Image.fromarray(label.astype(np.uint8)).save(
            os.path.join(root, "Label", it["fn"] + ".png"))
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(it["fn"] for it in items) + "\n")


def protocol_phase(S, cfg_lib, builder, evaluator_lib, dual_segformer):
    """The nyu preset's protocol with flip (multi-scale, the sliding grid,
    the flipped forward) on the card: evaluate(eval_batch=8) against
    per-image sliding_eval_rgbx (equal maps), K1's launches against the
    forwards the grid predicts, the kernel path against the plain attention
    path (argmax agreement); then eval_cli --compat-stride-swap on the same
    items written in the preset's layout, against an in-process evaluator
    with the flag."""
    import tempfile

    import torch
    from PIL import Image

    from rgbx_semantic_segmentation_tpu_torch import eval_cli
    from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset

    preset = cfg_lib.nyu_config()
    cfg = preset.replace(eval=dataclasses.replace(preset.eval, eval_flip=True))
    check(cfg.model.backbone == "mit_b2"
          and tuple(cfg.eval.eval_scale_array) == (0.75, 1.0, 1.25)
          and tuple(cfg.eval.eval_crop_size) == HW
          and not cfg.dataset.x_is_single_channel, "the nyu preset's protocol")
    nc = cfg.dataset.num_classes
    items = []
    for i, (hw, n) in enumerate(PROTO_ITEMS):
        items += synthetic_items(n, hw, nc, seed=10 + i, x_channels=3)
    for j, it in enumerate(items):
        it["fn"] = f"proto_{j:02d}"
    model = builder.build_model(cfg, seed=0)
    ev = evaluator_lib.SegEvaluator(cfg, model)
    windows = [forwards_of(evaluator_lib, ev, it["rgb"].shape[:2])
               for it in items]
    forwards = sum(len(w) for w in windows) * (2 if ev.flip else 1)
    ev.sliding_eval_rgbx(items[0]["rgb"], items[0]["modal_x"])   # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        S.sr_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, _ = ev.evaluate(items, eval_batch=EVAL_BATCH, save_path=tmp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = S.sr_attention.launches
        batched = [np.asarray(Image.open(os.path.join(tmp, it["fn"] + ".png")))
                   for it in items]
    print(f"nyu protocol (scales {ev.scales}, flip, crop {ev.crop}): "
          f"{len(items)} images {[tuple(it['rgb'].shape[:2]) for it in items]}"
          f", windows per scale {windows}; {forwards} forwards, K1 "
          f"{launches} launches (expected {32 * forwards}); evaluate("
          f"eval_batch={EVAL_BATCH}) {len(items) / dt:.2f} img/s ({dt:.3f} s,"
          " host resize and normalisation included)")
    check(launches == 32 * forwards, f"protocol K1 launches {launches}")
    check(np.isfinite(scores.pixel_acc), "protocol pixel_acc is finite")
    agree = total = 0
    per_size = {}
    for it, b in zip(items, batched):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = ev.sliding_eval_rgbx(it["rgb"], it["modal_x"]).cpu().numpy()
        per_size.setdefault(str(p.shape), []).append(
            time.perf_counter() - t0)
        check(p.shape == it["rgb"].shape[:2] and np.array_equal(p, b),
              f"evaluate's map of {it['fn']} equals sliding_eval_rgbx's")
        with dual_segformer.plain_attention(model):
            q = ev.sliding_eval_rgbx(it["rgb"], it["modal_x"]).cpu().numpy()
        agree += int((p == q).sum())
        total += p.size
    print(f"nyu protocol: evaluate's maps equal per-image sliding_eval_rgbx's"
          f" ({len(items)} of {len(items)}); seconds an image by size "
          f"{ {k: [round(t, 3) for t in v] for k, v in per_size.items()} }; "
          f"kernel vs plain attention path: argmax agreement "
          f"{agree / total:.6f} (>= {PROTO_AGREE})")
    check(agree / total >= PROTO_AGREE, "protocol kernel vs plain argmax")
    del model, ev
    torch.cuda.empty_cache()

    # eval_cli --compat-stride-swap: the preset (no flip), seed-0 weights,
    # on the 720x960 items, against an in-process evaluator with the flag.
    big = [it for it in items if it["rgb"].shape[:2] != HW]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "nyu")
        write_nyu_dataset(data, big)
        S.sr_attention.launches = 0
        res = eval_cli.main(["--config", "nyu", "--dataset_root", data,
                             "--compat-stride-swap",
                             "--val_log", os.path.join(tmp, "val.log")])
        cli_launches = S.sr_attention.launches
        ref = evaluator_lib.SegEvaluator(
            preset, builder.build_model(preset, seed=0),
            compat_stride_swap=True)
        ref.evaluate(RGBXDataset(preset.dataset, "val", root=data),
                     eval_batch=EVAL_BATCH)
    cli_forwards = 3 * len(big)
    (_, hist), = res.values()
    print(f"eval_cli --config nyu --compat-stride-swap: {len(big)} images, "
          f"K1 {cli_launches} launches (expected {32 * cli_forwards}), "
          f"confusion matrix equal to the in-process evaluator's: "
          f"{np.array_equal(hist, ref.last_hist)} ({int(hist.sum())} pixels)")
    check(cli_launches == 32 * cli_forwards, "eval_cli compat launches")
    check(np.array_equal(hist, ref.last_hist) and hist.sum() > 0,
          "eval_cli --compat-stride-swap == in-process")
    del ref
    torch.cuda.empty_cache()
    return {"launches": launches + cli_launches, "forwards": forwards,
            "windows": windows, "img_per_s": len(items) / dt,
            "s_per_image": per_size, "argmax_agreement": agree / total}


def preset_cli_phase(S, cfg_lib, builder, evaluator_lib, preset,
                     decoder=None, held_keys=()):
    """A preset (with `decoder` in place of its own, through --decoder)
    through the CLIs: train_cli for one short epoch on a synthetic PNG
    dataset of its classes, then eval_cli -e last, whose confusion matrix
    must be evaluate()'s on the checkpoint's weights; the checkpoint must
    hold `held_keys`; K1/K2 launches counted over the CLI calls."""
    import tempfile

    import torch

    from rgbx_semantic_segmentation_tpu_torch import eval_cli, train_cli
    from rgbx_semantic_segmentation_tpu_torch.checkpoint import (
        CheckpointManager)
    from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)

    cfg = cfg_lib.get_config(preset)
    argv = ["--config", preset]
    if decoder is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    decoder=decoder))
        argv += ["--decoder", decoder]
    tag = " ".join(argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        make_synthetic_dataset(data, num_train=PST_CLI_TRAIN,
                               num_val=PST_CLI_VAL, hw=HW,
                               num_classes=cfg.dataset.num_classes, seed=1)
        argv += ["--dataset_root", data]
        with contextlib.chdir(tmp):
            S.sr_attention.launches = S.sr_attention_bwd.launches = 0
            t0 = time.perf_counter()
            rec = train_cli.main(argv + [
                "--train_source", "train.txt", "--epochs", "1",
                "--niters", str(PST_CLI_NITERS)])
            train_s = time.perf_counter() - t0
            train_launches = (S.sr_attention.launches,
                              S.sr_attention_bwd.launches)
            S.sr_attention.launches = 0
            res = eval_cli.main(argv + ["-e", "last"])
            eval_launches = S.sr_attention.launches
        payload = CheckpointManager(os.path.join(
            tmp, "logs", cfg.tag(), "checkpoint")).load(1)
        model = builder.build_model(cfg, seed=None)
        model.load_state_dict(payload["model"], strict=True)
        ev = evaluator_lib.SegEvaluator(cfg, model)
        ev.evaluate(RGBXDataset(cfg.dataset, "val", root=data),
                    eval_batch=EVAL_BATCH)
    (_, (scores, hist)), = res.items()
    n_eval = -(-PST_CLI_VAL // EVAL_BATCH)
    print(f"{tag} CLIs: train_cli 1 epoch of {PST_CLI_NITERS} steps "
          f"({train_s:.1f} s with the model build; loss {rec[0]['loss']:.4f}, "
          f"{rec[0]['img_per_s']:.2f} img/s), K1/K2 {train_launches} "
          f"(expected {32 * PST_CLI_NITERS} each); eval_cli -e last K1 "
          f"{eval_launches} (expected {32 * n_eval}), mIoU "
          f"{scores.mean_iou:.4f}; confusion matrix equal to evaluate()'s: "
          f"{np.array_equal(hist, ev.last_hist)} ({int(hist.sum())} pixels)")
    check([r["epoch"] for r in rec] == [1] and np.isfinite(rec[0]["loss"]),
          f"{tag} train_cli epoch 1, finite loss")
    check(all(k in payload["model"] for k in held_keys),
          f"the checkpoint holds {held_keys}")
    check(train_launches == (32 * PST_CLI_NITERS,) * 2
          and eval_launches == 32 * n_eval, f"{tag} CLI launches")
    check(np.array_equal(hist, ev.last_hist) and hist.sum() > 0,
          f"{tag} eval_cli's confusion matrix is evaluate()'s")
    del model, ev, payload
    torch.cuda.empty_cache()
    return {"launches": {"fwd": train_launches[0] + eval_launches,
                         "bwd": train_launches[1]},
            "train_cli": rec, "mean_iou": scores.mean_iou}


# Every criterion name of build_criterion and the Mask2Former loss on the
# card against the same function on the CPU (fp32 both, TF32 off), on the
# preset's shapes: (8, 480, 640, 9) logits (noise + 2 x the one-hot of
# synthetic band labels with 2% ignored pixels), and for mask2former (8,
# 100, 10) class logits with (8, 100, 480, 640) mask logits upsampled from
# (8, 100, 120, 160) as the model does. Loss: CRIT_LOSS_RTOL relative;
# gradient w.r.t. the logits (the masks): CRIT_GRAD_RTOL of its largest
# magnitude (summation order and the ulps of exp / log between the two
# devices). The topology loss counts components of softmax > 0.5: a pixel
# within CRIT_NEAR_HALF of 0.5 may land on either side on the two devices
# and change a count by at most 4 (it joins or splits up to 4 components),
# which moves the loss by 0.2 x 0.1 x 4 / (B x C); that slack is added per
# such pixel. OHEM's k-th smallest probability and mask2former's assignment
# are read twice on the card and must give the same bits.
CRITERIA = ("CrossEntropyLoss", "FocalLoss", "SigmoidFocalLoss", "DiceLoss",
            "DiceCELoss", "RCELoss", "BalanceLoss", "FocalLoss2d",
            "OhemCrossEntropy", "berHuLoss", "CE_Focal", "TopologyAwareLoss",
            "TopologyAwareCE")
CRIT_LOSS_RTOL, CRIT_GRAD_RTOL, CRIT_NEAR_HALF = 1e-5, 1e-4, 1e-6
CRIT_BIT_EQUAL = ("OhemCrossEntropy", "mask2former")
# Names that build_criterion maps to the same function: the CPU reference
# is computed once for both.
CRIT_ALIASES = {"SigmoidFocalLoss": "FocalLoss",
                "TopologyAwareCE": "TopologyAwareLoss"}


def criteria_phase(cfg_lib, train_tf32):
    """`train_tf32`: (matmul, cuDNN) allow_tf32 as the process started,
    the settings a training step runs the criteria under."""
    import torch

    from rgbx_semantic_segmentation_tpu_torch import losses
    from rgbx_semantic_segmentation_tpu_torch.ops.resize import (
        resize_bilinear)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_lib.mfnet_config()
    C, B = cfg.dataset.num_classes, cfg.train.batch_size
    items = synthetic_items(B, HW, C, seed=3)
    labels = torch.from_numpy(np.stack([it["label"] for it in items])).long()
    rng = np.random.RandomState(4)
    logits = (torch.from_numpy(rng.randn(B, *HW, C).astype(np.float32))
              + 2.0 * losses._one_hot_safe(labels.clamp(max=C - 1), C))
    q_logits = torch.from_numpy(rng.randn(B, 100, C + 1).astype(np.float32))
    with torch.no_grad():
        masks = resize_bilinear(torch.from_numpy(
            4 * rng.randn(B, 100, HW[0] // 4, HW[1] // 4).astype(np.float32)
            ).cuda(), HW)
    dev = {"logits": logits.cuda(), "labels": labels.cuda(),
           "q_logits": q_logits.cuda(), "masks": masks}
    cpu = {k: v.cpu() for k, v in dev.items()}

    def run(fn, x, y, extra=None):
        """(loss, gradient w.r.t. x) of fn(x, y) (or fn(extra, x, y))."""
        x = x.detach().requires_grad_()
        loss = fn(x, y) if extra is None else fn(extra, x, y)
        loss.backward()
        return loss.detach(), x.grad

    cases = [(name, losses.build_criterion(cfg.replace(
        train=dataclasses.replace(cfg.train, criterion=name))), "logits",
        None) for name in CRITERIA]
    cases.append(("mask2former", lambda ql, m, y: losses.mask2former_loss(
        ql, m, y, C, cfg.dataset.background), "masks", "q_logits"))
    near = int(((torch.softmax(dev["logits"], -1) - 0.5).abs()
                < CRIT_NEAR_HALF).sum())
    out = {}
    print(f"criteria, fp32 (TF32 off), logits {tuple(logits.shape)}, masks "
          f"{tuple(masks.shape)}: card vs CPU, forward + backward device ms "
          f"(CUDA events, median of 5); {near} softmax values within "
          f"{CRIT_NEAR_HALF} of 0.5")
    refs = {}
    for name, fn, x, extra in cases:
        on = lambda d: run(fn, d[x], d["labels"],
                           None if extra is None else d[extra])
        loss, grad = on(dev)
        ref = CRIT_ALIASES.get(name, name)
        if ref not in refs:
            refs[ref] = on(cpu)
        ref_loss, ref_grad = refs[ref]
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        err = float((grad.cpu() - ref_grad).abs().max()
                    / ref_grad.abs().max())
        bound = CRIT_LOSS_RTOL
        if name.startswith("Topology"):
            bound += 0.2 * 0.1 * 4 * near / (B * C) / abs(float(ref_loss))
        same = None
        if name in CRIT_BIT_EQUAL:
            again, grad2 = on(dev)
            same = bool(torch.equal(again, loss) and torch.equal(grad2, grad))
        ms = median_ms(lambda: on(dev), warmup=1, iters=5)
        out[name] = {"loss": float(loss), "loss_rel": rel, "grad_rel": err,
                     "ms": ms, "bit_equal": same}
        print(f"  {name}: loss {float(loss):.6f} (CPU {float(ref_loss):.6f}, "
              f"rel {rel:.2e}, bound {bound:.1e}), gradient {err:.2e} of its "
              f"largest (bound {CRIT_GRAD_RTOL:.0e}), {ms:.3f} ms"
              + ("" if same is None else f", twice bit-equal: {same}"))
        check(np.isfinite(float(loss)) and rel <= bound
              and err <= CRIT_GRAD_RTOL, f"criterion {name} card vs CPU")
        check(same in (None, True), f"criterion {name} twice bit-equal")
    # The port sets no TF32 flag, so a training step keeps PyTorch's own:
    # cuDNN may run the topology loss's Laplacian conv in TF32, and a
    # boundary pixel near the 0.1 threshold may then fall the other way.
    # Read there, not held: that term carries no gradient, so only the
    # reported loss can move.
    off = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = train_tf32
    try:
        topo = dict((c[0], c[1]) for c in cases)["TopologyAwareLoss"]
        loss, grad = run(topo, dev["logits"], dev["labels"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = off
    ref_loss, ref_grad = refs["TopologyAwareLoss"]
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    err = float((grad.cpu() - ref_grad).abs().max() / ref_grad.abs().max())
    out["TopologyAwareLoss_train_tf32"] = {
        "matmul_tf32": train_tf32[0], "cudnn_tf32": train_tf32[1],
        "loss": float(loss), "loss_rel": rel, "grad_rel": err}
    print(f"  TopologyAwareLoss under the training step's TF32 settings "
          f"(matmul {train_tf32[0]}, cuDNN {train_tf32[1]}), read not held: "
          f"loss {float(loss):.6f} (CPU {float(ref_loss):.6f}, rel "
          f"{rel:.2e}), gradient {err:.2e} of its largest")
    check(np.isfinite(float(loss)), "TopologyAwareLoss finite under TF32")
    soft = torch.softmax(dev["logits"], -1)
    valid = (dev["labels"] != cfg.dataset.background).float()[..., None]
    oh = losses._one_hot_safe(dev["labels"].clamp(max=C - 1), C) * valid
    rounds = {}
    for tag, m in (("prediction", (soft > 0.5).float() * valid), ("target", oh)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts, rounds[tag] = losses.count_components(
            m.permute(0, 3, 1, 2), return_rounds=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"  components of the {tag} masks: {int(counts.sum())} in "
              f"{rounds[tag]} rounds (cap {losses.max_component_rounds(*HW)}"
              f"), {dt * 1e3:.1f} ms")
    out["component_rounds"] = rounds
    del dev, cpu, refs, masks, soft, oh
    torch.cuda.empty_cache()
    return out


# Data parallelism (parallel/): DDP_STEPS steps of Trainer at world 1 over
# NCCL (mit_b2, 480x640, global batch 8, bf16, the synced BatchNorm and the
# summed comm hook) against the plain one-process Trainer from the same
# seed, held to the resume bound (RESUME_FACTOR x the distance between two
# plain runs, + RESUME_FLOOR, per group of tensors). `--ddp N` runs the
# N-card part alone (K1-K4 at a rank's shapes, DDP_NITERS-step train_cli
# epochs at global batch 8 and 32 against one card at 8, eval_cli over N
# cards against one card, swin_s DDP_SWIN_STEPS steps at rate 0.3, the NCCL
# all-reduce's share of a step's device time, the first-step gradient). Its
# fp32 epoch loss at global batch 8 is held to one card's within
# DDP_LOSS_FACTOR x the largest spread of three one-card fp32 runs; the
# bf16 one is read beside two one-card runs, not held: each rank rounds its
# partial weight gradients to bf16, which no one-card run does (4-card
# gaps of 2.5x and 4.3x the one-card spread in two calls).
DDP_STEPS, DDP_NITERS, DDP_SWIN_STEPS = 3, 12, 2
DDP_LOSS_FACTOR = 4.0
# The first-step gradient on N ranks against one card: mit_b2 at global
# batch 8 and drop rates 0, on a batch whose row b ignores ~b/10 of its
# pixels (the ranks hold different valid counts), the relative L2 distance
# over all the gradients. In fp32 with TF32 off: in bf16 each rank rounds
# its own partial weight gradients, and under TF32 cuDNN picks other
# convolution algorithms for a rank's 2 images than for 8 (a 4-rank
# gradient 1.9e-3 from one card's against one-card readings of 3-4e-5), a
# noise that no one-card run shows. Bound:
# DDP_GRAD_FACTOR x the largest of three one-card readings: the same batch
# again (the card's run-to-run noise), its rows reversed (summation order
# alone: the loss and its gradient do not depend on the rows' order, which
# is what a split over ranks changes), and the launcher's world of one
# (the synced BatchNorm's E[x^2] - E[x]^2). DDP's default, each rank's own
# mean with the gradients averaged, must lie beyond the bound.
DDP_GRAD_FACTOR = 4.0


def rank_kernel_phase(S, W, T, per_rank):
    """K1-K4 at the shapes one rank of the `--ddp` run hands them
    (`per_rank` images), against their plain versions with the default
    run's bounds (hold_*): the mit_b2 stages (K1, K2) and the swin_s stages
    (K3, K4, bias unshifted and masked, rate 0 and T.RATE), bf16 as the
    models run them. Returns each kernel's largest error."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16 = torch.bfloat16
    err = dict.fromkeys(("sr_attention_fwd", "sr_attention_bwd",
                         "window_attention_fwd", "window_attention_bwd"),
                        0.0)
    for stage in FLAGSHIP:
        shape = (per_rank, *stage[1:])
        q, k, v, w = sr_inputs(gen, shape, bf16, cotangent=True)
        err["sr_attention_fwd"] = max(err["sr_attention_fwd"], hold_sr_fwd(
            S, q, k, v, shape, bf16))
        err["sr_attention_bwd"] = max(err["sr_attention_bwd"], hold_sr_bwd(
            S, q, k, v, w, shape, bf16))
    for stage in T.STAGES:
        shape = (per_rank, *stage[1:], T.D, T.WS)
        for shifted in (False, True):
            err["window_attention_fwd"] = max(
                err["window_attention_fwd"],
                hold_window_fwd(W, T, shape, bf16, shifted, gen))
            err["window_attention_bwd"] = max(
                err["window_attention_bwd"],
                hold_window_bwd(W, T, shape, bf16, shifted, gen))
    return err


def _to_cpu(obj):
    """A state dict (nested dicts and lists of tensors) on the CPU."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _trainer_payload(trainer):
    return _to_cpu({"model": trainer.model.state_dict(),
                    "optimizer": trainer.optimizer.state_dict()})


def _ddp_cfg(cfg_lib, batch=8):
    """The mfnet preset (mit_b2) at global batch `batch`, no warm-up (the
    few steps move the weights at the preset's lr)."""
    cfg = cfg_lib.mfnet_config()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=batch, warm_up_epoch=0))


def _ddp_world1_rank(world, cfg, steps):
    """The rank of the world-1 DDP phase: `steps` Trainer steps on the
    synthetic batches, with the K1/K2 launches and the step time (events
    after the first step)."""
    import torch
    import torch.distributed as dist

    from rgbx_semantic_segmentation_tpu_torch import train as train_lib
    from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S
    from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
        SyncBatchNorm2d)

    backend = dist.get_backend()
    check(backend == "nccl", f"DDP phase: process group on {backend}")
    batches = uint8_batches(synthetic_items(N_IMAGES, HW,
                                            cfg.dataset.num_classes), 8)
    trainer = train_lib.Trainer(cfg, seed=0, world=world)
    check(trainer.device == world.device and any(
        isinstance(m, SyncBatchNorm2d) for m in trainer.model.modules()),
        "DDP phase: the rank's card, synced BatchNorms")
    S.sr_attention.launches = S.sr_attention_bwd.launches = 0
    losses, t0 = [], None
    for i in range(steps):
        losses.append(trainer.step(batches[i % len(batches)])["loss"])
        if i == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    launches = (S.sr_attention.launches, S.sr_attention_bwd.launches)
    payload = _trainer_payload(trainer)
    del trainer
    torch.cuda.empty_cache()
    # OHEM and berHu through their over-ranks functions (NCCL all-gather,
    # all-reduce MAX and its backward) against the same criteria as one
    # process computes them.
    from rgbx_semantic_segmentation_tpu_torch import config as cfg_lib
    from rgbx_semantic_segmentation_tpu_torch.parallel.dist import World

    rows = slice(0, 8)
    order = hold_order_losses(
        "world of 1 over NCCL", [order_losses(world, cfg_lib, rows, 1,
                                              force_ranks=True)],
        order_losses(World.solo(world.device), cfg_lib, rows, 1))
    return {"backend": backend, "device": str(world.device),
            "launches": launches, "losses": [float(v) for v in losses],
            "step_ms": step_ms, "payload": payload,
            "order_statistics_grad_err": order}


def ddp_world1_phase(S, cfg_lib, train_lib):
    """Trainer through the launcher at world 1 over NCCL against two plain
    one-process Trainers from the same seed (see DDP_STEPS)."""
    import torch

    from rgbx_semantic_segmentation_tpu_torch.parallel import launch

    cfg = _ddp_cfg(cfg_lib)
    batches = uint8_batches(synthetic_items(N_IMAGES, HW,
                                            cfg.dataset.num_classes), 8)
    plain, plain_ms = [], []
    for _ in range(2):
        trainer = train_lib.Trainer(cfg, seed=0)
        for i in range(DDP_STEPS):
            trainer.step(batches[i % len(batches)])
            if i == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3 / (DDP_STEPS - 1))
        plain.append(_state_groups(_trainer_payload(trainer)))
        del trainer
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rank = launch.spawn(_ddp_world1_rank, [torch.cuda.current_device()],
                        "cuda", (cfg, DDP_STEPS))[0]
    wall = time.perf_counter() - t0
    check(rank["backend"] == "nccl", "DDP phase: NCCL")
    want = (32 * DDP_STEPS, 32 * DDP_STEPS)
    print(f"DDP world 1 ({rank['device']}, NCCL, {wall:.1f} s with the "
          f"process start): losses {rank['losses']}, K1 {rank['launches'][0]}"
          f", K2 {rank['launches'][1]} launches (expected {want}); step "
          f"{rank['step_ms']:.1f} ms against the plain Trainer's "
          f"{plain_ms[0]:.1f}, {plain_ms[1]:.1f} ms")
    check(tuple(rank["launches"]) == want, f"DDP launches {rank['launches']}")
    check(all(np.isfinite(rank["losses"])), "DDP losses finite")
    got = _state_groups(rank["payload"])
    dist = {}
    for name in got:
        norm = float(plain[0][name].norm())
        d_ddp = float((got[name] - plain[0][name]).norm()) / norm
        d_two = float((plain[1][name] - plain[0][name]).norm()) / norm
        dist[name] = {"ddp": d_ddp, "two_runs": d_two}
        print(f"  DDP {name}: rel L2 from a plain run {d_ddp:.3e}, between "
              f"two plain runs {d_two:.3e} (bound {RESUME_FACTOR:g}x + "
              f"{RESUME_FLOOR:g})")
        check(d_ddp <= RESUME_FACTOR * d_two + RESUME_FLOOR,
              f"DDP {name}: {d_ddp} vs {d_two}")
    return {"launches": {"fwd": rank["launches"][0],
                         "bwd": rank["launches"][1]},
            "losses": rank["losses"], "step_ms": rank["step_ms"],
            "plain_step_ms": plain_ms, "rel_l2": dist, "seconds": wall,
            "order_statistics_grad_err": rank["order_statistics_grad_err"]}


def _grad_cfg(cfg_lib):
    """The gradient check's configuration: the mfnet preset (mit_b2) at
    global batch 8, fp32, drop rates 0."""
    cfg = _ddp_cfg(cfg_lib)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, use_mixed_precision=False, drop_path_rate=0.0,
        decoder_dropout_ratio=0.0))


def ragged_ignore(batch, seed=5):
    """The batch with row b ignoring ~b/10 of its pixels (label 255) on
    top of the synthetic 2%: split over ranks, the rows hold different
    valid counts, so the mean over the global batch and the mean of the
    ranks' means differ."""
    rng = np.random.RandomState(seed)
    label = batch["label"].copy()
    for b in range(len(label)):
        label[b][rng.rand(*label.shape[1:]) < 0.1 * b] = 255
    return {**batch, "label": label}


def normalised(cfg, batch, device):
    """A uint8 batch as Trainer's step hands it to the model: (x / 255 -
    mean) / std on the device, the labels as int64."""
    import torch

    mean = torch.tensor(cfg.dataset.norm_mean, device=device)
    std = torch.tensor(cfg.dataset.norm_std, device=device)
    rgb, mx = (torch.from_numpy(batch[k]).to(device).float() / 255.0
               for k in ("rgb", "modal_x"))
    return ((rgb - mean) / std, (mx - mean) / std,
            torch.from_numpy(batch["label"]).to(device).long())


def _flat_grads(model):
    import torch

    return torch.cat([p.grad.detach().float().flatten()
                      for p in model.parameters()]).cpu()


def _ddp_grad_rank(world, cfg, batch):
    """One rank of the gradient check: Trainer.step on the rank's rows of
    `batch` (the global-mean loss, the summed buckets, the synced
    BatchNorm); then DDP's default on the same weights and rows (each
    rank's own mean, the gradients averaged). Rank 0 returns the losses and
    both gradients."""
    import torch
    from torch.nn.parallel import DistributedDataParallel

    from rgbx_semantic_segmentation_tpu_torch import train as train_lib
    from rgbx_semantic_segmentation_tpu_torch.models.builder import (
        build_model)
    from rgbx_semantic_segmentation_tpu_torch.parallel.multihost import (
        process_batch_slice)
    from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
        convert_sync_batchnorm)

    torch.backends.cuda.matmul.allow_tf32 = False   # see DDP_GRAD_FACTOR
    torch.backends.cudnn.allow_tf32 = False
    rows = process_batch_slice(len(batch["label"]), world.rank, world.size)
    local = {k: v[rows] for k, v in batch.items()}
    trainer = train_lib.Trainer(cfg, seed=0, world=world)
    out = {"loss": float(trainer.step(local)["loss"])}
    if world.is_main():
        out["grad"] = _flat_grads(trainer.model)
    del trainer
    torch.cuda.empty_cache()
    model = convert_sync_batchnorm(build_model(cfg, device=world.device,
                                               seed=0)).train()
    net = DistributedDataParallel(model, device_ids=[world.device.index])
    rgb, mx, label = normalised(cfg, local, world.device)
    loss = train_lib.make_loss_fn(cfg)(net(rgb, mx), label)
    loss.backward()
    out["rank_mean_loss"] = float(world.all_reduce(
        loss.detach().clone())) / world.size
    if world.is_main():
        out["rank_mean_grad"] = _flat_grads(model)
    return out


def grad_phase(train_lib, cfg_lib, devices):
    """The first-step gradient over the ranks against one card (see
    DDP_GRAD_FACTOR). The control's check is returned, for the caller to
    make last: it needs two ranks."""
    import torch

    from rgbx_semantic_segmentation_tpu_torch.parallel import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _grad_cfg(cfg_lib)
    batch = ragged_ignore(uint8_batches(
        synthetic_items(8, HW, cfg.dataset.num_classes), 8)[0])
    valid = (batch["label"] != 255).reshape(len(devices), -1).sum(1)

    def one_card(b):
        t0 = time.perf_counter()
        trainer = train_lib.Trainer(cfg, seed=0)
        loss = float(trainer.step(b)["loss"])
        grad = _flat_grads(trainer.model)
        del trainer
        torch.cuda.empty_cache()
        print(f"  one card, fp32 step: {time.perf_counter() - t0:.1f} s with "
              "the model build", flush=True)
        return loss, grad

    ref_loss, ref = one_card(batch)
    runs = {"again": one_card(batch),
            "rows reversed": one_card({k: v[::-1].copy()
                                       for k, v in batch.items()})}
    world1 = launch.spawn(_ddp_grad_rank, devices[:1], "cuda", (cfg, batch))
    runs["world of 1"] = (world1[0]["loss"], world1[0]["grad"])
    ranks = launch.spawn(_ddp_grad_rank, devices, "cuda", (cfg, batch))
    r0 = ranks[0]

    def rel(g):
        return float((g - ref).norm() / ref.norm())

    readings = {k: rel(g) for k, (_, g) in runs.items()}
    bound = DDP_GRAD_FACTOR * max(readings.values())
    got, miss = rel(r0["grad"]), rel(r0["rank_mean_grad"])
    n = len(devices)
    print(f"first-step gradient, mit_b2 fp32, global batch 8 (valid pixels "
          f"per rank {valid.tolist()}): one card loss {ref_loss:.6f}; "
          "one-card readings (rel L2 from it) " + ", ".join(
              f"{k} {v:.3e} (loss {runs[k][0]:.6f})"
              for k, v in readings.items())
          + f"; {n} ranks {got:.3e} (loss {r0['loss']:.6f}), bound "
          f"{bound:.3e} ({DDP_GRAD_FACTOR:g}x); each rank's own mean "
          f"(DDP's default) {miss:.3e} (loss {r0['rank_mean_loss']:.6f})")
    check(all(r["loss"] == r0["loss"] for r in ranks),
          "gradient check: every rank reports the global loss")
    check(got <= bound, f"{n}-rank gradient {got} from one card's, bound "
          f"{bound}")
    out = {"readings": readings, "bound": bound, "ranks": got,
           "rank_mean": miss, "losses": {
               "one card": ref_loss, **{k: v[0] for k, v in runs.items()},
               "ranks": r0["loss"], "rank_mean": r0["rank_mean_loss"]}}
    return out, (miss > bound, f"DDP's default (each rank's mean) at "
                               f"{miss} does not miss the bound {bound}")


def _cli_rank(world, argv, fp32=False):
    """One rank of train_cli (train_cli.train, as its launcher runs it; the
    one process as World.solo), the preset at drop rates 0 (and with
    `fp32` without its bf16 autocast), with the K1/K2 launches, the peak
    memory, the steps' host stamps and losses read around it."""
    import torch

    from rgbx_semantic_segmentation_tpu_torch import train_cli
    from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S
    from rgbx_semantic_segmentation_tpu_torch.train import Trainer

    args = train_cli.parse_args(argv)
    # Drop rates 0: the ranks draw their own masks (the rank folds into the
    # mask seed), so only then is the N-card loss one card's.
    cfg = train_cli.build_config(args)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, drop_path_rate=0.0, decoder_dropout_ratio=0.0,
        use_mixed_precision=cfg.model.use_mixed_precision and not fp32))
    stamps, losses = [], []
    step, fit_epoch = Trainer.step, Trainer.fit_epoch

    def timed_step(self, batch):
        stamps.append(time.perf_counter())
        out = step(self, batch)
        losses.append(out["loss"])
        return out

    def timed_fit_epoch(self, *a, **kw):
        result = fit_epoch(self, *a, **kw)
        stamps.append(time.perf_counter())
        return result

    S.sr_attention.launches = S.sr_attention_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    Trainer.step, Trainer.fit_epoch = timed_step, timed_fit_epoch
    try:
        records = train_cli.train(world, args, cfg)
    finally:
        Trainer.step, Trainer.fit_epoch = step, fit_epoch
    n, bs = len(stamps) - 1, cfg.train.batch_size
    return {"rank": world.rank,
            "records": records, "losses": [float(v) for v in losses],
            "steady_img_per_s": (n - 1) * bs / (stamps[-1] - stamps[1]),
            "steps": n,
            "launches": (S.sr_attention.launches, S.sr_attention_bwd.launches),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _nccl_share(prof, steps):
    """Device ms a step in a finished torch.profiler run: the NCCL kernels,
    K1 (sr_fwd_*, sr_attention_fwd*), K2 (sr_bwd_*, sr_attention_bwd*) and
    the device's busy time."""
    import torch

    from rgbx_semantic_segmentation_tpu_torch.engine import device_busy_ms

    def ms(pattern):
        return sum(e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and re.search(pattern, e.name)) / (1e3 * steps)

    busy = device_busy_ms(prof)
    return {"nccl_ms": ms(r"(?i)nccl"),
            "k1_ms": ms(r"\bsr_(attention_)?fwd"),
            "k2_ms": ms(r"\bsr_(attention_)?bwd"),
            "busy_ms": None if busy is None else busy / steps}


def _ddp_inmem_rank(world, swin_steps):
    """One rank of the in-memory part: mit_b2 at global batch 32 (8 a
    rank), 2 steps under torch.profiler on rank 0 after 2 untimed (the
    NCCL all-reduce's device time against the step's); then swin_s at
    global batch 8, `swin_steps` steps at its attention dropout 0.3 with
    the K3/K4 launches and the first window attention's kernel seed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbx_semantic_segmentation_tpu_torch import config as cfg_lib
    from rgbx_semantic_segmentation_tpu_torch import train as train_lib
    from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as W
    from rgbx_semantic_segmentation_tpu_torch.parallel.multihost import (
        process_batch_slice)

    out = {"rank": world.rank}

    def local(cfg, batch):
        rows = process_batch_slice(cfg.train.batch_size, world.rank,
                                   world.size)
        return {k: v[rows] for k, v in batch.items()}

    cfg = _ddp_cfg(cfg_lib, batch=32)
    items = synthetic_items(N_IMAGES, HW, cfg.dataset.num_classes)
    batch = local(cfg, uint8_batches(items + items, 32)[0])
    trainer = train_lib.Trainer(cfg, seed=0, world=world)
    for _ in range(2):
        trainer.step(batch)
    torch.cuda.synchronize()
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if world.is_main() else contextlib.nullcontext()) as prof:
        for _ in range(2):
            trainer.step(batch)
        torch.cuda.synchronize()
    if world.is_main():
        out.update(_nccl_share(prof, 2))
    del trainer
    torch.cuda.empty_cache()

    cfg = swin_cfg(cfg_lib)
    batch = local(cfg, uint8_batches(items, 8)[0])
    trainer = train_lib.Trainer(cfg, seed=0, world=world)
    seeds, rank_seed = [], W.rank_seed

    def spy(seed, rate, rank):
        seeds.append(rank_seed(seed, rate, rank))
        return seeds[-1]

    W.window_attention.launches = W.window_attention_bwd.launches = 0
    W.rank_seed = spy
    try:
        for _ in range(swin_steps):
            loss = trainer.step(batch)["loss"]
    finally:
        W.rank_seed = rank_seed
    out["swin"] = {"launches": (W.window_attention.launches,
                                W.window_attention_bwd.launches),
                   "seed": int(seeds[0].item()), "loss": float(loss)}
    return out


def ddp_main(n: int, card: str) -> int:
    """The N-card part (`--ddp N`): see DDP_STEPS."""
    import tempfile

    import torch

    from rgbx_semantic_segmentation_tpu_torch import config as cfg_lib
    from rgbx_semantic_segmentation_tpu_torch import eval_cli
    from rgbx_semantic_segmentation_tpu_torch import train as train_lib
    from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
        make_synthetic_dataset)
    from rgbx_semantic_segmentation_tpu_torch.native import build
    from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S
    from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as W
    from rgbx_semantic_segmentation_tpu_torch.parallel import launch
    from rgbx_semantic_segmentation_tpu_torch.parallel.dist import World
    from rgbx_semantic_segmentation_tpu_torch.tools import (
        bench_window_attention as T)

    have = torch.cuda.device_count()
    if have < n:
        print(f"chip_smoke --ddp {n}: {have} card(s) visible", file=sys.stderr)
        return 1
    devices = list(range(n))
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    # K1-K4 at a rank's shapes: global batch 8 (mit_b2 and swin_s below)
    # over the n cards; 32 over 4 gives the default run's 8.
    out = {"cards": n, "rank_kernel_err": rank_kernel_phase(S, W, T, 8 // n)}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        make_synthetic_dataset(data, num_train=16, num_val=8, hw=HW,
                               num_classes=9, seed=0)
        argv = ["--config", "mfnet", "--dataset_root", data,
                "--train_source", "train.txt", "--epochs", "1", "--niters",
                str(DDP_NITERS)]
        runs = {}
        one_card = ["-d", "0"]
        for tag, extra, devs, fp32 in (
                ("1 card, batch 8", one_card, None, False),
                ("1 card, batch 8 (again)", one_card, None, False),
                (f"{n} cards, batch 8", [], devices, False),
                (f"{n} cards, batch 32", ["--batch_size", "32"], devices,
                 False),
                ("1 card, batch 8, fp32", one_card, None, True),
                ("1 card, batch 8, fp32 (again)", one_card, None, True),
                ("1 card, batch 8, fp32 (third)", one_card, None, True),
                (f"{n} cards, batch 8, fp32", [], devices, True)):
            cwd = os.path.join(tmp, f"run{len(runs)}")
            os.makedirs(cwd)
            t1 = time.perf_counter()
            with contextlib.chdir(cwd):
                if devs is None:
                    torch.cuda.set_device(0)
                    ranks = [_cli_rank(World.solo("cuda:0"), argv + extra,
                                       fp32)]
                else:
                    ranks = launch.spawn(_cli_rank, devs, "cuda",
                                         (argv + extra, fp32))
            torch.cuda.empty_cache()
            r0 = ranks[0]
            runs[tag] = {
                "img_per_s": r0["steady_img_per_s"], "loss":
                r0["records"][0]["loss"], "losses": r0["losses"],
                "peak_gib": [r["peak_gib"] for r in ranks],
                "launches": [r["launches"] for r in ranks],
                "seconds": time.perf_counter() - t1, "cwd": cwd}
            print(f"train_cli, {tag}: steady over steps 2..{r0['steps']} "
                  f"{r0['steady_img_per_s']:.1f} img/s, epoch loss "
                  f"{r0['records'][0]['loss']:.5f}, peak GiB per rank "
                  f"{[round(r['peak_gib'], 2) for r in ranks]}, K1/K2 "
                  f"launches per rank {[r['launches'] for r in ranks]} "
                  f"({runs[tag]['seconds']:.1f} s)")
            want = (32 * DDP_NITERS, 32 * DDP_NITERS)
            check(all(tuple(r["launches"]) == want for r in ranks)
                  and len(ranks) == (1 if devs is None else n),
                  f"{tag}: 32 K1 and K2 launches a step on every rank")
            check(all(r["losses"] == r0["losses"] for r in ranks),
                  f"{tag}: every rank reports the global loss")
        # bf16 (read, not held: each rank rounds its partial weight
        # gradients to bf16, a perturbation that no one-card run has) and
        # fp32 (held: DDP_LOSS_FACTOR x the largest spread of three one-card
        # runs, whose perturbations are summation orders, as the split's).
        many = runs[f"{n} cards, batch 8"]
        for kind, tags in (("bf16", ("", " (again)")),
                           ("fp32", (", fp32", ", fp32 (again)",
                                     ", fp32 (third)"))):
            ones = [runs[f"1 card, batch 8{t}"]["loss"] for t in tags]
            got = runs[f"{n} cards, batch 8{tags[0]}"]["loss"]
            spread = max(abs(a - b) for a in ones for b in ones)
            gap = max(abs(got - a) for a in ones)
            print(f"epoch loss, {kind}: {n} cards {got:.6f}, one card "
                  f"{', '.join(f'{v:.6f}' for v in ones)}: largest gap "
                  f"{gap:.3e}, largest one-card spread {spread:.3e} "
                  f"(bound {DDP_LOSS_FACTOR:g}x in fp32)")
        check(gap <= DDP_LOSS_FACTOR * spread,
              f"fp32 {n}-card loss {got} vs one card's {ones}")
        out["train_cli"] = {k: {kk: vv for kk, vv in v.items() if kk != "cwd"}
                            for k, v in runs.items()}

        # eval_cli over the N cards against one card, one image a forward,
        # on the N-card run's checkpoint
        with contextlib.chdir(many["cwd"]):
            ev = {}
            for tag, extra in (("1 card", ["-d", "0"]),
                               (f"{n} cards", ["-d", ",".join(
                                   map(str, devices))])):
                t1 = time.perf_counter()
                res = eval_cli.main(["--config", "mfnet", "--dataset_root",
                                     data, "-e", "last", "--eval_batch", "1"]
                                    + extra)
                ev[tag] = (res["epoch 1"][1], time.perf_counter() - t1)
        same = bool(np.array_equal(ev["1 card"][0], ev[f"{n} cards"][0]))
        print(f"eval_cli --eval_batch 1: confusion matrix over {n} cards "
              f"equal to one card's: {same} (sum {int(ev['1 card'][0].sum())}"
              f"; {ev['1 card'][1]:.1f} s and {ev[f'{n} cards'][1]:.1f} s)")
        check(same and ev["1 card"][0].sum() > 0, "eval_cli over the cards")
        out["eval_cli"] = {"equal": same, "seconds": {
            k: v[1] for k, v in ev.items()}}

    ranks = launch.spawn(_ddp_inmem_rank, devices, "cuda", (DDP_SWIN_STEPS,))
    r0 = ranks[0]
    share = r0["nccl_ms"] / r0["busy_ms"]
    print(f"mit_b2, {n} cards, global batch 32: NCCL kernels "
          f"{r0['nccl_ms']:.2f} ms of {r0['busy_ms']:.2f} ms device time a "
          f"step on rank 0 ({share:.1%}); K1 {r0['k1_ms']:.3f} ms, K2 "
          f"{r0['k2_ms']:.3f} ms a step (device, 8 images a rank)")
    swin = [r["swin"] for r in ranks]
    want = (48 * DDP_SWIN_STEPS, 48 * DDP_SWIN_STEPS)
    print(f"swin_s, {n} cards, {DDP_SWIN_STEPS} steps at rate 0.3: K3/K4 "
          f"launches per rank {[s['launches'] for s in swin]} (expected "
          f"{want}), first kernel seeds {[s['seed'] for s in swin]}, losses "
          f"{[s['loss'] for s in swin]}")
    check(all(tuple(s["launches"]) == want for s in swin),
          "swin_s: 48 K3 and K4 launches a step on every rank")
    check(len({s["loss"] for s in swin}) == 1, "swin_s: one global loss")
    t1 = time.perf_counter()
    ranks = launch.spawn(_order_rank, devices, "cuda", ())
    want = order_losses(World.solo("cuda:0"), cfg_lib, slice(0, 8), n)
    print(f"OHEM and berHu over {n} cards against one card on the global "
          f"(8, 480, 640, 9) batch ({time.perf_counter() - t1:.1f} s):")
    out["order_statistics_grad_err"] = hold_order_losses(
        f"{n} cards", ranks, want)
    del ranks, want
    out["gradient"], control = grad_phase(train_lib, cfg_lib, devices)
    # Last, the two checks that need two ranks (`--ddp 1` fails them).
    # (the first call: stage 1, its first window attention; rate 0.3)
    masks = [W.keep_mask(torch.tensor([s["seed"]]), 1, 4, 3, 49, 0.3)
             for s in swin[:2]]
    check(len(masks) == 2 and not torch.equal(masks[0], masks[-1]),
          "swin_s: ranks 0 and 1 draw different masks")
    check(*control)
    out["profile_rank0"] = {**{k: r0[k] for k in ("nccl_ms", "k1_ms",
                                                   "k2_ms", "busy_ms")},
                            "nccl_share": share}
    out["swin"] = swin
    print(card)
    print(json.dumps({"ddp": out, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------ segnext_b and resnet50 --

# K5 at segnext_b's IFFM shapes (T5.SEGNEXT_SHAPES: d = 8, 16, 40, the
# columns past d of the kernels' 64-wide panels zeros), at segnext_large's
# (T5.SEGNEXT_LARGE_SHAPES: d = 12, 24, 48) and on the padded route at
# segnext_tiny's first and third stages and segnext_large's first: d = 4,
# 20 and 12 zero-padded to 8, 24 and 16 by ops/attention.
# multi_head_attention. Held by the kernel phase's bounds.
SEGNEXT_PADDED = (8, 8, 19200, 19200, 4)
SEGNEXT_NEW_PADDED = [(8, 8, 19200, 19200, 12), (8, 8, 1200, 1200, 20)]
# segnext_b: K5 serves the IFFM of stages 1-3 (two calls each), K1/K2 the
# two short-kv calls of stage 4 (15 x 20 tokens, d = 64). slice_phase and
# train_phase drive it as mit_b2pp (IFRM/IFFM at every stage): its bf16
# kernel path is held to its fp32 plain path (PP_TRUTH_FACTOR), its fp32
# paths to each other at batch SEGNEXT_FP32_BATCH.
SEGNEXT_FLASH_CALLS, SEGNEXT_SR_CALLS, SEGNEXT_FP32_BATCH = 6, 2, 2
SEGNEXT_GRAD_NAMES = [
    "backbone.stem.0.weight",
    "backbone.stages.0.0.attn.conv211.0.weight",
    "backbone.extra_stages.0.2.ffn_fc1.weight",
    "backbone.stages.2.26.ls1_layer_scale",
    "backbone.FRMs.0.channel_weights.mlp.0.weight",
    "backbone.FFMs.0.cross.cross_attn.q1.weight",
    "backbone.FFMs.0.cross.cross_attn.kv2.weight",
    "backbone.FFMs.2.cross.cross_attn.proj1.weight",
    "decode_head.linear_pred.weight"]
# resnet50 + UPernet (the preset's FRM/FFM: no attention kernel on its
# path) is held card against CPU: the card's fp32 forward (TF32 off) and
# the CPU's on the same weights, batch 1: logits within 1e-4 of their
# largest magnitude (summation orders through ~60 layers), argmax
# agreement >= 0.999.
RESNET_STEPS, RESNET_CPU_RTOL, RESNET_CPU_AGREE = 3, 1e-4, 0.999


def hold_padded_route(FA, T5, shape, dtype, gen):
    """K5 on the padded route at `shape` (d not a multiple of 8):
    hold_flash_case on the zero-padded operands; multi_head_attention under
    autograd bit-equal to the kernels on those operands (output and dq, dk,
    dv); the kernels' output at d within FLASH_REL_L2 of the plain version
    at d. Returns hold_flash_case's errors."""
    import torch
    import torch.nn.functional as F

    from rgbx_semantic_segmentation_tpu_torch.ops import attention as A

    B, h, N, M, d = shape
    sc = d ** -0.5
    q, k, v, w = T5.inputs(shape, dtype, gen)
    padded = [F.pad(t, (0, -d % 8)) for t in (q, k, v, w)]
    errs = hold_flash_case(FA, f"padded route (B,h,N,M,d)={shape} -> d = "
                           f"{padded[0].shape[3]}", *padded, sc)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = A.multi_head_attention(*leaves, sc, use_kernels=True)
    out.backward(w.transpose(1, 2).reshape(B, N, h * d))
    with torch.no_grad():
        kout, lse = FA._forward(*padded[:3], sc)
        grads = FA.flash_attention_bwd(*padded[:3], kout, lse, padded[3], sc)
        same = torch.equal(out, kout[..., :d].transpose(1, 2).reshape(
            B, N, h * d)) and all(torch.equal(t.grad, g[..., :d])
                                  for t, g in zip(leaves, grads))
        plain = FA.flash_attention_reference(q, k, v, sc)[0].float()
        rel = float((kout[..., :d].float() - plain).norm() / plain.norm())
    print(f"padded route through multi_head_attention, {str(dtype)[6:]} "
          f"{shape}: output and dq, dk, dv bit-equal to the kernels on the "
          f"padded operands: {same}; kernel vs plain at d = {d}: rel L2 "
          f"{rel:.2e} (<= {FLASH_REL_L2:.0e})")
    check(same and rel <= FLASH_REL_L2, f"the padded flash route at {shape}")
    torch.cuda.empty_cache()
    return errs


def narrow_flash_kernel_phase(FA, T5):
    """K5's three kernels at segnext_b's and segnext_large's shapes in bf16
    and (batch 1) fp32, and on the padded route at SEGNEXT_PADDED (bf16) and
    SEGNEXT_NEW_PADDED (bf16 and fp32 at batch 1), against their plain
    versions (hold_flash_case), two runs bit-equal; the padded route
    through multi_head_attention under autograd bit-equal to the kernels on
    the padded operands, whose plain version lies within FLASH_REL_L2 of the
    plain version at the true d; then the times at segnext_b's and
    segnext_large's shapes (kernel, plain, SDPA, bound, the exponentials'
    floor). Returns ({kernel: worst error at the bf16 shapes}, {kernel:
    segnext_b rows}, {kernel: segnext_large rows})."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    direct = T5.SEGNEXT_SHAPES + [s for s in T5.SEGNEXT_LARGE_SHAPES
                                  if s[4] % 8 == 0]
    cases = [(s, torch.bfloat16) for s in direct] + \
            [((1, *s[1:]), torch.float32) for s in direct]
    for shape, dtype in cases:
        q, k, v, w = T5.inputs(shape, dtype, gen)
        errs = hold_flash_case(FA, f"segnext (B,h,N,M,d)={shape}", q, k, v, w,
                               shape[4] ** -0.5)
        if dtype == torch.bfloat16:
            worst = {key: max(worst[key], e) for key, e in errs.items()}
        del q, k, v, w
    padded = [(SEGNEXT_PADDED, torch.bfloat16)] + \
        [(s, torch.bfloat16) for s in SEGNEXT_NEW_PADDED] + \
        [((1, *s[1:]), torch.float32) for s in SEGNEXT_NEW_PADDED]
    for shape, dtype in padded:
        errs = hold_padded_route(FA, T5, shape, dtype, gen)
        if dtype == torch.bfloat16:
            worst = {key: max(worst[key], e) for key, e in errs.items()}
    torch.cuda.empty_cache()
    rows = {}
    for model, shapes in (("segnext_b", T5.SEGNEXT_SHAPES),
                          ("segnext_large", T5.SEGNEXT_LARGE_SHAPES)):
        rows[model] = {"fwd": [], "dkv": [], "dq": []}
        for shape in shapes:
            timed = T5.time_shape(shape, gen)
            T5.print_rows(shape, timed)
            for which, row in timed.items():
                rows[model][which].append(row)
        torch.cuda.empty_cache()
    print(f"narrow K5 phase: {time.perf_counter() - t0:.1f} s")
    return worst, rows["segnext_b"], rows["segnext_large"]


def family_cfg(cfg_lib, backbone, decoder=None):
    """The mfnet preset with `backbone` (and `decoder`), no warm-up."""
    cfg = cfg_lib.mfnet_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, backbone=backbone,
                                  decoder=decoder or cfg.model.decoder),
        train=dataclasses.replace(cfg.train, warm_up_epoch=0))


# The widths segnext_tiny (dims 32/64/160/256) and segnext_large (96/192/
# 384/768) put on the kernels through the model, 8 IFFM heads at every
# stage: K5 serves stages 1-3 (two calls each; d = 4, 8, 20 and 12, 24, 48,
# d = 4, 20, 12 on the padded route), K1/K2 stage 4 (two calls; d = 32 and
# 96).
SEGNEXT_WIDTH_MODELS = ("segnext_tiny", "segnext_large")
SEGNEXT_WIDTH_STEPS = 2


def segnext_widths_phase(S, FA, cfg_lib, builder, evaluator_lib, train_lib,
                         items):
    """segnext_tiny and segnext_large + MLPDecoder at the preset's 480x640,
    batch 8, bf16, through the entry points: evaluate() on the 16 images
    and SEGNEXT_WIDTH_STEPS Trainer.fit_epoch steps, each counting the
    launches of K1/K2 (2 a forward / a step) and of K5's three kernels (6);
    mIoU and losses finite. Returns {model: {counter: launches}} over both
    runs of each model."""
    import torch

    t0 = time.perf_counter()
    counters = {"sr_fwd": S.sr_attention, "sr_bwd": S.sr_attention_bwd,
                "flash_fwd": FA.flash_attention,
                "flash_dkv": FA.flash_attention_dkv,
                "flash_dq": FA.flash_attention_dq}
    out = {}
    for name in SEGNEXT_WIDTH_MODELS:
        cfg = family_cfg(cfg_lib, name)
        model = builder.build_model(cfg, seed=0)
        ev = evaluator_lib.SegEvaluator(cfg, model)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scores, line = ev.evaluate(items, eval_batch=EVAL_BATCH)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        ev_n = {k: fn.launches for k, fn in counters.items()}
        forwards = N_IMAGES // EVAL_BATCH
        want = {"sr_fwd": 2 * forwards, "sr_bwd": 0,
                "flash_fwd": 6 * forwards, "flash_dkv": 0, "flash_dq": 0}
        print(f"{name} eval: {N_IMAGES} images in {dt:.2f} s (first call: "
              f"warm-up included), launches {ev_n} (expected {want}); "
              f"{line.splitlines()[-1]}")
        check(ev_n == want and np.isfinite(scores.pixel_acc),
              f"{name} eval launches {ev_n}")
        del model, ev
        torch.cuda.empty_cache()

        trainer = train_lib.Trainer(cfg, seed=0)
        log = LossLog()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.fit_epoch(cycle(uint8_batches(items, cfg.train.batch_size)),
                          SEGNEXT_WIDTH_STEPS, log_every=1, logger=log)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        tr_n = {k: fn.launches for k, fn in counters.items()}
        steps = SEGNEXT_WIDTH_STEPS
        want = {"sr_fwd": 2 * steps, "sr_bwd": 2 * steps,
                "flash_fwd": 6 * steps, "flash_dkv": 6 * steps,
                "flash_dq": 6 * steps}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name} train: {steps} steps of batch "
              f"{cfg.train.batch_size} in {dt:.2f} s (first steps: warm-up "
              f"included), peak {peak:.2f} GiB, launches {tr_n} (expected "
              f"{want})")
        check(tr_n == want and all(np.isfinite(x) for x in log.losses),
              f"{name} train launches {tr_n}, losses {log.losses}")
        out[name] = {k: ev_n[k] + tr_n[k] for k in counters}
        del trainer
        torch.cuda.empty_cache()
    print(f"segnext_tiny / segnext_large phase: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def tools_phase():
    """The port's tools on the card: tools/check_gpu as a program (rc 0,
    its exact matmul line); ops/resize.resize_nearest on CUDA equal to the
    CPU on (8, 480, 640) uint8 labels, down to 240x320 and up to 960x1280;
    tools/bench_input at a small n (host time, read, not held). Returns its
    readings."""
    import torch

    from rgbx_semantic_segmentation_tpu_torch.ops.resize import (
        resize_nearest)
    from rgbx_semantic_segmentation_tpu_torch.tools import (
        bench_input, check_gpu)

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m",
         "rgbx_semantic_segmentation_tpu_torch.tools.check_gpu"],
        cwd=root, capture_output=True, text=True, timeout=300)
    print("check_gpu (rc %d):" % proc.returncode)
    for ln in proc.stdout.splitlines():
        print("  " + ln)
    n = check_gpu.N
    matmul = re.search(rf"^matmul OK \(([0-9.]+) ms\), sum={n ** 3} == "
                       rf"{n}\^3$", proc.stdout, re.M)
    check(proc.returncode == 0 and matmul is not None,
          f"check_gpu: rc {proc.returncode}, {proc.stderr[-2000:]}")

    gen = torch.Generator().manual_seed(9)
    labels = torch.randint(0, 256, (8, *HW), generator=gen,
                           dtype=torch.uint8)
    equal = {}
    for size in ((240, 320), (960, 1280)):
        cpu = resize_nearest(labels, size)
        card = resize_nearest(labels.cuda(), size)
        equal[f"{size[0]}x{size[1]}"] = bool(
            card.dtype == cpu.dtype and torch.equal(card.cpu(), cpu))
    print(f"resize_nearest (8, 480, 640) uint8 on the card equal to the CPU: "
          f"{equal}")
    check(all(equal.values()), f"resize_nearest card vs CPU: {equal}")

    bench = bench_input.run(n=10)
    print("bench_input (n = 10, 480x640, host time): " + ", ".join(
        f"{k} {v:.2f}" for k, v in bench.items()))
    print(f"tools phase: {time.perf_counter() - t0:.1f} s")
    return {"check_gpu_matmul_ms": float(matmul.group(1)),
            "resize_nearest_equal": equal, "bench_input": bench}


def resnet_phase(S, FA, cfg_lib, builder, evaluator_lib, train_lib, items):
    """resnet50 + UPernet (the aux FCNHead, 0.4) at the preset's 480x640,
    batch 8, bf16: evaluate() on 16 images and RESNET_STEPS counted
    fit_epoch steps, no attention kernel launched (the preset's FRM/FFM
    use the linear cross-attention); step ms, peak, the profiler's device
    time and top operations, the main and aux losses; the card's fp32
    forward against the CPU's (RESNET_CPU_RTOL)."""
    import torch

    from rgbx_semantic_segmentation_tpu_torch import losses as losses_lib

    t0 = time.perf_counter()
    cfg = family_cfg(cfg_lib, "resnet50", "UPernet")
    counters = {"sr_fwd": S.sr_attention, "sr_bwd": S.sr_attention_bwd,
                "flash_fwd": FA.flash_attention,
                "flash_dkv": FA.flash_attention_dkv,
                "flash_dq": FA.flash_attention_dq}
    model = builder.build_model(cfg, seed=0)
    ev = evaluator_lib.SegEvaluator(cfg, model)
    ev.evaluate(items[:EVAL_BATCH], eval_batch=EVAL_BATCH)  # warm-up
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scores, line = ev.evaluate(items, eval_batch=EVAL_BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    n = {k: fn.launches for k, fn in counters.items()}
    print(f"resnet50 + UPernet eval: {N_IMAGES} images, {N_IMAGES / dt:.2f} "
          f"img/s; launches {n} (none expected); {line.splitlines()[-1]}")
    check(not any(n.values()) and np.isfinite(scores.pixel_acc),
          f"resnet50 eval launches {n}")
    pair = ev.prepare(items[0]["rgb"], items[0]["modal_x"])
    del model, ev
    torch.cuda.empty_cache()

    batches = uint8_batches(items, cfg.train.batch_size)
    data = cycle(batches)
    trainer = train_lib.Trainer(cfg, seed=0)
    trainer.fit_epoch(data, 1)    # warm-up
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    loss = trainer.fit_epoch(data, RESNET_STEPS)
    b.record()
    b.synchronize()
    n = {k: fn.launches for k, fn in counters.items()}
    step_ms = a.elapsed_time(b) / RESNET_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rgb, mx, label = normalised(cfg, batches[0], "cuda")
    criterion = losses_lib.build_criterion(cfg)
    trainer.model.eval()
    with torch.no_grad():
        logits, aux = trainer.model(rgb, mx)
        main_loss, aux_loss = (float(criterion(t, label))
                               for t in (logits, aux))
    trainer.model.train()
    print(f"resnet50 + UPernet train: {RESNET_STEPS} steps of batch 8 at "
          f"{HW}, bf16: {step_ms:.1f} ms a step (CUDA events), "
          f"{8e3 / step_ms:.2f} img/s, mean loss {loss:.4f}, peak "
          f"{peak:.2f} GiB; launches {n} (none expected); on batch 0 after "
          f"training (eval mode): main loss {main_loss:.4f}, aux loss "
          f"{aux_loss:.4f} (weight {builder.AUX_RATE})")
    check(not any(n.values()) and np.isfinite(loss)
          and np.isfinite(aux_loss), f"resnet50 train launches {n}")
    prof = profile_steps(trainer, data, steps=1)
    del trainer
    torch.cuda.empty_cache()

    # fp32, TF32 off: the card's forward against the CPU's, same weights.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(model=dataclasses.replace(
        cfg.model, use_mixed_precision=False))
    x = [torch.from_numpy(p[None]) for p in pair]
    with torch.no_grad():
        card = builder.main_logits(builder.build_model(cfg32, seed=0)(
            *(t.cuda() for t in x))).cpu()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cpu = builder.main_logits(builder.build_model(
            cfg32, device="cpu", seed=0)(*x))
        cpu_s = time.perf_counter() - t1
    err = float((card - cpu).abs().max())
    tol = RESNET_CPU_RTOL * float(cpu.abs().max())
    agree = float((card.argmax(-1) == cpu.argmax(-1)).float().mean())
    print(f"resnet50 + UPernet fp32 forward, batch 1, card (TF32 off) vs CPU "
          f"({cpu_s:.1f} s): max_abs_err {err:.3e} (tol {tol:.3e}), argmax "
          f"agreement {agree:.6f} (>= {RESNET_CPU_AGREE})")
    check(err <= tol and agree >= RESNET_CPU_AGREE,
          "resnet50 fp32 card forward vs CPU")
    seconds = time.perf_counter() - t0
    print(f"resnet50 phase: {seconds:.1f} s")
    return {"eval_img_per_s": N_IMAGES / dt, "step_ms": step_ms,
            "peak_gib": peak, "main_loss": main_loss, "aux_loss": aux_loss,
            "device_kernels": prof[0] if prof else None,
            "device_ms": prof[1] if prof else None,
            "cpu_max_abs_err": err, "cpu_argmax_agreement": agree,
            "seconds": seconds}


# The order-statistic criteria over ranks: (name, TrainConfig overrides).
# The preset's OHEM (threshold 0.6) and one whose threshold lies below most
# target probabilities, so the k-th smallest of the global batch decides
# the kept set; berHu as configured and with its largest residual tied
# across the ranks (the same pixel, label and logits in the first image of
# every rank, logit 9 on a wrong class: residual 0.99988, unsaturated).
ORDER_CASES = (("OhemCrossEntropy", {}),
               ("OhemCrossEntropy", {"ohem_thresh": 0.05,
                                     "ohem_min_kept": 500000}),
               ("berHuLoss", {}), ("berHuLoss", {"tie": True}))


def order_inputs(cfg, n_ranks, tie):
    """(8, 480, 640, 9) logits and labels made from a seed on the CPU; with
    `tie` the first image of each of `n_ranks` ranks shares pixel (0, 0)."""
    C, B = cfg.dataset.num_classes, cfg.train.batch_size
    rng = np.random.RandomState(11)
    # Logits of scale 0.5: no random pixel's residual reaches the tie's.
    logits = (0.5 * rng.randn(B, *HW, C)).astype(np.float32)
    labels = rng.randint(0, C, (B, *HW))
    labels[rng.rand(B, *HW) < 0.05] = 255
    if tie:
        for b in range(0, B, B // n_ranks):
            logits[b, 0, 0] = 0.0
            logits[b, 0, 0, 1] = 9.0
            labels[b, 0, 0] = 0
    return logits, labels


def order_losses(world, cfg_lib, rows, n_ranks, force_ranks=False):
    """[(loss, gradient of this rank's rows)] of ORDER_CASES through
    make_loss_fn(cfg, world), on the card; `force_ranks`: through the
    over-ranks functions (all_gather_ranks, max_over_ranks) whatever the
    world's size."""
    import functools

    import torch

    from rgbx_semantic_segmentation_tpu_torch import losses as losses_lib
    from rgbx_semantic_segmentation_tpu_torch import train as train_lib

    out = []
    for name, extra in ORDER_CASES:
        extra = dict(extra)
        tie = extra.pop("tie", False)
        cfg = cfg_lib.mfnet_config()
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, criterion=name, **extra))
        logits, labels = order_inputs(cfg, n_ranks, tie)
        x = torch.from_numpy(logits[rows]).to(world.device).requires_grad_()
        y = torch.from_numpy(labels[rows]).to(world.device)
        fn = train_lib.make_loss_fn(cfg, world)
        if force_ranks:
            glob = {"ignore_index": cfg.dataset.background,
                    "denom_reduce": lambda t: world.all_reduce(
                        t.detach().clone())}
            fn = (functools.partial(
                losses_lib.prob_ohem_cross_entropy, **glob,
                thresh=cfg.train.ohem_thresh,
                min_kept=cfg.train.ohem_min_kept,
                gather=losses_lib.all_gather_ranks)
                if name == "OhemCrossEntropy" else functools.partial(
                    losses_lib.berhu_seg_loss, **glob,
                    global_max=losses_lib.max_over_ranks))
        loss = fn(x, y)
        loss.backward()
        out.append((float(loss.detach()), x.grad.cpu()))
    return out


def hold_order_losses(tag, got, want):
    """Per case: the ranks' losses add up to the global batch's (rtol
    1e-5), their gradients, stacked in rank order, are its gradient (1e-4
    of the largest)."""
    import torch

    worst = 0.0
    for i, (name, extra) in enumerate(ORDER_CASES):
        loss = sum(r[i][0] for r in got)
        grad = torch.cat([r[i][1] for r in got])
        wl, wg = want[i]
        rel = abs(loss - wl) / abs(wl)
        gerr = float((grad - wg).abs().max() / wg.abs().max())
        worst = max(worst, gerr)
        print(f"  {tag}: {name} {extra}: loss {loss:.6f} vs {wl:.6f} (rel "
              f"{rel:.2e}, <= 1e-5), gradient {gerr:.2e} of its largest "
              f"(<= 1e-4)")
        check(rel <= 1e-5 and gerr <= 1e-4,
              f"{tag}: {name} {extra} over ranks vs the global batch")
    return worst


def _order_rank(world):
    """One rank of the order-statistic check: ORDER_CASES on its rows."""
    from rgbx_semantic_segmentation_tpu_torch import config as cfg_lib
    from rgbx_semantic_segmentation_tpu_torch.parallel.multihost import (
        process_batch_slice)

    rows = process_batch_slice(8, world.rank, world.size)
    return order_losses(world, cfg_lib, rows, world.size)


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ddp", type=int, default=0, metavar="N",
                        help="run only the data-parallel part on N cards "
                             "(fails when fewer are visible)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port is not run on the CPU",
              file=sys.stderr)
        return 1
    # PyTorch's TF32 settings before any phase turns TF32 off: the ones a
    # training step of the port runs under.
    train_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
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
    from rgbx_semantic_segmentation_tpu_torch.ops import flash_attention as FA
    from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S
    from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as W
    from rgbx_semantic_segmentation_tpu_torch.tools import (
        bench_flash_attention as T5)
    from rgbx_semantic_segmentation_tpu_torch.tools import (
        bench_window_attention as T)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    if args.ddp:
        return ddp_main(args.ddp, " | ".join(smi.stdout.strip().splitlines()))

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
        for r in rows:
            print(f"  {r['shape']}: {r['ms']:.4f} ms, {r['tflops']:.1f} "
                  f"TFLOP/s, {100 * r['share_of_bound']:.1f}% of the bound")
    wfwd_err, wfwd_rows = window_kernel_phase(W, T)
    wbwd_err, wbwd_rows = window_bwd_kernel_phase(W, T)
    for tag, rows in (("forward", wfwd_rows), ("backward", wbwd_rows)):
        dev_ms = per_step(rows, "device_ms", SWIN_CALLS)
        bound = per_step(rows, "bound_ms", SWIN_CALLS)
        dev_text = ("device not read" if dev_ms is None else
                    f"device {dev_ms:.3f} ms, {bound / dev_ms:.1%} of the "
                    "bound")
        print(f"window attention {tag}, the 48 calls of a step at rate "
              f"{T.RATE}: kernel {per_step(rows, 'ms', SWIN_CALLS):.3f} ms "
              f"({dev_text}), "
              f"plain {per_step(rows, 'plain_ms', SWIN_CALLS):.3f} ms, SDPA "
              f"{per_step(rows, 'library_ms', SWIN_CALLS):.3f} ms, bound "
              f"{bound:.3f} ms")
    swin_b_kernels = swin_b_kernel_phase(W, T)
    flash_err, flash_rows = flash_kernel_phase(FA, T5)
    narrow_err, narrow_rows, large_rows = narrow_flash_kernel_phase(FA, T5)
    sr_narrow_err, sr_narrow_rows = segnext_sr_kernel_phase(S)
    for which, tag in (("fwd", "forward"), ("dkv", "dk/dv"), ("dq", "dq")):
        for model, rows in (("mit_b2pp", flash_rows[which]),
                            ("segnext_b", narrow_rows[which]),
                            ("segnext_large", large_rows[which])):
            print(f"flash attention {tag}, the 6 calls of a {model} step: "
                  f"kernel {per_step(rows, 'ms', T5.CALLS):.3f} ms, plain "
                  f"{per_step(rows, 'plain_ms', T5.CALLS):.3f} ms, SDPA "
                  f"{per_step(rows, 'library_ms', T5.CALLS):.3f} ms, bound "
                  f"{per_step(rows, 'bound_ms', T5.CALLS):.3f} ms, "
                  f"exponentials' floor "
                  f"{per_step(rows, 'exp_floor_ms', T5.CALLS):.3f} ms")
    for which, rows in sr_narrow_rows.items():
        for r in rows:
            print(f"SR attention {which} {r['shape']}: kernel {r['ms']:.4f} "
                  f"ms, plain {r['plain_ms']:.4f} ms, SDPA "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
                  f"{100 * r['share_of_bound']:.1f}% of the bound")
    tools = tools_phase()
    cfg = cfg_lib.mfnet_config()
    check(cfg.model.backbone == "mit_b2", "mfnet preset is mit_b2")
    items = synthetic_items(N_IMAGES, HW, cfg.dataset.num_classes)
    mit_eval = slice_phase(S, FA, cfg, builder, evaluator_lib, dual_segformer,
                           items)
    train = train_phase(S, FA, cfg, train_lib, dual_segformer, items)
    swin_eval = swin_eval_phase(S, W, T, cfg_lib, builder, evaluator_lib,
                                dual_swin, items)
    swin_train = swin_train_phase(S, W, T, cfg_lib, train_lib, dual_swin,
                                  items)
    swin_b = swin_b_phase(S, W, T, cfg_lib, builder, evaluator_lib,
                          train_lib, dual_swin, items)
    remat = remat_phase(S, W, cfg_lib, train_lib, items)
    lbfgs = lbfgs_phase(S, cfg_lib, train_lib, items)
    pp_eval = slice_phase(S, FA, pp_cfg(cfg_lib), builder, evaluator_lib,
                          dual_segformer, items, sr_calls=PP_SR_CALLS,
                          flash_calls=PP_FLASH_CALLS, fp32_batch=PP_FP32_BATCH,
                          vs_truth=True)
    pp_train = train_phase(S, FA, pp_cfg(cfg_lib), train_lib, dual_segformer,
                           items, sr_calls=PP_SR_CALLS,
                           flash_calls=PP_FLASH_CALLS,
                           grad_names=PP_GRAD_NAMES, fp32_batch=PP_FP32_BATCH,
                           vs_truth=True)
    cli = cli_phase(S, cfg_lib, train)
    pst = cfg_lib.pst900_config()
    check(pst.model.backbone == "mit_b2_w_aspp"
          and pst.model.decoder == "UPernet", "pst900 preset")
    pst_items = synthetic_items(N_IMAGES, HW, pst.dataset.num_classes, seed=2)
    pst_eval = slice_phase(S, FA, pst, builder, evaluator_lib, dual_segformer,
                           pst_items)
    pst_train = train_phase(S, FA, pst, train_lib, dual_segformer, pst_items,
                            grad_names=PST_GRAD_NAMES, vs_truth=True)
    proto = protocol_phase(S, cfg_lib, builder, evaluator_lib, dual_segformer)
    pst_cli = preset_cli_phase(
        S, cfg_lib, builder, evaluator_lib, "pst900", held_keys=(
            "backbone.aspp_modules.3.project.0.weight",
            "decode_head.fpn_bottleneck.0.weight", "aux_head.conv.0.weight"))
    m2f = cfg.replace(model=dataclasses.replace(cfg.model,
                                                decoder="mask2former"))
    m2f_eval = slice_phase(S, FA, m2f, builder, evaluator_lib,
                           dual_segformer, items, vs_truth=True)
    m2f_train = train_phase(S, FA, m2f, train_lib, dual_segformer, items,
                            grad_names=M2F_GRAD_NAMES, vs_truth=True)
    m2f_cli = preset_cli_phase(
        S, cfg_lib, builder, evaluator_lib, "mfnet", decoder="mask2former",
        held_keys=("decode_head.query_embed", "decode_head.scale",
                   "decode_head.layers.8.ffn.3.weight"))
    mlppp = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  decoder="MLPDecoderpp"))
    mlppp_eval = slice_phase(S, FA, mlppp, builder, evaluator_lib,
                             dual_segformer, items)
    mlppp_train = train_phase(S, FA, mlppp, train_lib, dual_segformer, items,
                              grad_names=MLPPP_GRAD_NAMES,
                              steps=MLPPP_TRAIN_STEPS)
    t0 = time.perf_counter()
    segnext_cfg = family_cfg(cfg_lib, "segnext_b")
    segnext_eval = slice_phase(S, FA, segnext_cfg, builder, evaluator_lib,
                               dual_segformer, items, sr_calls=SEGNEXT_SR_CALLS,
                               flash_calls=SEGNEXT_FLASH_CALLS,
                               fp32_batch=SEGNEXT_FP32_BATCH, vs_truth=True)
    segnext_train = train_phase(S, FA, segnext_cfg, train_lib, dual_segformer,
                                items, sr_calls=SEGNEXT_SR_CALLS,
                                flash_calls=SEGNEXT_FLASH_CALLS,
                                grad_names=SEGNEXT_GRAD_NAMES,
                                fp32_batch=SEGNEXT_FP32_BATCH, vs_truth=True)
    print(f"segnext_b phases: {time.perf_counter() - t0:.1f} s")
    widths = segnext_widths_phase(S, FA, cfg_lib, builder, evaluator_lib,
                                  train_lib, items)
    resnet = resnet_phase(S, FA, cfg_lib, builder, evaluator_lib, train_lib,
                          items)
    criteria = criteria_phase(cfg_lib, train_tf32)
    torch.cuda.empty_cache()
    ddp = ddp_world1_phase(S, cfg_lib, train_lib)
    print(card)

    def kernel_entry(name, replaces, launches, err, rows, calls, source=None):
        # Times are those of the calls of one forward (backward) of the
        # model that runs the kernel (32 for mit_b2, 48 for swin_s, 6 for
        # mit_b2pp's flash attention); `per_call` has them per shape. K3
        # and K4 also carry their device time (torch.profiler).
        entry = {"name": name, "route": "cuda",
                "source": "rgbx_semantic_segmentation_tpu_torch/csrc/"
                          f"{source or name}.cu",
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
        if "device_ms" in rows[0]:
            entry["device_ms"] = per_step(rows, "device_ms", calls)
        if "exp_floor_ms" in rows[0]:
            entry["exp_floor_ms"] = per_step(rows, "exp_floor_ms", calls)
        return entry

    def with_rates(entry, calls):
        # Every kernel's entry also carries its share of the bound and the
        # achieved TFLOP/s (the function's operations over the kernel's
        # time), over the `calls` of a step: each row's operations are its
        # rate times its time.
        rows = entry["per_call"]
        entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
        if "device_ms" in entry:
            entry["device_share_of_bound"] = (
                None if entry["device_ms"] is None
                else entry["bound_ms"] / entry["device_ms"])
        entry["tflops"] = sum(c * r["tflops"] * r["ms"] for c, r in zip(
            calls, rows)) / entry["ms"]
        return entry

    # K5 replaces the three upstream Pallas kernels that attention.py:50
    # (`_flash_attention`) reaches: jax/experimental/pallas/ops/tpu/
    # flash_attention.py :758 (forward), :1121 (dk/dv), :1456 (dq).
    flash_eval = pp_eval["flash_launches"]
    flash_train = pp_train["flash_launches"]
    entries = [
        ("sr_attention_fwd", "sr_attention.py:104",
         mit_eval["launches"] + train["fwd_launches"] + pp_eval["launches"]
         + pp_train["fwd_launches"] + cli["launches"]["fwd"]
         + pst_eval["launches"] + pst_train["fwd_launches"]
         + proto["launches"] + pst_cli["launches"]["fwd"]
         + m2f_eval["launches"] + m2f_train["fwd_launches"]
         + m2f_cli["launches"]["fwd"] + mlppp_eval["launches"]
         + mlppp_train["fwd_launches"] + ddp["launches"]["fwd"]
         + remat_launches(remat, 0) + lbfgs["k1"]
         + segnext_eval["launches"] + segnext_train["fwd_launches"]
         + sum(n["sr_fwd"] for n in widths.values()),
         max(fwd_err, sr_narrow_err["fwd"]), fwd_rows, CALLS_PER_FORWARD,
         None),
        ("sr_attention_bwd", "sr_attention.py:123",
         train["bwd_launches"] + pp_train["bwd_launches"]
         + cli["launches"]["bwd"] + pst_train["bwd_launches"]
         + pst_cli["launches"]["bwd"] + m2f_train["bwd_launches"]
         + m2f_cli["launches"]["bwd"] + mlppp_train["bwd_launches"]
         + ddp["launches"]["bwd"] + remat_launches(remat, 1) + lbfgs["k2"]
         + segnext_train["bwd_launches"]
         + sum(n["sr_bwd"] for n in widths.values()),
         max(bwd_err, sr_narrow_err["bwd"]), bwd_rows, CALLS_PER_FORWARD,
         None),
        ("window_attention_fwd", "window_attention.py:179",
         swin_eval["launches"] + swin_train["fwd_launches"]
         + swin_b["eval_launches"] + swin_b["fwd_launches"]
         + remat_launches(remat, 2),
         max(wfwd_err, swin_b_kernels["fwd_max_abs_err"]), wfwd_rows,
         SWIN_CALLS, None),
        ("window_attention_bwd", "window_attention.py:205",
         swin_train["bwd_launches"] + remat_launches(remat, 3), wbwd_err,
         wbwd_rows, SWIN_CALLS, None),
        # K4's route for bf16 windows 56 < N <= 144 (swin_b's window 12):
        # the same entry and wrapper, its launches those of the swin_b phase.
        ("window_attention_bwd_cluster", "window_attention.py:205",
         swin_b["bwd_launches"], swin_b_kernels["bwd_max_abs_err"],
         swin_b_kernels["bwd_per_call"], T.SWIN_B_BWD_CALLS,
         "window_attention_bwd"),
        ("flash_attention_fwd", "attention.py:50", flash_eval + flash_train[0],
         flash_err["fwd"], flash_rows["fwd"], T5.CALLS, None),
        ("flash_attention_bwd_dkv", "attention.py:50", flash_train[1],
         flash_err["dkv"], flash_rows["dkv"], T5.CALLS, "flash_attention_bwd"),
        ("flash_attention_bwd_dq", "attention.py:50", flash_train[2],
         flash_err["dq"], flash_rows["dq"], T5.CALLS, "flash_attention_bwd"),
        # K5 at SegNeXt's narrow heads (d = 8, 16, 40 of segnext_b in the
        # 64-wide panel; the padded route): the same kernels, the launches
        # of the segnext_b phases and of segnext_tiny / segnext_large; the
        # times segnext_b's (segnext_large's under "segnext_large_flash"),
        # the errors over all of SegNeXt's shapes.
        ("flash_attention_fwd_narrow", "attention.py:50",
         segnext_eval["flash_launches"] + segnext_train["flash_launches"][0]
         + sum(n["flash_fwd"] for n in widths.values()),
         narrow_err["fwd"],
         narrow_rows["fwd"], T5.CALLS, "flash_attention_fwd"),
        ("flash_attention_bwd_dkv_narrow", "attention.py:50",
         segnext_train["flash_launches"][1]
         + sum(n["flash_dkv"] for n in widths.values()), narrow_err["dkv"],
         narrow_rows["dkv"], T5.CALLS, "flash_attention_bwd"),
        ("flash_attention_bwd_dq_narrow", "attention.py:50",
         segnext_train["flash_launches"][2]
         + sum(n["flash_dq"] for n in widths.values()), narrow_err["dq"],
         narrow_rows["dq"], T5.CALLS, "flash_attention_bwd")]
    print(json.dumps({"kernels": [
        with_rates(kernel_entry(name, replaces, launches, err, rows, calls,
                                source), calls)
        for name, replaces, launches, err, rows, calls, source in entries],
        "eval_launches": mit_eval["launches"], "mit_eval": mit_eval,
        "train": train, "swin_eval": swin_eval, "swin_train": swin_train,
        "pp_eval": pp_eval, "pp_train": pp_train, "cli": cli,
        "pst_eval": pst_eval, "pst_train": pst_train, "protocol": proto,
        "pst_cli": pst_cli, "m2f_eval": m2f_eval, "m2f_train": m2f_train,
        "m2f_cli": m2f_cli, "mlppp_eval": mlppp_eval,
        "mlppp_train": mlppp_train, "criteria": criteria,
        "ddp_world1": ddp, "swin_b_kernels": swin_b_kernels,
        "swin_b": swin_b, "remat": remat, "lbfgs": lbfgs,
        "segnext_b_eval": segnext_eval, "segnext_b_train": segnext_train,
        "resnet50": resnet, "segnext_widths": widths,
        "segnext_sr": {"max_abs_err": sr_narrow_err, "rows": sr_narrow_rows},
        "segnext_large_flash": large_rows, "tools": tools, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
