"""Device times of the window-attention kernels (K3 forward, K4 backward)
at the swin_s (or swin_b) shapes, on one NVIDIA GPU.

    python -m rgbx_semantic_segmentation_tpu_torch.tools.bench_window_attention \
        [--model swin_s|swin_b] [--batch B] [--parent DIR] [--json PATH]

For each of the four swin_s stages at 480x640, batch 8 (bf16, d = 32,
window 7; swin_b: window 12, N = 144), with a bias block per window
carrying the model's shift mask ("shifted") and with one block shared by
all windows ("unshifted"), at the preset's attention dropout 0.3 and at 0:

  * the forward kernel and the backward kernel (dqkv, db) in device time
    per call (torch.profiler, the kernels' own time), beside
    F.scaled_dot_product_attention's forward and backward on the same
    windows (a yardstick only: the port never calls it; the bias goes in as
    a bf16 additive mask, dropout as SDPA's own; its backward is forward +
    backward through autograd minus the forward) and beside the card's bound
    for the same work;
  * the launch of each kernel as the profiler records it: blocks, and from
    them the (unit, image) pairs of a block (B x units / blocks; the window-12
    backward's blocks each take a third of a unit's rows over all images);
  * each kernel's result against its plain version: the forward in bf16
    ulps of the output's largest magnitude, dqkv likewise, db relative to
    its largest magnitude;
  * per step: the 48 calls of one forward or backward (4 / 4 / 36 / 4 at
    stages 1-4, half of them shifted); swin_b's backward runs 0 / 4 / 36 / 4
    (stage 1 frozen, the preset's swin_frozen_stages).

With --batch B the stages run at B images instead of 8: B = 2 is one
rank's share of the global batch 8 on four cards (chip_smoke.py --ddp 4).

With --parent DIR, the package directory of another checkout (the parent
commit unpacked under .chipcheck/, say), that checkout's kernels are timed
instead, built from its csrc/ and called through its C entries (whose
signatures every checkout of the port shares); SDPA is then not timed. Run
it in its own process, before and after this checkout's run in the same
chip call (old, new, new, old): loaded into one process, two checkouts'
libraries failed with an illegal instruction (PERF.md section 6).

It prints the card's name and power limit first; --json writes the numbers
to a file as well. chip_smoke.py takes the shapes, the input builder, the
SDPA inputs, the work counts and the kernels' mask readers from here.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile

import torch

from rgbx_semantic_segmentation_tpu_torch.models.encoders.dual_swin import (
    _shift_attn_mask)
from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as W
from rgbx_semantic_segmentation_tpu_torch.tools.bench_sr_attention import (
    device_ms, ulps)

# (B, Hp, Wp, h) of the swin_s window attentions at 480x640, batch 8 (padded
# token maps; d = 32, window 7, N = 49), the calls of each stage in one
# forward (2 towers x depths (2, 2, 18, 2); every second call shifted) and
# the attention dropout of the preset.
STAGES = [(8, 126, 161, 3), (8, 63, 84, 6), (8, 35, 42, 12), (8, 21, 21, 24)]
CALLS = [4, 4, 36, 4]
D, WS, RATE = 32, 7, 0.3
# The same of swin_b (window 12, N = 144; the same depths and d).
SWIN_B_STAGES = [(8, 120, 168, 4), (8, 60, 84, 8), (8, 36, 48, 16),
                 (8, 24, 24, 32)]
SWIN_B_WS = 12
SWIN_B_BWD_CALLS = [0, 4, 36, 4]
# Peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate
# and device-memory rate.
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
KINDS = ("shifted", "unshifted")


def window_inputs(shape, dtype, kind, gen):
    """Inputs of one call at shape (B, Hp, Wp, h, d, ws): qkv as the qkv
    Linear hands it over, a bias as the model builds it, a non-uniform
    cotangent and a seed. `kind` is the bias: "unshifted" (one block
    expanded to all windows), "shifted" (a block per window carrying the
    model's own shift mask) or "masked" (a block per window with a random
    two-way partition of every window's tokens, -100 across it)."""
    B, Hp, Wp, h, d, ws = shape
    N, nW = ws * ws, (Hp // ws) * (Wp // ws)
    qkv = torch.randn(B, Hp, Wp, 3 * h * d, device="cuda",
                      generator=gen).to(dtype)
    bias = torch.randn(1, h, N, N, device="cuda", generator=gen)
    if kind == "shifted":
        mask = torch.from_numpy(_shift_attn_mask(Hp, Wp, ws, ws // 2)).cuda()
        bias = bias + mask[:, None]
    elif kind == "masked":
        part = (torch.rand(nW, 1, N, 1, device="cuda", generator=gen)
                < 0.3).float()
        bias = bias + torch.where(part != part.transpose(-1, -2), -100.0, 0.0)
    elif kind == "unshifted":
        bias = bias.expand(nW, -1, -1, -1)
    else:
        raise ValueError(f"unknown bias kind {kind!r}")
    cot = torch.randn(B, Hp, Wp, h * d, device="cuda", generator=gen).to(dtype)
    seed = torch.empty(1, dtype=torch.int64, device="cuda").random_(
        generator=gen)
    return qkv, bias, cot, seed


def sdpa_inputs(qkv, bias, shape):
    """What the library yardstick takes: q, k, v partitioned into contiguous
    (B * nW, h, N, d) windows and the bias as a bf16 additive mask of shape
    (B * nW, h, N, N). SDPA then runs with its own dropout; the partition
    and reverse copies a library path would need are not in its time."""
    B, _, _, h, d, ws = shape
    x = W._split_windows(qkv, ws, 3, h)
    q, k, v = (x[:, :, i].reshape(-1, h, ws * ws, d).contiguous()
               for i in range(3))
    mask = bias.to(torch.bfloat16)[None].expand(B, -1, -1, -1, -1)
    return q, k, v, mask.reshape(-1, h, ws * ws, ws * ws).contiguous()


def units(shape):
    """(window, head) units of one call at shape (B, Hp, Wp, h, d, ws)."""
    _, Hp, Wp, h, _, ws = shape
    return (Hp // ws) * (Wp // ws) * h


def work(shape, shifted, backward):
    """(bytes, operations) of one call: qkv and the bias read once, out
    written once; the backward also reads g and writes dqkv and db. 2
    products forward, 5 backward (bf16 operands, 2 bytes an element)."""
    B, Hp, Wp, h, d, ws = shape
    N, nW = ws * ws, (Hp // ws) * (Wp // ws)
    pixels, C = B * Hp * Wp, h * d
    bias = (nW if shifted else 1) * h * N * N * 4
    if backward:
        nbytes = 2 * pixels * (3 * C + C + 3 * C) + bias + nW * h * N * N * 4
    else:
        nbytes = 2 * pixels * (3 * C + C) + bias
    return nbytes, (10 if backward else 4) * B * nW * h * N * N * d


def bound_ms(shape, shifted, backward):
    """Least time the card could take for the work; (ms, what binds)."""
    nbytes, ops = work(shape, shifted, backward)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def launch_blocks(fn):
    """Blocks of the first window-attention kernel fn launches, read off
    the profiler's trace (its `grid` field); None where the trace has
    none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    grids = [e.get("args", {}).get("grid") for e in events
             if e.get("cat") == "kernel"
             and "window_attention" in e.get("name", "")]
    grids = [g for g in grids if g]
    return math.prod(grids[0]) if grids else None


def kernel_mask(shape, seed, rate):
    """The keep mask the forward KERNEL drew, read off its outputs: with
    q = k = 0 and a zero bias every probability is 1 / N > 0, and with v
    one-hot over d keys at a time, out[row, e] > 0 iff key e of the chunk
    was kept. bool (B, nW, h, N, N), to be equal to W.keep_mask."""
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


def kernel_bwd_mask(shape, seed, rate):
    """The keep mask the backward KERNEL drew, read off its dv: with q = k =
    0 and a zero bias every probability is 1 / N > 0, and with the
    cotangent one-hot over d query rows at a time (g[row, e] = 1 iff row =
    c0 + e), dv[key, e] = pd[c0 + e, key] > 0 iff that element was kept.
    bool (B, nW, h, N, N), to be equal to W.keep_mask."""
    B, Hp, Wp, h, d, ws = shape
    N, nW = ws * ws, (Hp // ws) * (Wp // ws)
    bias = torch.zeros(1, h, N, N, device="cuda").expand(nW, -1, -1, -1)
    qkv = torch.zeros(B, Hp, Wp, 3 * h * d, device="cuda",
                      dtype=torch.bfloat16)
    kept = torch.zeros(B, nW, h, N, N, dtype=torch.bool, device="cuda")
    for c0 in range(0, N, d):
        cot = torch.zeros(B, nW, 1, h, N, d, device="cuda",
                          dtype=torch.bfloat16)
        rows = torch.arange(c0, min(c0 + d, N), device="cuda")
        cot[:, :, 0, :, rows, rows - c0] = 1.0
        dqkv, _ = W.window_attention_bwd(
            qkv, bias, seed, W._merge_windows(cot, ws, Hp, Wp), 1.0, rate, ws)
        dv = W._split_windows(dqkv, ws, 3, h)[:, :, 2]    # (B, nW, h, N, d)
        kept[..., c0:c0 + len(rows), :] = (
            dv[..., :len(rows)] > 0).transpose(-1, -2)
    return kept


class Parent:
    """K3 and K4 of another checkout's package, built from its csrc/ and
    called through its C entries; the arguments are this checkout's
    (`W._kernel_args`), which both sides share (a checkout whose C entries
    take `window0`)."""

    def __init__(self, pkg_dir: str):
        spec = importlib.util.spec_from_file_location(
            "parent_build", os.path.join(pkg_dir, "native", "build.py"))
        build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(build)
        self.fwd = getattr(ctypes.CDLL(build.build("window_attention_fwd")),
                           "window_attention_fwd")
        self.fwd.argtypes = [ctypes.c_void_p] * 4 + W._ARGS
        self.bwd = getattr(ctypes.CDLL(build.build("window_attention_bwd")),
                           "window_attention_bwd")
        self.bwd.argtypes = [ctypes.c_void_p] * 6 + W._ARGS

    def forward(self, qkv, bias, seed, scale, rate, ws):
        dims = W._check(qkv, bias, seed, rate, ws)
        B, Hp, Wp, h, d, _ = dims
        out = torch.empty(B, Hp, Wp, h * d, dtype=qkv.dtype, device=qkv.device)
        rc = self.fwd(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                      seed.data_ptr() if rate > 0.0 else None,
                      *W._kernel_args("window_attention", qkv, bias, seed,
                                      scale, rate, ws, dims))
        assert rc == 0, rc
        return out

    def backward(self, qkv, bias, seed, g, scale, rate, ws):
        dims = W._check(qkv, bias, seed, rate, ws)
        nW, h, N = dims[5], dims[3], ws * ws
        dqkv = torch.empty_like(qkv)
        db = torch.empty(nW, h, N, N, dtype=torch.float32, device=qkv.device)
        rc = self.bwd(qkv.data_ptr(), bias.data_ptr(), g.data_ptr(),
                      dqkv.data_ptr(), db.data_ptr(),
                      seed.data_ptr() if rate > 0.0 else None,
                      *W._kernel_args("window_attention_bwd", qkv, bias, seed,
                                      scale, rate, ws, dims))
        assert rc == 0, rc
        return dqkv, db


def kernel_ms(fn):
    """Device ms per call of fn's window-attention kernels (torch.profiler
    over 20 calls of fn, one kernel each). A reading that lost some of the
    kernels' events (seen in chip_smoke.py's long process: 0 or a fraction
    of the time) is taken again, at most three times in all; None if all
    three lost events."""
    from torch.profiler import ProfilerActivity, profile

    calls = 20
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if "window_attention" in e.key]
        if sum(e.count for e in ev) == calls:
            total = 0.0
            for e in ev:
                t = getattr(e, "self_device_time_total", None)
                total += t if t is not None else e.self_cuda_time_total
            return total / calls * 1e-3
    return None


def measured_ms(fn):
    """kernel_ms(fn), raising where the profiler lost the kernels' events."""
    ms = kernel_ms(fn)
    if ms is None:
        raise RuntimeError("torch.profiler lost window-attention kernel "
                           "events in three readings")
    return ms


def time_stage(stage, gen, parent=None, ws=WS):
    """One stage's row: device ms per call by bias kind and rate of K3, K4
    (this checkout's or the parent's) and, for this checkout, SDPA's forward
    and backward; blocks per launch and (unit, image) pairs a block; errors
    against the plain versions."""
    shape = (*stage, D, ws)
    B, Hp, Wp, h, d, ws = shape
    n_units = units(shape)
    sc = d ** -0.5
    if parent is not None:
        fwd, bwd = parent.forward, parent.backward
    else:
        fwd, bwd = W.window_attention, W.window_attention_bwd
    row = {"shape": list(shape), "units": n_units, "fwd_ms": {}, "bwd_ms": {},
           "sdpa_fwd_ms": {}, "sdpa_bwd_ms": {}, "fwd_ulps": 0.0,
           "dqkv_ulps": 0.0, "db_rel": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for kind in KINDS:
        qkv, bias, cot, seed = window_inputs(shape, torch.bfloat16, kind, gen)
        shifted = kind == "shifted"
        row[f"fwd_bound_ms_{kind}"] = bound_ms(shape, shifted, False)[0]
        row[f"bwd_bound_ms_{kind}"] = bound_ms(shape, shifted, True)[0]
        for rate in (RATE, 0.0):
            key = f"{kind}_{rate}"
            with torch.no_grad():
                out = fwd(qkv, bias, seed, sc, rate, ws)
                ref = W.window_attention_reference(qkv, bias, seed, sc, rate,
                                                   ws)
                row["fwd_ulps"] = max(row["fwd_ulps"], ulps(out, ref))
                del out, ref
                row["fwd_ms"][key] = measured_ms(
                    lambda: fwd(qkv, bias, seed, sc, rate, ws))
                if key == f"shifted_{RATE}":
                    row["fwd_blocks"] = launch_blocks(
                        lambda: fwd(qkv, bias, seed, sc, rate, ws))
                dqkv, db = bwd(qkv, bias, seed, cot, sc, rate, ws)
                rq, rb = W.window_attention_bwd_reference(
                    qkv, bias, seed, cot, sc, rate, ws)
                row["dqkv_ulps"] = max(row["dqkv_ulps"], ulps(dqkv, rq))
                row["db_rel"] = max(row["db_rel"], float(
                    (db - rb).abs().max() / rb.abs().max()))
                del dqkv, db, rq, rb
                row["bwd_ms"][key] = measured_ms(
                    lambda: bwd(qkv, bias, seed, cot, sc, rate, ws))
                if key == f"shifted_{RATE}":
                    row["bwd_blocks"] = launch_blocks(
                        lambda: bwd(qkv, bias, seed, cot, sc, rate, ws))
            if parent is not None:
                continue
            lq, lk, lv, mask = (t.requires_grad_() for t in
                                sdpa_inputs(qkv, bias, shape))
            w = W._split_windows(cot, ws, 1, h)[:, :, 0].reshape(lq.shape)

            def lib_fwd():
                return sdpa(lq, lk, lv, attn_mask=mask, dropout_p=rate,
                            scale=sc)

            def lib_fwd_bwd():
                torch.autograd.grad(lib_fwd(), (lq, lk, lv, mask), w)

            with torch.no_grad():
                row["sdpa_fwd_ms"][key] = device_ms(lib_fwd)
            row["sdpa_bwd_ms"][key] = (device_ms(lib_fwd_bwd)
                                       - row["sdpa_fwd_ms"][key])
            del lq, lk, lv, mask, w
    for which in ("fwd", "bwd"):
        if row.get(f"{which}_blocks"):
            row[f"{which}_images_per_block"] = math.ceil(
                B * n_units / row[f"{which}_blocks"])
    return row


def per_step(rows, key, calls=CALLS):
    """{rate: ms} of one swin_s (swin_b) forward or backward: `calls` of
    each stage, half shifted, half unshifted."""
    out = {}
    for rate in (RATE, 0.0):
        if not rows[0][key]:
            continue
        out[str(rate)] = sum(
            c * sum(r[key][f"{kind}_{rate}"] for kind in KINDS) / 2
            for c, r in zip(calls, rows))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="package directory of another checkout: "
                    "time its kernels instead of this checkout's")
    ap.add_argument("--json", help="also write the numbers to this file")
    ap.add_argument("--model", choices=("swin_s", "swin_b"), default="swin_s",
                    help="whose stage shapes (swin_b: window 12)")
    ap.add_argument("--batch", type=int, default=8,
                    help="images a call (8: the preset's batch; 2: a rank's "
                    "share of it on four cards)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_window_attention: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    parent = Parent(args.parent) if args.parent else None
    tag = "parent" if parent is not None else "new"
    gen = torch.Generator(device="cuda").manual_seed(0)
    swin_b = args.model == "swin_b"
    whiches = ("fwd", "bwd")
    calls = {"fwd": CALLS, "bwd": SWIN_B_BWD_CALLS if swin_b else CALLS}
    rows = []
    for stage in SWIN_B_STAGES if swin_b else STAGES:
        stage = (args.batch, *stage[1:])
        row = time_stage(stage, gen, parent, SWIN_B_WS if swin_b else WS)
        rows.append(row)
        print(f"{tag} {args.model} (B,Hp,Wp,h)={stage}: " + ", ".join(
                  f"{which} {row.get(f'{which}_blocks')} blocks of "
                  f"{row.get(f'{which}_images_per_block')} unit-images"
                  for which in whiches) + "; "
              + "; ".join(
                  f"{key} " + " ".join(
                      f"{which} {row[f'{which}_ms'][key]:.4f}"
                      for which in whiches)
                  + (" sdpa " + " / ".join(
                      f"{row[f'sdpa_{which}_ms'][key]:.4f}"
                      for which in whiches)
                     if row["sdpa_fwd_ms"] else "")
                  for key in row["fwd_ms"])
              + f" ms; err fwd {row['fwd_ulps']:.2f} ulps, dqkv "
              f"{row['dqkv_ulps']:.2f} ulps, db {row['db_rel']:.2e}",
              flush=True)
    step = {f"{key}_ms": per_step(rows, f"{key}_ms", calls[key[-3:]])
            for key in ("fwd", "bwd", "sdpa_fwd", "sdpa_bwd")}
    for which in whiches:
        step[f"{which}_bound_ms"] = sum(
            c * (r[f"{which}_bound_ms_shifted"]
                 + r[f"{which}_bound_ms_unshifted"]) / 2
            for c, r in zip(calls[which], rows))
        ms = step[f"{which}_ms"][str(RATE)]
        step[f"{which}_share_of_bound"] = step[f"{which}_bound_ms"] / ms
    print(f"{tag}, per {args.model} step ({sum(calls['fwd'])} forward, "
          f"{sum(calls['bwd'])} backward calls): " + json.dumps(step))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "tag": tag, "model": args.model,
                       "batch": args.batch, "rows": rows, "step": step}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
