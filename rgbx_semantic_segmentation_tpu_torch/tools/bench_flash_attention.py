"""Times of the long-kv flash attention kernels on one NVIDIA GPU.

    python -m rgbx_semantic_segmentation_tpu_torch.tools.bench_flash_attention \
        [--parent DIR] [--json PATH]

At the three shapes the IFFM cross-attention of mit_b2pp gives them at
480x640, batch 8 (stages 1-3; stage 4 is short-kv and goes to the SR
kernels), bf16, on the model's layouts:

  * the forward kernel, the dk/dv kernel and the dq kernel, each beside its
    plain version (the chunked reference of ops/flash_attention.py), beside
    F.scaled_dot_product_attention (a yardstick only: the port never calls
    it; its inputs require grad, so that its forward writes the logsumexp
    as the forward kernel does) and beside the card's bound for the same
    work, in CUDA-event windows (plain, kernel, kernel, plain);
  * the forward kernel and SDPA's forward, then the backward (dk/dv + dq
    kernels) and SDPA's backward, in device time by kernel (torch.profiler),
    each checked against the plain version in bf16 ulps of the output's (of
    each gradient's) largest magnitude;
  * the forward's host time a call: its C entry (tensor maps, launch
    plan, launches) called back to back through ctypes without waiting for
    the card, the same Python path for this checkout and the parent's;
  * with --parent DIR, the package directory of another checkout (the parent
    commit unpacked under .chipcheck/, say), that checkout's forward and
    backward kernels instead, built from its csrc/ and called through its C
    entries, in the same device time. Run it in its own process, before and
    after this checkout's run in the same chip call (old, new, new, old):
    loaded into one process, two checkouts' libraries failed with an illegal
    instruction (PERF.md section 6), so the parent's process loads only the
    parent's libraries.

It prints the card's name and power limit first; --json writes the numbers
to a file as well. chip_smoke.py takes the shapes, the input builder and the
work counts from here.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from rgbx_semantic_segmentation_tpu_torch.ops import flash_attention as FA
from rgbx_semantic_segmentation_tpu_torch.tools.bench_sr_attention import (
    device_ms, ulps)

# (B, h, N, M, d) of the IFFM cross-attentions of mit_b2pp at 480x640, batch
# 8, and the calls of each in one forward (x1 -> x2 and x2 -> x1).
SHAPES = [(8, 1, 19200, 19200, 64), (8, 2, 4800, 4800, 64),
          (8, 5, 1200, 1200, 64)]
CALLS = [2, 2, 2]
# The same for segnext_b (8 heads on the stage width: d = 8, 16, 40), whose
# kernels stage d in a 64-wide panel with zero columns past d.
SEGNEXT_SHAPES = [(8, 8, 19200, 19200, 8), (8, 8, 4800, 4800, 16),
                  (8, 8, 1200, 1200, 40)]
# The same for segnext_large (d = 12, 24, 48). d = 12 reaches the kernels
# zero-padded to 16 (ops/attention.multi_head_attention), and so it is
# timed: the kernels on the padded operands, the plain version, SDPA and
# the bound on the true d.
SEGNEXT_LARGE_SHAPES = [(8, 8, 19200, 19200, 12), (8, 8, 4800, 4800, 24),
                        (8, 8, 1200, 1200, 48)]
# Exponentials a second of one H100 SXM: 132 SMs, 16 MUFU.EX2 a clock each,
# at the 1.98 GHz boost clock. Every kernel takes one exponential per logit
# (the backward ones recompute p); at a narrow d they, not the products,
# bind the kernel, a floor beside the table's bound.
EXP_RATE = 132 * 16 * 1.98e9
# Peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate
# and device-memory rate.
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# Products of each function: the forward q k^T and p v; the dk/dv kernel
# q k^T, g v^T, p^T g, ds^T q; the dq kernel q k^T, g v^T, ds k.
PRODUCTS = {"fwd": 2, "dkv": 4, "dq": 3}


def inputs(shape, dtype, gen):
    """q, k, v as ImprovedCrossAttention hands them over and the cotangent
    as autograd hands it back: head-split views of (B, N, h*d) tensors and
    of the (B, M, 2, h, d) kv projection."""
    B, h, N, M, d = shape
    dev = gen.device
    x = torch.randn(B, N, h * d, device=dev, generator=gen).to(dtype)
    kv = torch.randn(B, M, 2, h, d, device=dev, generator=gen).to(dtype)
    w = torch.randn(B, N, h * d, device=dev, generator=gen).to(dtype)
    k, v = (t.transpose(1, 2) for t in kv.unbind(2))
    return (x.reshape(B, N, h, d).transpose(1, 2), k, v,
            w.reshape(B, N, h, d).transpose(1, 2))


def work(shape, which, itemsize=2):
    """(operations, bytes) of one call: 2 * B*h*N*M*d a product; every input
    read once and every output written once (lse and di are fp32 rows)."""
    B, h, N, M, d = shape
    ops = 2 * PRODUCTS[which] * B * h * N * M * d
    rows_q, rows_kv = B * h * N * d * itemsize, B * h * M * d * itemsize
    stat = B * h * N * 4
    if which == "fwd":
        return ops, 2 * rows_q + 2 * rows_kv + stat
    if which == "dkv":
        return ops, 2 * rows_q + 4 * rows_kv + 2 * stat
    return ops, 3 * rows_q + 2 * rows_kv + 2 * stat


def exp_floor_ms(shape):
    """Least time of one call's B*h*N*M exponentials (EXP_RATE), in ms."""
    B, h, N, M, _ = shape
    return B * h * N * M / EXP_RATE * 1e3


def bound_ms(shape, which):
    """Least time the card could take for bf16 work; (ms, what binds)."""
    ops, nbytes = work(shape, which)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def median_ms(fn, warmup=2, iters=5, reps=2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def time_shape(shape, gen):
    """The times of one shape in bf16: {"fwd" | "dkv" | "dq": {"ms",
    "plain_ms", "library_ms", "bound_ms", "bound_by", "exp_floor_ms",
    "share_of_bound", "tflops"}}. The plain backward
    is one function, so the dk/dv and dq rows share its time and the
    library's backward (SDPA forward + backward through autograd, minus the
    forward alone). A head dim that is not a multiple of 8 times the
    kernels on the operands zero-padded to one, as the model's path calls
    them (the pad itself not timed); everything else on the true d."""
    B, h, N, M, d = shape
    sc = d ** -0.5
    q, k, v, w = inputs(shape, torch.bfloat16, gen)
    kq, kk, kv_, kw = ((torch.nn.functional.pad(t, (0, -d % 8))
                        for t in (q, k, v, w)) if d % 8 else (q, k, v, w))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        kout, klse = FA._forward(kq, kk, kv_, sc)
        out, lse = (FA.flash_attention_reference(q, k, v, sc) if d % 8
                    else (kout, klse))
        di = (kout.float() * kw.float()).sum(-1).contiguous()

        def plain_fwd():
            FA.flash_attention_reference(q, k, v, sc)

        def plain_bwd():
            FA.flash_attention_bwd_reference(q, k, v, out, lse, w, sc)

        def dkv():
            FA.flash_attention_dkv(kq, kk, kv_, kw, klse, di, sc)

        def dq():
            FA.flash_attention_dq(kq, kk, kv_, kw, klse, di, sc)

        # The plain versions take 0.07-2 s a call at these shapes: one
        # window after one warm call each.
        p1 = median_ms(plain_fwd, warmup=1, iters=1, reps=1)
        k1 = median_ms(lambda: FA._forward(kq, kk, kv_, sc))
        k2 = median_ms(lambda: FA._forward(kq, kk, kv_, sc))
        p2 = median_ms(plain_fwd, warmup=1, iters=1, reps=1)
        b1 = median_ms(plain_bwd, warmup=1, iters=1, reps=1)
        kv1 = median_ms(dkv)
        dq1 = median_ms(dq)
        dq2 = median_ms(dq)
        kv2 = median_ms(dkv)
        b2 = median_ms(plain_bwd, warmup=1, iters=1, reps=1)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        torch.autograd.grad(sdpa(lq, lk, lv, scale=sc), (lq, lk, lv), w)

    lib_fwd = median_ms(lambda: sdpa(lq, lk, lv, scale=sc))
    lib_bwd = median_ms(fwd_bwd) - lib_fwd
    rows = {}
    for which, ms, plain, lib in (
            ("fwd", (k1 + k2) / 2, (p1 + p2) / 2, lib_fwd),
            ("dkv", (kv1 + kv2) / 2, (b1 + b2) / 2, lib_bwd),
            ("dq", (dq1 + dq2) / 2, (b1 + b2) / 2, lib_bwd)):
        bound, by = bound_ms(shape, which)
        rows[which] = {"shape": list(shape), "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bound, "bound_by": by,
                       "exp_floor_ms": exp_floor_ms(shape),
                       "share_of_bound": bound / ms,
                       "tflops": work(shape, which)[0] / ms * 1e-9}
    return rows


def print_rows(shape, rows) -> None:
    for which, r in rows.items():
        note = " (whole backward)" if which != "fwd" else ""
        print(f"time bf16 flash {which} (B,h,N,M,d)={tuple(shape)}: kernel "
              f"{r['ms']:.4f} ms, plain{note} {r['plain_ms']:.3f} ms, SDPA"
              f"{note} {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound; "
              f"exponentials' floor {r['exp_floor_ms']:.4f} ms")


class Parent:
    """K5 of another checkout's package (its forward, dk/dv and dq kernels),
    built from its csrc/ and called through its C entries."""

    def __init__(self, pkg_dir: str):
        spec = importlib.util.spec_from_file_location(
            "parent_build", os.path.join(pkg_dir, "native", "build.py"))
        build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(build)
        vp, i = ctypes.c_void_p, ctypes.c_int
        tail = [i] * 5 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          i, vp]
        self.fwd_lib = ctypes.CDLL(build.build("flash_attention_fwd"))
        self.fwd_lib.flash_attention_fwd.argtypes = [vp] * 5 + tail
        self.lib = ctypes.CDLL(build.build("flash_attention_bwd"))
        self.lib.flash_attention_bwd_dkv.argtypes = [vp] * 8 + tail
        self.lib.flash_attention_bwd_dq.argtypes = [vp] * 7 + tail

    def forward(self, q, k, v, scale):
        B, h, N, d = q.shape
        out = torch.empty(B, N, h, d, dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        lse = torch.empty(B, h, N, dtype=torch.float32, device=q.device)
        rc = self.fwd_lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, h, N, k.shape[2], d, FA._strides(q, k, v, out),
            scale, 1, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out, lse

    def backward(self, q, k, v, g, lse, di, scale):
        B, h, N, d = q.shape
        M = k.shape[2]
        dq = torch.empty(B, N, h, d, dtype=q.dtype,
                         device=q.device).transpose(1, 2)
        dkv = torch.empty(B, M, 2, h, d, dtype=q.dtype, device=q.device)
        dk, dv = (t.transpose(1, 2) for t in dkv.unbind(2))
        stream = torch.cuda.current_stream().cuda_stream
        rc = self.lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, h,
            N, M, d, FA._strides(q, k, v, g, dk, dv), scale, 1, stream)
        rc = rc or self.lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, h, N, M, d,
            FA._strides(q, k, v, g, dq), scale, 1, stream)
        assert rc == 0, rc
        return dq, dk, dv


def host_us(fn, calls=50):
    """Host time of one call of fn in us: `calls` calls back to back on
    the host's clock, the card left to catch up afterwards; the median of
    three such runs."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(runs))


def kernel_device_ms(fn, pattern, count):
    """(device ms per call of fn's kernels, {kernel name: ms per call}) from
    torch.profiler; a reading that lost one of the `count` kernels matching
    `pattern` is taken again."""
    for _ in range(3):
        per_kernel = device_ms(fn, calls=5, by_kernel=True)
        by_kernel = {
            name[0]: t for key, t in per_kernel.items()
            if (name := re.findall(pattern, key))}
        if len(by_kernel) == count:
            break
    return sum(per_kernel.values()), by_kernel


def device_times(shape, gen, parent=None):
    """K5 in bf16 at one shape in device time (torch.profiler, by kernel)
    and in event windows: this checkout's forward kernel and its dk/dv and
    dq kernels, SDPA's forward (inputs that require grad: it writes its
    logsumexp) and SDPA's backward (forward + backward through autograd,
    minus that forward); or with `parent` only that checkout's kernels. Each
    is checked against the plain version: bf16 ulps of the output's largest
    magnitude (and the lse's largest error), of each gradient's largest."""
    B, h, N, M, d = shape
    sc = d ** -0.5
    q, k, v, w = inputs(shape, torch.bfloat16, gen)
    if parent is not None:
        tag = "parent"
        fwd = lambda: parent.forward(q, k, v, sc)  # noqa: E731
        entry = parent
    else:
        tag = "new"
        fwd = lambda: FA._forward(q, k, v, sc)  # noqa: E731
        entry = Parent(os.path.dirname(os.path.dirname(FA.__file__)))
    out, lse = fwd()
    di = (out.float() * w.float()).sum(-1).contiguous()
    if parent is not None:
        bwd = lambda: parent.backward(q, k, v, w, lse, di, sc)  # noqa: E731
    else:
        def bwd():
            dk, dv = FA.flash_attention_dkv(q, k, v, w, lse, di, sc)
            return FA.flash_attention_dq(q, k, v, w, lse, di, sc), dk, dv
    row = {"shape": list(shape)}
    with torch.no_grad():
        ref_out, ref_lse = FA.flash_attention_reference(q, k, v, sc)
        row[f"{tag}_fwd_ulps"] = ulps(out, ref_out)
        row[f"{tag}_fwd_lse_err"] = float((lse - ref_lse).abs().max())
        ref = FA.flash_attention_bwd_reference(q, k, v, out, lse, w, sc)
        row[f"{tag}_ulps"] = [ulps(x, y) for x, y in zip(bwd(), ref)]
        del ref
        row[f"{tag}_fwd_ms"] = [median_ms(fwd, warmup=1, iters=5, reps=2)
                                for _ in range(2)]
        row[f"{tag}_ms"] = [median_ms(bwd, warmup=1, iters=5, reps=2)
                            for _ in range(2)]
        row[f"{tag}_fwd_device_ms"] = kernel_device_ms(
            fwd, r"\bflash_\w+(?:<[^>]*>)?", 1)[0]
        row[f"{tag}_fwd_host_us"] = host_us(
            lambda: entry.forward(q, k, v, sc))
        (row[f"{tag}_device_ms"],
         row[f"{tag}_device_ms_by_kernel"]) = kernel_device_ms(
             bwd, r"\bflash_\w+(?:<[^>]*>)?", 2)
    if parent is not None:
        return row
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(*leaves, scale=sc)
    row["sdpa_fwd_ulps"] = ulps(lib_out.detach(), ref_out)
    del lib_out
    lib_fwd = device_ms(lambda: sdpa(*leaves, scale=sc))
    row["sdpa_fwd_device_ms"] = lib_fwd

    def sdpa_fwd_bwd():
        for t in leaves:
            t.grad = None
        sdpa(*leaves, scale=sc).backward(w)

    row["sdpa_bwd_device_ms"] = device_ms(sdpa_fwd_bwd) - lib_fwd
    row["fwd_bound_ms"] = bound_ms(shape, "fwd")[0]
    row["bound_ms"] = bound_ms(shape, "dkv")[0] + bound_ms(shape, "dq")[0]
    row["fused_bound_ms"] = 10 * B * h * N * M * d / PEAK_BF16_FLOPS * 1e3
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="package directory of another checkout: "
                    "time its kernels instead of this checkout's")
    ap.add_argument("--json", help="also write the numbers to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    parent = Parent(args.parent) if args.parent else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in SHAPES:
        if parent is None:
            print_rows(shape, time_shape(shape, gen))
        row = device_times(shape, gen, parent)
        print(json.dumps(row), flush=True)
        rows.append(row)
    step = {key: sum(c * r[key] for c, r in zip(CALLS, rows))
            for key in rows[0] if key.endswith("device_ms")
            or key.endswith("bound_ms")}
    for key in [k for k in rows[0] if k.endswith("device_ms_by_kernel")]:
        for name in rows[0][key]:
            step[name] = sum(c * r[key][name] for c, r in zip(CALLS, rows))
    print("per mit_b2pp step (6 calls): " + json.dumps(step))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows, "step": step}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
