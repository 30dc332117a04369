"""Times of the long-kv flash attention kernels on one NVIDIA GPU.

    python -m rgbx_semantic_segmentation_tpu_torch.tools.bench_flash_attention

At the three shapes the IFFM cross-attention of mit_b2pp gives them at
480x640, batch 8 (stages 1-3; stage 4 is short-kv and goes to the SR
kernels), bf16, on the model's layouts: the forward kernel, the dk/dv kernel
and the dq kernel, each beside its plain version (the chunked reference of
ops/flash_attention.py), beside F.scaled_dot_product_attention (a yardstick
only: the port never calls it) and beside the card's bound for the same
work. Plain and kernel are timed in one window (plain, kernel, kernel,
plain).

chip_smoke.py takes the shapes, the input builder and the work counts from
here.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from rgbx_semantic_segmentation_tpu_torch.ops import flash_attention as FA

# (B, h, N, M, d) of the IFFM cross-attentions of mit_b2pp at 480x640, batch
# 8, and the calls of each in one forward (x1 -> x2 and x2 -> x1).
SHAPES = [(8, 1, 19200, 19200, 64), (8, 2, 4800, 4800, 64),
          (8, 5, 1200, 1200, 64)]
CALLS = [2, 2, 2]
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
    "plain_ms", "library_ms", "bound_ms", "bound_by"}}. The plain backward
    is one function, so the dk/dv and dq rows share its time and the
    library's backward (SDPA forward + backward through autograd, minus the
    forward alone)."""
    B, h, N, M, d = shape
    sc = d ** -0.5
    q, k, v, w = inputs(shape, torch.bfloat16, gen)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        out, lse = FA._forward(q, k, v, sc)
        di = (out.float() * w.float()).sum(-1).contiguous()

        def plain_fwd():
            FA.flash_attention_reference(q, k, v, sc)

        def plain_bwd():
            FA.flash_attention_bwd_reference(q, k, v, out, lse, w, sc)

        p1 = median_ms(plain_fwd, warmup=1, iters=3, reps=1)
        k1 = median_ms(lambda: FA._forward(q, k, v, sc))
        k2 = median_ms(lambda: FA._forward(q, k, v, sc))
        p2 = median_ms(plain_fwd, warmup=1, iters=3, reps=1)
        lib_fwd = median_ms(lambda: sdpa(q, k, v, scale=sc))
        b1 = median_ms(plain_bwd, warmup=1, iters=3, reps=1)
        kv1 = median_ms(lambda: FA.flash_attention_dkv(q, k, v, w, lse, di, sc))
        dq1 = median_ms(lambda: FA.flash_attention_dq(q, k, v, w, lse, di, sc))
        dq2 = median_ms(lambda: FA.flash_attention_dq(q, k, v, w, lse, di, sc))
        kv2 = median_ms(lambda: FA.flash_attention_dkv(q, k, v, w, lse, di, sc))
        b2 = median_ms(plain_bwd, warmup=1, iters=3, reps=1)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        torch.autograd.grad(sdpa(lq, lk, lv, scale=sc), (lq, lk, lv), w)

    lib_bwd = median_ms(fwd_bwd) - lib_fwd
    rows = {}
    for which, ms, plain, lib in (
            ("fwd", (k1 + k2) / 2, (p1 + p2) / 2, lib_fwd),
            ("dkv", (kv1 + kv2) / 2, (b1 + b2) / 2, lib_bwd),
            ("dq", (dq1 + dq2) / 2, (b1 + b2) / 2, lib_bwd)):
        bound, by = bound_ms(shape, which)
        rows[which] = {"shape": list(shape), "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bound, "bound_by": by}
    return rows


def print_rows(shape, rows) -> None:
    for which, r in rows.items():
        note = " (whole backward)" if which != "fwd" else ""
        print(f"time bf16 flash {which} (B,h,N,M,d)={tuple(shape)}: kernel "
              f"{r['ms']:.4f} ms, plain{note} {r['plain_ms']:.3f} ms, SDPA"
              f"{note} {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound")


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        print_rows(shape, time_shape(shape, gen))
    return 0


if __name__ == "__main__":
    sys.exit(main())
