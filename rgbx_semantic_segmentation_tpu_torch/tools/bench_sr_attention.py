"""Design choices of the short-kv SR-attention kernels (K1 forward, K2
backward), timed on one NVIDIA GPU.

    python -m rgbx_semantic_segmentation_tpu_torch.tools.bench_sr_attention \
        [--parent DIR] [--json PATH]

At the four mit_b2 480x640 batch-8 shapes, bf16, on the model's layouts
(head-split views of the token tensors), each choice timed in one window
with the planned kernel before and after it:

  * forward: the planned one-pass kernel (logits row in registers) against
    the two-pass kernel forced (online max and sum, then p @ v); and the
    two-pass kernel at the stage-1 shape of a whole 720x1280 frame
    (M = 880), where one pass does not fit;
  * backward: the cluster size of the dkv kernel (the shares of a kv tile's
    q rows that sum their dk, dv partials through distributed shared
    memory): planned, 1 (a block owns its kv tile over all of N: no
    reduction, few blocks), 2, 4, 8;
  * device times (torch.profiler) of K1, K2 (by kernel) and of
    `F.scaled_dot_product_attention`'s forward and backward on the same
    inputs;
  * delta: max abs error, in bf16 ulps of each gradient's largest, of the
    kernel (delta = rowsum(dp * pf)) and of the plain residual backward
    with delta = rowsum(g * out) instead, both against the plain version;
  * with --parent DIR, the package directory of another checkout (the
    parent commit unpacked under .chipcheck/, say): its K1 and K2, built
    from its csrc/, against this checkout's, in turns old, new, new, old,
    per call and per step (the 32 calls of a mit_b2 forward or backward).

It prints the card's name and power limit first; --json writes every
number to a file as well.
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

import numpy as np
import torch

from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S

FLAGSHIP = [(8, 1, 19200, 300, 64), (8, 2, 4800, 300, 64),
            (8, 5, 1200, 300, 64), (8, 8, 300, 300, 64)]
CALLS = [6, 8, 12, 6]  # calls of each shape in one mit_b2 forward
LARGE_FRAME = (2, 1, 57600, 880, 64)


def median_ms(fn, warmup=3, iters=20, reps=5) -> float:
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


def device_ms(fn, calls=20, by_kernel=False):
    """Device time per call: the summed time of the kernels `fn` launches,
    from torch.profiler (CUDA-event windows also hold the host's time per
    call where the host is slower than the device); with `by_kernel`, a
    {kernel name: ms per call} dict."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        times[e.key] = (t if t is not None else e.self_cuda_time_total) \
            / calls * 1e-3
    return times if by_kernel else sum(times.values())


def inputs(B, h, N, M, d, gen):
    x = torch.randn(B, N, h * d, device="cuda", generator=gen).bfloat16()
    kv = torch.randn(B, M, 2, h, d, device="cuda", generator=gen).bfloat16()
    w = torch.randn(B, N, h * d, device="cuda", generator=gen).bfloat16()
    return (x.reshape(B, N, h, d).transpose(1, 2), kv[:, :, 0].transpose(1, 2),
            kv[:, :, 1].transpose(1, 2), w.reshape(B, N, h, d).transpose(1, 2))


def ulps(a, b) -> float:
    """max |a - b| in bf16 ulps of b's largest magnitude."""
    mag = float(b.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7) if mag > 0 else 1.0
    return float((a.float() - b.float()).abs().max()) / ulp


def delta_from_out_backward(q, k, v, lse, g, scale):
    """The plain residual backward with delta = rowsum(g * out): the other
    definition the kernel could have taken."""
    dt = q.dtype
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    out = S.sr_attention_reference(q, k, v, scale).float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    pf = torch.exp2(logits * S.LOG2E - lse.unsqueeze(-1))
    dv = torch.matmul(pf.to(dt).float().transpose(-1, -2), gf).to(dt)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * out).sum(-1, keepdim=True)
    dl = ((dp - delta) * pf * scale).to(dt).float()
    return (torch.matmul(dl, kf).to(dt),
            torch.matmul(dl.transpose(-1, -2), qf).to(dt), dv)


class Parent:
    """K1 and K2 of another checkout's package, built from its sources and
    called through their C entries (the same as this checkout's scalar
    entries: the parent picked its tensor-core kernels inside them)."""

    def __init__(self, pkg_dir: str):
        spec = importlib.util.spec_from_file_location(
            "parent_build", os.path.join(pkg_dir, "native", "build.py"))
        build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(build)
        vp, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        self.fwd = ctypes.CDLL(build.build("sr_attention_fwd"))
        self.fwd.sr_attention_fwd.argtypes = [vp] * 4 + [i] * 5 + [
            strides, ctypes.c_float, i, vp]
        self.bwd = ctypes.CDLL(build.build("sr_attention_bwd"))
        self.bwd.sr_attention_bwd.argtypes = [vp] * 9 + [i] * 5 + [
            strides, ctypes.c_float, i, i, vp]
        self.bwd.sr_attention_bwd_splits.argtypes = [i] * 7

    def forward(self, q, k, v, scale):
        B, h, N, d = q.shape
        M = k.shape[2]
        out = torch.empty(B, N, h, d, dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        rc = self.fwd.sr_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, h, N,
            M, d, S._strides(q, k, v, out), scale, 1,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    def backward(self, q, k, v, g, scale):
        B, h, N, d = q.shape
        M = k.shape[2]
        splits = self.bwd.sr_attention_bwd_splits(B, h, N, M, d, 1, 0)
        dq = torch.empty(B, N, h, d, dtype=q.dtype,
                         device=q.device).transpose(1, 2)
        dkv = torch.empty(B, M, 2, h, d, dtype=q.dtype, device=q.device)
        dk, dv = dkv[:, :, 0].transpose(1, 2), dkv[:, :, 1].transpose(1, 2)
        stats = torch.empty(B * h * N * 4, dtype=torch.float32,
                            device=q.device)
        partials = torch.empty(2 * B * h * splits * M * d,
                               dtype=torch.float32, device=q.device)
        rc = self.bwd.sr_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            partials.data_ptr(), B, h, N, M, d,
            S._strides(q, k, v, g, dq, dk, dv), scale, 1, 0,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return dq, dk, dv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="package directory of another checkout")
    ap.add_argument("--json", help="also write the numbers to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_sr_attention: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    parent = Parent(args.parent) if args.parent else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = S._bwd_kernel()
    rows = []
    for B, h, N, M, d in FLAGSHIP + [LARGE_FRAME]:
        q, k, v, w = inputs(B, h, N, M, d, gen)
        sc = d ** -0.5
        row = {"shape": [B, h, N, M, d]}
        with torch.no_grad():
            lse = S._forward(q, k, v, sc, with_lse=True)[1]
            fwd = {p: (lambda p=p: S._forward(q, k, v, sc, passes=p))
                   for p in (0, 2)}
            if (B, h, N, M, d) == LARGE_FRAME:
                row["fwd_two_pass_ms"] = median_ms(fwd[0])
                print(f"{row['shape']}: forward two-pass "
                      f"{row['fwd_two_pass_ms']:.4f} ms")
                rows.append(row)
                continue
            a, two, b = median_ms(fwd[0]), median_ms(fwd[2]), median_ms(fwd[0])
            row.update(fwd_ms=(a + b) / 2, fwd_two_pass_ms=two,
                       fwd_device_ms=device_ms(fwd[0]),
                       fwd_two_pass_device_ms=device_ms(fwd[2]),
                       sdpa_device_ms=device_ms(
                           lambda: torch.nn.functional.
                           scaled_dot_product_attention(q, k, v, scale=sc)))
            planned = lib.sr_attention_bwd_tc_shares(B, h, N, M, d, 0)
            row["shares_planned"] = planned
            for cap in (1, 2, 4, 8):
                a = median_ms(lambda: S.sr_attention_bwd(q, k, v, w, sc, 0,
                                                         lse=lse))
                c = median_ms(lambda: S.sr_attention_bwd(q, k, v, w, sc, cap,
                                                         lse=lse))
                b = median_ms(lambda: S.sr_attention_bwd(q, k, v, w, sc, 0,
                                                         lse=lse))
                row[f"bwd_shares_{cap}_ms"] = c
                row.setdefault("bwd_ms_windows", []).append((a + b) / 2)
            row["bwd_ms"] = float(np.median(row.pop("bwd_ms_windows")))
            per_kernel = device_ms(
                lambda: S.sr_attention_bwd(q, k, v, w, sc, lse=lse),
                by_kernel=True)
            row["bwd_device_ms"] = sum(per_kernel.values())
            # The library's backward: forward + backward minus the forward.
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]

            def sdpa_fwd_bwd():
                for t in leaves:
                    t.grad = None
                with torch.enable_grad():
                    torch.nn.functional.scaled_dot_product_attention(
                        *leaves, scale=sc).backward(w)

            row["sdpa_bwd_device_ms"] = (device_ms(sdpa_fwd_bwd)
                                         - row["sdpa_device_ms"])
            row["bwd_device_ms_by_kernel"] = {
                name[0]: t for key, t in per_kernel.items()
                if (name := re.findall(r"\bsr_\w+(?:<[^>]*>)?", key))}
            ref = S.sr_attention_bwd_reference(q, k, v, w, sc)
            got = S.sr_attention_bwd(q, k, v, w, sc, lse=lse)
            alt = delta_from_out_backward(q, k, v, lse, w.bfloat16(), sc)
            row["delta_pf_ulps"] = [ulps(x, y) for x, y in zip(got, ref)]
            row["delta_out_ulps"] = [ulps(x, y) for x, y in zip(alt, ref)]
            if parent is not None:
                old = [median_ms(lambda: parent.forward(q, k, v, sc))]
                new = [median_ms(fwd[0]), median_ms(fwd[0])]
                old.append(median_ms(lambda: parent.forward(q, k, v, sc)))
                row.update(fwd_old_ms=old, fwd_new_ms=new)
                kern = (lambda: S.sr_attention_bwd(q, k, v, w, sc, lse=lse))
                oldb = [median_ms(lambda: parent.backward(q, k, v, w, sc))]
                newb = [median_ms(kern), median_ms(kern)]
                oldb.append(median_ms(lambda: parent.backward(q, k, v, w, sc)))
                row.update(bwd_old_ms=oldb, bwd_new_ms=newb)
                row["fwd_old_device_ms"] = device_ms(
                    lambda: parent.forward(q, k, v, sc))
                row["bwd_old_device_ms"] = device_ms(
                    lambda: parent.backward(q, k, v, w, sc))
                pref = parent.backward(q, k, v, w, sc)
                row["bwd_old_ulps"] = [ulps(x, y) for x, y in zip(pref, ref)]
        print(json.dumps(row))
        rows.append(row)

    flag = rows[:len(FLAGSHIP)]
    step = {key: sum(c * r[key] for c, r in zip(CALLS, flag))
            for key in ("fwd_ms", "fwd_two_pass_ms", "bwd_ms", "fwd_device_ms",
                        "fwd_two_pass_device_ms", "sdpa_device_ms",
                        "bwd_device_ms", "sdpa_bwd_device_ms",
                        "bwd_shares_1_ms", "bwd_shares_2_ms",
                        "bwd_shares_4_ms", "bwd_shares_8_ms")}
    if parent is not None:
        for key in ("fwd_old_ms", "fwd_new_ms", "bwd_old_ms", "bwd_new_ms",
                    "fwd_old_device_ms", "bwd_old_device_ms"):
            step[key] = sum(c * float(np.mean(r[key]))
                            for c, r in zip(CALLS, flag))
    print("per step (32 calls): " + json.dumps(step))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows, "step": step}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
