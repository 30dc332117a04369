"""Times of the SR-attention backward kernel under different cuts of a
slice's q rows, on one NVIDIA GPU.

    python -m rgbx_semantic_segmentation_tpu_torch.tools.bench_sr_attention

dk and dv of a (batch*head) slice are sums over its N q rows. The kernel
cuts the rows into `splits` shares, one block per (share, run of kv rows),
and sums the shares' fp32 partials in a second pass (no atomics). This
script times the choice at the four mit_b2 480x640 batch-8 shapes, bf16, on
the model's layouts: 1 share (a block owns its kv rows over all of N: few
blocks at stage 1, no partials to sum), 2, 4, 8, and the kernel's own plan
(about 4 blocks per SM), each in one window with the planned version before
and after it. It also prints the planned number of shares.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from rgbx_semantic_segmentation_tpu_torch.ops import sr_attention as S

FLAGSHIP = [(8, 1, 19200, 300, 64), (8, 2, 4800, 300, 64),
            (8, 5, 1200, 300, 64), (8, 8, 300, 300, 64)]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_sr_attention: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = S._bwd_kernel()
    for B, h, N, M, d in FLAGSHIP:
        x = torch.randn(B, N, h * d, device="cuda", generator=gen).bfloat16()
        kv = torch.randn(B, M, 2, h, d, device="cuda", generator=gen).bfloat16()
        w = torch.randn(B, N, h * d, device="cuda", generator=gen).bfloat16()
        q = x.reshape(B, N, h, d).transpose(1, 2)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        g = w.reshape(B, N, h, d).transpose(1, 2)
        sc = d ** -0.5
        planned = lib.sr_attention_bwd_splits(B, h, N, M, d, 1, 0)
        line = [f"(B,h,N,M,d)={(B, h, N, M, d)}: planned {planned} shares"]
        for cap in (1, 2, 4, 8):
            a = median_ms(lambda: S.sr_attention_bwd(q, k, v, g, sc))
            c = median_ms(lambda: S.sr_attention_bwd(q, k, v, g, sc, cap))
            b = median_ms(lambda: S.sr_attention_bwd(q, k, v, g, sc))
            line.append(f"<= {cap}: {c:.4f} ms (planned {a:.4f}/{b:.4f})")
        print("; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
