"""Card check of the port (the counterpart of
rgbx_semantic_segmentation_tpu/tools/check_tpu.py).

Parity target: reference `utils/check_gpu.py:5-38` (CUDA availability and a
matmul smoke test). Prints torch's CUDA version, the device count and each
card's name, compute capability and memory; runs a bf16 2048x2048 matmul of
ones on card 0, timed around torch.cuda.synchronize(), whose fp32 sum must
be exactly 2048^3; says whether NCCL is available and which world
parallel/launch.py would start over the cards (`-d` as the CLIs take it;
default: every visible card). Without a CUDA device it prints why and exits
with 1: it has no CPU path.

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.tools.check_gpu [-d 0,1]
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from rgbx_semantic_segmentation_tpu_torch.parallel import dist as dist_lib

N = 2048


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--devices", default="",
                   help="the cards of the world to report, as the CLIs' -d "
                        "(default: all)")
    args = p.parse_args(argv)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("check_gpu: no CUDA device (torch.cuda.is_available() is "
              "False); the port runs on the GPU", file=sys.stderr)
        return 1
    count = torch.cuda.device_count()
    print(f"devices ({count}):")
    for i in range(count):
        prop = torch.cuda.get_device_properties(i)
        print(f"  cuda:{i} {prop.name}, compute capability "
              f"{prop.major}.{prop.minor}, {prop.total_memory / 2**30:.2f} GiB")

    x = torch.ones(N, N, dtype=torch.bfloat16, device="cuda:0")
    (x @ x).float().sum()  # warm-up: cuBLAS handle and kernel selection
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total = float((x @ x).float().sum())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if total != float(N) ** 3:
        print(f"check_gpu: matmul sum {total!r}, want {float(N) ** 3!r}",
              file=sys.stderr)
        return 1
    print(f"matmul OK ({dt * 1000:.3f} ms), sum={total:.0f} == {N}^3")
    nccl = dist.is_available() and dist.is_nccl_available()
    print(f"nccl: {'available' if nccl else 'not available'}")
    spec = args.devices or ",".join(str(i) for i in range(count))
    devices = dist_lib.world_devices("cuda", spec)
    print(f"world: {len(devices)} rank(s), one a card {devices}, backend "
          f"{'nccl' if len(devices) > 1 else 'none (one process)'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
