"""Build the port's CUDA kernels and load them with ctypes.

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.native.build

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface, under `_build/` in this package (listed in
.gitignore). The file name carries a hash of the source and the flags, so a
changed source builds anew at its first use and an unchanged one is loaded
as it is. nvcc's report (`-Xptxas=-v`: registers, shared memory, spills)
is kept beside the library as `<library>.log`.

The counterpart of rgbx_semantic_segmentation_tpu/native/build.py, which
builds the host-side C++ image ops.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; return its path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu; one handle per process."""
    return ctypes.CDLL(build(name))


if __name__ == "__main__":
    for src in sorted(os.listdir(CSRC_DIR)):
        if src.endswith(".cu"):
            path = build(src[:-3])
            print(f"built {path}")
    sys.exit(0)
