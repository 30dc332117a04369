"""Build the port's native code and load it with ctypes: the CUDA kernels
(nvcc) and the host-side C++ image ops of the data pipeline (g++).

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.native.build

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface, under `_build/` in this package (listed in
.gitignore). The file name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so a changed source builds anew at its first
use and an unchanged one is loaded as it is. `build_all` compiles every
source at once, one nvcc process each. nvcc's report (`-Xptxas=-v`: registers, shared memory, spills)
is kept beside the library as `<library>.log`.

`build_host` compiles `native/cv_ops.cpp` with g++ (OpenMP, -march=native,
the flags of rgbx_semantic_segmentation_tpu/native/build.py) by the same
hash-named scheme; a failed compile raises with g++'s message.
"""
from __future__ import annotations

import concurrent.futures
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
HOST_SRC = os.path.join(PKG_DIR, "native", "cv_ops.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17")
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


def kernel_names() -> list:
    return sorted(n[:-3] for n in os.listdir(CSRC_DIR) if n.endswith(".cu"))


def library_path(name: str) -> str:
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _compile(cmd, src: str, out: str) -> str:
    """Run `cmd + [-o tmp, src]` unless `out` exists; keep the compiler's
    report beside the library as `<library>.log`; return `out`."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [*cmd, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; return its path."""
    return _compile([nvcc(), *NVCC_FLAGS], os.path.join(CSRC_DIR, name + ".cu"),
                    library_path(name))


def build_host() -> str:
    """Compile native/cv_ops.cpp with g++ unless its library exists; return
    its path. Raises RuntimeError with g++'s message when it fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the data pipeline's native image "
                           "ops (native/cv_ops.cpp) need it")
    # -march=native: the hash takes in what it means on this host (g++'s
    # resolved target options), so a library built for another CPU is not
    # loaded here.
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    digest = hashlib.sha256((" ".join(GXX_FLAGS) + target).encode())
    with open(HOST_SRC, "rb") as f:
        digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"libcvops-{digest.hexdigest()[:16]}.so")
    return _compile([gxx, *GXX_FLAGS], HOST_SRC, out)


def build_all() -> dict:
    """Compile every csrc/*.cu that is not built yet, all nvcc processes
    started together; returns {name: library path}."""
    names = kernel_names()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu; one handle per process."""
    return ctypes.CDLL(build(name))


if __name__ == "__main__":
    print(f"built {build_host()}")
    for path in build_all().values():
        print(f"built {path}")
    sys.exit(0)
