"""Filesystem / device-spec helpers (the port's own copy of
rgbx_semantic_segmentation_tpu/utils/fs.py).

Parity target: reference `utils/pyt_utils.py:194-245` — `parse_devices`
("0,2-5", "*"), `link_file`, `ensure_dir`. The reference shells out to
`os.system('rm -rf ...; ln -s ...')` and retries mkdir with random sleeps
("conflict !!!"); these versions are atomic and race-free.
"""
from __future__ import annotations

import os
from typing import List, Optional


def ensure_dir(path: str) -> str:
    """mkdir -p without the reference's jittered-retry race hack
    (pyt_utils.py:238-245)."""
    os.makedirs(path, exist_ok=True)
    return path


def link_file(src: str, target: str) -> None:
    """Atomically (re)point `target` at `src` (replaces the reference's
    `os.system('rm -rf target; ln -s src target')`, pyt_utils.py:232-235)."""
    tmp = target + ".tmp_link"
    if os.path.lexists(tmp):
        os.remove(tmp)
    os.symlink(src, tmp)
    os.replace(tmp, target)


def parse_devices(spec: str, available: Optional[int] = None) -> List[int]:
    """'0,2-5' -> [0, 2, 3, 4, 5]; '*' -> all (reference pyt_utils.py:194-218).
    `available` defaults to the number of CUDA devices."""
    if available is None:
        import torch

        available = torch.cuda.device_count()
    if spec.strip() in ("", "*"):
        return list(range(available))
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    for d in out:
        if d >= available:
            raise ValueError(f"device {d} out of range (have {available})")
    return out
