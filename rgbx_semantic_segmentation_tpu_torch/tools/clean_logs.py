"""Delete near-empty log/event directories (the port's counterpart of
rgbx_semantic_segmentation_tpu/tools/clean_logs.py).

Parity target: reference `remove_empty_logs.ipynb` (delete TB event dirs
< 3 KiB).

Usage:
    python -m rgbx_semantic_segmentation_tpu_torch.tools.clean_logs \
        --log_dir logs [--min_bytes 3072] [--dry_run]
"""
from __future__ import annotations

import argparse
import os
import shutil


def dir_size(path: str) -> int:
    """Bytes of the files under `path`."""
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log_dir", required=True)
    p.add_argument("--min_bytes", type=int, default=3072)
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)

    removed = 0
    for entry in sorted(os.listdir(args.log_dir)):
        path = os.path.join(args.log_dir, entry)
        if not os.path.isdir(path):
            continue
        size = dir_size(path)
        if size < args.min_bytes:
            print(f"{'would remove' if args.dry_run else 'removing'} "
                  f"{path} ({size} bytes)")
            if not args.dry_run:
                shutil.rmtree(path)
            removed += 1
    print(f"{removed} director{'ies' if removed != 1 else 'y'} "
          f"{'flagged' if args.dry_run else 'removed'}")


if __name__ == "__main__":
    main()
