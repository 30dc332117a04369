"""Start a data-parallel run: one process per device.

The JAX CLIs are one process that drives the whole mesh (root
train_cli.py:5-6), so the port's CLIs keep one command: `-d 0,1,2,3` starts
one rank per index here (`spawn`, torch.multiprocessing's spawn context; on
the CPU, `--device cpu -d 0,1` starts two gloo ranks). Under torchrun
(RANK and WORLD_SIZE in the environment) the command runs as the rank it
was given instead (`run`), on card LOCAL_RANK.

The CUDA kernels are built here once, before the ranks start (the build is
atomic, so ranks building at once would be safe, but would each compile).
A rank that raises or dies fails the run: the other ranks are stopped and
the failed rank's traceback is raised in the launching process.
"""
from __future__ import annotations

import glob
import logging
import os
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from rgbx_semantic_segmentation_tpu_torch.logger import get_logger
from rgbx_semantic_segmentation_tpu_torch.parallel import dist as dist_lib

# Seconds the other ranks get to end by themselves when one fails, then
# again after SIGTERM before SIGKILL (a rank waiting in a collective ends
# only so).
GRACE_S = 5.0
# Seconds the ranks get to write their preemption checkpoint when the
# launching process is interrupted (the ranks see the SIGINT too).
PREEMPT_GRACE_S = 120.0


def _rank_main(rank: int, fn: Callable, devices: List[int], device_type: str,
               init_method: str, workdir: str, args: tuple,
               mesh: Optional[str] = None) -> None:
    backend = None
    if device_type == "cuda":
        device = torch.device("cuda", devices[rank])
        if len(set(devices)) < len(devices):
            backend = "gloo"   # ranks that share a card: NCCL refuses them
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    with dist_lib.process_group(rank, len(devices), device, init_method,
                                mesh, backend) as world:
        try:
            result = fn(_as_rank(world), *args)
        except BaseException:
            # Written before the group closes: a rank that then fails in a
            # collective ("connection closed by peer") fails later.
            with open(os.path.join(workdir, f"rank{rank}.error"), "w") as f:
                f.write(f"{time.time()!r}\n{traceback.format_exc()}")
            raise
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))


def _first_failure(workdir: str, error: mp.ProcessRaisedException,
                   processes) -> mp.ProcessRaisedException:
    """The error of the rank that failed first. torch reports the lowest
    rank among those that had ended when it looked, which may be a rank
    that failed only because another one did."""
    failed = []
    for path in glob.glob(os.path.join(workdir, "rank*.error")):
        with open(path) as f:
            when, trace = f.read().split("\n", 1)
        rank = int(os.path.basename(path)[len("rank"):-len(".error")])
        failed.append((float(when), rank, trace))
    if not failed:
        return error
    _, rank, trace = min(failed)
    if rank == error.error_index:
        return error
    return mp.ProcessRaisedException(
        f"\n\n-- Process {rank} terminated with the following error:\n"
        f"{trace}", rank, processes[rank].pid)


def _join(ctx, timeout: Optional[float], workdir: str) -> None:
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(f"a world of {len(ctx.processes)} ranks "
                                   f"did not end within {timeout} s")
            try:
                if ctx.join(timeout=left, grace_period=GRACE_S):
                    return
            except mp.ProcessRaisedException as e:
                first = _first_failure(workdir, e, ctx.processes)
                if first is e:
                    raise
                raise first from e
    except KeyboardInterrupt:
        for p in ctx.processes:
            p.join(PREEMPT_GRACE_S)
        raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def spawn(fn: Callable, devices: Sequence[int], device_type: str,
          args: tuple = (), timeout: Optional[float] = None,
          workdir: Optional[str] = None, mesh: Optional[str] = None) -> list:
    """Run `fn(world, *args)` in one new process per entry of `devices`
    (rank r on card devices[r], or on the CPU for device_type 'cpu') and
    return the ranks' return values in rank order. `fn` must be importable
    by name (the processes start from a fresh interpreter) and return what
    torch.save can write. The ranks meet at a file in `workdir` (default: a
    temporary directory). With `timeout` (s) a world not ended by then is
    killed and TimeoutError raised. A '2d:D,S' or 'tp:D,M' `mesh` gives
    the world its data and spatial (model) groups (dist.init_process_group).
    A card named twice in `devices` holds several ranks, whose world runs on
    gloo (`tp:1,2` on one card, as `2d:1,2`)."""
    devices = list(devices)
    if device_type == "cuda":
        from rgbx_semantic_segmentation_tpu_torch.native import build

        have = torch.cuda.device_count()
        missing = [d for d in devices if not 0 <= d < have]
        if missing:
            raise ValueError(f"devices {missing} named, {have} present")
        build.build_all()
    elif device_type != "cpu":
        raise ValueError(f"device {device_type!r}: cuda or cpu")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, devices, device_type, init, tmp,
                              tuple(args), mesh),
            nprocs=len(devices), join=False, start_method="spawn")
        _join(ctx, timeout, tmp)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(devices))]


def under_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def cli_devices(device_type: str, spec: str, mesh: Optional[str] = None,
                batch_size: int = 1) -> List[int]:
    """The devices of a CLI's ranks: those `-d` names (dist.world_devices),
    of which a `--mesh` spec (when the CLI takes one) keeps
    make_world_from_spec's. Under torchrun none: a rank's card is
    cuda:LOCAL_RANK (choose the cards with CUDA_VISIBLE_DEVICES), `-d` is
    refused, and the spec must take the whole WORLD_SIZE."""
    if not under_torchrun():
        devices = dist_lib.world_devices(device_type, spec)
        if mesh is None:
            return devices
        return dist_lib.make_world_from_spec(mesh, batch_size, devices)
    if spec.strip():
        raise ValueError("under torchrun a rank's card is cuda:LOCAL_RANK "
                         "(choose cards with CUDA_VISIBLE_DEVICES): -d is for "
                         "the built-in launcher")
    if mesh is not None:
        size = int(os.environ["WORLD_SIZE"])
        took = len(dist_lib.make_world_from_spec(mesh, batch_size,
                                                 range(size)))
        if took != size:
            raise ValueError(f"--mesh {mesh} takes {took} of the {size} "
                             f"ranks torchrun started (global batch "
                             f"{batch_size})")
    return []


def _as_rank(world: dist_lib.World) -> dist_lib.World:
    """A rank other than 0 logs only warnings."""
    if not world.is_main():
        get_logger().setLevel(logging.WARNING)
    return world


def run(fn: Callable, device_type: str, devices: Sequence[int],
        args: tuple = (), mesh: Optional[str] = None):
    """A CLI's entry over `devices` (from cli_devices): `fn(world, *args)`.
    Under torchrun as the rank the environment names, on card LOCAL_RANK;
    otherwise one device runs it in this process as World.solo (the card
    made current) and several run `spawn`; a '2d' or 'tp' `mesh` gives the
    world its axes. The return value is rank 0's."""
    devices = list(devices)
    if under_torchrun():
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = (torch.device("cuda", local) if device_type == "cuda"
                  else torch.device("cpu"))
        with dist_lib.process_group(rank, size, device, "env://",
                                    mesh) as world:
            return fn(_as_rank(world), *args)
    if len(devices) > 1:
        return spawn(fn, devices, device_type, args, mesh=mesh)[0]
    if device_type == "cuda":
        torch.cuda.set_device(devices[0])   # the kernels launch on it
    device = (torch.device("cuda", devices[0]) if device_type == "cuda"
              else torch.device(device_type))
    return fn(dist_lib.World.solo(device), *args)
