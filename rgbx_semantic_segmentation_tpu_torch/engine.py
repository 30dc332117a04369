"""Training engine: run lifecycle, device choice, checkpoint cadence,
preemption save, profiling hooks (the port's counterpart of
rgbx_semantic_segmentation_tpu/engine.py).

Parity target: reference `engine/engine.py:29-163` (Engine context manager,
State, checkpoint save/restore). An Engine runs on one device, or as one
rank of a data-parallel world (parallel/dist.py; the CLIs start the ranks
through parallel/launch.py): the logger speaks and the profiler traces on
rank 0, checkpoints are written by rank 0, every rank handles the stop
signals and the ranks agree on a stop. `--mesh` takes 'dp' and 'dp:N'; the
2-D meshes raise (ROADMAP Queue 1 item 5). Profiling uses torch.profiler
where the JAX engine uses jax.profiler.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time
from typing import Iterator, Optional

import torch

from rgbx_semantic_segmentation_tpu_torch.checkpoint import CheckpointManager
from rgbx_semantic_segmentation_tpu_torch.config import Config
from rgbx_semantic_segmentation_tpu_torch.device import resolve_device
from rgbx_semantic_segmentation_tpu_torch.logger import get_logger
from rgbx_semantic_segmentation_tpu_torch.parallel.dist import (
    World, make_world_from_spec)

_STOP_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def should_checkpoint(cfg: Config, epoch: int) -> bool:
    """Checkpoint cadence (reference train.py:310-318): from
    checkpoint_start_epoch every checkpoint_step epochs, plus the final epoch."""
    tc = cfg.train
    if epoch == tc.nepochs:
        return True
    return (epoch >= tc.checkpoint_start_epoch
            and (epoch - tc.checkpoint_start_epoch) % tc.checkpoint_step == 0)


def select_device(device: str = "cuda", devices: str = "") -> torch.device:
    """The device of a one-process run: `device` ("cuda" or "cpu"), and for
    cuda the index `devices` names (default: the current card). Several
    indices are a data-parallel run, which parallel/launch.py starts: here
    they raise ValueError."""
    if device != "cuda" or not devices:
        return resolve_device(None if device == "cuda" else device)
    from rgbx_semantic_segmentation_tpu_torch.utils.fs import parse_devices

    resolve_device(None)   # raises without a CUDA device
    idx = parse_devices(devices)
    if len(idx) != 1:
        raise ValueError(f"devices {idx}: one process runs on one device "
                         "(parallel/launch.py starts one per device)")
    torch.cuda.set_device(idx[0])   # the kernels launch on the current one
    return torch.device("cuda", idx[0])


class Engine:
    """Run lifecycle wrapper. Usage:

        with Engine(cfg, args) as engine:
            trainer = Trainer(cfg, device=engine.device)
            ...

    `args` may carry `device` ("cuda" default, or "cpu"), `devices` (one
    CUDA index), `mesh` ("dp", "dp:N") and `profile_dir`. With a `world`
    (parallel/launch.run gives every CLI one) the engine is that rank's, on
    the world's device: the launcher has applied `devices` and `mesh`.
    Without, it is one process's on the device `args` name."""

    def __init__(self, cfg: Config, args: Optional[argparse.Namespace] = None,
                 world: Optional[World] = None):
        self.cfg = cfg
        self.logger = get_logger()
        if world is None:
            make_world_from_spec(getattr(args, "mesh", "") or "dp",
                                 cfg.train.batch_size, [0])
            world = World.solo(select_device(
                getattr(args, "device", None) or "cuda",
                getattr(args, "devices", "") or ""))
        self.world = world
        self.device = world.device
        ckpt_dir = os.path.join(cfg.log_dir, cfg.tag(), "checkpoint")
        self.checkpoints = CheckpointManager(ckpt_dir)
        self._profile_dir = getattr(args, "profile_dir", None)
        self._preempt_signum = None
        self._saved_handlers = {}
        self.last_profile = None

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self):
        self.logger.info("Engine start: device %s, rank 0 of %d",
                         self.device, self.world.size)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.logger.error("run failed: %s", exc)
        for sig, handler in self._saved_handlers.items():
            signal.signal(sig, handler)
        self._saved_handlers = {}
        return False

    # -- checkpointing -----------------------------------------------------
    def save_checkpoint_if_due(self, epoch: int, trainer) -> bool:
        if not should_checkpoint(self.cfg, epoch):
            return False
        t0 = time.time()
        path = self.checkpoints.save(epoch, trainer)
        self.logger.info("checkpoint epoch %d saved in %.2fs (%.1f MB)", epoch,
                         time.time() - t0, os.path.getsize(path) / 1e6)
        return True

    def restore_checkpoint(self, trainer) -> int:
        """Resume from the latest checkpoint (reference engine.py:129-150);
        returns the epoch to start at."""
        next_epoch = self.checkpoints.restore(trainer)
        self.logger.info("resumed at epoch %d (step %d)", next_epoch,
                         trainer.global_step)
        return next_epoch

    # -- preemption handling (the reference has none: engine.py:157-163 just
    #    logs and exits, losing everything since the last cadence save) -----
    def install_preemption_handler(self):
        """On SIGTERM/SIGINT, request a graceful stop. The handler only
        records the signal (a torch.save inside a signal handler could land
        in the middle of another); the train loop polls `preempted` and
        calls `drain_preemption` to save from normal context. The previous
        handlers come back when the engine exits."""

        def handler(signum, frame):
            self._preempt_signum = signum
            self.logger.warning(
                "signal %d: preemption checkpoint queued (will save from the "
                "train loop)", signum)

        self._preempt_signum = None
        for sig in _STOP_SIGNALS:
            self._saved_handlers.setdefault(sig, signal.getsignal(sig))
            signal.signal(sig, handler)

    @property
    def preempted(self) -> bool:
        return self._preempt_signum is not None

    def drain_preemption(self, epoch: int, trainer,
                         reraise: bool = True) -> bool:
        """If a stop signal arrived, checkpoint the trainer at `epoch` and (by
        default) re-raise the signal with its default disposition so the
        process exits with the conventional status. Returns True when a
        preemption was handled. In a world the ranks agree first: a signal
        to any rank stops every rank (rank 0 writes the one checkpoint and
        each re-raises the signal)."""
        signum = self.world.host_max(self._preempt_signum or 0) or None
        if signum is None:
            return False
        self.logger.warning(
            "signal %d: writing preemption checkpoint (epoch %d)", signum, epoch)
        self.checkpoints.save(max(epoch, 0), trainer)
        self._preempt_signum = None
        if reraise:
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
        return True

    # -- profiling (the reference has none) ---------------------------------
    @contextlib.contextmanager
    def profile(self, name: str = "train") -> Iterator[None]:
        """torch.profiler over the block when the engine has a profile_dir:
        a Chrome trace `<profile_dir>/<name>.json` and, in `last_profile`,
        the device's busy time (the union of its kernels and copies) and
        idle share over the block's wall time. In a world, rank 0's."""
        if not self._profile_dir or not self.world.is_main():
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self._profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(self._profile_dir, f"{name}.json")
        prof.export_chrome_trace(path)
        busy_ms = device_busy_ms(prof)
        self.last_profile = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                             "idle_share": None if busy_ms is None
                             else 1.0 - busy_ms / wall_ms}
        self.logger.info("profiler trace written to %s: %s", path,
                         self.last_profile)

    @contextlib.contextmanager
    def step_trace(self, name: str, step: int) -> Iterator[None]:
        with torch.profiler.record_function(f"{name}#{step}"):
            yield


def device_busy_ms(prof) -> Optional[float]:
    """The union of the device intervals (kernels, copies, sets) in a
    finished torch.profiler run, in ms; None when it holds none. Ranges the
    profiler mirrors onto the device timeline (Optimizer.step, record_function
    annotations) span the gaps between their kernels and are left out."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and not e.name.startswith(("Optimizer.", "ProfilerStep")))
    if not spans:
        return None
    busy, start, end = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            start = s
        end = max(end, e)
    return (busy + end - start) / 1e3
