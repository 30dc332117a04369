"""Epoch checkpoints in the original repo's own format (the port's
counterpart of rgbx_semantic_segmentation_tpu/checkpoint.py, which uses
Orbax).

Parity target: reference engine/engine.py:84-150. A checkpoint is
`epoch-N.pth` in the checkpoint directory, a torch.save of

    {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
     "epoch": N, "iteration": the trainer's global step}

with `epoch-last.pth` a symlink to the newest. `iteration` is restored
because the lr schedule and the drop-path / dropout mask stream are keyed by
it (train.py). A file is written under a temporary name and renamed into
place, so a process killed mid-write leaves no torn checkpoint. Being the
reference's format, the same loader (convert.load_torch_checkpoint) reads a
port checkpoint and a reference .pth alike.

On the data x model mesh the file is the one one process writes: the
model ranks' slices are gathered whole before rank 0 writes
(parallel/tensor.py), and a restore on a split model slices the whole
tensors back, so a run resumes on any mesh from a file of any other.
"""
from __future__ import annotations

import functools
import os
import re
from typing import List, Optional

import torch

from rgbx_semantic_segmentation_tpu_torch.parallel import tensor
from rgbx_semantic_segmentation_tpu_torch.utils.fs import link_file

_EPOCH_FILE = re.compile(r"^epoch-(\d+)\.pth$")
LAST = "epoch-last.pth"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


class CheckpointManager:
    """Epoch-keyed checkpoints of a Trainer (save cadence applied by the
    caller, like reference train.py:310-318)."""

    def __init__(self, directory: str):
        self.directory = _abs(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch-{epoch}.pth")

    def save(self, epoch: int, trainer) -> str:
        """Write the trainer's model, optimizer and step at `epoch` and point
        epoch-last.pth at it; returns the file's path. Blocks until the file
        is in place (torch.save copies device tensors to the host). Rank 0
        of the trainer's world writes (the bare model: no DDP prefix; the
        ranks' states are equal; a split model's slices gathered whole, in
        which every rank takes part) and every rank waits for it."""
        path = self.path(epoch)
        model = tensor.full_state_dict(trainer.model)
        optimizer = tensor.full_optimizer_state(trainer.optimizer,
                                                trainer.model)
        if trainer.world.is_main():
            payload = {"model": model, "optimizer": optimizer,
                       "epoch": int(epoch),
                       "iteration": int(trainer.global_step)}
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                torch.save(payload, tmp)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            link_file(os.path.basename(path),
                      os.path.join(self.directory, LAST))
        trainer.world.barrier()
        return path

    def all_epochs(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _EPOCH_FILE.match, os.listdir(self.directory)) if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def load(self, epoch: Optional[int] = None) -> dict:
        """The payload of `epoch` (default: the latest) on the CPU."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(epoch), map_location="cpu",
                          weights_only=True)

    def load_model(self, epoch: int, model) -> None:
        """Load `epoch`'s weights and BN statistics into `model` (strict)."""
        model.load_state_dict(self.load(epoch)["model"], strict=True)

    def restore(self, trainer, epoch: Optional[int] = None) -> int:
        """Load `epoch` (default: the latest) into the trainer: weights, BN
        statistics, optimizer moments and step, global step. Returns the
        epoch to resume at, saved epoch + 1 (reference engine.py:143).

        The payload is read to the CPU; load_state_dict copies the weights
        into the model's tensors on its device and moves the optimizer's
        moments to their parameters' device, while AdamW's step counters
        stay fp32 scalars on the CPU, as AdamW keeps them. Every rank of a
        data-parallel run restores the same file onto its own device; the
        file does not record the world size it was written by. A split
        model (`--mesh tp`) keeps its slices of the whole tensors."""
        payload = self.load(epoch)
        trainer.model.load_state_dict(payload["model"], strict=True)
        trainer.optimizer.load_state_dict(tensor.local_optimizer_state(
            payload["optimizer"], trainer.optimizer, trainer.model))
        trainer.global_step = int(payload["iteration"])
        return int(payload["epoch"]) + 1


def resolve_checkpoint_spec(spec: str, default_dir: str):
    """Map an `-e` checkpoint spec to (manager, epochs) — the reference's
    flexible `-e` forms (evaluator.py:42-81); a direct .pth path is handled
    by resolve_weights first (it needs a config flip for erf GELU parity):

    - an existing checkpoint directory -> its latest epoch
    - otherwise a spec ('last' | '300' | '250-400' | '250-') parsed against
      `default_dir`'s available epochs.

    Raises SystemExit when nothing matches (CLI context)."""
    from rgbx_semantic_segmentation_tpu_torch.evaluator import parse_epoch_spec

    if os.path.isdir(spec):
        mgr = CheckpointManager(spec)
        epoch = mgr.latest_epoch()
        if epoch is None:
            raise SystemExit(f"no checkpoints under {mgr.directory}")
        return mgr, [epoch]
    if not os.path.isdir(default_dir):
        raise SystemExit(f"no checkpoint directory {default_dir}")
    mgr = CheckpointManager(default_dir)
    epochs = parse_epoch_spec(spec, mgr.all_epochs())
    if not epochs:
        raise SystemExit(f"no checkpoints matching {spec!r} in {default_dir}")
    return mgr, epochs


def resolve_weights(cfg, spec: str, checkpoint_dir: Optional[str] = None,
                    logger=None):
    """What eval_cli's and predict_cli's `-e` names, as (cfg, targets) with
    targets a list of (label, load) and load(model) putting the weights into
    a port model:

    - a whole-model .pth/.pt of the original repo (convert.
      load_full_model_checkpoint); erf GELU is then forced in the returned
      cfg, as the original trains with it;
    - otherwise a checkpoint directory or an epoch spec over
      `checkpoint_dir` (default <log_dir>/<tag>/checkpoint), through
      resolve_checkpoint_spec: one target per epoch."""
    if os.path.isfile(spec) and spec.endswith((".pth", ".pt")):
        import dataclasses

        from rgbx_semantic_segmentation_tpu_torch.convert import (
            load_full_model_checkpoint)

        path = _abs(spec)
        if cfg.model.gelu_approximate:
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, gelu_approximate=False))
            if logger is not None:
                logger.info("a torch checkpoint: gelu_approximate disabled "
                            "for erf parity")
        return cfg, [(os.path.basename(path),
                      functools.partial(load_full_model_checkpoint, path))]
    mgr, epochs = resolve_checkpoint_spec(spec, checkpoint_dir or os.path.join(
        cfg.log_dir, cfg.tag(), "checkpoint"))
    return cfg, [(f"epoch {e}", functools.partial(mgr.load_model, e))
                 for e in epochs]
