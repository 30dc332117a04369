"""The world of a data-parallel run: one process per device, joined by
torch.distributed (counterpart of rgbx_semantic_segmentation_tpu/parallel/
mesh.py:28-37, 136-188, the 1-D 'data' mesh).

The JAX package runs one jitted step over a mesh whose 'data' axis shards
the batch; here each device has a process of its own (a rank) and the ranks
meet in collectives: NCCL on the card, gloo on the CPU. A rank binds its
card (`torch.cuda.set_device`) before anything touches CUDA, so the
ctypes kernels, which launch on the current device and stream, run on it.

Besides the device group each world has a gloo group for host-side values
(a stop flag, a barrier): agreeing on one of those then costs no wait on
the card's stream.

`--mesh` specs (the JAX make_mesh_from_spec): 'dp' = the largest count of
the named devices that divides the global batch (make_mesh_for_batch),
'dp:N' = exactly N of them. '2d:D,S' and 'tp:D,M' are the 2-D meshes, not
ported (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, List, Sequence

import torch
import torch.distributed as dist

TWO_D_MESH = "the 2-D data x spatial / data x model mesh (ROADMAP Queue 1 item 5)"


def make_world_from_spec(spec: str, batch_size: int,
                         devices: Sequence[int]) -> List[int]:
    """The devices of the ranks that a `--mesh` spec takes from `devices`
    (rank r runs on the r-th): 'dp' the largest count that divides
    `batch_size`, 'dp:N' the first N (ValueError when there are fewer or the
    batch does not divide); the 2-D specs raise NotImplementedError."""
    spec = spec or "dp"
    devices = list(devices)
    if not devices:
        raise ValueError("no devices named")
    if spec == "dp":
        n = len(devices)
        while n > 1 and batch_size % n:
            n -= 1
        return devices[:n]
    kind, _, dims = spec.partition(":")
    if kind in ("2d", "tp"):
        raise NotImplementedError(f"--mesh {spec}: {TWO_D_MESH}")
    if kind != "dp" or not dims.isdigit():
        raise ValueError(f"unknown mesh spec {spec!r} "
                         "(dp | dp:N | 2d:D,S | tp:D,M)")
    n = int(dims)
    if not 1 <= n <= len(devices):
        raise ValueError(f"--mesh {spec}: {len(devices)} device(s) named")
    if batch_size % n:
        raise ValueError(f"--mesh {spec}: global batch {batch_size} does not "
                         f"divide by {n}")
    return devices[:n]


def world_devices(device_type: str, spec: str) -> List[int]:
    """The device indices `-d` names: on 'cuda' CUDA indices (each must
    exist; none named = the current card; ValueError otherwise, never fewer
    than named), on 'cpu' one rank per index ('0,1' = two ranks; none named
    = one)."""
    from rgbx_semantic_segmentation_tpu_torch.device import resolve_device
    from rgbx_semantic_segmentation_tpu_torch.utils.fs import parse_devices

    if device_type == "cuda":
        resolve_device(None)   # raises without a CUDA device
        idx = (parse_devices(spec) if spec.strip()
               else [torch.cuda.current_device()])
    elif device_type == "cpu":
        idx = (parse_devices(spec, available=os.cpu_count() or 1)
               if spec.strip() else [0])
    else:
        raise ValueError(f"device {device_type!r}: cuda or cpu")
    if len(set(idx)) != len(idx):
        raise ValueError(f"devices {idx}: an index named twice")
    return idx


@dataclasses.dataclass
class World:
    """One rank's view of the run: its rank, the world's size, its device,
    and the gloo group for host-side values. Collectives on tensors go over
    the default group (NCCL on the card, gloo on the CPU).

    `World.solo(device)` is one process with no process group: its
    collectives are identities and its barrier a no-op, so code written
    for a rank runs unchanged as one process."""

    rank: int
    size: int
    device: torch.device
    host_group: object = None

    @classmethod
    def solo(cls, device="cpu") -> "World":
        return cls(0, 1, torch.device(device))

    @property
    def distributed(self) -> bool:
        """Whether a process group joins the ranks (a world of one rank
        started by the launcher has one)."""
        return self.host_group is not None

    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank (on the host)."""
        if self.distributed:
            dist.barrier(group=self.host_group)

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` over the ranks in place and return it. On the card
        the host does not wait: the stream does."""
        if self.distributed:
            dist.all_reduce(tensor)
        return tensor

    def host_max(self, value: int) -> int:
        """The largest of the ranks' `value`s (a flag, a signal number)."""
        if not self.distributed:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return int(t.item())


def init_process_group(rank: int, size: int, device: torch.device,
                       init_method: str) -> World:
    """Join the world as `rank` of `size` on `device`: NCCL on 'cuda' (the
    card bound first), gloo on 'cpu'. Raises if the group comes up on
    another backend."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            raise ValueError("a rank's card needs an index: cuda:N")
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device}: cuda or cpu")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size)
    got = dist.get_backend()
    if got != backend:
        raise RuntimeError(f"process group on {got}, {backend} asked for")
    return World(rank, size, device, dist.new_group(backend="gloo"))


@contextlib.contextmanager
def process_group(rank: int, size: int, device: torch.device,
                  init_method: str) -> Iterator[World]:
    """init_process_group for the block; the group is destroyed when it
    ends, however it ends."""
    try:
        yield init_process_group(rank, size, device, init_method)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
