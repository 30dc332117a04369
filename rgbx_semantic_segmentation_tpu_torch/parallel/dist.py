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
'dp:N' = exactly N of them, '2d:D,S' = D x S of them, data x spatial (JAX
make_mesh_2d): rank r holds the images of data rank r // S and, of each,
the row block r % S (parallel/spatial.py), 'tp:D,M' = D x M of them, data
x model (JAX make_mesh_dp_tp): rank r holds the images of data rank r // M
and, of each Mix-FFN / Swin MLP, the hidden slice r % M
(parallel/tensor.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from rgbx_semantic_segmentation_tpu_torch.parallel.spatial import (
    SpatialGroup)
from rgbx_semantic_segmentation_tpu_torch.parallel.tensor import ModelGroup


def _two_counts(spec: Optional[str], kind: str
                ) -> Optional[Tuple[int, int]]:
    """(D, X) of a '<kind>:D,X' spec, None for any other spec; ValueError
    for such a spec that is not two positive counts."""
    got, _, dims = (spec or "").partition(":")
    if got != kind:
        return None
    parts = dims.split(",")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"bad mesh spec {spec!r}: {kind}:D,"
                         f"{'S' if kind == '2d' else 'M'} with two positive "
                         "counts")
    return int(parts[0]), int(parts[1])


def mesh_2d(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """(D, S) of a '2d:D,S' spec, None for any other spec; ValueError for
    a '2d' spec that is not two positive counts."""
    return _two_counts(spec, "2d")


def mesh_tp(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """(D, M) of a 'tp:D,M' spec, None for any other spec; ValueError for
    a 'tp' spec that is not two positive counts."""
    return _two_counts(spec, "tp")


def make_world_from_spec(spec: str, batch_size: int,
                         devices: Sequence[int]) -> List[int]:
    """The devices of the ranks that a `--mesh` spec takes from `devices`
    (rank r runs on the r-th): 'dp' the largest count that divides
    `batch_size`, 'dp:N' the first N (ValueError when there are fewer or the
    batch does not divide), '2d:D,S' the first D x S (ValueError when there
    are fewer or the batch does not divide by D), 'tp:D,M' likewise the
    first D x M."""
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
        d, s = _two_counts(spec, kind)
        if d * s > len(devices):
            raise ValueError(f"bad mesh spec {spec!r}: need {d * s} devices, "
                             f"{len(devices)} device(s) named")
        if batch_size % d:
            raise ValueError(f"--mesh {spec}: global batch {batch_size} does "
                             f"not divide by {d}")
        return devices[:d * s]
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
    the default group (NCCL on the card, gloo on the CPU); the training
    step's sums over the batch go over `batch_group` (`batch_sum`).

    On a '2d:D,S' mesh (S > 1) the rank also has its coordinates, data rank
    rank // S of `data_size` D and spatial rank rank % S, with the process
    groups of its data axis (`data_group`) and of its spatial axis
    (`spatial`, parallel/spatial.SpatialGroup: the S ranks that hold one
    image's rows). On a 'tp:D,M' mesh (M > 1) the data rank is rank // M
    and `model` the rank's ModelGroup (parallel/tensor.py: the M ranks that
    hold the same images and split the Mix-FFN / MLP hidden widths, model
    rank rank % M); `data_group` then holds the D ranks of one model rank,
    and every sum of the training step over the batch (`batch_sum`, the
    losses' counts, the synced BatchNorm, DDP's buckets) goes over it: the M ranks of a data
    rank hold the same images, which a sum over all ranks would count M
    times. Elsewhere the data rank is the rank, and `spatial` and `model`
    None.

    `World.solo(device)` is one process with no process group: its
    collectives are identities and its barrier a no-op, so code written
    for a rank runs unchanged as one process."""

    rank: int
    size: int
    device: torch.device
    host_group: object = None
    data_rank: Optional[int] = None
    data_size: Optional[int] = None
    data_group: object = None
    spatial: Optional[SpatialGroup] = None
    model: Optional[ModelGroup] = None

    def __post_init__(self):
        if self.data_rank is None:
            self.data_rank, self.data_size = self.rank, self.size

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

    @property
    def batch_group(self):
        """The process group of sums over the global batch: the data group
        on a 'tp' mesh, else the default group (None)."""
        return self.data_group if self.model is not None else None

    @property
    def batch_ranks(self) -> int:
        """The number of ranks in `batch_group`."""
        return self.data_size if self.model is not None else self.size

    def barrier(self) -> None:
        """Wait for every rank (on the host)."""
        if self.distributed:
            dist.barrier(group=self.host_group)

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` over every rank in place and return it. On the card
        the host does not wait: the stream does."""
        if self.distributed:
            dist.all_reduce(tensor)
        return tensor

    def batch_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` over the ranks of `batch_group` in place and return
        it: all_reduce, but on a 'tp' mesh each image counted once."""
        if self.distributed:
            dist.all_reduce(tensor, group=self.batch_group)
        return tensor

    def host_max(self, value: int) -> int:
        """The largest of the ranks' `value`s (a flag, a signal number)."""
        if not self.distributed:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return int(t.item())


def init_process_group(rank: int, size: int, device: torch.device,
                       init_method: str, mesh: Optional[str] = None,
                       backend: Optional[str] = None) -> World:
    """Join the world as `rank` of `size` on `device`: NCCL on 'cuda' (the
    card bound first), gloo on 'cpu', or the `backend` named (gloo on
    'cuda' for ranks that share a card, which NCCL refuses: launch.spawn
    picks it). Raises if the
    group comes up on another backend. With a '2d:D,S' or 'tp:D,M' `mesh`
    (D x S or D x M = size) every rank makes the groups of both axes, in
    one order."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            raise ValueError("a rank's card needs an index: cuda:N")
        torch.cuda.set_device(device)
        backend = backend or "nccl"
    elif device.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"device {device}: cuda or cpu")
    dims, tp = mesh_2d(mesh), mesh_tp(mesh)
    for axes in (dims, tp):
        if axes is not None and axes[0] * axes[1] != size:
            raise ValueError(f"--mesh {mesh} in a world of {size}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size)
    got = dist.get_backend()
    if got != backend:
        raise RuntimeError(f"process group on {got}, {backend} asked for")
    world = World(rank, size, device, dist.new_group(backend="gloo"))
    if dims is not None and dims[1] > 1:
        D, S = dims
        spatial = [dist.new_group(list(range(d * S, (d + 1) * S)))
                   for d in range(D)]
        data = [dist.new_group(list(range(s, size, S))) for s in range(S)]
        world = dataclasses.replace(
            world, data_rank=rank // S, data_size=D,
            data_group=data[rank % S],
            spatial=SpatialGroup(spatial[rank // S], rank % S, S))
    if tp is not None and tp[1] > 1:
        D, M = tp
        model = [dist.new_group(list(range(d * M, (d + 1) * M)))
                 for d in range(D)]
        data = [dist.new_group(list(range(m, size, M))) for m in range(M)]
        world = dataclasses.replace(
            world, data_rank=rank // M, data_size=D,
            data_group=data[rank % M],
            model=ModelGroup(model[rank // M], rank % M, M, rank // M * M))
    return world


@contextlib.contextmanager
def process_group(rank: int, size: int, device: torch.device,
                  init_method: str, mesh: Optional[str] = None,
                  backend: Optional[str] = None) -> Iterator[World]:
    """init_process_group for the block; the group is destroyed when it
    ends, however it ends."""
    try:
        yield init_process_group(rank, size, device, init_method, mesh,
                                 backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
