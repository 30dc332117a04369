"""Each rank's rows of the global batch (counterpart of
rgbx_semantic_segmentation_tpu/parallel/multihost.py:22-29, where each host
loads its shard of the batch that the mesh then holds as one array).

Rank r of a world of N holds rows [r * B / N, (r + 1) * B / N) of every
global batch of B rows, the split of the reference's
batch_size // world_size (dataloader.py:153-156); the ranks' rows in rank
order are the global batch.
"""
from __future__ import annotations


def process_batch_slice(global_batch: int, rank: int, world: int) -> slice:
    """The half-open range of the global batch that `rank` of `world` holds.
    Raises ValueError unless the batch divides by the world."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    per, rest = divmod(global_batch, world)
    if rest:
        raise ValueError(f"global batch {global_batch} does not divide by "
                         f"{world} ranks")
    return slice(rank * per, (rank + 1) * per)
