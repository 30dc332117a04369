"""Data parallelism of the port (counterpart of rgbx_semantic_segmentation_tpu/
parallel/): one process per device under torch.distributed, with the JAX
1-D data mesh's global-batch semantics.

`dist` holds the world (process group, rank, the `--mesh` spec), `launch`
the entry that starts one process per device, `sync_bn` the BatchNorm whose
statistics are global over the batch, and `multihost` each rank's slice of
the global batch.
"""
