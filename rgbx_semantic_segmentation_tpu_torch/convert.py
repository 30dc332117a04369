"""Flax variables -> PyTorch state dict (the inverse of the JAX package's
convert.torch_to_flax_variables).

The port's modules carry the original repo's torch attribute paths and the
JAX modules mirror them with `_` for `.` (`block1.0` <-> `block1_0`,
`mlp.0` <-> `mlp_0`), so one generic key and layout transform covers every
module:

  - Dense kernel (in, out)          -> weight (out, in)
  - Conv kernel HWIO                -> weight OIHW (depthwise (3, 3, 1, C)
                                       -> (C, 1, 3, 3))
  - LayerNorm/BatchNorm scale       -> weight
  - batch_stats mean / var          -> running_mean / running_var, plus a
                                       zero num_batches_tracked
  - a path segment `a_b_<digits>`   -> `a_b.<digits>`
  - any other leaf (biases, the 0-d IFRM lambdas) as it is

`flax_params_to_torch` applies the same transform to any tree shaped like
`params` (gradients, updated parameters). BatchNorm running statistics
travel both ways: here as above, and back through the function below.

The other direction needs no port code: rgbx_semantic_segmentation_tpu.
convert.torch_to_flax_variables takes a port state_dict as it is.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_INDEX = re.compile(r"_(\d+)$")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _segment(name: str) -> str:
    return _INDEX.sub(r".\1", name)


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _param(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:   # conv HWIO -> OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:   # dense (in, out) -> (out, in)
            return "weight", value.T
        raise ValueError(f"unhandled kernel ndim {value.ndim}")
    if name == "scale":
        return "weight", value
    return name, value


def flax_to_torch_state_dict(variables: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX {"params", "batch_stats"} tree (numpy or jax arrays) -> a state
    dict for `load_state_dict(strict=True)` on the matching port module."""
    out: Dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        if coll not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {coll!r}")
        for path, value in _leaves(tree):
            arr = np.asarray(value)
            if coll == "params":
                name, arr = _param(path[-1], arr)
            else:
                name = _STATS[path[-1]]
            prefix = ".".join(_segment(p) for p in path[:-1])
            key = f"{prefix}.{name}" if prefix else name
            out[key] = torch.from_numpy(np.array(arr, copy=True))
            if coll == "batch_stats":
                out[f"{prefix}.num_batches_tracked"] = torch.tensor(
                    0, dtype=torch.long)
    return out


def flax_params_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `params`-shaped tree (parameters, their gradients or an
    optimizer moment) laid out in the port's key space, so that gradients
    and updated parameters of the two packages compare by name."""
    return flax_to_torch_state_dict({"params": params})
