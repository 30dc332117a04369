"""Flax variables -> PyTorch state dict (the inverse of the JAX package's
convert.torch_to_flax_variables).

The port's modules carry the original repo's torch attribute paths and the
JAX modules mirror them with `_` for `.` (`block1.0` <-> `block1_0`,
`mlp.0` <-> `mlp_0`), so one generic key and layout transform covers every
module:

  - Dense kernel (in, out)          -> weight (out, in)
  - Conv kernel HWIO                -> weight OIHW (depthwise (3, 3, 1, C)
                                       -> (C, 1, 3, 3))
  - Swin absolute_pos_embed(_d)     -> the original's (1, C, h, w) from
    (1, h, w, C)                       flax's NHWC grid
  - LayerNorm/BatchNorm scale       -> weight (a `scale` leaf beside a
                                       `bias`; any other `scale`, such
                                       as Mask2Former's temperature, stays
                                       a bare `scale`, as the JAX
                                       convert maps it back)
  - batch_stats mean / var          -> running_mean / running_var, plus a
                                       zero num_batches_tracked
  - a path segment's trailing run of `_<digits>` groups -> `.`-indices
                                       (`block1_0` -> `block1.0`,
                                       `psp_modules_0_1` -> `psp_modules.0.1`:
                                       the inverse of the JAX
                                       convert.torch_key_to_path)
  - any other leaf (biases, the 0-d IFRM lambdas, Mask2Former's
    query_embed) as it is

`flax_params_to_torch` applies the same transform to any tree shaped like
`params` (gradients, updated parameters). BatchNorm running statistics
travel both ways: here as above, and back through the function below.

The other direction needs no port code: rgbx_semantic_segmentation_tpu.
convert.torch_to_flax_variables takes a port state_dict as it is.

The checkpoint loaders below (the JAX convert.py's, in torch key space)
read the original repo's .pth files, and the port's own checkpoints, which
have the same format: single-tower pretrained backbones duplicated into the
dual-tower key space (`load_dualpath_pretrained`) and whole trained models
(`load_full_model_checkpoint`).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

_INDEX = re.compile(r"(?:_\d+)+$")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _segment(name: str) -> str:
    return _INDEX.sub(lambda m: m.group(0).replace("_", "."), name)


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    """(path, value, the leaf's siblings) of every leaf."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v, tree


def _param(name: str, value: np.ndarray,
           siblings: Mapping[str, Any]) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:   # conv HWIO -> OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:   # dense (in, out) -> (out, in)
            return "weight", value.T
        raise ValueError(f"unhandled kernel ndim {value.ndim}")
    if name == "scale" and "bias" in siblings:   # a norm's scale
        return "weight", value
    if name.startswith("absolute_pos_embed") and value.ndim == 4:
        return name, value.transpose(0, 3, 1, 2)   # NHWC grid -> NCHW
    return name, value


def flax_to_torch_state_dict(variables: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX {"params", "batch_stats"} tree (numpy or jax arrays) -> a state
    dict for `load_state_dict(strict=True)` on the matching port module."""
    out: Dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        if coll not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {coll!r}")
        for path, value, siblings in _leaves(tree):
            arr = np.asarray(value)
            if coll == "params":
                name, arr = _param(path[-1], arr, siblings)
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


# ------------------------------------------------- checkpoint loading --


def duplicate_dual_path(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Single-tower SegFormer checkpoint -> dual-tower key space, replicating
    reference `load_dualpath_model` (dual_segformer.py:460-470): every
    patch_embed/block/norm entry is duplicated under the extra_* prefix."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        if "patch_embed" in k:
            out[k] = v
            out[k.replace("patch_embed", "extra_patch_embed")] = v
        elif "block" in k:
            out[k] = v
            out[k.replace("block", "extra_block")] = v
        elif "norm" in k:
            out[k] = v
            out[k.replace("norm", "extra_norm")] = v
        else:
            out[k] = v
    return out


def duplicate_dual_path_swin(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Single-tower Swin checkpoint -> dual-tower key space, replicating
    reference dual_swin.load_dualpath_model (dual_swin.py:699-737): pulls
    layers.i.downsample.* out into downsamples.i.*, then duplicates each entry
    under the _d tower."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        if k.startswith("absolute_pos_embed"):
            # QUIRK FIXED: the reference duplicator has no catch-all branch, so
            # a pretrained APE is silently DROPPED (stays at random init even
            # with ape=True); here it loads into both towers.
            out[k] = v
            out["absolute_pos_embed_d"] = v
        elif "downsample" in k and "layer" in k:
            name = k.replace("downsample.", "").replace("layers", "downsamples")
            out[name] = v
            out[name.replace("downsamples", "downsamples_d")] = v
        elif "patch_embed" in k:
            out[k] = v
            out[k.replace("patch_embed", "patch_embed_d")] = v
        elif "layer" in k:
            out[k] = v
            out[k.replace("layers", "layers_d")] = v
        elif "norm" in k:
            out[k] = v
            out[k.replace("norm", "norm_d")] = v
        else:
            out[k] = v
    return out


def duplicate_dual_path_resnet(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """torchvision ResNet checkpoint -> dual-tower key space (reference
    dual_resnet.load_dualpath_model, dual_resnet.py:102-138). Accepts either
    bare torchvision keys (conv1.weight, ...) or backbone.-prefixed ones; the
    fc head is dropped (reference strips it, dual_resnet.py:39-40)."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        if k.startswith("fc.") or ".fc." in k:
            continue
        key = k if k.startswith("backbone.") else "backbone." + k
        out[key] = v
        out[key.replace("backbone.", "backbone_d.")] = v
    return out


def duplicate_dual_path_segnext(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """SegNeXt single-tower -> dual-tower (reference dual_segnext.py:358-387
    semantics, adapted to the JAX package's stage/downsample naming)."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        for prefix in ("stem", "stages", "downsample", "norm"):
            if k.startswith(prefix):
                out[k] = v
                out["extra_" + k] = v
                break
        else:
            out[k] = v
    return out


_DUPLICATORS = {
    "mit": duplicate_dual_path,
    "swin": duplicate_dual_path_swin,
    "resnet": duplicate_dual_path_resnet,
    "segnext": duplicate_dual_path_segnext,
}


def family_for_backbone(backbone: str) -> str:
    """Map a backbone registry name to its pretrained-checkpoint family
    (which duplicator understands the single-tower key space). Used by
    train_cli's --pretrained dispatch."""
    for family in ("swin", "resnet", "segnext"):
        if backbone.startswith(family):
            return family
    return "mit"


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A .pth checkpoint's state dict on the CPU: unwraps a {"model": ...}
    (the original repo's and the port's checkpoints) or {"state_dict": ...}
    payload and strips a DDP `module.` prefix (the original's own save
    strips it, engine/engine.py:92-96; plain torch.save(model.state_dict())
    under DDP keeps it). Tensors only (weights_only)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in raw.items()}


def load_full_model_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Load a TRAINED whole-model checkpoint (the original repo's
    EncoderDecoder .pth, or a port checkpoint) into `model`. Unlike
    load_dualpath_pretrained, every tensor of the model must be covered: a
    key missing from the file would otherwise be evaluated at its init
    value. Raises KeyError naming the missing keys."""
    sd = load_torch_checkpoint(path)
    missing = [k for k in model.state_dict() if k not in sd]
    if missing:
        preview = ", ".join(missing[:8]) + ("..." if len(missing) > 8 else "")
        raise KeyError(
            f"{len(missing)} model tensors missing from {path}: {preview} — "
            f"check --backbone/--decoder match the checkpoint's config")
    model.load_state_dict(sd, strict=True)


def load_dualpath_pretrained(path: str, model: torch.nn.Module,
                             family: str = "mit", logger=None
                             ) -> Tuple[List[str], List[str]]:
    """Full pretrained-backbone load: .pth -> dual-path duplication -> load
    into `model.backbone` with strict=False (the FRM/FFM and whatever else
    the file lacks stay at init). Returns (missing, unexpected) keys of the
    backbone and logs their counts."""
    sd = _DUPLICATORS[family](load_torch_checkpoint(path))
    result = model.backbone.load_state_dict(sd, strict=False)
    if logger is not None:
        logger.info("pretrained %s: %d backbone tensors loaded, %d left at "
                    "init (%s), %d in the file unused", path,
                    len(sd) - len(result.unexpected_keys),
                    len(result.missing_keys),
                    ", ".join(result.missing_keys[:4]),
                    len(result.unexpected_keys))
    return list(result.missing_keys), list(result.unexpected_keys)
