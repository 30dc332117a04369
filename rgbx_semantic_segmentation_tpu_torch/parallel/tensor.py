"""Tensor parallelism for the data x model mesh (`--mesh tp:D,M`; the
counterpart of rgbx_semantic_segmentation_tpu/parallel/mesh.py:64-117,
142-150, `make_mesh_dp_tp`, `_tp_spec` and `shard_state_tp`, where GSPMD
inserts the collectives by itself).

The split. The M ranks of a data rank hold the same images. Each Mix-FFN
(MiT, `mit_*pp`) and each Swin MLP holds 1/M of its hidden width on each
of them, megatron-style: `fc1` its output rows, the depthwise conv its
channels, `fc2` its input columns. The rules are JAX's `_tp_spec`, on the
same module keys (`split_dim`): exact keys, so SegNeXt's `ffn_fc1` /
`ffn_dwconv` / `ffn_fc2` stay whole, and a layer whose hidden width does
not divide by M stays whole. Every other parameter, the `fc2` bias among
them, is whole on every rank.

The two moves between layouts, each a torch.autograd.Function over the
model group:

- `copy_to_model`, before `fc1`: the identity; its backward sums the
  input's gradient over the model group (each rank's is the part that its
  hidden slice contributes);
- `reduce_from_model`, after `fc2`: sums the ranks' partial products (in
  fp32); its backward is the identity. The whole `fc2` bias is added once,
  after it.

So every tensor outside the split layers, and every gradient of a
parameter that is whole, is the same on the M ranks: the data-parallel sum
over the data group (train.py) is then all they need, and no sum over the
model group follows (it would count each image M times). A rank's slice of
a split parameter gets the gradient of its slice. The same in value, not
always in bits: on the card, atomics in cuDNN's weight gradients, the
bilinear resize's backward and the loss make the M ranks' gradients of a
whole parameter differ in their last bits, and the ranks' weights would
drift apart; `agree` hands model rank 0's (and its BatchNorm running
statistics) to the others (a broadcast over the model group, after the
data-parallel sum), so the M ranks take one step.

Weights and checkpoints are whole. Every rank builds the whole model from
the seed and keeps its slice (`shard_module`); a split module slices, as
it loads, a whole tensor handed to load_state_dict (a checkpoint, a
pretrained file, a one-process state dict). `full_state_dict` and
`full_optimizer_state` gather the slices over the model group into what
one process holds (every rank of the group must call them);
`local_optimizer_state` slices a whole optimizer state back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The M ranks that hold one data rank's images and split the hidden
    widths: their process group, this rank's place among them and their
    count."""

    group: object
    rank: int
    size: int
    root: int = 0   # the global rank of the group's model rank 0


def split_dim(name: str, shape: Sequence[int], size: int) -> Optional[int]:
    """The dim along which a parameter of the (whole) `shape` splits over
    `size` model ranks, None when it stays whole: JAX `_tp_spec` on the
    torch names and layouts. Under a module keyed `fc1` the 2-D weight
    (hidden, C) on dim 0 and the bias; under one keyed `dwconv` the 4-D
    depthwise weight (hidden, 1, 3, 3) on dim 0 and the bias; under one
    keyed `fc2` the 2-D weight (C, hidden) on dim 1. Each only when the
    hidden width divides by `size`."""
    *modules, leaf = name.split(".")
    shape = tuple(shape)

    def ok(dim):
        return shape[dim] % size == 0

    if "fc1" in modules:
        if leaf == "weight" and len(shape) == 2 and ok(0):
            return 0
        if leaf == "bias" and len(shape) == 1 and ok(0):
            return 0
    if "dwconv" in modules:
        if leaf == "weight" and len(shape) == 4 and ok(0):
            return 0
        if leaf == "bias" and len(shape) == 1 and ok(0):
            return 0
    if "fc2" in modules and leaf == "weight" and len(shape) == 2 and ok(1):
        return 1
    return None


class _CopyToModel(torch.autograd.Function):
    """Identity; the gradient is summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The input of a split layer: the same on every model rank; its
    gradient is the sum of the ranks' parts."""
    return _CopyToModel.apply(x, mg.group)


def reduce_from_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """The sum of the model ranks' partial products `x`, summed in fp32
    (float64 kept) and returned in fp32."""
    x = x if x.dtype == torch.float64 else x.float()
    return _ReduceFromModel.apply(x, mg.group)


def split_fc2(fc2: nn.Linear, x: torch.Tensor,
              mg: ModelGroup) -> torch.Tensor:
    """`fc2` of a split layer on the rank's hidden slice `x` (fc2 holding
    its input columns): the partial products without the bias, summed over
    the model group, then the whole bias added once, returned in the
    partial product's dtype (bf16 under autocast)."""
    y = F.linear(x, fc2.weight)
    out = reduce_from_model(y, mg)
    if fc2.bias is not None:
        out = out + fc2.bias
    return out.to(y.dtype)


def local_slice(t: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    """The rank's slice of the whole `t` along `dim`."""
    n = t.shape[dim] // mg.size
    return t.narrow(dim, mg.rank * n, n)


def gather(t: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    """The whole tensor from the model ranks' slices `t` along `dim`."""
    parts = [torch.empty_like(t) for _ in range(mg.size)]
    dist.all_gather(parts, t.contiguous(), group=mg.group)
    return torch.cat(parts, dim)


def shard_module(module: nn.Module, mg: ModelGroup) -> Dict[str, int]:
    """Keep the rank's slice of each of `module`'s parameters that
    split_dim splits (local names: `fc1.weight`, ...), as new Parameters
    (call it before an optimizer takes them), and slice whole tensors of
    those names as the module loads a state dict. Returns {local name:
    dim} of what it split."""
    dims = {}
    for name, p in list(module.named_parameters()):
        dim = split_dim(name, p.shape, mg.size)
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        with torch.no_grad():
            piece = local_slice(p.detach(), dim, mg).clone()
        setattr(sub, leaf, nn.Parameter(piece, requires_grad=p.requires_grad))
        dims[name] = dim

    def slice_whole(mod, state_dict, prefix, *args):
        for name, dim in dims.items():
            t = state_dict.get(prefix + name)
            local = mod.get_parameter(name)
            if (t is not None and t.dim() == local.dim()
                    and t.shape[dim] == local.shape[dim] * mg.size):
                state_dict[prefix + name] = local_slice(t, dim, mg)

    module._register_load_state_dict_pre_hook(slice_whole, with_module=True)
    return dims


def agree(model: nn.Module, mg: ModelGroup,
          extra: Sequence[torch.Tensor] = ()) -> None:
    """Overwrite, on every rank of the model group, the gradients of
    `model`'s whole parameters, its floating-point buffers (the BatchNorm
    running statistics) and the `extra` tensors with model rank 0's (one
    broadcast a dtype): bit-equal inputs to one update on every model rank
    (see the module docstring)."""
    split = split_params(model)
    tensors = ([p.grad for n, p in model.named_parameters()
                if n not in split and p.grad is not None]
               + [b for b in model.buffers() if b.is_floating_point()]
               + list(extra))
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=mg.root, group=mg.group)
        torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(
            torch.split(flat, [t.numel() for t in group]), group)])


def split_params(model: nn.Module) -> Dict[str, int]:
    """{parameter name: dim} of the model's split parameters (empty for a
    model that is not split)."""
    return dict(getattr(model, "tp_dims", None) or {})


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """model.state_dict() with every split parameter gathered whole: the
    state dict of one process. A collective over the model group."""
    dims, mg = split_params(model), getattr(model, "model_group", None)
    sd = model.state_dict()
    for name in sorted(dims):
        sd[name] = gather(sd[name], dims[name], mg)
    return sd


def full_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: gradient} of the model's parameters, those of the split ones
    gathered whole (a collective over the model group)."""
    dims, mg = split_params(model), getattr(model, "model_group", None)
    out = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[name] = gather(g, dims[name], mg) if name in dims else g
    return out


def _param_dims(optimizer, model) -> List[Optional[int]]:
    """For each parameter in the optimizer's order (its state dict's
    indices), its split dim or None."""
    dims = split_params(model)
    by_id = {id(p): dims.get(n) for n, p in model.named_parameters()}
    return [by_id[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _opt_params(optimizer):
    return [p for g in optimizer.param_groups for p in g["params"]]


def _flat_full(t: torch.Tensor, params, dims, mg) -> torch.Tensor:
    """A flat (..., P) vector over `params` (LBFGS's memory) with each
    split parameter's segment gathered whole."""
    parts = [torch.empty_like(t) for _ in range(mg.size)]
    dist.all_gather(parts, t.contiguous(), group=mg.group)
    lead = t.shape[:-1]
    out, at = [], 0
    for p, dim in zip(params, dims):
        n = p.numel()
        if dim is None:
            out.append(t[..., at:at + n])
        else:
            pieces = [q[..., at:at + n].reshape(*lead, *p.shape)
                      for q in parts]
            out.append(torch.cat(pieces, len(lead) + dim).reshape(*lead, -1))
        at += n
    return torch.cat(out, -1)


def _flat_local(t: torch.Tensor, params, dims, mg) -> torch.Tensor:
    """The inverse of _flat_full: a whole flat vector's local segments."""
    lead = t.shape[:-1]
    out, at = [], 0
    for p, dim in zip(params, dims):
        n = p.numel() * (1 if dim is None else mg.size)
        seg = t[..., at:at + n]
        if dim is not None:
            whole = list(p.shape)
            whole[dim] *= mg.size
            seg = local_slice(seg.reshape(*lead, *whole), len(lead) + dim,
                              mg).reshape(*lead, -1)
        out.append(seg)
        at += n
    return torch.cat(out, -1)


_LBFGS_FLAT = ("params", "updates", "diff_params", "diff_updates")


def full_optimizer_state(optimizer, model) -> dict:
    """optimizer.state_dict() as one process holds it: each per-parameter
    tensor of a split parameter's shape (AdamW's and SGD's moments)
    gathered whole, LBFGS's flat memory with the split segments gathered
    whole. A collective over the model group."""
    sd = optimizer.state_dict()
    dims = _param_dims(optimizer, model)
    if not any(d is not None for d in dims):
        return sd
    mg = model.model_group
    params = _opt_params(optimizer)
    state = {}
    for i in sorted(sd["state"]):
        entry = dict(sd["state"][i])
        for key in sorted(entry):
            v = entry[key]
            if not isinstance(v, torch.Tensor):
                continue
            if key in _LBFGS_FLAT and v.dim() >= 1 and v.shape[-1] == sum(
                    p.numel() for p in params):
                entry[key] = _flat_full(v, params, dims, mg)
            elif dims[i] is not None and v.shape == params[i].shape:
                entry[key] = gather(v, dims[i], mg)
        state[i] = entry
    return {**sd, "state": state}


def local_optimizer_state(sd: dict, optimizer, model) -> dict:
    """A whole optimizer state dict (full_optimizer_state's, or one
    process's) cut to this rank's slices, for optimizer.load_state_dict."""
    dims = _param_dims(optimizer, model)
    if not any(d is not None for d in dims):
        return sd
    mg = model.model_group
    params = _opt_params(optimizer)
    whole_p = sum(p.numel() * (1 if d is None else mg.size)
                  for p, d in zip(params, dims))
    state = {}
    for i, entry in sd["state"].items():
        entry = dict(entry)
        for key, v in entry.items():
            if not isinstance(v, torch.Tensor):
                continue
            if key in _LBFGS_FLAT and v.dim() >= 1 and v.shape[-1] == whole_p:
                entry[key] = _flat_local(v, params, dims, mg).clone()
            elif dims[i] is not None and v.dim() == params[i].dim() and (
                    v.shape[dims[i]] == params[i].shape[dims[i]] * mg.size):
                entry[key] = local_slice(v, dims[i], mg).clone()
        state[i] = entry
    return {**sd, "state": state}
