"""Shared layer primitives: initializers, DropPath, Dropout, the
conv + BN + ReLU block of the convolutional heads, token/map reshapes.

Counterpart of rgbx_semantic_segmentation_tpu/ops/layers.py. The layers
themselves are torch's own: nn.Linear, nn.Conv2d with torch's symmetric
padding (k // 2 both sides, the convention the JAX package re-creates with
explicit padding), nn.LayerNorm with its eps passed explicitly, and
nn.BatchNorm2d, whose eval mode normalises with the running statistics
(the JAX TorchBatchNorm exists to re-create exactly torch's semantics).

Initialization follows the JAX package (which follows the original repo's
`_init_weights`): Linear, the Swin relative-position bias tables and
absolute position embeddings = truncated normal (std 0.02), Linear bias
zero; Conv2d = normal(0, sqrt(2 / fan_out)), fan_out = kh * kw * out / groups,
with zero bias; norms = ones / zeros; the IFRM lambdas = 0.5; the
Mask2Former queries = normal(0.02) and its mask temperature = 20; the
SegNeXt LayerScales = their block's `ls_init` (1e-2).
`init_weights` applies it to a whole model from an explicit
torch.Generator.

Randomness in training is explicit too: DropPath and Dropout draw their
masks from the torch.Generator in their `generator` attribute, which
`set_generator` hands to every such module of a model (the trainer reseeds
it from (seed, step, rank) before each step). With no generator set they draw
from torch's global one on their input's device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

# Std of a standard normal truncated to [-2, 2]. jax's truncated_normal
# initializer divides by it so the samples have the requested std, and cuts
# them at +-2 of its own scale.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    s = std / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s,
                                 generator=generator)


@torch.no_grad()
def conv_kaiming_normal_(w: torch.Tensor, groups: int,
                         generator: torch.Generator) -> torch.Tensor:
    """torch-style fan-out kaiming normal for an OIHW conv weight."""
    out_ch, _, kh, kw = w.shape
    std = math.sqrt(2.0 / (kh * kw * out_ch / groups))
    return w.normal_(0.0, std, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every Linear, Conv2d, LayerNorm, BatchNorm2d,
    `relative_position_bias_table`, Swin `absolute_pos_embed`, IFRM
    lambda, Mask2Former `query_embed` / `scale` and SegNeXt LayerScale
    parameter of `model` in
    place (see module docstring); BatchNorm running stats are reset."""
    for name, p in model.named_parameters():
        # Bare nn.Parameters (Swin WindowAttention, IFRM, Mask2Former), not
        # modules.
        if name.endswith(("relative_position_bias_table",
                          "absolute_pos_embed", "absolute_pos_embed_d")):
            trunc_normal_(p, 0.02, generator)
        elif name.endswith(("lambda_channel", "lambda_spatial")):
            p.fill_(0.5)
        elif name.endswith("query_embed"):
            p.normal_(0.0, 0.02, generator=generator)
        elif name == "scale" or name.endswith(".scale"):
            p.fill_(20.0)
        elif name.endswith(("ls1_layer_scale", "ls2_layer_scale")):
            p.fill_(model.get_submodule(name.rpartition(".")[0]).ls_init)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, 0.02, generator)
        elif isinstance(m, nn.Conv2d):
            conv_kaiming_normal_(m.weight, m.groups, generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
    return model


class _Stochastic(nn.Module):
    """A module that draws a keep mask in training."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"drop rate {rate} outside [0, 1)")
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        # The data-parallel rank: a kernel that draws its own mask from a
        # seed (the window attention) offsets the seed by it.
        self.rank = 0

    def _mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        raise NotImplementedError

    def forward(self, x: torch.Tensor,
                split: Optional[Tuple[int, int]] = None,
                dim: int = -1,
                span: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """`split` = (r, n): x is slice r of n equal slices of its dim `dim`
        (the last: a hidden width split over the model ranks, parallel/
        tensor.py; -2: an attention's query rows split over the spatial
        ranks, parallel/spatial.py); `span` = (start, whole): x is the
        slice [start, start + its size) of `whole` along `dim` (a Swin
        block's window slab on a spatial rank). The mask is drawn at the
        whole size and sliced, so each rank keeps its slice of what one
        process draws, and the generator moves as one process's."""
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = self._mask_shape(x)
        if split is not None:
            span = (split[0] * shape[dim], shape[dim] * split[1])
        if span is None:
            u = torch.rand(shape, device=x.device, generator=self.generator)
        else:
            whole = list(shape)
            whole[dim] = span[1]
            u = torch.rand(whole, device=x.device,
                           generator=self.generator).narrow(dim, span[0],
                                                            shape[dim])
        return x * ((u < keep).to(x.dtype) / keep)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class DropPath(_Stochastic):
    """Stochastic depth: drops the whole residual branch per sample in
    training, kept samples scaled by 1 / keep; the identity at eval and at
    rate 0."""

    def _mask_shape(self, x):
        return (x.shape[0],) + (1,) * (x.dim() - 1)


class Dropout(_Stochastic):
    """Elementwise dropout from the explicit generator."""

    def _mask_shape(self, x):
        return tuple(x.shape)


class Dropout2d(_Stochastic):
    """Drops whole channel maps of an NCHW tensor (torch Dropout2d)."""

    def _mask_shape(self, x):
        return tuple(x.shape[:2]) + (1, 1)


def set_generator(model: nn.Module, generator: Optional[torch.Generator],
                  rank: int = 0) -> None:
    """Hand `generator` and the data-parallel `rank` to every DropPath /
    Dropout / Dropout2d of `model`."""
    for m in model.modules():
        if isinstance(m, _Stochastic):
            m.generator = generator
            m.rank = rank


def checkpointed(module: nn.Module, *args):
    """`module(*args)` under activation checkpointing (the JAX package's
    `remat`, nn.remat): in training with autograd on, the forward keeps only
    its inputs and the backward runs it again
    (torch.utils.checkpoint, non-reentrant). The recompute must draw the
    masks of the first run: the module's DropPath / Dropout (and the window
    attention's kernel seed) draw from the explicit generator that
    set_generator handed out, which checkpoint's own preserve_rng_state does
    not cover; so the generator is put back to its state before the first
    run for the recompute, and to its later state after it. Elsewhere a
    plain call.

    On the data x spatial mesh (`--mesh 2d:D,S`) `args` carry the spatial
    group and the recompute replays the block's all-gathers and halo
    exchanges (parallel/spatial.py) inside the backward. Every spatial rank
    of an image runs the same blocks in the same order, each block's input
    requiring grad, so each rank recomputes the same blocks in the same
    order and the collectives pair up. The generator restored is the
    rank's own, which the trainer seeds from the data rank: the masks of
    the recompute are the first run's on every rank, and those of an
    image's spatial ranks stay one process's."""
    from torch.utils.checkpoint import checkpoint

    if not (module.training and torch.is_grad_enabled()):
        return module(*args)
    gen = next((m.generator for m in module.modules()
                if isinstance(m, _Stochastic) and m.generator is not None),
               None)
    before = None if gen is None else gen.get_state()
    runs = [0]

    def run(*a):
        runs[0] += 1
        if runs[0] == 1 or gen is None:
            return module(*a)
        after = gen.get_state()
        gen.set_state(before)
        try:
            return module(*a)
        finally:
            gen.set_state(after)

    return checkpoint(run, *args, use_reentrant=False)


def conv_bn_relu(in_ch: int, out_ch: int, kernel: int, bias: bool = True,
                 dilation: int = 1, bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5) -> nn.Sequential:
    """Conv2d (symmetric padding dilation * (kernel // 2)) + BatchNorm2d +
    ReLU as the original repo's Sequential: keys `0.*` and `1.*`. `bias`
    follows the JAX module (its `L.conv` has one, its `nn.Conv` in the ASPP
    branches none)."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, kernel, padding=dilation * (kernel // 2),
                  dilation=dilation, bias=bias),
        nn.BatchNorm2d(out_ch, eps=bn_eps, momentum=bn_momentum),
        nn.ReLU())


def tokens_to_map(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, N, C) tokens -> (B, C, H, W) map (row-major token order)."""
    B, N, C = x.shape
    return x.transpose(1, 2).reshape(B, C, H, W)


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) map -> (B, H*W, C) tokens."""
    return x.flatten(2).transpose(1, 2)
