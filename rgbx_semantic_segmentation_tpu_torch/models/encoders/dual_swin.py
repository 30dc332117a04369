"""Dual-branch Swin Transformer encoder.

Counterpart of rgbx_semantic_segmentation_tpu/models/encoders/dual_swin.py:
two Swin towers (windowed attention with relative position bias and shifted
windows, PatchMerging downsampling) with per-stage FRM rectification of the
pre-downsample features and FFM fusion of the per-stage outputs. Variants
swin_s (96, depths (2, 2, 18, 2), window 7) and swin_b (128, window 12).
Attribute paths are the original torch repo's (`layers.0.blocks.1.attn.qkv`,
`layers_d.0`, `downsamples_d.0`, `norm_d0`, `FRMs.0`), which the JAX names
mirror with `_` for `.`, so state dicts convert with no key tables.

Layouts: the towers' inputs and the fused outputs are NCHW maps; inside,
tokens are (B, L, C) with L = H*W in row-major order and a block's window
attention works on the (B, Hp, Wp, C) padded, rolled image. With
`use_pallas` the attention middle is the hand-written kernel pair of
ops/window_attention.py, which reads the windows out of the whole image
through its strides; without it, the literal composition (window partition,
q * scale, softmax, Dropout, window reverse) that the kernel path is held
against.

Knobs of the JAX module: `ape`, the absolute position embedding of each
tower (stored as the original's (1, C, res, res) grid, res =
pretrain_img_size // patch_size, bicubic-resized to the token grid);
`frozen_stages` (see DualSwinTransformer); `remat`, each block under
activation checkpointing (ops/layers.checkpointed).

On the data x spatial mesh (`--mesh 2d:D,S`, parallel/spatial.py) the
towers run on the rank's row block of every map (`forward(..., sp)`), the
stages that `spatial_layout` shards. There the residual stream, the MLPs,
the patch embed, the downsample and the FRM/FFM act on the rank's own rows
(equal blocks), while a block's attention runs on whole window rows: the
rank's window slab of the padded, rolled image (spatial.window_slab_plan:
window rows [r0, r1), the last rank's slab with the padding), whose rows
it fetches from their owners, wrapping from the last rank to the first
(spatial.ring_rows), and returns to them after the proj
(spatial.ring_rows_back). The kernels then run on the slab with window0 =
the slab's first window (the dropout masks of the whole image's windows),
the shift mask is the slab's windows of the whole image's, and a dropout
mask is drawn at the whole image's size and the slab's (or the own rows')
part kept, so an image's spatial ranks compute one process's step. JAX
runs the XLA composition there (its mesh_plan returns None under
`spatial`); K3/K4 on a rank's window rows is the port's own.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rgbx_semantic_segmentation_tpu_torch.models import fusion
from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as WA
from rgbx_semantic_segmentation_tpu_torch.ops.layers import (
    DropPath, Dropout, checkpointed, map_to_tokens, tokens_to_map)
from rgbx_semantic_segmentation_tpu_torch.ops.resize import (
    resize_bicubic_torch)
from rgbx_semantic_segmentation_tpu_torch.parallel import spatial, tensor
from rgbx_semantic_segmentation_tpu_torch.parallel.sync_bn import (
    set_replicas)

# The JAX Swin's LayerNorms take flax's default eps (the original torch repo
# used nn.LayerNorm's 1e-5); the port holds to the JAX package.
LN_EPS = 1e-6


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int
                   ) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _relative_position_index(ws: int) -> np.ndarray:
    """Static pairwise relative-position lookup, (N, N) into the
    ((2 ws - 1)^2, heads) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))          # 2, ws, ws
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]               # 2, N, N
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)                                      # N, N


def _shift_attn_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """Static SW-MSA mask (nW, N, N) of 0 / -100."""
    img = np.zeros((1, Hp, Wp, 1), np.float32)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img[:, h, w, :] = cnt
            cnt += 1
    win = img.reshape(1, Hp // ws, ws, Wp // ws, ws, 1)
    win = win.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class SwinMlp(nn.Module):
    """fc1 -> GELU (erf) -> fc2. On the data x model mesh the hidden width
    splits over the model ranks (set_tensor_parallel)."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = Dropout(drop)
        self.tp: Optional[tensor.ModelGroup] = None

    def set_tensor_parallel(self, mg: tensor.ModelGroup) -> Dict[str, int]:
        """Keep the rank's slice of the hidden width (parallel/tensor.py;
        the whole layer when the width does not divide); returns {local
        name: dim} of the split parameters."""
        dims = tensor.shard_module(self, mg)
        if dims:
            self.tp = mg
        return dims

    def forward(self, x, split=None):
        """`split` = (s, S): x holds token block s of S (a spatial rank's
        rows): the masks are drawn over the whole map's tokens."""
        tp = self.tp
        if tp is None:
            x = self.drop(F.gelu(self.fc1(x)), split, -2)
            return self.drop(self.fc2(x), split, -2)
        x = F.gelu(self.fc1(tensor.copy_to_model(x, tp)))
        x = self.drop(x, split=(tp.rank, tp.size))
        return self.drop(tensor.split_fc2(self.fc2, x, tp))


class WindowAttention(nn.Module):
    """W-MSA with relative position bias. Two input forms, same parameters
    and math (as the JAX module):

    - (B, Hp, Wp, C), the whole padded, rolled image: the kernel path
      (SwinBlock gates on `use_pallas` alone: on the card a window the
      kernels do not take raises in WA.window_attention). qkv projects on
      the image and WA.window_attention does the rest up to proj.
    - (B_, N, C), partitioned windows: the plain composition.

    `mask` is the (nW, N, N) shift mask of x's windows or None. `span` =
    (window0, nW, whole): x holds windows [window0, window0 + nW) of each
    image's `whole` (a spatial rank's window slab, whole window rows); the
    kernels take window0 and the dropout masks are drawn at the whole
    image's size and the slab's windows kept."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.dtype = dtype
        ws = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) * (2 * ws - 1), num_heads))
        self._index = {}   # device -> flat relative-position index
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        # On the kernel path the dropout happens inside the kernel; this
        # module then only lends its rate and its generator to the seed.
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def _bias(self) -> torch.Tensor:
        """(h, N, N) fp32 and contiguous (the kernels want whole blocks),
        gathered from the table: its gradient reaches the table through
        autograd."""
        N = self.window_size ** 2
        table = self.relative_position_bias_table.float()
        if table.device not in self._index:
            self._index[table.device] = torch.from_numpy(
                _relative_position_index(self.window_size).reshape(-1)
            ).to(table.device)
        bias = table[self._index[table.device]].view(N, N, -1)
        return bias.permute(2, 0, 1).contiguous()

    def _seed(self, device) -> torch.Tensor:
        """The kernels' dropout seed: one int64 on the device, drawn from the
        module's generator; no host sync."""
        return torch.empty(1, dtype=torch.int64, device=device).random_(
            generator=self.attn_drop.generator)

    def forward(self, x, mask: Optional[torch.Tensor] = None, span=None):
        h = self.num_heads
        d = x.shape[-1] // h
        scale = d ** -0.5
        bias = self._bias()
        window0 = 0 if span is None else span[0]
        if x.dim() == 4:
            B, Hp, Wp, C = x.shape
            nW = (Hp // self.window_size) * (Wp // self.window_size)
            qkv = self.qkv(x)
            if (x.is_cuda and self.dtype == torch.bfloat16
                    and qkv.dtype != torch.bfloat16):
                raise TypeError(f"bf16 model sent {qkv.dtype} qkv to the "
                                "kernel (the forward must run under bf16 "
                                "autocast)")
            if mask is not None:
                comb = mask[:, None] + bias[None]
            else:
                comb = bias[None].expand(nW, -1, -1, -1)
            rate = self.attn_drop.rate if self.training else 0.0
            seed = (WA.rank_seed(self._seed(x.device), rate,
                                 self.attn_drop.rank)
                    if rate > 0.0 else None)
            out = WA.window_attention(qkv, comb, seed, scale, rate,
                                      self.window_size, window0)
            rows = None
            if span is not None:
                # the slab's rows of the whole padded image
                cols = Wp // self.window_size
                rows = (window0 // cols * self.window_size,
                        span[2] // cols * self.window_size)
            return self.proj_drop(self.proj(out), None, 1, rows)

        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_, N, 3, h, d)
        q = qkv[:, :, 0].transpose(1, 2) * scale
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        # Autocast off and explicit upcasts (exact for bf16): fp32 logits
        # and softmax, probs in v's dtype, fp32 accumulation, as the JAX
        # einsums with preferred_element_type=float32.
        with torch.autocast(x.device.type, enabled=False):
            attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
            attn = attn + bias[None]
            if mask is not None:
                nW = mask.shape[0]
                attn = attn.view(B_ // nW, nW, h, N, N) + mask[None, :, None]
                attn = attn.view(B_, h, N, N)
            attn = torch.softmax(attn, dim=-1)
            if span is None:
                attn = self.attn_drop(attn)
            else:
                _, nW, whole = span
                attn = self.attn_drop(attn.view(B_ // nW, nW, h, N, N), None,
                                      1, (window0, whole)).view(B_, h, N, N)
            out = torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)
        out = self.proj(out.transpose(1, 2).reshape(B_, N, C))
        if span is None:
            return self.proj_drop(out)
        _, nW, whole = span
        return self.proj_drop(out.view(B_ // nW, nW, N, C), None, 1,
                              (window0, whole)).view(B_, N, C)


class SwinBlock(nn.Module):
    """Swin block with optional cyclic shift: tokens (B, H*W, C) in and out."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        # Name kept from the JAX module (ModelConfig.use_pallas_kernels): it
        # enables the hand-written kernels here.
        self.use_pallas = use_pallas
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias,
                                    attn_drop, drop, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio), drop)
        # (Hp, Wp, device) -> shift mask, built once: making it per forward
        # would put a host-to-device copy into every shifted block.
        self._masks = {}

    def _mask(self, Hp: int, Wp: int, device) -> torch.Tensor:
        key = (Hp, Wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_shift_attn_mask(
                Hp, Wp, self.window_size, self.shift_size)).to(device)
        return self._masks[key]

    def forward(self, x, H: int, W: int, rows=None):
        """`rows`: the spatial group when x holds the rank's H rows of the
        map: the attention runs on the rank's window slab (module
        docstring), the rest on the own rows."""
        if rows is not None:
            return self._forward_rows(x, H, W, rows)
        B, L, C = x.shape
        ws = self.window_size
        shortcut = x
        y = self.norm1(x).view(B, H, W, C)
        pad_b = (ws - H % ws) % ws
        pad_r = (ws - W % ws) % ws
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if self.shift_size > 0:
            y = torch.roll(y, (-self.shift_size, -self.shift_size), (1, 2))
            mask = self._mask(Hp, Wp, x.device)
        if self.use_pallas:
            y = self.attn(y, mask)                 # whole-image kernel path
        else:
            y = window_reverse(self.attn(window_partition(y, ws), mask), ws,
                               Hp, Wp)
        if self.shift_size > 0:
            y = torch.roll(y, (self.shift_size, self.shift_size), (1, 2))
        if pad_b or pad_r:
            y = y[:, :H, :W]
        x = shortcut + self.drop_path(y.reshape(B, H * W, C))
        return x + self.drop_path(self.mlp(self.norm2(x)))

    def _forward_rows(self, x, H: int, W: int, rows: spatial.SpatialGroup):
        """forward on a spatial rank: x the rank's H rows of a map of H * S
        rows. norm1 on the own rows; the rows of the rank's window slab of
        the padded image rolled up by the shift, fetched from their owners
        (the padding: zero rows); the columns padded and rolled here; qkv,
        the attention and proj on the slab, whose rows then go back to
        their owners; the MLP and the masks of the own rows as one
        process's."""
        B, L, C = x.shape
        ws, shift = self.window_size, self.shift_size
        whole = H * rows.size
        shortcut = x
        blocks, plan = spatial.window_slab_plan(whole, ws, shift, rows.size)
        r0, r1 = blocks[rows.rank]
        y = spatial.ring_rows(self.norm1(x).view(B, H, W, C), rows, plan, 1)
        pad_r = (ws - W % ws) % ws
        if pad_r:
            y = F.pad(y, (0, 0, 0, pad_r))
        Hp, Wp = -(-whole // ws) * ws, W + pad_r
        cols = Wp // ws
        span = (r0 * cols, (r1 - r0) * cols, (Hp // ws) * cols)
        mask = None
        if shift > 0:
            y = torch.roll(y, -shift, 2)
            mask = self._mask(Hp, Wp, x.device)[span[0]:span[0] + span[1]]
        if self.use_pallas:
            y = self.attn(y, mask, span)
        else:
            n = (r1 - r0) * ws
            y = window_reverse(self.attn(window_partition(y, ws), mask, span),
                               ws, n, Wp)
        if shift > 0:
            y = torch.roll(y, shift, 2)
        if pad_r:
            y = y[:, :, :W]
        y = spatial.ring_rows_back(y, rows, plan, 1, H)
        x = shortcut + self.drop_path(y.reshape(B, H * W, C))
        split = (rows.rank, rows.size)
        return x + self.drop_path(self.mlp(self.norm2(x), split))


class BasicLayer(nn.Module):
    """One Swin stage; blocks alternate shift 0 / ws // 2. With `remat`
    each block runs under activation checkpointing."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0,
                 drop_path: Sequence[float] = (0.0,),
                 use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      qkv_bias, drop, attn_drop, drop_path[i], use_pallas,
                      dtype)
            for i in range(depth)])

    def forward(self, x, H: int, W: int, rows=None):
        """`rows`: the spatial group when x holds the rank's H rows."""
        for blk in self.blocks:
            x = (checkpointed(blk, x, H, W, rows) if self.remat
                 else blk(x, H, W, rows))
        return x


class PatchMerging(nn.Module):
    """2x2 patch concat + LayerNorm + Linear(4C -> 2C) on (B, H*W, C)
    tokens; odd H or W is zero-padded."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H: int, W: int):
        B, L, C = x.shape
        y = x.view(B, H, W, C)
        if H % 2 or W % 2:
            y = F.pad(y, (0, 0, 0, W % 2, 0, H % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2],
                       y[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(y.view(B, -1, 4 * C)))


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding: NCHW map -> tokens, Wh, Ww. The map
    is zero-padded on the right and bottom to a multiple of the patch."""

    def __init__(self, patch_size: int = 4, in_chans: int = 3,
                 embed_dim: int = 96, patch_norm: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS) if patch_norm else None

    def forward(self, x):
        p = self.patch_size
        H, W = x.shape[2:]
        if H % p or W % p:
            x = F.pad(x, (0, (p - W % p) % p, 0, (p - H % p) % p))
        x = self.proj(x)
        Wh, Ww = x.shape[2:]
        x = map_to_tokens(x)
        if self.norm is not None:
            x = self.norm(x)
        return x, Wh, Ww


class DualSwinTransformer(nn.Module):
    """Two Swin towers with per-stage FRM + FFM. Takes NCHW rgb and modal
    maps; returns the fused NCHW maps of the `out_indices` stages
    [1/4, 1/8, 1/16, 1/32].

    FRM rectifies the pre-downsample features; its outputs feed both the
    next stage's PatchMerging and (normed) the FFM fusion.

    `frozen_stages` fs (the JAX module's, which fixes the original's
    RGB-only freeze: both towers freeze): fs >= 0 detaches both towers'
    tokens after the patch embeds, fs >= 1 the absolute position
    embeddings, fs >= 2 runs `pos_drop` in eval mode, and stage i is frozen
    iff fs >= 2 and i < fs - 1: it runs in eval mode (no DropPath, Dropout
    or attention dropout: the window kernel at rate 0) and without autograd
    (its outputs carry no gradient). The FRMs, FFMs, downsamples and output
    norms stay trainable; optim.frozen_mask names the frozen parameters.
    A downsample whose only reader is a frozen stage (fs >= 3) then gets no
    gradient: `every_param_in_loss` says so (data parallelism must look for
    such parameters)."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.2,
                 ape: bool = False, pretrain_img_size: int = 224,
                 patch_size: int = 4, patch_norm: bool = True,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, remat: bool = False,
                 frm: str = "FRM", ffm: str = "FFM",
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 use_pallas: bool = False, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        num_layers = len(depths)
        self.frozen_stages = frozen_stages
        self.every_param_in_loss = frozen_stages < 3
        self.window_size = window_size
        self.patch_size = patch_size
        dims = [int(embed_dim * 2 ** i) for i in range(num_layers)]
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        frm_cls = fusion.get_frm(frm)
        ffm_cls = fusion.get_ffm(ffm)
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim,
                                      patch_norm)
        self.patch_embed_d = PatchEmbed(patch_size, in_chans, embed_dim,
                                        patch_norm)
        self.ape = ape
        if ape:
            res = pretrain_img_size // patch_size
            self.absolute_pos_embed = nn.Parameter(
                torch.zeros(1, embed_dim, res, res))
            self.absolute_pos_embed_d = nn.Parameter(
                torch.zeros(1, embed_dim, res, res))
        self.pos_drop = Dropout(drop_rate)

        def tower():
            return nn.ModuleList([
                BasicLayer(dims[i], depths[i], num_heads[i], window_size,
                           mlp_ratio, qkv_bias, drop_rate, attn_drop_rate,
                           dpr[sum(depths[:i]):sum(depths[:i + 1])],
                           use_pallas, dtype, remat)
                for i in range(num_layers)])

        self.layers = tower()
        self.layers_d = tower()
        self.downsamples = nn.ModuleList(
            [PatchMerging(d) for d in dims[:-1]])
        self.downsamples_d = nn.ModuleList(
            [PatchMerging(d) for d in dims[:-1]])
        self.FRMs = nn.ModuleList([frm_cls(dim=d, reduction=1) for d in dims])
        self.FFMs = nn.ModuleList([
            ffm_cls(dim=d, reduction=1, num_heads=h, bn_momentum=bn_momentum,
                    bn_eps=bn_eps) for d, h in zip(dims, num_heads)])
        for i in self.out_indices:
            setattr(self, f"norm{i}", nn.LayerNorm(dims[i], eps=LN_EPS))
            setattr(self, f"norm_d{i}", nn.LayerNorm(dims[i], eps=LN_EPS))

    def _frozen(self, i: int) -> bool:
        return self.frozen_stages >= 2 and i < self.frozen_stages - 1

    def train(self, mode: bool = True):
        """As nn.Module.train, but the frozen stages (and `pos_drop`, from
        fs >= 2) stay in eval mode."""
        super().train(mode)
        if mode and self.frozen_stages >= 2:
            self.pos_drop.eval()
            for i, (layer, layer_d) in enumerate(zip(self.layers,
                                                     self.layers_d)):
                if self._frozen(i):
                    layer.eval()
                    layer_d.eval()
        return self

    def spatial_layout(self, h: int, w: int,
                       sp: spatial.SpatialGroup) -> List[bool]:
        """Which stages shard their rows over `sp` for images of h x w. The
        port's rule (JAX has none for Swin): stage i shards iff every
        earlier stage does, its H_i rows divide over the S ranks, it has
        at least S window rows (R_i = ceil(H_i / ws)) and the slabs of
        both shifts reach no rank past a ring neighbour
        (spatial.window_slab_plan); stage 0 also needs whole patches on a
        rank (h divides by patch_size * S), and a later stage the rank's
        rows of the one before even (the 2x2 downsample then runs on
        them). From the first stage that does not shard, all runs whole
        on every rank (the rows gathered before the downsample, or before
        the patch embed)."""
        S, ws, p = sp.size, self.window_size, self.patch_size
        sharded, H = h % (p * S) == 0, -(-h // p)
        layout = []
        for i in range(len(self.layers)):
            if i:
                sharded = sharded and (H // S) % 2 == 0
                H = (H + 1) // 2
            sharded = sharded and H % S == 0 and -(-H // ws) >= S
            if sharded:
                try:
                    for shift in (0, ws // 2):
                        spatial.window_slab_plan(H, ws, shift, S)
                except ValueError:
                    sharded = False
            layout.append(sharded)
        return layout

    def forward(self, x_rgb, x_e,
                sp: Optional[spatial.SpatialGroup] = None
                ) -> List[torch.Tensor]:
        """The fused maps of the `out_indices` stages. With `sp`, the
        spatial group of `--mesh 2d:D,S` (models/builder.spatial_support),
        x_rgb and x_e are the rank's row block of the images, and each map
        is the rank's row block where `spatial_layout` shards its stage,
        else the whole map."""
        n_stages = len(self.layers)
        sharded = [False] * n_stages
        if sp is not None:
            sharded = self.spatial_layout(x_rgb.shape[2] * sp.size,
                                          x_rgb.shape[3], sp)
            if not sharded[0]:
                x_rgb = spatial.gather_rows(x_rgb, sp, 2)
                x_e = spatial.gather_rows(x_e, sp, 2)
        x, H, W = self.patch_embed(x_rgb)
        x_d, _, _ = self.patch_embed_d(x_e)
        fs = self.frozen_stages
        if fs >= 0:
            x, x_d = x.detach(), x_d.detach()
        # with the rows sharded, a mask over the whole map's tokens of which
        # the rank keeps its rows'
        split = (sp.rank, sp.size) if sharded[0] else None
        if self.ape:
            ape, ape_d = self.absolute_pos_embed, self.absolute_pos_embed_d
            if fs >= 1:
                ape, ape_d = ape.detach(), ape_d.detach()
            # The sum is fp32, as in the JAX module, where the bf16 tokens
            # plus the fp32 embedding promote to fp32 before pos_drop and
            # the first LayerNorm. The port's tokens leave the patch embed's
            # LayerNorm in fp32 already (autocast runs layer_norm in fp32),
            # so they are not rounded to bf16 before the add, as JAX's are.
            # A spatial rank adds its rows of the whole map's embedding (its
            # gradient: the rank's partial sum).
            whole = H * sp.size if split else H
            ape = resize_bicubic_torch(ape, (whole, W))
            ape_d = resize_bicubic_torch(ape_d, (whole, W))
            if split:
                ape = spatial.own_rows(ape, sp, 2)
                ape_d = spatial.own_rows(ape_d, sp, 2)
            x = x + map_to_tokens(ape)
            x_d = x_d + map_to_tokens(ape_d)
        x = self.pos_drop(x, split, -2)
        x_d = self.pos_drop(x_d, split, -2)
        outs = []
        for i, (layer, layer_d) in enumerate(zip(self.layers, self.layers_d)):
            rows = sp if sharded[i] else None
            grad = torch.is_grad_enabled() and not self._frozen(i)
            with torch.set_grad_enabled(grad):
                x = layer(x, H, W, rows)
                x_d = layer_d(x_d, H, W, rows)
            # a stage run whole on every spatial rank counts its
            # BatchNorms' copies once
            replicas = 1 if sp is None or sharded[i] else sp.size
            set_replicas(self.FRMs[i], replicas)
            set_replicas(self.FFMs[i], replicas)
            m, m_d = self.FRMs[i](tokens_to_map(x, H, W),
                                  tokens_to_map(x_d, H, W), rows)
            x, x_d = map_to_tokens(m), map_to_tokens(m_d)
            if i in self.out_indices:
                n = getattr(self, f"norm{i}")(x)
                n_d = getattr(self, f"norm_d{i}")(x_d)
                outs.append(self.FFMs[i](tokens_to_map(n, H, W),
                                         tokens_to_map(n_d, H, W), rows))
            if i < n_stages - 1:
                if sharded[i] and not sharded[i + 1]:
                    x = spatial.gather_rows(x, sp, 1)
                    x_d = spatial.gather_rows(x_d, sp, 1)
                    H *= sp.size
                x = self.downsamples[i](x, H, W)
                x_d = self.downsamples_d[i](x_d, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
        return outs


@contextlib.contextmanager
def plain_attention(model: nn.Module) -> Iterator[nn.Module]:
    """Run `model`'s Swin blocks on the plain window-attention composition
    inside the block (for holding the kernel path against it); restores on
    exit."""
    mods = [m for m in model.modules() if isinstance(m, SwinBlock)]
    saved = [m.use_pallas for m in mods]
    try:
        for m in mods:
            m.use_pallas = False
        yield model
    finally:
        for m, s in zip(mods, saved):
            m.use_pallas = s


def swin_s(**kw):
    return DualSwinTransformer(**{**dict(
        embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
        window_size=7, attn_drop_rate=0.3, drop_path_rate=0.1), **kw})


def swin_b(**kw):
    return DualSwinTransformer(**{**dict(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
        window_size=12, attn_drop_rate=0.3, drop_path_rate=0.1,
        pretrain_img_size=384), **kw})


# Output channel lists per variant (what decoders consume).
CHANNELS = {
    "swin_s": (96, 192, 384, 768),
    "swin_b": (128, 256, 512, 1024),
}
