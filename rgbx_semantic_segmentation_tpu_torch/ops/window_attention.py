"""Window attention (Swin W-MSA / SW-MSA), forward and backward: the
hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of rgbx_semantic_segmentation_tpu/ops/window_attention.py. The
Swin towers run tens of thousands of tiny self-attentions (N = ws^2 = 49
tokens, d = 32) with a trainable relative-position bias, an additive shift
mask and attention dropout. The TPU kernel packs several windows into one
block-diagonal unit for its 128-wide matrix unit and needs a pack transpose
around it; the CUDA kernels (csrc/window_attention_fwd.cu, the port of
`_fwd_kernel`, and csrc/window_attention_bwd.cu, the port of `_bwd_kernel`)
take the WHOLE padded, rolled image instead and address a window's tokens
through the image's strides:

    qkv  (B, Hp, Wp, 3C)  from the qkv Linear, channels in (3, h, d) order
    bias (nW, h, N, N)    fp32: rel-pos table gather (+ shift mask), built by
                          the caller in PyTorch so d(table) falls out of
                          autograd; an expanded (stride-0) window dim is
                          taken as it is
    out  (B, Hp, Wp, C)   channels in (h, d) order, the proj Linear's input

so no partition, pack or reverse copy exists. Numerics (both versions, as
the TPU kernel): fp32 logits (q k^T) * scale + bias with the scale applied
to the fp32 logits; fp32 softmax pf; p = pf rounded to the input type; with
dropout pd = keep ? p / (1 - rate) : 0, rounded again; out = pd v with fp32
accumulation. (The TPU kernel multiplies by a bf16-rounded 1 / (1 - rate);
here the factor is fp32 in both passes.) The backward recomputes pf and
regenerates the keep mask, so the residual is (qkv, bias, seed) only;
dl = (dp - rowsum(dp * pf)) * pf uses the unrounded pf, db is its unscaled
fp32 sum over the batch, dlf = dl * scale is rounded before dq = dlf k and
dk = dlf^T q; dq, dk, dv land in one tensor in the qkv layout.

Dropout: the keep mask is a pure function of (seed, image, window, head,
row, column) through Philox4x32-10, written out twice: inside the kernels
(csrc/attention_common.cuh) and here in PyTorch integer ops (`keep_mask`),
so the plain versions draw the identical mask, bit for bit. The seed is an
int64 device tensor that the kernels read from device memory. The mask
folds in only the image's index within the call, so a data-parallel rank
offsets the seed (`rank_seed`), as the JAX window_attention_sharded does
per shard (JAX :389-393): the ranks' images draw different masks. The bias
gradient db is summed over the rank's images; the JAX psum over the data
axis (:416) is DDP's sum over the ranks (train.py).

On the spatial axis (`--mesh 2d:D,S`, models/encoders/dual_swin.py) a rank
runs the windows [window0, window0 + nW) of the whole padded, rolled image
(a slab of whole window rows: qkv (B, rows, Wp, 3C), bias (nW, h, N, N)).
The mask's window counter is then window0 + the window's index in the
call, so the slab draws the whole call's masks of its windows, and the
rank keeps the data rank's seed: an image's spatial ranks draw one
process's masks. window0 = 0 is the whole image. JAX runs no kernel there
(its mesh_plan, ops/window_attention.py:119-125, takes the XLA
composition); each window is computed alone, so a slab's out and dqkv are
the whole call's bits, and its db the whole call's sum over its windows.

Device rule: a CPU tensor takes the plain versions
(`window_attention_reference`, `window_attention_bwd_reference`); a CUDA
tensor launches the kernels or raises. There is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rgbx_semantic_segmentation_tpu_torch.ops.sr_attention import _on_device

MAX_N = 256   # tokens per window the kernels take (the TPU kernel's budget)
MAX_D = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def usable(n: int, d: int) -> bool:
    """Shapes the kernels take: n = ws^2 tokens per window, head dim d."""
    return n <= MAX_N and d <= MAX_D


def dropout_threshold(rate: float) -> int:
    """An element is kept iff its 32 random bits are >= this."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


# ------------------------------------------------------------- Philox ----


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of a * b for a 32-bit constant a and an int64
    tensor b of 32-bit values, without leaving int64: b is split in 16-bit
    halves so that every product stays below 2^48."""
    lo_part = a * (b & 0xFFFF)
    t = a * (b >> 16) + (lo_part >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (lo_part & 0xFFFF)


def philox4x32(counter, key, rounds: int = 10):
    """Philox4x32 (Salmon et al., SC 2011) on int64 tensors holding 32-bit
    words: counter = (c0, c1, c2, c3), key = (k0, k1), broadcast against
    each other; returns the four output words. The kernels' generator
    (csrc/attention_common.cuh `philox4x32_10`) in PyTorch integer ops."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


RANK_SEED_STRIDE = 1000003


def rank_seed(seed: torch.Tensor, rate: float, rank: int) -> torch.Tensor:
    """The kernels' dropout seed on data-parallel rank `rank`: seed + rank x
    1000003 when rate > 0 (JAX `_local_seed`), the seed itself at rate 0."""
    if rate > 0.0 and rank:
        return seed + rank * RANK_SEED_STRIDE
    return seed


def keep_mask(seed: torch.Tensor, B: int, nW: int, h: int, N: int,
              rate: float, window0: int = 0) -> torch.Tensor:
    """The kernels' dropout keep mask, bool (B, nW, h, N, N), on seed's
    device, of windows window0 .. window0 + nW - 1. One Philox call serves
    rows r, r + 8 of a 16-row tile and columns c, c + 1 (c even) — the four
    values one thread holds of an mma accumulator tile: counter (c // 2,
    8 * (r // 16) + r % 8, (window0 + window) * h + head, image), key = the
    seed's low and high word; element (r, c) reads word
    2 * ((r % 16) // 8) + c % 2 and is kept iff it is >= dropout_threshold(
    rate)."""
    dev = seed.device
    s = seed.reshape(-1)[0].to(torch.int64)
    key = (s & _MASK32, (s >> 32) & _MASK32)
    rows = torch.arange(N, device=dev)
    row_group = 8 * (rows // 16) + rows % 8
    word = (2 * ((rows % 16) // 8))[:, None] + (rows % 2)[None, :]
    n_groups = int(row_group.max()) + 1
    ar = functools.partial(torch.arange, device=dev, dtype=torch.int64)
    counter = (ar((N + 1) // 2).view(1, 1, 1, -1),
               ar(n_groups).view(1, 1, -1, 1),
               ar(window0 * h, (window0 + nW) * h).view(1, -1, 1, 1),
               ar(B).view(-1, 1, 1, 1))
    out = torch.stack(torch.broadcast_tensors(*philox4x32(counter, key)), -1)
    bits = out[:, :, row_group[:, None], (rows // 2)[None, :], word]
    return (bits >= dropout_threshold(rate)).view(B, nW, h, N, N)


# ------------------------------------------------------ plain versions ----


def _split_windows(x: torch.Tensor, ws: int, k: int, h: int) -> torch.Tensor:
    """(B, Hp, Wp, k*h*d) image -> (B, nW, k, h, N, d) window tokens."""
    B, Hp, Wp, ch = x.shape
    d = ch // (k * h)
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, k, h, d)
    return x.permute(0, 1, 3, 5, 6, 2, 4, 7).reshape(B, -1, k, h, ws * ws, d)


def _merge_windows(x: torch.Tensor, ws: int, Hp: int, Wp: int) -> torch.Tensor:
    """The inverse: (B, nW, k, h, N, d) -> (B, Hp, Wp, k*h*d)."""
    B, _, k, h, _, d = x.shape
    x = x.reshape(B, Hp // ws, Wp // ws, k, h, ws, ws, d)
    return x.permute(0, 1, 5, 2, 6, 3, 4, 7).reshape(B, Hp, Wp, k * h * d)


def _probs(x: torch.Tensor, bias: torch.Tensor, seed, scale: float,
           rate: float, window0: int = 0):
    """fp32 q, k, v (B, nW, h, N, d) of split windows `x` (the first one
    window `window0`), the fp32 softmax pf and the keep mask (None at rate
    0)."""
    q, k, v = x[:, :, 0].float(), x[:, :, 1].float(), x[:, :, 2].float()
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale + bias[None]
    pf = torch.softmax(logits, dim=-1)
    keep = None
    if rate > 0.0:
        B, nW, h, N, _ = q.shape
        keep = keep_mask(seed, B, nW, h, N, rate, window0)
    return q, k, v, pf, keep


def _dropped(pf: torch.Tensor, keep, rate: float, dt) -> torch.Tensor:
    """pd: pf rounded to dt, dropped and rescaled, rounded again; fp32."""
    p = pf.to(dt).float()
    if keep is None:
        return p
    return torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0).to(dt).float()


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               seed: Optional[torch.Tensor], scale: float,
                               rate: float, ws: int,
                               window0: int = 0) -> torch.Tensor:
    """Plain version of the forward kernel (module docstring). Inputs are
    upcast to fp32 explicitly (exact for bf16) and autocast is off, so the
    products are those of a bf16 matmul with fp32 accumulation."""
    B, Hp, Wp, _ = qkv.shape
    h = bias.shape[1]
    with torch.autocast(qkv.device.type, enabled=False):
        x = _split_windows(qkv, ws, 3, h)
        _, _, v, pf, keep = _probs(x, bias, seed, scale, rate, window0)
        out = torch.matmul(_dropped(pf, keep, rate, qkv.dtype), v)
        return _merge_windows(out.to(qkv.dtype)[:, :, None], ws, Hp, Wp)


def window_attention_bwd_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                   seed: Optional[torch.Tensor],
                                   g: torch.Tensor, scale: float, rate: float,
                                   ws: int, window0: int = 0
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: (dqkv, db) from the residual
    (qkv, bias, seed) and the output's cotangent g (B, Hp, Wp, C), cast to
    qkv's dtype. dqkv has qkv's shape and dtype; db is fp32 (nW, h, N, N),
    summed over the batch."""
    B, Hp, Wp, _ = qkv.shape
    h = bias.shape[1]
    dt = qkv.dtype
    with torch.autocast(qkv.device.type, enabled=False):
        x = _split_windows(qkv, ws, 3, h)
        q, k, v, pf, keep = _probs(x, bias, seed, scale, rate, window0)
        gf = _split_windows(g.to(dt), ws, 1, h)[:, :, 0].float()
        pd = _dropped(pf, keep, rate, dt)
        dv = torch.matmul(pd.transpose(-1, -2), gf)
        dp = torch.matmul(gf, v.transpose(-1, -2))
        if keep is not None:
            dp = torch.where(keep, dp * (1.0 / (1.0 - rate)), 0.0)
        dl = (dp - (dp * pf).sum(-1, keepdim=True)) * pf
        db = dl.sum(0)
        dlf = (dl * scale).to(dt).float()
        dq = torch.matmul(dlf, k)
        dk = torch.matmul(dlf.transpose(-1, -2), q)
        dqkv = torch.stack([dq, dk, dv], 2).to(dt)
        return _merge_windows(dqkv, ws, Hp, Wp), db


# ------------------------------------------------------------- kernels ----


_ARGS = [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_float,
                              ctypes.c_float, ctypes.c_uint, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _load(name: str, n_pointers: int):
    from rgbx_semantic_segmentation_tpu_torch.native import build

    lib = build.load(name)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + _ARGS
    fn.restype = ctypes.c_int
    err = getattr(lib, name + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


@functools.lru_cache(maxsize=None)
def _kernel():
    return _load("window_attention_fwd", 4)


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    return _load("window_attention_bwd", 6)


def _check(qkv: torch.Tensor, bias: torch.Tensor, seed, rate: float,
           ws: int) -> Tuple[int, int, int, int, int, int]:
    """Shape and type rules of both versions; returns (B, Hp, Wp, h, d, nW)."""
    if qkv.dim() != 4 or bias.dim() != 4:
        raise ValueError(f"window_attention wants qkv (B, Hp, Wp, 3C) and "
                         f"bias (nW, h, N, N), got {tuple(qkv.shape)}, "
                         f"{tuple(bias.shape)}")
    B, Hp, Wp, c3 = qkv.shape
    h, N = bias.shape[1], ws * ws
    if Hp % ws or Wp % ws or c3 % (3 * h):
        raise ValueError(f"window_attention: image {Hp}x{Wp} with {c3} "
                         f"channels does not split into windows of {ws} and "
                         f"3 x {h} heads")
    nW = (Hp // ws) * (Wp // ws)
    if tuple(bias.shape) != (nW, h, N, N):
        raise ValueError(f"window_attention: bias {tuple(bias.shape)}, "
                         f"expected {(nW, h, N, N)}")
    if bias.dtype != torch.float32 or bias.device != qkv.device:
        raise ValueError(f"window_attention: bias must be float32 on "
                         f"{qkv.device}, got {bias.dtype} on {bias.device}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"drop rate {rate} outside [0, 1)")
    if rate > 0.0 and (seed is None or seed.dtype != torch.int64
                       or seed.numel() != 1 or seed.device != qkv.device):
        raise ValueError("window_attention with dropout wants a one-element "
                         f"int64 seed tensor on {qkv.device}")
    return B, Hp, Wp, h, c3 // (3 * h), nW


def _kernel_args(name: str, qkv, bias, seed, scale, rate, ws, dims,
                 window0: int = 0):
    """What the CUDA kernels take (raises on anything else) and the
    arguments both entries share after their pointers."""
    B, Hp, Wp, h, d, nW = dims
    N = ws * ws
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes bfloat16 or float32, "
                        f"got {qkv.dtype}")
    if not usable(N, d):
        raise ValueError(f"{name} kernel does not take N = {N}, d = {d} "
                         f"(N <= {MAX_N}, d <= {MAX_D})")
    if not qkv.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous qkv image")
    if window0 < 0 or (window0 + nW) * h >= 2 ** 31:
        raise ValueError(f"{name} kernel: window0 {window0} out of range")
    bias_w = 0 if nW == 1 else bias.stride(0)
    if not bias[0].is_contiguous() or bias_w not in (0, h * N * N):
        raise ValueError(f"{name} kernel takes contiguous (h, N, N) bias "
                         "blocks, one per window or one expanded to all")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    return (B, Hp, Wp, h, d, ws, bias_w, float(scale),
            1.0 / (1.0 - rate), dropout_threshold(rate), int(rate > 0.0),
            int(window0), _DTYPE_CODES[qkv.dtype], stream)


def _forward(qkv, bias, seed, scale: float, rate: float, ws: int,
             window0: int = 0):
    """The forward without autograd: plain version on the CPU, kernel on
    CUDA."""
    dims = _check(qkv, bias, seed, rate, ws)
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, seed, scale, rate, ws,
                                          window0)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for {qkv.device}")
    B, Hp, Wp, h, d, _ = dims
    fn, err = _kernel()
    with _on_device(qkv):
        args = _kernel_args("window_attention", qkv, bias, seed, scale, rate,
                            ws, dims, window0)
        out = torch.empty(B, Hp, Wp, h * d, dtype=qkv.dtype, device=qkv.device)
        rc = fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                seed.data_ptr() if rate > 0.0 else None, *args)
    if rc != 0:
        raise RuntimeError(f"window_attention_fwd launch failed ({rc}): "
                           f"{err(rc).decode()}")
    window_attention.launches += 1
    return out


def window_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         seed: Optional[torch.Tensor], g: torch.Tensor,
                         scale: float, rate: float, ws: int,
                         window0: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window attention backward: (dqkv, db) from the residual (qkv, bias,
    seed) and the output's cotangent g (B, Hp, Wp, C), cast to qkv's dtype;
    `window0` as in window_attention.

    CPU tensors: the plain version. CUDA tensors: the CUDA kernel, under the
    forward's conditions; anything else raises. db is fp32 (nW, h, N, N)
    whatever the strides of `bias`. `window_attention_bwd.launches` counts
    kernel launches."""
    dims = _check(qkv, bias, seed, rate, ws)
    B, Hp, Wp, h, d, nW = dims
    if tuple(g.shape) != (B, Hp, Wp, h * d) or g.device != qkv.device:
        raise ValueError(f"window_attention_bwd: cotangent {tuple(g.shape)} "
                         f"on {g.device} for qkv {tuple(qkv.shape)} on "
                         f"{qkv.device}")
    g = g.to(qkv.dtype)
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, bias, seed, g, scale, rate,
                                              ws, window0)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: no kernel for {qkv.device}")
    fn, err = _bwd_kernel()
    N = ws * ws
    with _on_device(qkv):
        args = _kernel_args("window_attention_bwd", qkv, bias, seed, scale,
                            rate, ws, dims, window0)
        g = g.contiguous()
        dqkv = torch.empty_like(qkv)
        db = torch.empty(nW, h, N, N, dtype=torch.float32, device=qkv.device)
        rc = fn(qkv.data_ptr(), bias.data_ptr(), g.data_ptr(),
                dqkv.data_ptr(), db.data_ptr(),
                seed.data_ptr() if rate > 0.0 else None, *args)
    if rc != 0:
        raise RuntimeError(f"window_attention_bwd launch failed ({rc}): "
                           f"{err(rc).decode()}")
    window_attention_bwd.launches += 1
    return dqkv, db


window_attention_bwd.launches = 0


class _WindowAttention(torch.autograd.Function):
    """Residual (qkv, bias, seed) only, as the JAX `_fwd_rule` / `_bwd_rule`.
    qkv arrives in the compute dtype (the qkv Linear runs under autocast);
    the backward casts the cotangent to it."""

    @staticmethod
    def forward(ctx, qkv, bias, seed, scale, rate, ws, window0):
        ctx.save_for_backward(qkv, bias, seed)
        ctx.args = (scale, rate, ws, window0)
        return _forward(qkv, bias, seed, scale, rate, ws, window0)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, seed = ctx.saved_tensors
        dqkv, db = window_attention_bwd(qkv, bias, seed, g, *ctx.args)
        return dqkv, db, None, None, None, None, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     seed: Optional[torch.Tensor], scale: float, rate: float,
                     ws: int, window0: int = 0) -> torch.Tensor:
    """Windowed self-attention with additive bias and dropout on the whole
    padded, rolled image (module docstring). qkv: (B, Hp, Wp, 3C); bias:
    fp32 (nW, h, N, N); seed: one-element int64 tensor on qkv's device
    (None allowed at rate 0) -> (B, Hp, Wp, C) in qkv's dtype;
    differentiable in qkv and bias (backward: window_attention_bwd).
    `window0`: qkv is a slab of whole window rows whose first window is
    window `window0` of the whole image (the dropout masks' counter; 0: the
    whole image).

    CPU tensors: the plain versions. CUDA tensors: the CUDA kernels, which
    take a contiguous bf16 or fp32 qkv with usable(ws * ws, d); anything
    else raises, in the forward. `window_attention.launches` counts forward
    kernel launches."""
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _WindowAttention.apply(qkv, bias, seed, scale, rate, ws,
                                      window0)
    return _forward(qkv, bias, seed, scale, rate, ws, window0)


window_attention.launches = 0
