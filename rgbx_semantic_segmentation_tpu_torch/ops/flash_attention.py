"""Long-kv flash attention, forward and backward: the hand-written CUDA
kernels and their plain PyTorch versions.

Counterpart of `_flash_attention` in rgbx_semantic_segmentation_tpu/ops/
attention.py, which calls the upstream Pallas TPU kernels
(jax.experimental.pallas.ops.tpu.flash_attention: a forward, a dk/dv and a
dq kernel under one custom VJP). It serves the quadratic cross-attention of
the IFFM fusion (models/fusion.ImprovedCrossAttention): N = M = 19200 / 4800
/ 1200 tokens at the first three mit_b2pp stages of a 480x640 image, where
the (N, M) probabilities of one call would be 11.8 GB in fp32. The kernels
stream kv (forward, dq) or q (dk/dv) in tiles with an online softmax, so no
(N, M) tensor reaches device memory, and the residual of an attention is
q, k, v, out and one fp32 logsumexp per q row.

`flash_attention` is differentiable (a torch.autograd.Function). Device rule
of every function here: a CPU tensor takes the plain version
(`flash_attention_reference`, `flash_attention_bwd_reference`); a CUDA
tensor launches the kernel or raises. There is no fallback from a kernel to
its plain version.

The plain versions keep the TPU kernels' rounding points (see their
docstrings) and walk q in chunks of rows, so their memory is bounded too and
they can be run at the full shapes beside the kernels.

Layouts as in ops/sr_attention.py: q, k, v and the cotangent are read where
they lie (any batch, head and row strides, the head dim unit-stride); out
and dq are (B, h, N, d) views of (B, N, h, d) buffers and dk, dv the two
halves of one (B, M, 2, h, d) buffer, so the head split of the q and kv
projections, the merge back and their gradients cost no copy.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from rgbx_semantic_segmentation_tpu_torch.ops.sr_attention import (
    _DTYPE_CODES, _on_device)

MAX_D = 128
# Elements of one fp32 (rows, M) temporary of the plain versions: they walk
# q in chunks of this many logits.
CHUNK_ELEMS = 1 << 28


def supported(q_shape: Sequence[int], k_shape: Sequence[int]) -> bool:
    """Shapes the dispatch sends here: N >= 1024 (the JAX package's
    `flash_supported`: below that the (N, M) tensor is small) and the
    kernels' d <= 128. The JAX gate's d >= 32, d % 8 == 0 was the upstream
    TPU kernel's block constraint, not the attention's: the CUDA kernels
    stage any d that is a multiple of 8 into a 64-wide panel whose columns
    past d are zeros, and ops/attention.multi_head_attention zero-pads
    other head dims (SegNeXt's 4, 12 and 20) up to the next multiple of 8
    before it calls them."""
    N, d = q_shape[2], q_shape[3]
    return N >= 1024 and d <= MAX_D


def _row_chunks(q: torch.Tensor, M: int):
    B, h, N, _ = q.shape
    rows = max(1, CHUNK_ELEMS // (B * h * M))
    return [(r, min(r + rows, N)) for r in range(0, N, rows)]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float,
                              round_p: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out (B, h, N, d) in v's dtype,
    lse (B, h, N) fp32). The TPU kernel's rounding points: fp32 logits *
    scale; p = exp(s - max) rounded to v's dtype before the fp32 p @ v,
    while the row sum l adds the unrounded p; out = (p @ v) / l, rounded.
    The max is the whole row's (the kernels' running max gives other
    roundings of p, within a bf16 ulp of out). `round_p=False` keeps p in
    fp32: the wrong rounding point, for checks that can tell the two apart.
    Inputs are upcast explicitly and autocast is off (ops/sr_attention.py)."""
    dt = v.dtype
    out = torch.empty(q.shape, dtype=dt, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.autocast(q.device.type, enabled=False):
        kt, vf = k.float().transpose(-1, -2), v.float()
        for a, b in _row_chunks(q, k.shape[2]):
            s = torch.matmul(q[:, :, a:b].float(), kt) * scale
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            if round_p:
                p = p.to(dt).float()
            out[:, :, a:b] = (torch.matmul(p, vf) / l).to(dt)
            lse[:, :, a:b] = (m + torch.log(l)).squeeze(-1)
    return out, lse


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, g: torch.Tensor,
                                  scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version of the two backward kernels, the TPU kernels' rounding
    points: di = rowsum(out * g) in fp32; p = exp(s - lse) recomputed in
    fp32; dv = p^T g with p rounded to the input dtype; ds = (g v^T - di) *
    p * scale from the unrounded p, rounded to the input dtype before
    dq = ds k and dk = ds^T q; every product accumulated in fp32 (dk and dv
    summed over the row chunks in fp32). Returns (dq, dk, dv) in the input
    dtype."""
    dt = q.dtype
    dq = torch.empty(q.shape, dtype=dt, device=q.device)
    with torch.autocast(q.device.type, enabled=False):
        kf, vf = k.float(), v.float()
        kt, vt = kf.transpose(-1, -2), vf.transpose(-1, -2)
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        for a, b in _row_chunks(q, k.shape[2]):
            qf, gf = q[:, :, a:b].float(), g[:, :, a:b].to(dt).float()
            di = (out[:, :, a:b].float() * gf).sum(-1, keepdim=True)
            p = torch.exp(torch.matmul(qf, kt) * scale
                          - lse[:, :, a:b].unsqueeze(-1))
            dv += torch.matmul(p.to(dt).float().transpose(-1, -2), gf)
            ds = ((torch.matmul(gf, vt) - di) * p * scale).to(dt).float()
            dq[:, :, a:b] = torch.matmul(ds, kf).to(dt)
            dk += torch.matmul(ds.transpose(-1, -2), qf)
    return dq, dk.to(dt), dv.to(dt)


@functools.lru_cache(maxsize=None)
def _kernel():
    from rgbx_semantic_segmentation_tpu_torch.native import build

    lib = build.load("flash_attention_fwd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [vp] * 5 + [i] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, vp]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_fwd_error_string.argtypes = [i]
    lib.flash_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    from rgbx_semantic_segmentation_tpu_torch.native import build

    lib = build.load("flash_attention_bwd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 5 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, vp]
    lib.flash_attention_bwd_dkv.argtypes = [vp] * 8 + tail
    lib.flash_attention_bwd_dkv.restype = i
    lib.flash_attention_bwd_dq.argtypes = [vp] * 7 + tail
    lib.flash_attention_bwd_dq.restype = i
    lib.flash_attention_bwd_error_string.argtypes = [i]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants 4-D q/k/v, got {q.shape}, "
                         f"{k.shape}, {v.shape}")
    B, h, N, d = q.shape
    if k.shape != v.shape or tuple(k.shape[:2]) != (B, h) or k.shape[3] != d:
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: mixed dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")


def _check_kernel_inputs(name: str, *operands: torch.Tensor) -> None:
    """What the CUDA kernels take of q, k, v (and the cotangent); raises on
    anything else."""
    q = operands[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes bfloat16 or float32, "
                        f"got {q.dtype}")
    d = q.shape[3]
    if d > MAX_D or d % 8:
        raise ValueError(f"{name} kernel takes a head dim that is a multiple "
                         f"of 8 up to {MAX_D}, got {d}")
    for t in operands:
        if t.stride(3) != 1:
            raise ValueError(f"{name} kernel takes operands with a "
                             "contiguous head dim (stride 1 along d)")
        # The tensor-core kernels read 16 bytes at a time.
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"{name} kernel takes bf16 operands that start "
                             "on a 16-byte boundary with strides that are "
                             f"multiples of 8, got strides {t.stride()}")


def _strides(*tensors: torch.Tensor):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _raise(lib, entry: str, rc: int) -> None:
    msg = getattr(lib, f"{entry}_error_string")(rc).decode()
    raise RuntimeError(f"{entry} launch failed ({rc}): {msg}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) without autograd: plain version on the CPU, kernel on
    CUDA."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check_kernel_inputs("flash_attention", q, k, v)
    lib = _kernel()
    B, h, N, d = q.shape
    out = torch.empty(B, N, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty(B, h, N, dtype=torch.float32, device=q.device)
    with _on_device(q):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, h, N, k.shape[2], d, _strides(q, k, v, out),
            float(scale), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        _raise(lib, "flash_attention_fwd", rc)
    flash_attention.launches += 1
    return out, lse


def flash_attention_dkv(q, k, v, g, lse, di, scale
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel alone (CUDA tensors only): (dk, dv) as the two
    halves of one (B, M, 2, h, d) buffer. `flash_attention_dkv.launches`
    counts its launches."""
    lib = _bwd_kernels()
    B, h, N, d = q.shape
    M = k.shape[2]
    dkv = torch.empty(B, M, 2, h, d, dtype=q.dtype, device=q.device)
    dk, dv = (t.transpose(1, 2) for t in dkv.unbind(2))
    with _on_device(q):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, h, N, M, d, _strides(q, k, v, g, dk, dv), float(scale),
            _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        _raise(lib, "flash_attention_bwd", rc)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_dq(q, k, v, g, lse, di, scale) -> torch.Tensor:
    """The dq kernel alone (CUDA tensors only): dq as a (B, h, N, d) view of
    a (B, N, h, d) buffer. `flash_attention_dq.launches` counts its
    launches."""
    lib = _bwd_kernels()
    B, h, N, d = q.shape
    dq = torch.empty(B, N, h, d, dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    with _on_device(q):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, h, N,
            k.shape[2], d, _strides(q, k, v, g, dq), float(scale),
            _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        _raise(lib, "flash_attention_bwd", rc)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward: (dq, dk, dv) from the residual (q, k, v,
    out, lse) and the output's cotangent g (B, h, N, d), cast to q's dtype.

    CPU tensors: the plain version. CUDA tensors: di = rowsum(out * g) as a
    torch reduction (the TPU code computes it outside its kernels too), then
    the dk/dv kernel and the dq kernel, under the forward's conditions;
    anything else raises."""
    _check(q, k, v)
    if (g.shape != q.shape or out.shape != q.shape or g.device != q.device
            or lse.shape != q.shape[:3]):
        raise ValueError(f"flash_attention_bwd: cotangent {tuple(g.shape)}, "
                         f"out {tuple(out.shape)}, lse {tuple(lse.shape)} on "
                         f"{g.device} for q {tuple(q.shape)} on {q.device}")
    g = g.to(q.dtype)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, g, scale)
    if g.stride(3) != 1:
        g = g.contiguous()
    _check_kernel_inputs("flash_attention_bwd", q, k, v, g)
    lse = lse.contiguous()
    di = (out.float() * g.float()).sum(-1).contiguous()
    dk, dv = flash_attention_dkv(q, k, v, g, lse, di, scale)
    dq = flash_attention_dq(q, k, v, g, lse, di, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Residual (q, k, v, out, lse), as the upstream custom VJP keeps
    (q, k, v, o, l, m). Inputs arrive in the compute dtype (the projections
    run under autocast); the backward casts the cotangent to it."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.scale)
        return dq, dk, dv, None


class _FlashAttentionPlain(torch.autograd.Function):
    """The plain versions under autograd, on any device: the same residual
    as the kernel path, so neither path keeps an (N, M) tensor."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_reference(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                   ctx.scale)
        return dq, dk, dv, None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """`flash_attention` on the plain versions whatever the device: the
    path a model on the card is held against at shapes whose (N, M)
    probabilities do not fit."""
    _check(q, k, v)
    return _FlashAttentionPlain.apply(q, k, v, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Long-kv attention. q: (B, h, N, d); k, v: (B, h, M, d) ->
    (B, h, N, d) in q's dtype; differentiable (backward:
    flash_attention_bwd).

    CPU tensors: the plain versions. CUDA tensors: the CUDA kernels, which
    take bf16 or fp32 tensors with a unit-stride head dim that is a multiple
    of 8 up to 128 (bf16: 16-byte aligned rows); anything else raises, in
    the forward. On the kernel path the output is a (B, h, N, d) view of a
    (B, N, h, d) buffer. `flash_attention.launches` counts forward kernel
    launches."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)[0]


flash_attention.launches = 0
