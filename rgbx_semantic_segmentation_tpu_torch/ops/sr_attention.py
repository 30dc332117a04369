"""Short-kv SR-attention, forward and backward: the hand-written CUDA
kernels and their plain PyTorch versions.

Every attention of the MiT encoder is short-kv: the spatial-reduction conv
shrinks k/v to M = N / r^2 tokens, and all four mit_b2 stages at 480x640 land
on M = 300 (N = 19200 / 4800 / 1200 / 300, d = 64). The forward kernels
(csrc/sr_attention_fwd.cu, the port of the TPU kernel
rgbx_semantic_segmentation_tpu/ops/sr_attention.py `_fwd_kernel`) keep k
and v of a (batch*head) slice in shared memory and the fp32 logits of their
current q rows on chip, so no (N, M) tensor reaches device memory; the
backward kernels (csrc/sr_attention_bwd.cu, the port of `_bwd_kernel`)
recompute the probs on chip.

Two routes on the card, picked by `route` from what the tensors are, never
as a fallback: bf16 with a head dim that is a multiple of 8 and every row on
a 16-byte boundary (all the model's layouts) takes the tensor-core kernels
(wgmma, cp.async); fp32, and bf16 views that are not so aligned, take the
scalar kernels. On the tensor-core route the forward also writes each q
row's fp32 logsumexp in base 2 ("lse2", see `sr_attention_reference`), and
the residual of an attention is (q, k, v, lse2); on the scalar route it is
(q, k, v), as in the JAX package.

`sr_attention` is differentiable (a torch.autograd.Function, the counterpart
of the JAX `_sr_attention_3d` custom VJP). Device rule of the forward and of
the backward: a CPU tensor takes the plain versions (`sr_attention_reference`
with its lse, and `sr_attention_bwd_residual_reference` from that residual);
a CUDA tensor launches a kernel or raises. There is no fallback from a kernel
to its plain version. `sr_attention_bwd_reference` is the plain backward of
the TPU kernel's own numerics (delta from pf), the yardstick of both routes.

The kernels read q, k, v and the cotangent where they lie (any batch, head
and row strides; the head dim unit-stride). The forward writes its output as
a (B, h, N, d) view of a (B, N, h, d) buffer, the backward writes dq the same
way and dk, dv as the two halves of one (B, M, 2, h, d) buffer, so the
model's head split of its (B, N, h*d) q tokens and (B, M, 2*h*d) kv tokens,
the merge back, and their gradients cost no copy around the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Sequence, Tuple

import torch

# Whole-kv bound of the TPU kernel (rgbx_semantic_segmentation_tpu/ops/
# sr_attention.py MAX_M_PAD); the CUDA kernel covers the same shapes.
MAX_M_PAD = 1024
MAX_D = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LOG2E = 1.4426950408889634


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def supported(q_shape: Sequence[int], k_shape: Sequence[int]) -> bool:
    """Shapes the kernel takes: q (B, h, N, d), k (B, h, M, d) with d <= 128
    and M <= 1024 (the TPU kernel's gate, same arithmetic)."""
    d = q_shape[3]
    M = k_shape[2]
    return d <= MAX_D and _round_up(M, 128) <= MAX_M_PAD


def sr_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, return_lse: bool = False):
    """Plain version, the numerics of the JAX `_sdpa_fwd`: fp32 logits * scale,
    fp32 softmax, probs rounded to v's dtype, fp32 p @ v, output in v's dtype.
    `return_lse=True` also returns each q row's fp32 logsumexp in base 2 of
    the scaled logits, log2(sum_j 2^(s_j * scale * log2 e)) (the natural
    logsumexp times log2 e), (B, h, N): the statistic the tensor-core forward
    saves for the backward.

    Inputs are upcast to fp32 explicitly (exact for bf16), so the products
    are those of a bf16 matmul with fp32 accumulation on any device; autocast
    is off so it cannot cast them back down."""
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs.float(), v.float()).to(v.dtype)
        if return_lse:
            return out, torch.logsumexp(logits, dim=-1) * LOG2E
        return out


def sr_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, g: torch.Tensor, scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain version of the backward kernel, the numerics of the TPU
    `_bwd_kernel`: probs recomputed in fp32 from q and k; dv = p^T g with p
    rounded to the input dtype; the softmax backward
    dl = (dp - rowsum(dp * pf)) * pf * scale with the UNROUNDED fp32 pf,
    rounded to the input dtype before dq = dl k and dk = dl^T q; every
    product accumulated in fp32; g cast to q's dtype first. Returns
    (dq, dk, dv) in the input dtype."""
    dt = q.dtype
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf = q.float(), k.float(), v.float()
        gf = g.to(dt).float()
        logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        pf = torch.softmax(logits, dim=-1)
        p = pf.to(dt).float()
        dv = torch.matmul(p.transpose(-1, -2), gf).to(dt)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        dl = ((dp - (dp * pf).sum(-1, keepdim=True)) * pf * scale)
        dl = dl.to(dt).float()
        dq = torch.matmul(dl, kf).to(dt)
        dk = torch.matmul(dl.transpose(-1, -2), qf).to(dt)
    return dq, dk, dv


def sr_attention_bwd_residual_reference(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor, lse: torch.Tensor,
                                        g: torch.Tensor, scale: float
                                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """Plain version of the tensor-core backward, from the forward's
    residual: pf = 2^(logits * scale * log2 e - lse2) in fp32 (lse2 from
    `sr_attention_reference(..., return_lse=True)`), then the numerics of
    `sr_attention_bwd_reference` (delta = rowsum(dp * pf)). Returns
    (dq, dk, dv) in the input dtype."""
    dt = q.dtype
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf = q.float(), k.float(), v.float()
        gf = g.to(dt).float()
        logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        pf = torch.exp2(logits * LOG2E - lse.float().unsqueeze(-1))
        dv = torch.matmul(pf.to(dt).float().transpose(-1, -2), gf).to(dt)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        delta = (dp * pf).sum(-1, keepdim=True)
        dl = ((dp - delta) * pf * scale).to(dt).float()
        dq = torch.matmul(dl, kf).to(dt)
        dk = torch.matmul(dl.transpose(-1, -2), qf).to(dt)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _kernel():
    from rgbx_semantic_segmentation_tpu_torch.native import build

    lib = build.load("sr_attention_fwd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.sr_attention_fwd.argtypes = [vp] * 4 + [i] * 5 + [
        strides, ctypes.c_float, i, vp]
    lib.sr_attention_fwd.restype = i
    lib.sr_attention_fwd_tc.argtypes = [vp] * 5 + [i] * 5 + [
        strides, ctypes.c_float, i, vp]
    lib.sr_attention_fwd_tc.restype = i
    lib.sr_attention_fwd_tc_passes.argtypes = [i, i]
    lib.sr_attention_fwd_tc_passes.restype = i
    lib.sr_attention_fwd_error_string.argtypes = [i]
    lib.sr_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    from rgbx_semantic_segmentation_tpu_torch.native import build

    lib = build.load("sr_attention_bwd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.sr_attention_bwd.argtypes = [vp] * 9 + [i] * 5 + [
        strides, ctypes.c_float, i, i, vp]
    lib.sr_attention_bwd.restype = i
    lib.sr_attention_bwd_splits.argtypes = [i] * 7
    lib.sr_attention_bwd_splits.restype = i
    lib.sr_attention_bwd_tc.argtypes = [vp] * 9 + [i] * 5 + [
        strides, ctypes.c_float, i, vp]
    lib.sr_attention_bwd_tc.restype = i
    lib.sr_attention_bwd_tc_shares.argtypes = [i] * 6
    lib.sr_attention_bwd_tc_shares.restype = i
    lib.sr_attention_bwd_error_string.argtypes = [i]
    lib.sr_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"sr_attention wants 4-D q/k/v, got {q.shape}, "
                         f"{k.shape}, {v.shape}")
    B, h, N, d = q.shape
    if k.shape != v.shape or tuple(k.shape[:2]) != (B, h) or k.shape[3] != d:
        raise ValueError(f"sr_attention shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("sr_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"sr_attention: mixed dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _check_kernel_inputs(name: str, q, k, v) -> None:
    """What the CUDA kernels take; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes bfloat16 or float32, "
                        f"got {q.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{name} kernel takes q, k, v with a contiguous "
                         "head dim (stride 1 along d)")
    if not supported(q.shape, k.shape):
        raise ValueError(f"{name} kernel does not take q {tuple(q.shape)}"
                         f", k {tuple(k.shape)} (d <= {MAX_D}, "
                         f"M <= {MAX_M_PAD})")


def _aligned16(t: torch.Tensor) -> bool:
    """Every (batch, head, row) of `t` starts on a 16-byte boundary: what the
    tensor-core kernels' 16-byte copies read (bf16: strides in multiples of
    8 elements)."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernels a CUDA call takes: "tensor_cores" for bf16 with a head dim
    that is a multiple of 8 and every row of q, k and v on a 16-byte
    boundary (the model's layouts), "scalar" for the rest (fp32; bf16 with
    another head dim or an unaligned view)."""
    if (q.dtype == torch.bfloat16 and q.shape[3] % 8 == 0
            and all(_aligned16(t) for t in (q, k, v))):
        return "tensor_cores"
    return "scalar"


def _on_device(t: torch.Tensor):
    """The C side launches on the current device: switch only when `t` is
    elsewhere."""
    if t.device.index != torch.cuda.current_device():
        return torch.cuda.device(t.device)
    return contextlib.nullcontext()


def _strides(*tensors: torch.Tensor):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float, with_lse: bool = False, passes: int = 0):
    """The forward without autograd: plain version on the CPU, a kernel on
    CUDA. Returns out, or (out, lse) with `with_lse`; lse is None on the
    scalar route, which does not make it. `passes` (tensor-core route): 0
    as planned, 1 or 2 to force the one-pass or the two-pass kernel (for
    measuring that choice)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return sr_attention_reference(q, k, v, scale, return_lse=with_lse)
    _check_kernel_inputs("sr_attention", q, k, v)
    B, h, N, d = q.shape
    M = k.shape[2]
    out = torch.empty(B, N, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = _strides(q, k, v, out)
    lib = _kernel()
    lse = None
    with _on_device(q):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route(q, k, v) == "tensor_cores":
            if with_lse:
                lse = torch.empty(B, h, N, dtype=torch.float32,
                                  device=q.device)
            rc = lib.sr_attention_fwd_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, B, h, N, M, d, strides,
                float(scale), passes, stream)
        else:
            rc = lib.sr_attention_fwd(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), out.data_ptr(), B, h, N,
                                      M, d, strides, float(scale),
                                      _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.sr_attention_fwd_error_string(rc).decode()
        raise RuntimeError(f"sr_attention_fwd launch failed ({rc}): {msg}")
    sr_attention.launches += 1
    return (out, lse) if with_lse else out


def sr_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor, scale: float, max_splits: int = 0,
                     lse: torch.Tensor = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Short-kv attention backward: (dq, dk, dv) from the residual and the
    output's cotangent g (B, h, N, d), cast to q's dtype. `lse` is the
    forward's row logsumexp in base 2 (`_forward(..., with_lse=True)`); the
    tensor-core route runs the forward kernel for it when it is not given.

    CPU tensors: the plain versions (`sr_attention_bwd_residual_reference`
    given lse, else `sr_attention_bwd_reference`). CUDA tensors: the kernels
    of `route(q, k, v)`, under the forward's conditions (g too needs a
    unit-stride head dim; a g whose rows are not 16-byte aligned is copied
    for the tensor-core route); anything else raises. On the kernel path dq
    is a (B, h, N, d) view of a (B, N, h, d) buffer and dk, dv are views of
    one (B, M, 2, h, d) buffer: the layouts of the q and kv projections'
    outputs. `max_splits` > 0 caps the shares into which the kernels cut a
    slice's q rows for dk and dv (the cluster size on the tensor-core route;
    for measuring that choice; 0 lets the kernels plan them).
    `sr_attention_bwd.launches` counts calls that launched the kernels."""
    _check(q, k, v)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"sr_attention_bwd: cotangent {tuple(g.shape)} on "
                         f"{g.device} for q {tuple(q.shape)} on {q.device}")
    g = g.to(q.dtype)
    if q.device.type == "cpu":
        if lse is not None:
            return sr_attention_bwd_residual_reference(q, k, v, lse, g, scale)
        return sr_attention_bwd_reference(q, k, v, g, scale)
    _check_kernel_inputs("sr_attention_bwd", q, k, v)
    if g.stride(3) != 1:
        g = g.contiguous()
    B, h, N, d = q.shape
    M = k.shape[2]
    lib = _bwd_kernel()
    tensor_cores = route(q, k, v) == "tensor_cores"
    if tensor_cores:
        if lse is None:
            lse = _forward(q, k, v, scale, with_lse=True)[1]
        if not _aligned16(g):
            g = g.clone(memory_format=torch.contiguous_format)
        lse = lse.float().contiguous()
    with _on_device(q):
        dq = torch.empty(B, N, h, d, dtype=q.dtype,
                         device=q.device).transpose(1, 2)
        dkv = torch.empty(B, M, 2, h, d, dtype=q.dtype, device=q.device)
        dk, dv = dkv[:, :, 0].transpose(1, 2), dkv[:, :, 1].transpose(1, 2)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tensor_cores:
            delta = torch.empty(B, h, N, dtype=torch.float32,
                                device=q.device)
            rc = lib.sr_attention_bwd_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, h, N, M, d,
                _strides(q, k, v, g, dq, dk, dv), float(scale), max_splits,
                stream)
        else:
            code = _DTYPE_CODES[q.dtype]
            splits = lib.sr_attention_bwd_splits(B, h, N, M, d, code,
                                                 max_splits)
            if splits <= 0:
                msg = lib.sr_attention_bwd_error_string(-splits).decode()
                raise RuntimeError(f"sr_attention_bwd plan failed "
                                   f"({-splits}): {msg}")
            # Row statistics and the per-split fp32 partials of dk and dv.
            stats = torch.empty(B * h * N * 4, dtype=torch.float32,
                                device=q.device)
            partials = torch.empty(2 * B * h * splits * M * d,
                                   dtype=torch.float32, device=q.device)
            rc = lib.sr_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                partials.data_ptr(), B, h, N, M, d,
                _strides(q, k, v, g, dq, dk, dv), float(scale), code,
                max_splits, stream)
    if rc != 0:
        msg = lib.sr_attention_bwd_error_string(rc).decode()
        raise RuntimeError(f"sr_attention_bwd launch failed ({rc}): {msg}")
    sr_attention_bwd.launches += 1
    return dq, dk, dv


sr_attention_bwd.launches = 0


class _SRAttention(torch.autograd.Function):
    """Residual (q, k, v, lse2) on the tensor-core route and on the CPU (the
    plain versions), (q, k, v) on the scalar route, as the JAX `_sr_fwd` /
    `_sr_bwd` keep. Inputs arrive in the compute
    dtype (the projections run under autocast); the backward casts the
    cotangent to it and runs outside autocast."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        keep = q.device.type == "cpu" or route(q, k, v) == "tensor_cores"
        if keep:
            out, lse = _forward(q, k, v, scale, with_lse=True)
        else:
            out, lse = _forward(q, k, v, scale), None
        ctx.save_for_backward(q, k, v, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = sr_attention_bwd(q, k, v, g, ctx.scale, lse=lse)
        return dq, dk, dv, None


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Short-kv attention. q: (B, h, N, d); k, v: (B, h, M, d) ->
    (B, h, N, d) in q's dtype; differentiable (backward: sr_attention_bwd).

    CPU tensors: the plain versions. CUDA tensors: the CUDA kernels of
    `route(q, k, v)`, which take bf16 or fp32 tensors with a unit-stride
    head dim and supported(q.shape, k.shape); anything else raises, in the
    forward. On the kernel path the output is a (B, h, N, d) view of a
    (B, N, h, d) buffer. `sr_attention.launches` counts forward kernel
    launches."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _SRAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


sr_attention.launches = 0


def sr_attention_sharded(q_rows: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, scale: float) -> torch.Tensor:
    """SR attention of one rank of the spatial axis (`--mesh 2d:D,S`), the
    counterpart of the JAX `sr_attention_sharded` (ops/sr_attention.py:333,
    its shard_map at :303-330): q_rows (B, h, N / S, d) are the rank's own
    query rows, k and v (B, h, M, d) the whole image's keys, which every
    spatial rank computes from the gathered map. K1 runs on the own rows
    and K2 returns dq for them and the rank's PARTIAL dk, dv: the sums over
    its own query rows only. The same kernels (`sr_attention`) at the
    rank's shapes.

    The JAX wrapper psums dk and dv over 'spatial' inside the op (:323-324).
    Here that sum is taken one linear map later: k and v come from the
    all-gathered map (parallel/spatial.gather_rows), whose backward sums
    the kv branch's gradient over the spatial group. Summing dk/dv here as
    well would count the kv projection's weight gradient S times once the
    world's summing all-reduce adds the ranks' partial gradients."""
    return sr_attention(q_rows, k, v, scale)
