"""Short-kv SR-attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Every attention of the MiT encoder is short-kv: the spatial-reduction conv
shrinks k/v to M = N / r^2 tokens, and all four mit_b2 stages at 480x640 land
on M = 300 (N = 19200 / 4800 / 1200 / 300, d = 64). The kernel
(csrc/sr_attention_fwd.cu, the port of the TPU kernel
rgbx_semantic_segmentation_tpu/ops/sr_attention.py `_fwd_kernel`) keeps k
and v of a (batch*head) slice in shared memory and the fp32 logits of its
current q rows on chip (registers on the bf16 tensor-core path, shared
memory on the scalar path), so no (N, M) tensor reaches device memory.

Device rule of `sr_attention`: a CPU tensor takes the plain version
(`sr_attention_reference`); a CUDA tensor launches the kernel or raises.
There is no fallback from the kernel to the plain version.

The kernel reads q, k and v where they lie (any batch, head and row strides;
the head dim unit-stride) and writes its output as a (B, h, N, d) view of a
(B, N, h, d) buffer, so the model's head split of its (B, N, h*d) tokens and
the merge back cost no copy.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Sequence

import torch

# Whole-kv bound of the TPU kernel (rgbx_semantic_segmentation_tpu/ops/
# sr_attention.py MAX_M_PAD); the CUDA kernel covers the same shapes.
MAX_M_PAD = 1024
MAX_D = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (batch, head, row) element strides of q, k, v and out.
_Strides = ctypes.c_longlong * 12


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def supported(q_shape: Sequence[int], k_shape: Sequence[int]) -> bool:
    """Shapes the kernel takes: q (B, h, N, d), k (B, h, M, d) with d <= 128
    and M <= 1024 (the TPU kernel's gate, same arithmetic)."""
    d = q_shape[3]
    M = k_shape[2]
    return d <= MAX_D and _round_up(M, 128) <= MAX_M_PAD


def sr_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Plain version, the numerics of the JAX `_sdpa_fwd`: fp32 logits * scale,
    fp32 softmax, probs rounded to v's dtype, fp32 p @ v, output in v's dtype.

    Inputs are upcast to fp32 explicitly (exact for bf16), so the products
    are those of a bf16 matmul with fp32 accumulation on any device; autocast
    is off so it cannot cast them back down."""
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.matmul(probs.float(), v.float()).to(v.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    from rgbx_semantic_segmentation_tpu_torch.native import build

    lib = build.load("sr_attention_fwd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.sr_attention_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i,
                                     ctypes.POINTER(ctypes.c_longlong),
                                     ctypes.c_float, i, vp]
    lib.sr_attention_fwd.restype = i
    lib.sr_attention_fwd_error_string.argtypes = [i]
    lib.sr_attention_fwd_error_string.restype = ctypes.c_char_p
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


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Short-kv attention forward. q: (B, h, N, d); k, v: (B, h, M, d) ->
    (B, h, N, d) in q's dtype.

    CPU tensors: the plain version. CUDA tensors: the CUDA kernel, which
    takes bf16 or fp32 tensors with a unit-stride head dim and
    supported(q.shape, k.shape); anything else raises. On the kernel path the
    output is a (B, h, N, d) view of a (B, N, h, d) buffer.
    `sr_attention.launches` counts kernel launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return sr_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"sr_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"sr_attention kernel takes bfloat16 or float32, "
                        f"got {q.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("sr_attention kernel takes q, k, v with a contiguous "
                         "head dim (stride 1 along d)")
    if not supported(q.shape, k.shape):
        raise ValueError(f"sr_attention kernel does not take q {tuple(q.shape)}"
                         f", k {tuple(k.shape)} (d <= {MAX_D}, "
                         f"M <= {MAX_M_PAD})")
    B, h, N, d = q.shape
    M = k.shape[2]
    out = torch.empty(B, N, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = _Strides(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *out.stride()[:3])
    lib = _kernel()
    # The C side launches on the current device: switch only when q is
    # elsewhere.
    switch = (torch.cuda.device(q.device)
              if q.device.index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sr_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), B, h, N, M, d, strides,
                                  float(scale), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.sr_attention_fwd_error_string(rc).decode()
        raise RuntimeError(f"sr_attention_fwd launch failed ({rc}): {msg}")
    sr_attention.launches += 1
    return out


sr_attention.launches = 0
