"""Times of the window-attention kernels at the swin_s shapes, on one
NVIDIA GPU.

    python -m rgbx_semantic_segmentation_tpu_torch.tools.bench_window_attention

For each of the four swin_s stages at 480x640 (bf16, d = 32, window 7): the
forward and the backward kernel with a bias block per window carrying the
model's shift mask (shifted blocks; -100 only in the last row and column of
windows), with every window's tokens cut in two by -100 entries ("masked":
the softmax then meets denormal exponentials in every row), and with one
shared block (unshifted), without dropout and at the preset's rate 0.3. The
backward kernel gives one block of threads a
(window, head) unit and lets it loop over the images, so that the bias
gradient needs no atomics; the second table shows what that costs where
units are few: its time per (unit, image) at batch 1, 2, 8 and 32 against
the number of blocks in flight.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from rgbx_semantic_segmentation_tpu_torch.models.encoders.dual_swin import (
    _shift_attn_mask)
from rgbx_semantic_segmentation_tpu_torch.ops import window_attention as W
from rgbx_semantic_segmentation_tpu_torch.tools.bench_sr_attention import (
    median_ms)

# (B, Hp, Wp, h) of the swin_s window attentions at 480x640, batch 8 (padded
# token maps; d = 32, window 7, N = 49) and the attention dropout of the
# preset.
STAGES = [(8, 126, 161, 3), (8, 63, 84, 6), (8, 35, 42, 12), (8, 21, 21, 24)]
D, WS, RATE = 32, 7, 0.3


def window_inputs(shape, dtype, kind, gen):
    """Inputs of one call at shape (B, Hp, Wp, h, d, ws): qkv as the qkv
    Linear hands it over, a bias as the model builds it, a non-uniform
    cotangent and a seed. `kind` is the bias: "unshifted" (one block
    expanded to all windows), "shifted" (a block per window carrying the
    model's own shift mask) or "masked" (a block per window with a random
    two-way partition of every window's tokens, -100 across it)."""
    B, Hp, Wp, h, d, ws = shape
    N, nW = ws * ws, (Hp // ws) * (Wp // ws)
    qkv = torch.randn(B, Hp, Wp, 3 * h * d, device="cuda",
                      generator=gen).to(dtype)
    bias = torch.randn(1, h, N, N, device="cuda", generator=gen)
    if kind == "shifted":
        mask = torch.from_numpy(_shift_attn_mask(Hp, Wp, ws, ws // 2)).cuda()
        bias = bias + mask[:, None]
    elif kind == "masked":
        part = (torch.rand(nW, 1, N, 1, device="cuda", generator=gen)
                < 0.3).float()
        bias = bias + torch.where(part != part.transpose(-1, -2), -100.0, 0.0)
    elif kind == "unshifted":
        bias = bias.expand(nW, -1, -1, -1)
    else:
        raise ValueError(f"unknown bias kind {kind!r}")
    cot = torch.randn(B, Hp, Wp, h * d, device="cuda", generator=gen).to(dtype)
    seed = torch.empty(1, dtype=torch.int64, device="cuda").random_(
        generator=gen)
    return qkv, bias, cot, seed


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_window_attention: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    sc = D ** -0.5
    for stage in STAGES:
        line = [f"(B,Hp,Wp,h)={stage}"]
        for kind in ("shifted", "masked", "unshifted"):
            qkv, bias, cot, seed = window_inputs((*stage, D, WS),
                                                 torch.bfloat16, kind, gen)
            for rate in (0.0, RATE):
                f = median_ms(lambda: W.window_attention(
                    qkv, bias, seed, sc, rate, WS))
                b = median_ms(lambda: W.window_attention_bwd(
                    qkv, bias, seed, cot, sc, rate, WS))
                line.append(f"{kind} rate {rate}: fwd {f:.4f} ms, bwd "
                            f"{b:.4f} ms")
        print("; ".join(line))
    for _, Hp, Wp, h in STAGES:
        units = (Hp // WS) * (Wp // WS) * h
        line = [f"backward, {units} blocks (one per unit), ns per (unit, image)"]
        for B in (1, 2, 8, 32):
            qkv, bias, cot, seed = window_inputs(
                (B, Hp, Wp, h, D, WS), torch.bfloat16, "shifted", gen)
            t = median_ms(lambda: W.window_attention_bwd(
                qkv, bias, seed, cot, sc, RATE, WS))
            line.append(f"B={B}: {t:.4f} ms = {t * 1e6 / (units * B):.1f} ns")
        print("; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
