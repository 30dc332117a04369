"""Device rule of the port's entry points: the card unless the caller asks
for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device=None` means "cuda" and raises when no CUDA device is present;
    there is no quiet move to the CPU. Anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
