"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device:
``None`` resolves to ``cuda`` and raises when no CUDA device exists.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; a CUDA device without an index
    gets the current one, so devices compare equal to tensors' devices."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
