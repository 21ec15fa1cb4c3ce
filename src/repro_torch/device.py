"""Where the port runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"`` (the current card). Asking for CUDA on a
    machine without a usable card raises instead of quietly running on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the card by "
                "default; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # name the card, so device comparisons hold
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
