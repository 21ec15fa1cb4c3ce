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


class CaptureError(RuntimeError):
    """Work that a CUDA graph cannot hold was reached while one was being
    captured: a copy from host memory, a read back to the host, or a lazy
    cache that the eager warm-up run should have built."""


def capturing() -> bool:
    """Whether this thread's current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def refuse_in_capture(what: str) -> None:
    """Raise :class:`CaptureError` where ``what`` is reached while the
    current stream captures a graph: a graph replays device work only, so
    host work there would run once, at capture, and never again."""
    if capturing():
        raise CaptureError(
            f"{what} while capturing a CUDA graph: the eager warm-up run "
            "before a capture must build it, and a graph cannot hold it"
        )
