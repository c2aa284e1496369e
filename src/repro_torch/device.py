"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent (the entry points default to ``"cuda"``; tests pass ``"cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host: the port's entry points run "
            "on the card by default; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU), so a host
    clock read after it measures run time rather than enqueue time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
