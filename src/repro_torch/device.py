"""Device resolution for every entry point of the port.

Entry points default to ``"cuda"``. Asking for CUDA where there is no card
raises instead of quietly running on the CPU; the CPU is used only when the
caller names it (the parity tests pass ``device="cpu"``).
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = "cuda") -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in (so devices
    compare equal however they were named); raises if it is CUDA and no
    card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                f"False; pass device='cpu' to run the plain versions on the "
                f"CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
