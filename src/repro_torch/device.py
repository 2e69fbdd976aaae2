"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card (``"cuda"``) unless the
    caller asks for another one.  Asking for the card where there is none
    raises; nothing moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available on this machine; pass "
            "device='cpu' (launcher: --device cpu) to run on the CPU")
    return dev
