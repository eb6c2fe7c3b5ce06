"""Device choice shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and there
    is none (no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev
