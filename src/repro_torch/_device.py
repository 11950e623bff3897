"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no GPU is present.

    Entry points default to ``"cuda"``; only a caller that passes
    ``device="cpu"`` explicitly runs the plain PyTorch versions on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch versions on the CPU")
    return dev
