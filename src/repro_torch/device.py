"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device and raises when there is none: an
    entry point never carries on silently on the CPU.  Ask for the CPU
    explicitly with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch entry points run on the GPU "
                "unless device='cpu' is requested explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
