"""Dispatch for flash attention in model layout (B, S, H, D): the CUDA kernel
vs the plain version.

CUDA tensors go to the hand-written kernel (K2), which launches or raises;
CPU tensors go to the plain PyTorch version (``ref.py``) — only because they
lie on the CPU.  Both routes are held to the kernel's argument contract
(``flash_attention.check_args``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    check_args, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import attention_reference


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, KH, D/DV) -> (B, Sq, H, DV) in q's
    dtype."""
    if q.is_cuda:
        return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      scale=scale)
    check_args(q, k, v, window)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """The plain version in model layout."""
    ot = attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             scale=scale)
    return ot.transpose(1, 2)
