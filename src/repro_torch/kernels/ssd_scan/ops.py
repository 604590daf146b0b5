"""Dispatch for the SSD chunked scan: the CUDA kernel vs the plain version.

CUDA tensors go to the hand-written kernel (K3), which launches or raises;
CPU tensors go to the plain PyTorch version — only because they lie on the
CPU.  Both routes are held to the kernel's argument contract
(``ssd_scan.check_args``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_reference
from repro_torch.kernels.ssd_scan.ssd_scan import check_args, ssd_scan_kernel


def ssd_scan(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """Chunked SSD scan; the contract of ``models.ssm.ssd_reference`` minus
    the final state (the full-sequence forward does not need it).  Inputs
    are made contiguous first; y comes back in x's dtype."""
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    if x.is_cuda:
        return ssd_scan_kernel(x, dt, A, B, C, chunk)
    check_args(x, dt, A, B, C, chunk)
    return ssd_scan_ref(x, dt, A, B, C, chunk).to(x.dtype)


def ssd_scan_ref(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """The plain version: y (b, l, h, p) f32."""
    y, _ = ssd_reference(x, dt, A, B, C, chunk)
    return y
