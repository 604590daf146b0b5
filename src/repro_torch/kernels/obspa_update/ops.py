"""Blocked OBSPA sweep: the in-block kernel (K4) per 128-column block, then
the cross-block compensation ``W[:, rest] -= E @ Hinv[block, rest]`` as one
GEMM per block — the reference's ``ops.py`` decomposition.

Dispatch: CUDA tensors go to the CUDA kernel, which launches or raises; CPU
tensors go to the plain version (``ref.inblock_sweep_plain``) — only because
they lie on the CPU.  On the card the sweep runs in place on a padded f32
copy of W, one column block at a time, with one E buffer for all blocks.
The compensation GEMM is ``baddbmm_`` into the rest of that copy (no
temporary of the rest's size) with TF32 off, as the reference leaves it to
XLA outside its Pallas kernel.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels.obspa_update import ref
from repro_torch.kernels.obspa_update.obspa_update import (
    BLOCK, check_args, inblock_sweep_kernel)


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for the duration (full f32 products), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def inblock_sweep(w: torch.Tensor, hinv: torch.Tensor, mask: torch.Tensor,
                  out: torch.Tensor | None = None,
                  e_out: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One column block: the kernel on CUDA tensors, the plain version on
    CPU tensors — both held to the kernel's argument contract.  Shapes as
    ``inblock_sweep_kernel``."""
    if w.is_cuda:
        return inblock_sweep_kernel(w, hinv, mask, out=out, e_out=e_out)
    w3, h3, o3, e3 = check_args(w, hinv, mask, out, e_out)
    new, e = ref.inblock_sweep_plain(w3, h3, mask)
    if o3 is not None:
        new = o3.copy_(new)
    if e3 is not None:
        e = e3.copy_(e)
    return (new[0], e[0]) if w.ndim == 2 else (new, e)


def obspa_sweep_batched(W: torch.Tensor, Hinv: torch.Tensor,
                        prune_mask: torch.Tensor) -> torch.Tensor:
    """W (nb, R, K), Hinv (nb, K, K), mask (K,) shared -> new f32 W."""
    nb, R, K = W.shape
    dev = W.device
    mask = prune_mask.to(device=dev, dtype=torch.bool).contiguous()
    pad = (-K) % BLOCK
    Kp = K + pad
    Wp = torch.zeros((nb, R, Kp), dtype=torch.float32, device=dev)
    Wp[:, :, :K] = W
    if pad:
        # padded diag must be non-zero; padded cols are never pruned
        Hp = torch.zeros((nb, Kp, Kp), dtype=torch.float32, device=dev)
        Hp[:, :K, :K] = Hinv
        idx = torch.arange(K, Kp, device=dev)
        Hp[:, idx, idx] = 1.0
        mask = torch.cat([mask, mask.new_zeros(pad)])
    else:   # row-major: torch.linalg.inv returns column-major results
        Hp = Hinv.to(torch.float32).contiguous()
        if Hp.data_ptr() % 16:      # the kernel copies rows 16 bytes a time
            Hp = Hp.clone()
    e_blk = torch.empty((nb, R, BLOCK), dtype=torch.float32, device=dev)
    with full_f32_matmul():
        for b0 in range(0, Kp, BLOCK):
            blk = slice(b0, b0 + BLOCK)
            inblock_sweep(Wp[:, :, blk], Hp[:, blk, blk], mask[blk],
                          out=Wp[:, :, blk], e_out=e_blk)
            if b0 + BLOCK < Kp:
                Wp[:, :, b0 + BLOCK:].baddbmm_(
                    e_blk, Hp[:, blk, b0 + BLOCK:], alpha=-1)
    return Wp[:, :, :K] if pad else Wp


def obspa_sweep(W: torch.Tensor, Hinv: torch.Tensor,
                prune_mask: torch.Tensor) -> torch.Tensor:
    """Blocked OBSPA reconstruction.  W (R, K), Hinv (K, K), mask (K,)."""
    return obspa_sweep_batched(W[None], Hinv[None], prune_mask)[0]


def sweep_oracle(W, Hinv, prune_mask) -> np.ndarray:
    """Ground truth (float64 numpy Eq. 13/14), on host copies."""
    host = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return ref.sweep_numpy(host(W), host(Hinv), host(prune_mask))
