"""Plain versions of the OBSPA reconstruction sweep (paper Eq. 13/14).

Sequential semantics (SparseGPT column sweep, structured masks):

    for j in pruned columns, ascending:
        err      = W[:, j] / Hinv[j, j]
        W[:, j:] = W[:, j:] - err ⊗ Hinv[j, j:]     # zeroes W[:, j] exactly

``sweep_numpy`` is the float64 oracle, copied from the reference's
``ref.py``.  ``inblock_sweep_plain`` is the plain PyTorch version of the
kernel (one 128-column block: returns the updated block and the errors E),
and ``sweep_plain`` the plain PyTorch version of the whole sweep; both run on
whatever device their tensors are on.
"""
from __future__ import annotations

import numpy as np
import torch


def sweep_numpy(W: np.ndarray, Hinv: np.ndarray, prune_mask: np.ndarray
                ) -> np.ndarray:
    """Literal translation of Eq. 13/14 — ground truth for tests."""
    W = np.array(W, dtype=np.float64)
    Hinv = np.asarray(Hinv, dtype=np.float64)
    for j in np.nonzero(prune_mask)[0]:
        err = W[:, j] / Hinv[j, j]
        W[:, j:] -= err[:, None] * Hinv[j, j:][None, :]
    return W.astype(np.float32)


def _pruned_columns(mask: torch.Tensor) -> list[int]:
    return [int(j) for j in torch.nonzero(mask.bool().cpu())[:, 0]]


def inblock_sweep_plain(w: torch.Tensor, hinv: torch.Tensor,
                        mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One column block.  w (nb, R, B), hinv (nb or 1, B, B), mask (B,).

    Returns (updated w, errors E), both (nb, R, B) in f32 — what the kernel
    computes — or in float64 when w is float64 (the oracle run).  Columns
    whose mask is 0 change nothing and are skipped."""
    dt = w.dtype if w.dtype == torch.float64 else torch.float32
    w = w.to(dt).clone()
    hinv = hinv.to(dt)
    e = torch.zeros_like(w)
    for j in _pruned_columns(mask):
        err = w[:, :, j] / hinv[:, j, j][:, None]                 # (nb, R)
        w[:, :, j:] -= err[:, :, None] * hinv[:, j, None, j:]
        e[:, :, j] = err
    return w, e


def sweep_plain(W: torch.Tensor, Hinv: torch.Tensor, prune_mask: torch.Tensor
                ) -> torch.Tensor:
    """The whole sweep, unblocked, in ``W``'s float dtype (f32 or f64).
    W (R, K) or (nb, R, K); Hinv (K, K) or (nb, K, K); mask (K,)."""
    dt = W.dtype if W.dtype == torch.float64 else torch.float32
    W = W.to(dt).clone()
    Hinv = Hinv.to(dt)
    for j in _pruned_columns(prune_mask):
        err = W[..., j] / Hinv[..., j, j, None]
        W[..., j:] -= err[..., None] * Hinv[..., j, None, j:]
    return W
