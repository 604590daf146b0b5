"""Dispatch for paged attention: the CUDA kernel vs the plain version.

CUDA tensors with ``use_kernel`` go to the hand-written kernel, which
launches or raises; it takes a *static* integer window.  CPU tensors go to
the plain PyTorch version — only because they are on the CPU.  The hybrid
family's layers each pass a static window (``models.transformer.
layer_window``: the sliding window, or 0 on a global layer), so the kernel
serves them as it is.  A per-sequence ``(B,)`` tensor window (the
reference's form under ``lax.scan``) is served by the plain version on CPU
tensors only, and raises ``NotImplementedError`` on CUDA tensors.
``use_kernel=False`` is an explicit request for the plain version.

``return_visits`` exposes the kernel's per-(sequence, kv-head) block-visit
counter; it is kernel-only — the plain version materializes every table
entry by construction, so asking it for visit counts is a bug.
"""
from __future__ import annotations

import numbers

import torch

from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_kernel, paged_prefill_attention_kernel)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_reference, paged_prefill_attention_reference)


def _static_window(window) -> int:
    """The kernel's window argument: any integer type as a python int."""
    if isinstance(window, torch.Tensor):
        raise NotImplementedError(
            "a per-sequence tensor window is served by the plain version on "
            "CPU tensors only; on CUDA tensors the kernel takes a static "
            "integer window, one per layer "
            "(models.transformer.layer_window)")
    if isinstance(window, numbers.Integral):
        return int(window)
    return window            # the kernel wrapper raises TypeError on it


def paged_attention(q, k_pool, v_pool, block_tables, kv_lens, *,
                    window=0, scale: float | None = None,
                    use_kernel: bool = True, return_visits: bool = False,
                    k_scale=None, v_scale=None):
    """Decode: q (B, H, D); pools (P, bs, KH, D/DV) -> (B, H, DV).

    ``k_scale``/``v_scale`` (P, bs, KH) mark the pools as quantized: the
    kernel dequantizes while it loads; the plain version dequantizes the
    gathered history."""
    if use_kernel and q.is_cuda:
        return paged_attention_kernel(
            q, k_pool, v_pool, block_tables, kv_lens,
            window=_static_window(window),
            scale=scale, return_visits=return_visits,
            k_scale=k_scale, v_scale=v_scale)
    if return_visits:
        raise ValueError("visit counts are a kernel-path observable")
    return paged_attention_reference(
        q, k_pool, v_pool, block_tables, kv_lens,
        window=window, scale=scale, k_scale=k_scale, v_scale=v_scale)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_starts,
                            kv_lens, *, window=0,
                            scale: float | None = None,
                            use_kernel: bool = True,
                            return_visits: bool = False,
                            k_scale=None, v_scale=None):
    """Chunked prefill: q (B, C, H, D) -> (B, C, H, DV)."""
    if use_kernel and q.is_cuda:
        return paged_prefill_attention_kernel(
            q, k_pool, v_pool, block_tables, q_starts, kv_lens,
            window=_static_window(window), scale=scale, return_visits=return_visits,
            k_scale=k_scale, v_scale=v_scale)
    if return_visits:
        raise ValueError("visit counts are a kernel-path observable")
    return paged_prefill_attention_reference(
        q, k_pool, v_pool, block_tables, q_starts, kv_lens,
        window=window, scale=scale, k_scale=k_scale, v_scale=v_scale)
