"""Plain PyTorch version of paged attention (the kernel's oracle, and what a
CPU tensor is served by).

Query tokens attend over a KV history stored in non-contiguous fixed-size
blocks of a shared pool, addressed through a per-sequence block table.

Shapes:
  q            (B, H, D) decode | (B, C, H, D) chunked prefill, H = KH * G
  k_pool       (P, bs, KH, D)    shared block pool (P blocks of bs tokens)
  v_pool       (P, bs, KH, DV)
  block_tables (B, NB) int32     pool index of each logical block
  kv_lens      (B,)    int32     valid tokens per sequence (incl. current)
  window       int | (B,) tensor 0 = full causal; >0 = sliding window
  k/v_scale    (P, bs, KH) f32   per-write dequant scales when the pools
                                 are quantized (int8 / fp8-e4m3)

This version materializes the gathered history (B, NB*bs, KH, D); the CUDA
kernel never does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.quant import dequantize

NEG_INF = -1e30


def _gather_kv(pool, block_tables, scale):
    """Gather (B, S, KH, d) history from the pool, dequantizing with the
    identically-gathered scales when given — the same bytes->values rule as
    the kernel's fused load, applied after materialization."""
    B, NB = block_tables.shape
    bs = pool.shape[1]
    tables = block_tables.long()
    out = pool[tables].reshape(B, NB * bs, pool.shape[2], -1)
    if scale is not None:
        out = dequantize(
            out, scale[tables].reshape(B, NB * bs, pool.shape[2]))
    return out


def _window_of(window, B: int, device) -> torch.Tensor:
    win = torch.as_tensor(window, dtype=torch.int32, device=device)
    if win.ndim == 0:
        win = win.expand(B)
    return win


def paged_prefill_attention_reference(q, k_pool, v_pool, block_tables,
                                      q_starts, kv_lens, *, window=0,
                                      scale: float | None = None,
                                      k_scale=None, v_scale=None
                                      ) -> torch.Tensor:
    """Chunked prefill: C query tokens per sequence at absolute positions
    ``q_starts + arange(C)`` attend causally over the paged history.
    q (B, C, H, D); ``kv_lens = q_starts + valid``; rows past a sequence's
    valid count produce finite values the caller discards.  Output
    (B, C, H, DV)."""
    B, C, H, D = q.shape
    bs, KH = k_pool.shape[1], k_pool.shape[2]
    NB = block_tables.shape[1]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    dev = q.device

    k = _gather_kv(k_pool, block_tables, k_scale)           # (B, S, KH, D)
    v = _gather_kv(v_pool, block_tables, v_scale)

    qg = q.reshape(B, C, KH, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    idx = torch.arange(NB * bs, dtype=torch.int32, device=dev)[None, None, :]
    qpos = (q_starts.to(torch.int32)[:, None]
            + torch.arange(C, dtype=torch.int32, device=dev)[None, :]
            )[..., None]                                         # (B, C, 1)
    valid = (idx <= qpos) & (idx < kv_lens.to(torch.int32)[:, None, None])
    winb = _window_of(window, B, dev)[:, None, None]
    valid = valid & ((winb <= 0) | (idx > qpos - winb))
    s = torch.where(valid[:, None, None, :, :], s,
                    torch.full_like(s, NEG_INF))             # (B,KH,G,C,S)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, C, H, v.shape[-1]).to(q.dtype)


def paged_attention_reference(q, k_pool, v_pool, block_tables, kv_lens, *,
                              window=0, scale: float | None = None,
                              k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode: q (B, H, D), one query token at ``kv_len - 1`` -> (B, H, DV)."""
    B, H, D = q.shape
    bs, KH = k_pool.shape[1], k_pool.shape[2]
    NB = block_tables.shape[1]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    dev = q.device

    k = _gather_kv(k_pool, block_tables, k_scale)          # (B, S, KH, D)
    v = _gather_kv(v_pool, block_tables, v_scale)

    qg = q.reshape(B, KH, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    idx = torch.arange(NB * bs, dtype=torch.int32, device=dev)[None, :]
    lens = kv_lens.to(torch.int32)[:, None]
    valid = idx < lens
    win = _window_of(window, B, dev)[:, None]
    valid = valid & ((win <= 0) | (idx > lens - 1 - win))
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)
