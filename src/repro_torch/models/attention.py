"""Grouped-query attention with RoPE, qk-norm, masking modes, KV-cache decode.

Parameters are kept 3-D ``(d_model, heads, head_dim)`` so the SPA pruning
graph sees heads as a first-class channel axis (head pruning = slicing
axis 1); ``wo`` is ``(heads, v_head_dim, d_model)``.

Mask modes:
  "causal"  — standard decoder
  "sliding" — causal + window
  "bidir"   — encoder
  "prefix"  — bidirectional over the first ``prefix_len`` tokens, causal after.

In-place updates: where the JAX reference returns new (donated) cache
arrays, ``attention_decode`` and ``_scatter_kv`` write into the tensors
they are given and return the same objects.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_attention, paged_prefill_attention, quantize)
from repro_torch.models.layers import (
    dense_init, rms_norm, rope_sin_cos, rotate)

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg) -> dict:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    vhd = cfg.v_head_dim_
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    p = {
        "wq": dense_init(gen, (d, H, hd), dt),
        "wk": dense_init(gen, (d, KH, hd), dt),
        "wv": dense_init(gen, (d, KH, vhd), dt),
        "wo": dense_init(gen, (H, vhd, d), dt, fan_in=H * vhd),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
    return p


# logical sharding axes of the attention parameters (the reference's table;
# ``distributed.sharding`` maps them to mesh axes)
ATTN_AXES = {
    "wq": ("fsdp", "heads", "head_dim"),
    "wk": ("fsdp", "kv_heads", "head_dim"),
    "wv": ("fsdp", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "fsdp"),
    "q_norm": ("head_dim",),
    "k_norm": ("head_dim",),
}


def _build_mask(mode: str, q_pos: torch.Tensor, kv_pos: torch.Tensor,
                window: int, prefix_len: int) -> torch.Tensor:
    """Boolean (…, Sq, Skv) mask; True = attend."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    causal = k <= q
    if mode == "bidir":
        return torch.ones_like(causal)
    if mode == "causal":
        return causal
    if mode == "sliding":
        return causal & (k > q - window)
    if mode == "prefix":
        return causal | (k < prefix_len)
    raise ValueError(mode)


def _qkv(params, cfg, x, positions, memo: dict | None = None):
    """Project + rope + qk-norm.  Returns q (B,S,KH,G,hd), k, v (B,S,KH,hd).
    ``memo`` (a paged step's, shared by its layers) keeps the RoPE tables,
    which depend on the positions only, from the first layer on."""
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // KH
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    rope = None if memo is None else memo.get("rope")
    if rope is None:
        rope = rope_sin_cos(q, positions, cfg.rope_theta)
        if memo is not None:
            memo["rope"] = rope
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    q = q.reshape(q.shape[:2] + (KH, G, hd))
    return q, k, v


def _sdpa(q, k, v, mask):
    """q (B,Sq,KH,G,hd); k,v (B,Skv,KH,hd); mask (B,Sq,Skv) -> (B,Sq,KH,G,hd).
    Logits and softmax in f32; probabilities cast to q.dtype before PV."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", q, k).float() * scale
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqs,bshk->bqhgk", probs, v)


def _on_kernel(cfg, x: torch.Tensor) -> bool:
    """Whether the full-sequence attention goes to K2: CUDA tensors, unless
    the config asks for the plain version (``use_kernels=False``, which
    training, the gradient criteria and the pruning trace always do)."""
    return cfg.use_kernels and x.is_cuda


def attention_block(params: dict, cfg, x: torch.Tensor,
                    positions: torch.Tensor, mask_mode: str,
                    window: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """Full-sequence attention (train / prefill).

    The counterpart of the reference's ``use_pallas`` branch: on the
    kernel route (``_on_kernel``) the causal, bidirectional and sliding
    masks go through flash attention (K2, forward only); ``prefix`` and
    every other call run the plain ``_sdpa``, which is also what autograd
    differentiates."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    if _on_kernel(cfg, x) and mask_mode in ("causal", "bidir", "sliding"):
        qf = q.reshape(B, S, q.shape[2] * q.shape[3], q.shape[4])
        o = flash_attention(qf, k, v, causal=mask_mode != "bidir",
                            window=window if mask_mode == "sliding" else 0)
    else:
        mask = _build_mask(mask_mode, positions, positions, window,
                           prefix_len)
        if mask.ndim == 2:
            mask = mask[None].expand((B,) + tuple(mask.shape))
        o = _sdpa(q, k, v, mask)
        o = o.reshape(B, S, o.shape[2] * o.shape[3], o.shape[4])
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, S_max, KH, hd)
    v: torch.Tensor    # (B, S_max, KH, vhd)


def init_layer_cache(cfg, batch: int, max_len: int, dtype, device) -> KVCache:
    KH, hd, vhd = cfg.n_kv_heads, cfg.head_dim_, cfg.v_head_dim_
    return KVCache(
        torch.zeros((batch, max_len, KH, hd), dtype=dtype, device=device),
        torch.zeros((batch, max_len, KH, vhd), dtype=dtype, device=device))


def attention_decode(params: dict, cfg, x: torch.Tensor, pos: int,
                     cache: KVCache, mask_mode: str, window: int = 0,
                     prefix_len: int = 0) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  x (B,1,d); pos python int (current index).  The
    cache tensors are updated in place."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(params, cfg, x, positions)
    cache.k[:, pos:pos + 1] = k_new
    cache.v[:, pos:pos + 1] = v_new
    S = cache.k.shape[1]
    kv_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    valid = kv_pos <= pos
    if mask_mode == "sliding":
        valid &= kv_pos > pos - window
    # bidir/prefix reduce to "attend to all valid" during decode
    mask = valid[None, None, :].expand(B, 1, S)
    o = _sdpa(q, cache.k, cache.v, mask)
    o = o.reshape(B, 1, o.shape[2] * o.shape[3], o.shape[4])
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return out, cache


def _scatter_kv(kv: dict, k_new, v_new, block_tables, positions,
                inchunk=None) -> dict:
    """Scatter per-token K/V (B, C, KH, hd) into the pool blocks their
    absolute ``positions`` (B, C) map to through ``block_tables`` (B, NB).

    ``kv`` is one layer's pool slice: ``{"k", "v"}`` plus, when the pool is
    quantized, ``{"k_scale", "v_scale"}`` (P, bs, KH) f32.  ``inchunk``
    (B, C) bool masks padding: masked tokens (and positions pointing past
    the table) are redirected to the reserved null block 0, where writes are
    harmless by construction.  Shared by the paged decode, chunked-prefill
    and verify paths, so the "where does a token's KV land — and what bytes
    does it land as" rule exists exactly once.  Plain narrow pools cast on
    write; quantized pools quantize symmetrically on write, storing the
    per-(token, kv-head) scale at the same (block, offset) coordinates.

    The pools are written **in place** (``index_put_``) — the port's form of
    the reference's donated buffers — and ``kv`` is returned.  Live rows
    never share a cell; idle and padded rows all hit (block 0, offset 0),
    where the order of duplicate writes does not matter because every read
    of that cell is masked."""
    return scatter_kv_at(kv, k_new, v_new, kv_write_index(
        block_tables, positions, kv["k"].shape[1], inchunk))


def kv_write_index(block_tables, positions, block_size: int, inchunk=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(block, offset) of every token's K/V write (``_scatter_kv``'s rule):
    the same for every layer of a step."""
    NB = block_tables.shape[1]
    positions = positions.long()
    blk_idx = (positions // block_size).clamp(0, NB - 1)
    blk = torch.gather(block_tables.long(), 1, blk_idx)
    off = positions % block_size
    if inchunk is not None:
        zero = torch.zeros_like(blk)
        blk = torch.where(inchunk, blk, zero)
        off = torch.where(inchunk, off, zero)
    return blk, off


def scatter_kv_at(kv: dict, k_new, v_new, idx) -> dict:
    """``_scatter_kv`` at a ``kv_write_index``."""
    k_pool, v_pool = kv["k"], kv["v"]
    if "k_scale" in kv:
        qk, sk = quantize(k_new, k_pool.dtype)
        qv, sv = quantize(v_new, v_pool.dtype)
        _put(k_pool, idx, qk)
        _put(v_pool, idx, qv)
        kv["k_scale"].index_put_(idx, sk)
        kv["v_scale"].index_put_(idx, sv)
        return kv
    _put(k_pool, idx, k_new.to(k_pool.dtype))
    _put(v_pool, idx, v_new.to(v_pool.dtype))
    return kv


def _put(pool: torch.Tensor, idx, vals: torch.Tensor) -> None:
    """``pool[idx] = vals`` in place; one-byte float pools are written
    through a ``uint8`` view (indexed writes are not implemented for fp8 on
    every backend; the bytes are what matters)."""
    if pool.dtype == torch.float8_e4m3fn:
        pool.view(torch.uint8).index_put_(idx, vals.view(torch.uint8))
    else:
        pool.index_put_(idx, vals)


def _write_index(memo: dict | None, block_tables, positions, block_size,
                 inchunk=None):
    """``kv_write_index``, kept in a paged step's ``memo`` from its first
    layer on (every layer writes at the same coordinates)."""
    widx = None if memo is None else memo.get("widx")
    if widx is None:
        widx = kv_write_index(block_tables, positions, block_size, inchunk)
        if memo is not None:
            memo["widx"] = widx
    return widx


def attention_paged_decode(params: dict, cfg, x: torch.Tensor,
                           positions: torch.Tensor, kv: dict,
                           block_tables: torch.Tensor,
                           window=0, memo: dict | None = None
                           ) -> tuple[torch.Tensor, dict]:
    """One-token decode over a paged KV pool (continuous batching).

    x (B,1,d); positions (B,) int32 — per-sequence write index; ``kv`` is one
    layer's pool slice ``{"k", "v"}`` (P, bs, KH, hd/vhd), plus
    ``{"k_scale", "v_scale"}`` when quantized; block_tables (B, NB) maps
    logical to pool blocks.  window: python int for static masking (kernel)
    or a (B,) tensor for per-sequence dynamic windows (plain version).

    ``memo``: a dict the step's layers share (RoPE tables, write index).

    Returns (out (B,1,d), the same kv dict, written in place).
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, cfg, x, positions[:, None], memo)
    kv = scatter_kv_at(kv, k_new, v_new, _write_index(
        memo, block_tables, positions[:, None], kv["k"].shape[1]))
    qf = q.reshape(B, q.shape[2] * q.shape[3], q.shape[4])
    o = paged_attention(qf, kv["k"], kv["v"], block_tables,
                        (positions + 1).to(torch.int32),
                        window=window, use_kernel=cfg.use_kernels,
                        k_scale=kv.get("k_scale"),
                        v_scale=kv.get("v_scale"))
    o = o[:, None]                                       # (B, 1, H, vhd)
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return out, kv


def attention_paged_prefill(params: dict, cfg, x: torch.Tensor,
                            positions: torch.Tensor, kv: dict,
                            block_tables: torch.Tensor,
                            valid: torch.Tensor, window=0,
                            memo: dict | None = None
                            ) -> tuple[torch.Tensor, dict]:
    """Chunked-prefill attention over the paged KV pool.

    x (B, C, d) — a fixed-size chunk of tokens per sequence, right-padded;
    positions (B, C) absolute write indices (``chunk_start + arange(C)``);
    valid (B,) real-token counts.  K/V of the valid tokens are scattered
    into the pool blocks their positions map to (padding scatters into the
    reserved null block 0), then the chunk's queries attend causally over
    the *pool* history — which includes any prefix blocks aliased in by
    prefix caching.  The per-row absolute-position masking makes the same
    path serve speculative verify chunks.  ``memo``: a dict the step's
    layers share (RoPE tables, write index).  Returns (out (B, C, d), kv).
    """
    B, C, _ = x.shape
    q, k_new, v_new = _qkv(params, cfg, x, positions, memo)
    widx = None if memo is None else memo.get("widx")
    if widx is None:
        inchunk = torch.arange(C, device=x.device)[None, :] < valid[:, None]
        widx = _write_index(memo, block_tables, positions, kv["k"].shape[1],
                            inchunk)
    kv = scatter_kv_at(kv, k_new, v_new, widx)
    qf = q.reshape(B, C, q.shape[2] * q.shape[3], q.shape[4])
    starts = positions[:, 0].to(torch.int32).contiguous()
    o = paged_prefill_attention(
        qf, kv["k"], kv["v"], block_tables, starts,
        (starts + valid).to(torch.int32), window=window,
        use_kernel=cfg.use_kernels,
        k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"))
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return out, kv
