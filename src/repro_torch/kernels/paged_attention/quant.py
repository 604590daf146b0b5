"""Symmetric per-write K/V quantization for the paged block pools.

A quantized pool stores K/V in int8 or fp8-e4m3 (1 byte/element) plus one
f32 scale per written (token slot, kv-head) — the scale pools mirror the KV
pools' block layout ``(num_blocks, block_size, KH)``, so a scale is addressed
by exactly the same ``(block, offset, kv_head)`` coordinates as the vector it
scales and travels with its block through prefix aliasing and COW copies.

The head_dim vector of one token for one kv-head is the quantization group,
which makes quantization a pure function of the written vector:
deterministic, history-free, and exactly reproducible.

Shared by ``models.attention._scatter_kv`` (the only writer), the CUDA
kernel's fused load->dequant and the plain version — so "what do the stored
bytes mean" exists once.
"""
from __future__ import annotations

import torch

# pool element dtype and the absmax the scale maps onto it
QUANT_SPECS: dict[str, tuple] = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),   # max finite e4m3 value
}

# every ServeConfig.cache_dtype the engine accepts ("" = model dtype)
CACHE_DTYPES = ("", "float32", "bfloat16", "int8", "fp8_e4m3")


def is_quantized(dtype_name: str | None) -> bool:
    return (dtype_name or "") in QUANT_SPECS


def pool_dtype(dtype_name: str) -> torch.dtype:
    """Element dtype of a quantized pool."""
    return QUANT_SPECS[dtype_name][0]


def qmax_of(dtype: torch.dtype) -> float:
    """The absmax a stored element can represent, by pool *dtype*."""
    for dt, qmax in QUANT_SPECS.values():
        if dtype == dt:
            return qmax
    raise ValueError(f"{dtype} is not a quantized pool dtype")


def quantize(x: torch.Tensor, dtype: torch.dtype
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) -> (q (..., hd) in ``dtype``, scale (...) f32).

    Symmetric: scale = absmax/qmax over the trailing (head_dim) axis, so
    dequantization is ``q.float() * scale[..., None]``.  An all-zero vector
    (idle-slot null-block writes) gets scale 0 and quantizes to 0.  int8
    rounds half to even (``torch.round``) and clips to ±127; fp8 is clamped
    to ±448 before the cast so the CPU and CUDA casts agree on the edge.
    """
    qmax = qmax_of(dtype)
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / qmax
    qv = xf / scale.clamp(min=1e-30)[..., None]
    if dtype == torch.int8:
        qv = torch.round(qv)
    qv = qv.clamp(-qmax, qmax)
    return qv.to(dtype), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q (..., hd) quantized, scale (...) f32 -> f32 (..., hd)."""
    return q.float() * scale[..., None].float()
