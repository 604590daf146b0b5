"""Shared model layers: norms, RoPE, SwiGLU, embeddings, init helpers.

Everything is functional: params are plain nested dicts of tensors with
the reference's key paths, and every function takes the tensors it works
on (the device is wherever those tensors live).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Initialisers (seeded by an explicit torch.Generator on the target device)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def dense_init(gen: torch.Generator, shape, dtype,
               fan_in: int | None = None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return _normal(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return _normal(gen, shape, 0.02, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm with f32 statistics; returns x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics (the population variance, as
    ``jnp.var``); returns x.dtype.  No model of the reference calls it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int.
    Half-split rotation computed in f32."""
    return rotate(x, *rope_sin_cos(x, positions, theta))


def rope_sin_cos(x: torch.Tensor, positions: torch.Tensor, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotation ``apply_rope`` gives ``x`` (its head_dim, device and
    kind) at ``positions``: (sin, cos), each (..., seq, 1, hd/2) f32.
    They depend on the positions only, so a step may take them once for
    all its layers."""
    head_dim = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(head_dim, theta))
    if x.is_cuda and type(x) is torch.Tensor:
        # a real card tensor (not a tracer's fake one): stage the copy in
        # pinned memory so that it never waits for the device — a blocking
        # copy of pageable memory synchronizes the stream, twice a layer
        freqs = freqs.pin_memory().to(x.device, non_blocking=True)
    else:
        freqs = freqs.to(x.device)
    angles = positions[..., None].float() * freqs          # (..., seq, hd/2)
    return (torch.sin(angles)[..., None, :],               # broadcast heads
            torch.cos(angles)[..., None, :])


def rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
           ) -> torch.Tensor:
    """``apply_rope``'s rotation by ``rope_sin_cos``'s tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
    }


SWIGLU_AXES = {
    "w_gate": ("fsdp", "mlp"),
    "w_up": ("fsdp", "mlp"),
    "w_down": ("mlp", "fsdp"),
}


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    h = F.silu(gate.float()).to(x.dtype) * up      # silu in f32, cast back
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Cross entropy (reductions in f32)
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy.  logits (..., V) any float dtype."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
