"""int8 gradient compression with error feedback (the port of
``repro.train.compress``).

Each leaf is quantized symmetrically to int8 with one scale
(``max|g| / 127``), dequantized, and the residual is kept and added to the
next step's gradient, so the quantized sum tracks the true sum over steps.
On a multi-device run the all-reduce would sit between quantize and
dequantize; the residual algebra is the same because the residual is taken
against the local quantized value.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import tree_map_paths, tree_paths
from repro_torch.train.optim import f32_zeros


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params):
    return f32_zeros(params)


def compress_grads(grads, error_state):
    """Returns (dequantized grads, new error state)."""
    err_by = dict(tree_paths(error_state))
    new_err = {}

    def one(path, g):
        gf = g.float() + err_by[path]
        deq = dequantize_int8(*quantize_int8(gf))
        new_err[path] = gf - deq
        return deq

    new_g = tree_map_paths(one, grads)
    return new_g, tree_map_paths(lambda path, _: new_err[path], error_state)
