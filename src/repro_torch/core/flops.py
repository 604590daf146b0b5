"""FLOP / parameter accounting for the paper's RF / RP metrics (the port of
``repro.core.flops``).

RP is a parameter count over the tree.  RF counts the forward's FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` over the plain forward
(``use_kernels=False``) on the meta device: shapes only, nothing computed,
so a full-width model costs nothing to count.  The counter sees the matrix
products (einsum lowers to mm / bmm), not the elementwise work, which XLA's
cost analysis in the reference also counts; a kernel launched through
ctypes would be invisible to it, which is why the plain forward is counted
(the reference's default ``use_pallas=False`` counts the XLA path too).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.graph import tree_map_paths, tree_paths


def param_count(params) -> int:
    return int(sum(x.numel() for _, x in tree_paths(params)))


def _meta(tree):
    return tree_map_paths(
        lambda _, x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)


def model_forward_flops(model, params, batch) -> float:
    """Matrix-product FLOPs of one plain forward of ``batch``."""
    plain = type(model)(model.cfg.replace(use_kernels=False))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        plain.forward(_meta(params), _meta(batch))
    return float(counter.get_total_flops())


def rf_rp(model_before, params_before, model_after, params_after,
          batch_before, batch_after=None) -> dict:
    """Paper Eq. 15/16: RF = FLOPs_before / FLOPs_after, RP likewise."""
    batch_after = batch_after if batch_after is not None else batch_before
    f0 = model_forward_flops(model_before, params_before, batch_before)
    f1 = model_forward_flops(model_after, params_after, batch_after)
    p0 = param_count(params_before)
    p1 = param_count(params_after)
    return {
        "flops_before": f0, "flops_after": f1, "RF": f0 / max(f1, 1.0),
        "params_before": p0, "params_after": p1, "RP": p0 / max(p1, 1),
    }
