"""Carry parameters and configs of the JAX reference into the port.

The caller hands over the JAX parameter pytree **as numpy arrays**
(``jax.tree.map(np.asarray, params)``) and the reference ``ArchConfig``
as a dict (``dataclasses.asdict``); this module itself imports no JAX.
Key paths, the stacked ``(L, ...)`` layer layout, the 3-D head layouts
and the dtypes are kept — for the SSM leaves too: ``w_x``/``w_z``
``(L, d, nh, hp)``, ``w_out`` ``(L, nh, hp, d)``, and ``A_log``, ``D``,
``dt_bias`` in f32 whatever the model dtype; and for the MoE leaves:
``moe.router`` ``(L, d, E)`` and ``moe.shared.gate`` ``(L, d, 1)`` in f32,
``w_gate`` / ``w_up`` ``(L, E, d, f)``, ``w_down`` ``(L, E, f, d)``; and
for the front ends: the audio family's ``frame_proj`` ``(512, d)`` (no
``tok_embed``), the vlm family's ``vision_proj`` ``(vision_embed_dim, d)``
and an encoder's classifier ``head`` ``(d, vocab)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def to_tensor(a, device="cpu") -> torch.Tensor:
    """One numpy array -> a tensor that owns its memory.

    ``ml_dtypes`` arrays (bfloat16, float8) do not go through
    ``torch.from_numpy``: they are reinterpreted as same-width unsigned
    integers and viewed back as the torch dtype.  Always copies, because
    arrays exported from JAX are read-only buffers."""
    a = np.asarray(a)
    name = a.dtype.name
    if name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    elif name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of ``to_tensor`` for dtypes numpy knows; bf16/fp8 come back
    as their raw bits (uint16 / uint8) so a round trip can be compared
    bit for bit."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def convert_params(tree: Any, device="cpu") -> Any:
    """Nested dict / list of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: convert_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [convert_params(v, device) for v in tree]
    return to_tensor(tree, device)


def convert_config(jax_cfg: dict) -> ArchConfig:
    """Reference ``ArchConfig`` (as a dict) -> the port's ``ArchConfig``.
    ``use_pallas`` has no meaning here and is dropped: the port runs its
    kernels whenever the tensors are on the CUDA device."""
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {}
    for k, v in jax_cfg.items():
        if k == "use_pallas":
            continue
        if k not in fields:
            raise KeyError(f"unknown ArchConfig field {k!r}")
        kw[k] = tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                      for x in v) if isinstance(v, (list, tuple)) else v
    return ArchConfig(**kw)
