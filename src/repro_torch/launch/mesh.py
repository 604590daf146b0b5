"""Serving meshes: a (data, model) grid of devices, and the serving rules.

The reference's mesh is a ``jax.sharding.Mesh`` of XLA devices; its
multi-device tests force several logical host devices on one CPU.  The
port's :class:`Mesh` is a single-controller logical mesh: a grid of
``torch.device`` entries, possibly all the same device (``[cuda:0] * 4``
is four shards on one card, ``[cpu] * 4`` four on the CPU), that one host
program drives shard by shard.  Where a host has several cards, the same
code spreads the shards over them.

``make_serve_mesh(devices=None)`` takes the CUDA devices and raises the
reference's errors when there are too few; tests and ``chip_smoke.py``
pass ``devices=`` explicitly.  The dry run's ``arch_rules`` and
``make_production_mesh`` come with the dry run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingRules


class Mesh:
    """A grid of devices with named axes, like ``jax.sharding.Mesh``:
    ``devices`` is a numpy object array of ``torch.device`` of shape
    ``(data, model)``, ``axis_names`` its axes, ``shape`` the axis sizes by
    name.  Shards are numbered in mesh order: ``i * model + j``."""

    def __init__(self, devices: np.ndarray, axis_names=("data", "model")):
        self.devices = np.vectorize(torch.device, otypes=[object])(devices)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, {devs})"


def _devices(devices) -> list[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_test_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Every device on the data axis (tests / smoke runs)."""
    devs = _devices(devices)
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n], dtype=object).reshape(n, 1))


def make_serve_mesh(data: int = 0, model: int = 1, devices=None) -> Mesh:
    """(data, model) mesh for the serving engine over ``devices`` (default:
    the CUDA devices).  ``data=0`` takes every device not claimed by the
    model axis (the ``--mesh auto`` default)."""
    devs = _devices(devices)
    n = len(devs)
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide {n} devices")
    if data == 0:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, "
                         f"have {n}")
    return Mesh(np.array(devs[:data * model], dtype=object)
                .reshape(data, model))


def mesh_dims(spec: str) -> tuple[int, int]:
    """'DxM' -> (D, M)."""
    try:
        data, model = (int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants 'DxM' or 'auto', got {spec!r}")
    return data, model


def parse_mesh(spec: str, devices=None) -> Mesh:
    """'DxM' (e.g. '4x1', '2x2') -> serving mesh; 'auto' -> all devices
    on the data axis."""
    if spec == "auto":
        return make_serve_mesh(devices=devices)
    return make_serve_mesh(*mesh_dims(spec), devices=devices)


def serve_rules(cfg: ArchConfig, mesh, extra: dict | None = None
                ) -> ShardingRules:
    """Sharding rules for the serving engine on a (data, model) mesh.

    Request slots (``serve_batch``) go data-parallel; the paged KV pools
    and the head-sharded parameters go tensor-parallel over ``model`` via
    ``kv_heads``/``heads``.  Head counts that don't divide the model axis
    replicate (Megatron GQA convention).  No FSDP at serve time: each
    data-parallel replica holds the full weights."""
    ov: dict[str, tuple[str, ...]] = {}
    msize = mesh.shape["model"]
    if cfg.n_kv_heads and cfg.n_kv_heads % msize != 0:
        ov["kv_heads"] = ()
    if cfg.n_heads and cfg.n_heads % msize != 0:
        ov["heads"] = ()
    ov["fsdp"] = ()
    if extra:
        ov.update(extra)
    return ShardingRules.for_mesh(mesh, overrides=ov)
