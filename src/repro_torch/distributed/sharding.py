"""Logical-axis sharding rules (MaxText-style) and the port's sharded tensors.

Model code names each array dimension by a *logical* axis ("batch",
"heads", "kv_heads", "mlp", "vocab", ...).  A ``ShardingRules`` table maps
each logical name to zero or more *mesh* axes; ``spec`` turns a tuple of
logical names into one tuple of mesh axes per dimension — the port's
stand-in for a ``PartitionSpec`` (``()`` = replicated).  The rule tables
and the fitting logic are the reference's (``repro.distributed.sharding``).

The reference's ``constrain`` has no counterpart: no compiler partitions
the port's code.  Every placement is explicit — ``place`` cuts a tensor
into one torch tensor per shard of a ``launch.mesh.Mesh``, a
:class:`Sharded`, and the tensor-parallel steps (``distributed.
tensor_parallel``) and the paged-attention shard wrap
(``kernels.paged_attention.ops``) move data between shards only through
the explicit collectives of ``distributed.collectives``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

# Default logical->mesh rules for the single-pod (data, model) mesh.
SINGLE_POD_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("data",),
    "seq": (),
    "seq_q": (),             # context-parallel attention (e.g. heads don't
                             # divide the model axis: phi3 40H vs 16-way TP)
    "seq_sp": (),            # Megatron-style sequence-parallel residual
                             # stream (shards the remat stash)
    "kv_seq": (),            # overridden to ("data",) for long-context decode
    "embed": (),
    "fsdp": ("data",),       # dim-0 of big params (fully-sharded data parallel)
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "expert": ("model",),
    "expert_mlp": (),
    "vocab": ("model",),
    "conv_io": (),
    "ssm_heads": ("model",),
    "ssm_state": (),
    "layers": (),
    "capacity": ("data",),   # MoE dispatch-group axis (size-1 when grouped
                             # dispatch is off -> auto-replicated)
    # serving engine (repro.serve): request slots are data-parallel, the
    # paged block pools shard over kv_heads (tensor parallel) and the
    # block-address axes stay replicated (DESIGN.md §10).  Quantized
    # caches add scale pools that reuse these same rules — their
    # (layers, serve_blocks, offset, kv_heads) axes are the KV pools'
    # minus head_dim, so a tensor shard holding a kv-head's bytes holds
    # its scales with no extra rule (DESIGN.md §11)
    "serve_batch": ("data",),
    "serve_blocks": (),
}

# Multi-pod (pod, data, model): batch/fsdp additionally span the pod axis.
MULTI_POD_RULES: dict[str, tuple[str, ...]] = dict(
    SINGLE_POD_RULES,
    batch=("pod", "data"),
    fsdp=("pod", "data"),
    capacity=("pod", "data"),
)

Spec = tuple[tuple[str, ...], ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Immutable logical-axis -> mesh-axes mapping."""

    rules: Mapping[str, tuple[str, ...]]
    axis_sizes: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @staticmethod
    def for_mesh(mesh, overrides: Mapping[str, tuple[str, ...]] | None = None
                 ) -> "ShardingRules":
        """Rules for ``mesh`` (anything with ``axis_names`` and a
        ``devices.shape``): the multi-pod table when the mesh has a "pod"
        axis, ``overrides`` applied, and every mesh axis the mesh lacks
        dropped, so the same model code runs on every mesh."""
        base = MULTI_POD_RULES if "pod" in mesh.axis_names else \
            SINGLE_POD_RULES
        rules = dict(base)
        if overrides:
            rules.update(overrides)
        rules = {k: tuple(a for a in v if a in mesh.axis_names)
                 for k, v in rules.items()}
        sizes = {a: int(s) for a, s in zip(mesh.axis_names,
                                           mesh.devices.shape)}
        return ShardingRules(rules, sizes)

    def _fit(self, axes: tuple[str, ...], dim: int | None
             ) -> tuple[str, ...]:
        """Drop trailing mesh axes until the dim size divides evenly:
        replication on the offending axis is the standard fallback (Megatron
        replicates KV heads when tp > kv_heads, odd vocab sizes replicate
        over tensor)."""
        if dim is None or not self.axis_sizes:
            return axes
        while axes:
            prod = 1
            for a in axes:
                prod *= self.axis_sizes.get(a, 1)
            if dim % prod == 0:
                return axes
            axes = axes[:-1]
        return axes

    def spec(self, logical_axes: Sequence[str | None],
             shape: Sequence[int] | None = None) -> Spec:
        """One tuple of mesh axes per dimension (``()``: replicated).  A
        mesh axis already used by an earlier dimension is dropped; with
        ``shape``, each dimension keeps only axes whose product divides
        it (``_fit``)."""
        parts = []
        used: set[str] = set()
        for i, name in enumerate(logical_axes):
            if name is None:
                parts.append(())
                continue
            axes = tuple(a for a in self.rules.get(name, ()) if a not in used)
            axes = self._fit(axes, shape[i] if shape is not None else None)
            used.update(axes)
            parts.append(axes)
        return tuple(parts)


# The rules (and the concrete mesh) installed for the duration of a sharded
# call.  ``None`` means "no mesh": every call runs unsharded.  The mesh is
# what the paged-attention shard wrap reads to launch the kernel per shard.
_ACTIVE: ShardingRules | None = None
_ACTIVE_MESH = None


class use_rules:
    """Context manager installing sharding rules (and optionally the
    concrete mesh) for the calls made inside it."""

    def __init__(self, rules: ShardingRules | None, mesh=None):
        self.rules = rules
        self.mesh = mesh
        self._prev: ShardingRules | None = None
        self._prev_mesh = None

    def __enter__(self):
        global _ACTIVE, _ACTIVE_MESH
        self._prev, self._prev_mesh = _ACTIVE, _ACTIVE_MESH
        _ACTIVE, _ACTIVE_MESH = self.rules, self.mesh
        return self.rules

    def __exit__(self, *exc):
        global _ACTIVE, _ACTIVE_MESH
        _ACTIVE, _ACTIVE_MESH = self._prev, self._prev_mesh
        return False


def active_rules() -> ShardingRules | None:
    return _ACTIVE


def active_mesh():
    return _ACTIVE_MESH


def _is_axes_leaf(t) -> bool:
    return isinstance(t, tuple)


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over a logical-axes tree (tuples are leaves)
    and trees of the same structure (nested dicts)."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    return {k: tree_map_axes(fn, v, *(t[k] for t in trees))
            for k, v in axes_tree.items()}


def tree_specs(rules: ShardingRules, axes_tree, shaped_tree=None):
    """Logical-axes tree -> a tree of specs, divisibility-aware when a
    matching tree of shaped values (tensors, or anything with ``.shape``) is
    given — the counterpart of the reference's ``tree_shardings``.  Shared
    by the serving engine's placement of parameters and pools."""
    if shaped_tree is None:
        return tree_map_axes(lambda ax: rules.spec(ax), axes_tree)
    return tree_map_axes(lambda ax, x: rules.spec(ax, shape=x.shape),
                         axes_tree, shaped_tree)


@dataclasses.dataclass
class Sharded:
    """A tensor of a mesh: one torch tensor per shard, in mesh order (flat
    index ``i * model + j`` for data index i and model index j), each on
    its shard's device.  ``spec`` names the mesh axes each dimension is
    split over (``()``: replicated, so every shard holds all of it);
    ``shape`` is the global shape.  Replicas of a read-only tensor on one
    device may share storage; ``place(..., copy=True)`` never shares."""
    mesh: Any
    spec: Spec
    shards: list[torch.Tensor]
    shape: tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def local(self, i: int, j: int) -> torch.Tensor:
        return self.shards[i * self.mesh.shape["model"] + j]


def shard_slice(mesh, spec: Spec, shape: Sequence[int], i: int, j: int
                ) -> tuple[slice, ...]:
    """The index of shard (i, j)'s piece of a tensor of ``shape`` split as
    ``spec``.  Each dimension is split over at most one mesh axis (the
    serving rules of a (data, model) mesh never name two)."""
    coord = {"data": i, "model": j}
    out = []
    for dim, axes in zip(shape, spec):
        if not axes:
            out.append(slice(None))
            continue
        if len(axes) != 1:
            raise NotImplementedError(f"dimension split over {axes}")
        n = mesh.shape[axes[0]]
        if n == 1:
            out.append(slice(None))
            continue
        size = dim // n
        c = coord[axes[0]]
        out.append(slice(c * size, (c + 1) * size))
    return tuple(out)


def place(x: torch.Tensor, mesh, spec: Spec, copy: bool = False) -> Sharded:
    """Cut ``x`` into one tensor per shard of ``mesh`` as ``spec`` says, each
    on its shard's device.  A split piece is a contiguous copy; a piece
    that is all of ``x`` shares its storage when it stays on ``x``'s device,
    unless ``copy`` (pools: every shard owns its bytes).  Without ``copy``,
    the replicas of one split piece on one device (a tensor split over
    ``model`` and replicated over ``data``) share one copy too."""
    spec = tuple(spec) + ((),) * (x.ndim - len(spec))
    shards, made = [], {}
    for k, dev in enumerate(mesh.devices.flat):
        i, j = divmod(k, mesh.shape["model"])
        idx = shard_slice(mesh, spec, x.shape, i, j)
        key = (dev, tuple((s.start, s.stop) for s in idx))
        if key in made and not copy:
            shards.append(made[key])
            continue
        piece = x[idx]
        whole = all(s == slice(None) for s in idx)
        if whole and not copy:
            shards.append(piece.to(dev))
        else:
            shards.append(piece.to(dev, copy=True).contiguous())
        made[key] = shards[-1]
    return Sharded(mesh, spec, shards, tuple(x.shape))


def gather(s: Sharded, device=None) -> torch.Tensor:
    """The global tensor from its shards (on ``device``, default the first
    shard's), each piece taken from the first shard that holds it.  For
    tests and audits; the serving path never calls it."""
    device = s.shards[0].device if device is None else device
    split = {a for axes in s.spec for a in axes}
    d = s.mesh.shape["data"] if "data" in split else 1
    m = s.mesh.shape["model"] if "model" in split else 1
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    for i in range(d):
        for j in range(m):
            out[shard_slice(s.mesh, s.spec, s.shape, i, j)] = \
                s.local(i, j).to(device)
    return out


def place_tree(tree, mesh, specs, copy: bool = False):
    """``place`` over a tree of tensors and a matching tree of specs."""
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, specs[k], copy) for k, v in
                tree.items()}
    return place(tree, mesh, specs, copy)


def local_tree(tree, k: int):
    """Shard ``k``'s tensors of a tree of :class:`Sharded` (views, no
    copy)."""
    if isinstance(tree, dict):
        return {n: local_tree(v, k) for n, v in tree.items()}
    return tree.shards[k]
