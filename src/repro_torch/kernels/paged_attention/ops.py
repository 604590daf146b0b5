"""Dispatch for paged attention: the CUDA kernel vs the plain version, and
the shard wrap of a serving mesh.

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

Sharded serving: under ``distributed.sharding.use_rules(rules, mesh=mesh)``
with a mesh of more than one device, the call wraps itself — the
counterpart of the reference's ``shard_map`` (``_serve_partition``):
sequences split over the ``serve_batch`` (data) axes that divide B, heads
over the ``kv_heads`` (model) axes that divide both H and KH (the kernel's
GQA tiling needs every shard to hold whole (kv-head, query-group)
bundles), the pools and their scale pools over their kv heads.  The
kernel (or, on the CPU, the plain version) is launched once per shard on
that shard's tensors.  Where the heads do not divide, every shard attends
over all heads of its rows.  Inputs may be global tensors (each shard's
piece is cut from them and the outputs are reassembled into a global
tensor) or ``Sharded`` tensors already placed on the mesh (the tensor-
parallel engine's; the output stays a ``Sharded``, and an input split
other than the wrap needs is resharded through ``distributed.
collectives``).  Attention needs no reduction across shards: every
(sequence, kv-head) pair is computed wholly on one shard.
"""
from __future__ import annotations

import math
import numbers

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    Sharded, active_mesh, active_rules, gather, shard_slice)
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


def _serve_partition(q, k_pool, head: int):
    """(mesh, batch_axes, head_axes) when a serving mesh of more than one
    device is active and at least one axis can split the work; None
    otherwise.  Head axes must divide both H (q's dim ``head``) and KH,
    batch axes B; non-dividing axes drop to replication
    (``ShardingRules._fit``'s fallback)."""
    mesh, rules = active_mesh(), active_rules()
    if mesh is None or rules is None or mesh.size == 1:
        return None
    B, H, KH = _shape(q)[0], _shape(q)[head], _shape(k_pool)[2]

    def fit(name: str, *dims: int) -> tuple[str, ...]:
        axes = tuple(a for a in rules.rules.get(name, ())
                     if a in mesh.axis_names)
        while axes:
            sz = math.prod(mesh.shape[a] for a in axes)
            if all(d % sz == 0 for d in dims):
                return axes
            axes = axes[:-1]
        return ()

    batch_axes = fit("serve_batch", B)
    head_axes = tuple(a for a in fit("kv_heads", H, KH)
                      if a not in batch_axes)
    if not batch_axes and not head_axes:
        return None
    return mesh, batch_axes, head_axes


def _pieces(x, mesh, spec) -> list:
    """Every shard's piece of ``x`` split as ``spec``: cut from a global
    tensor (a contiguous copy on the shard's device), or taken from a
    ``Sharded`` (resharded first when it is split otherwise)."""
    if x is None:
        return [None] * mesh.size
    if isinstance(x, Sharded):
        return collectives.reshard(x, spec).shards
    out = []
    for k, dev in enumerate(mesh.devices.flat):
        i, j = divmod(k, mesh.shape["model"])
        out.append(x[shard_slice(mesh, spec, x.shape, i, j)].to(
            dev, copy=True).contiguous())
    return out


def _shape(x) -> tuple[int, ...]:
    return tuple(x.shape)


def _partition(q, k_pool, use_kernel: bool, head: int):
    """The wrap's partition for this call (``_serve_partition``), or None
    for a plain call.  Global tensors are wrapped on the kernel route only,
    as the reference wraps only its kernel; ``Sharded`` inputs are always
    run per shard — with nothing split (every shard attends over all its
    rows and heads) where no axis divides the work, or the mesh has one
    shard."""
    part = _serve_partition(q, k_pool, head) if use_kernel or \
        isinstance(q, Sharded) else None
    if part is None and isinstance(q, Sharded):
        part = (q.mesh, (), ())
    return part


def _wrapped(call, part, q, k_pool, v_pool, rows, k_scale, v_scale,
             return_visits: bool, chunked: bool):
    """Launch ``call`` once per shard of ``part`` and reassemble.  ``rows``
    are the (B, ...) row operands after the pools (tables, then starts
    and lengths)."""
    mesh, bd, hd = part
    head = 2 if chunked else 1
    q_spec = tuple(bd if n == 0 else hd if n == head else ()
                   for n in range(len(_shape(q))))
    pool_spec = ((), (), hd, ())
    qs = _pieces(q, mesh, q_spec)
    ks = _pieces(k_pool, mesh, pool_spec)
    vs = _pieces(v_pool, mesh, pool_spec)
    kss = _pieces(k_scale, mesh, pool_spec[:3])
    vss = _pieces(v_scale, mesh, pool_spec[:3])
    rs = [_pieces(r, mesh, (bd,) + ((),) * (len(_shape(r)) - 1))
          for r in rows]
    outs, visits = [], []
    for k in range(mesh.size):
        o = call(qs[k], ks[k], vs[k], *(r[k] for r in rs),
                 k_scale=kss[k], v_scale=vss[k])
        if return_visits:
            o, v = o
            visits.append(v)
        outs.append(o)
    B = _shape(q)[0]
    KH = _shape(k_pool)[2]
    out = Sharded(mesh, q_spec, outs,
                  _shape(q)[:-1] + (_shape(v_pool)[-1],))
    vis = Sharded(mesh, (bd, hd), visits, (B, KH)) if return_visits \
        else None
    if not isinstance(q, Sharded):     # a global call: reassemble
        out = gather(out, q.device)
        vis = gather(vis, q.device) if return_visits else None
    return (out, vis) if return_visits else out


def paged_attention(q, k_pool, v_pool, block_tables, kv_lens, *,
                    window=0, scale: float | None = None,
                    use_kernel: bool = True, return_visits: bool = False,
                    k_scale=None, v_scale=None):
    """Decode: q (B, H, D); pools (P, bs, KH, D/DV) -> (B, H, DV).

    ``k_scale``/``v_scale`` (P, bs, KH) mark the pools as quantized: the
    kernel dequantizes while it loads; the plain version dequantizes the
    gathered history.  Under an active serving mesh the call is launched
    once per shard (module docstring)."""
    def call(q, k_pool, v_pool, block_tables, kv_lens, *, k_scale=None,
             v_scale=None):
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

    part = _partition(q, k_pool, use_kernel, head=1)
    if part is None:
        return call(q, k_pool, v_pool, block_tables, kv_lens,
                    k_scale=k_scale, v_scale=v_scale)
    return _wrapped(call, part, q, k_pool, v_pool, (block_tables, kv_lens),
                    k_scale, v_scale, return_visits, chunked=False)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_starts,
                            kv_lens, *, window=0,
                            scale: float | None = None,
                            use_kernel: bool = True,
                            return_visits: bool = False,
                            k_scale=None, v_scale=None):
    """Chunked prefill: q (B, C, H, D) -> (B, C, H, DV).  Under an active
    serving mesh the call is launched once per shard (module docstring)."""
    def call(q, k_pool, v_pool, block_tables, q_starts, kv_lens, *,
             k_scale=None, v_scale=None):
        if use_kernel and q.is_cuda:
            return paged_prefill_attention_kernel(
                q, k_pool, v_pool, block_tables, q_starts, kv_lens,
                window=_static_window(window), scale=scale,
                return_visits=return_visits,
                k_scale=k_scale, v_scale=v_scale)
        if return_visits:
            raise ValueError("visit counts are a kernel-path observable")
        return paged_prefill_attention_reference(
            q, k_pool, v_pool, block_tables, q_starts, kv_lens,
            window=window, scale=scale, k_scale=k_scale, v_scale=v_scale)

    part = _partition(q, k_pool, use_kernel, head=2)
    if part is None:
        return call(q, k_pool, v_pool, block_tables, q_starts, kv_lens,
                    k_scale=k_scale, v_scale=v_scale)
    return _wrapped(call, part, q, k_pool, v_pool,
                    (block_tables, q_starts, kv_lens), k_scale, v_scale,
                    return_visits, chunked=True)
