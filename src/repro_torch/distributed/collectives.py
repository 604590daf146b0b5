"""The mesh's explicit collectives, and the bytes they move.

A sharded tensor of the port is one torch tensor per shard
(``distributed.sharding.Sharded``); a collective takes the participants'
tensors in mesh order and returns one result per participant, on that
participant's device.  Participants on one device share one result tensor
(its values are what each would hold); pools are never passed here, so no
mutable state is shared that way.

- ``all_reduce``: the sum of the partials, added in participant order in
  the partials' own dtype (``acc = p0; acc = acc + p1; ...``), so the
  result does not depend on where the shards sit.
- ``all_gather``: the pieces concatenated along one dimension (vocab-split
  logits, heads).
- ``broadcast_rows``: every data replica's rows to every other, concatenated
  in data order — the row broadcast that keeps a tensor-parallel engine's
  data replicas of one pool byte-equal (each writes every row's K/V).
- ``gather_to``: the pieces concatenated on one device (the sampled rows'
  logits to the device that samples).
- ``permute``: block bytes copied from one shard's pool to another's (the
  data-parallel engine's intra-mesh moves).

The first three take a ``kind``: the tensor-parallel steps count the
exchanges of the ssm, hybrid and moe families under their own kinds —
``ssm-conv-all-gather`` (the pre-conv x channels), ``ssm-norm-all-reduce``
(the gated norm's sums of squares), ``moe-router-all-gather`` (the router
logits), ``moe-expert-all-gather`` (the expert outputs) and
``moe-row-gather`` (every data replica's rows into one dispatch).

Each call with more than one participant adds to a process-wide count of
calls and bytes by kind: the bytes of the result as one participant holds
it (the reference's per-device convention for HLO collectives), once per
call.  A one-participant call moves nothing and counts nothing.
``collective_bytes()`` reports ``{"total_bytes", "per_kind", "counts"}``,
the reference's shape; the reference parses them from compiled HLO, which
the port has none of (its parser's counterpart comes with the dry run).
"""
from __future__ import annotations

from collections import defaultdict

import torch

from repro_torch.distributed.sharding import Sharded, shard_slice

_BYTES: dict[str, int] = defaultdict(int)
_COUNTS: dict[str, int] = defaultdict(int)


def reset_collectives() -> None:
    _BYTES.clear()
    _COUNTS.clear()


def collective_bytes() -> dict:
    """Bytes and calls by kind since the last ``reset_collectives``."""
    return {"total_bytes": sum(_BYTES.values()),
            "per_kind": dict(_BYTES), "counts": dict(_COUNTS)}


def _count(kind: str, t: torch.Tensor, n: int) -> None:
    if n > 1:
        _BYTES[kind] += t.numel() * t.element_size()
        _COUNTS[kind] += 1


def _replicate(t: torch.Tensor, parts: list[torch.Tensor]
               ) -> list[torch.Tensor]:
    """``t`` on each participant's device (one copy per other device)."""
    on: dict[torch.device, torch.Tensor] = {t.device: t}
    for p in parts:
        if p.device not in on:
            on[p.device] = t.to(p.device)
    return [on[p.device] for p in parts]


def all_reduce(parts: list[torch.Tensor], kind: str = "all-reduce"
               ) -> list[torch.Tensor]:
    """Sum over the participants, in their order, in the partials' dtype."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    _count(kind, acc, len(parts))
    return _replicate(acc, parts)


def all_gather(parts: list[torch.Tensor], dim: int,
               kind: str = "all-gather") -> list[torch.Tensor]:
    """The pieces concatenated along ``dim``, on every participant."""
    dev = parts[0].device
    out = parts[0] if len(parts) == 1 else \
        torch.cat([p.to(dev) for p in parts], dim=dim)
    _count(kind, out, len(parts))
    return _replicate(out, parts)


def broadcast_rows(parts: list[torch.Tensor], kind: str = "row-broadcast"
                   ) -> list[torch.Tensor]:
    """Every data replica's rows (dim 0) on every replica, in data order."""
    dev = parts[0].device
    out = parts[0] if len(parts) == 1 else \
        torch.cat([p.to(dev) for p in parts], dim=0)
    _count(kind, out, len(parts))
    return _replicate(out, parts)


def gather_to(parts: list[torch.Tensor], device, dim: int = 0
              ) -> torch.Tensor:
    """The pieces concatenated along ``dim`` on ``device``."""
    out = parts[0].to(device) if len(parts) == 1 else \
        torch.cat([p.to(device) for p in parts], dim=dim)
    _count("gather", out, len(parts))
    return out


def permute(src: torch.Tensor, dst: torch.Tensor, idx_src: torch.Tensor,
            idx_dst: torch.Tensor, dim: int = 1) -> None:
    """Copy ``src``'s slices ``idx_src`` along ``dim`` into ``dst`` in place
    (raw bytes, any dtype), across devices if they differ."""
    payload = src.view(torch.uint8).index_select(dim, idx_src)
    dst.view(torch.uint8).index_copy_(dim, idx_dst,
                                      payload.to(dst.device))
    _count("collective-permute", payload, 2)


def reshard(x: Sharded, spec) -> Sharded:
    """``x`` (a ``Sharded``) split as ``spec`` instead: a dimension ``x``
    splits over a mesh axis that ``spec`` does not is all-gathered over
    that axis; one that ``spec`` splits and ``x`` does not is sliced
    locally (no bytes move)."""
    spec = tuple(spec) + ((),) * (x.ndim - len(spec))
    if spec == x.spec:
        return x
    mesh = x.mesh
    d, m = mesh.shape["data"], mesh.shape["model"]
    shards = list(x.shards)
    cur = list(x.spec)
    for k, axes in enumerate(x.spec):
        if not axes or axes == spec[k]:
            continue
        (a,) = axes
        groups = ([[i * m + j for i in range(d)] for j in range(m)]
                  if a == "data" else
                  [[i * m + j for j in range(m)] for i in range(d)])
        for g in groups:
            for idx, t in zip(g, all_gather([shards[n] for n in g], k)):
                shards[idx] = t
        cur[k] = ()
    for k, axes in enumerate(spec):
        if axes and not cur[k]:
            one = tuple(() if n != k else axes for n in range(x.ndim))
            for n in range(len(shards)):
                i, j = divmod(n, m)
                shards[n] = shards[n][shard_slice(
                    mesh, one, x.shape, i, j)].contiguous()
            cur[k] = axes
    return Sharded(mesh, spec, shards, x.shape)
