"""Tensor parallelism of the dense decoder over a serving mesh: the paged
decode, prefill and verify steps of ``models.transformer`` run shard by
shard on parameters and pools placed by ``distributed.sharding.place``.

The counterpart of the reference engine's GSPMD-partitioned jit
(``repro/serve/engine.py``'s ``_jit_shardings`` / ``_trace_ctx``): where
XLA partitions one program and inserts the collectives, the port runs
every shard's part of each layer in mesh order and calls the explicit
collectives of ``distributed.collectives``.  Megatron's split, as the serve
rules place the parameters (a dimension that does not divide the model
axis replicates, and its product needs no reduction):

- ``wq`` by heads, ``wk`` / ``wv`` by kv heads (columns); ``wo`` by rows
  (heads), then an all-reduce;
- ``w_gate`` / ``w_up`` by ``mlp`` columns, ``w_down`` by rows, then an
  all-reduce;
- ``tok_embed`` by vocab rows: a masked lookup (rows outside the shard's
  range read zeros), then an all-reduce;
- the head (or the tied embedding) by vocab: each shard's logits, then an
  all-gather before sampling;
- norms replicated.

Partial sums are added in model-shard order (shard 0 + shard 1 + ...), in
the partial's own dtype.  Request rows split over the data axis when the
slot count divides it (else every data replica runs every row).  The KV
pools are global (one ``PagedCache``): every data replica of a model
shard's pool holds every slot's blocks, so each layer's new K/V rows are
broadcast between the data replicas (``broadcast_rows``) and each replica
writes all of them — the replicas stay byte-equal.  Attention goes through
the paged-attention shard wrap (``kernels.paged_attention.ops``), which
launches K1 once per shard.  The logits of every row are gathered to the
mesh's first device, where the engine samples as on one device.

Only the dense family (attention + SwiGLU, no experts, no SSM heads) is
partitioned: the ssm, hybrid and moe families need hand-written
reductions inside the gated RMSNorm and the expert dispatch (ROADMAP
Queue 1).  On a one-shard mesh every collective is the identity and each
step computes exactly what the unsharded step computes.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (
    Sharded, active_mesh, active_rules)
from repro_torch.kernels.paged_attention import (
    paged_attention, paged_prefill_attention)
from repro_torch.models.attention import kv_write_index, scatter_kv_at
from repro_torch.models.layers import rms_norm, rope_sin_cos, rotate, swiglu


def supports(cfg) -> bool:
    """Whether ``cfg``'s family is partitioned here (the dense decoder)."""
    return (cfg.family == "dense" and not cfg.hybrid and not cfg.n_experts
            and not cfg.is_encoder)


class _Step:
    """One sharded device call: the mesh, the rows of each data replica,
    and each shard's copy of the call's row operands."""

    def __init__(self, params: dict, B: int):
        self.mesh, self.rules = active_mesh(), active_rules()
        if self.mesh is None or self.rules is None:
            raise RuntimeError("a tensor-parallel step runs under "
                               "use_rules(rules, mesh=mesh)")
        self.d = self.mesh.shape["data"]
        self.m = self.mesh.shape["model"]
        self.devs = list(self.mesh.devices.flat)
        self.B = B
        self.bspec = self.rules.spec(("serve_batch",), shape=(B,))[0]
        n = B // self.d
        self.rows = [slice(i * n, (i + 1) * n) if self.bspec else slice(None)
                     for i in range(self.d)]
        self.params = params

    def groups(self):
        """Shard indices of each data replica's model group."""
        return [[i * self.m + j for j in range(self.m)]
                for i in range(self.d)]

    def local(self, x: torch.Tensor, all_rows: bool = False
              ) -> list[torch.Tensor]:
        """A global row operand's piece on every shard: its data replica's
        rows (all of them with ``all_rows``), on the shard's device."""
        out, on = [], {}
        for k, dev in enumerate(self.devs):
            r = slice(None) if all_rows else self.rows[k // self.m]
            key = (dev, r.start)
            if key not in on:
                on[key] = x[r].to(dev)
            out.append(on[key])
        return out

    def weights(self, leaf: Sharded, layer: int | None = None
                ) -> list[torch.Tensor]:
        return [t if layer is None else t[layer] for t in leaf.shards]

    def reduce_model(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """All-reduce over the model axis within each data replica."""
        out = [None] * len(parts)
        for g in self.groups():
            for k, t in zip(g, coll.all_reduce([parts[n] for n in g])):
                out[k] = t
        return out

    def gather_model(self, parts: list[torch.Tensor], dim: int
                     ) -> list[torch.Tensor]:
        out = [None] * len(parts)
        for g in self.groups():
            for k, t in zip(g, coll.all_gather([parts[n] for n in g], dim)):
                out[k] = t
        return out

    def all_rows(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every row of a per-replica row tensor on every shard: the row
        broadcast between data replicas (nothing moves when every replica
        already runs every row)."""
        if not self.bspec or self.d == 1:
            return parts
        out = [None] * len(parts)
        for j in range(self.m):
            g = [i * self.m + j for i in range(self.d)]
            for k, t in zip(g, coll.broadcast_rows([parts[n] for n in g])):
                out[k] = t
        return out

    def to_primary(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every row of the model-replicated ``parts`` on the mesh's first
        device (data replica 0's when every replica runs every row)."""
        if not self.bspec:
            return parts[0]
        return coll.gather_to([parts[i * self.m] for i in range(self.d)],
                              self.devs[0])


def _embed(st: _Step, tokens: torch.Tensor) -> list[torch.Tensor]:
    """Token embeddings of each shard's rows: a masked lookup of the
    shard's vocab rows, then the all-reduce, when the vocab is split."""
    emb = st.params["tok_embed"]
    toks = st.local(tokens.long())
    if not emb.spec[0]:
        return [e[t] for e, t in zip(emb.shards, toks)]
    V = emb.shape[0] // st.m
    parts = []
    for k, (e, t) in enumerate(zip(emb.shards, toks)):
        idx = t - (k % st.m) * V
        ok = (idx >= 0) & (idx < V)
        x = e[idx.clamp(0, V - 1)]
        parts.append(torch.where(ok[..., None], x, torch.zeros(
            (), dtype=x.dtype, device=x.device)))
    return st.reduce_model(parts)


def _logits(st: _Step, h: list[torch.Tensor], cfg) -> torch.Tensor:
    """(B, S, V) logits on the first device: each shard's vocab columns,
    all-gathered over the model axis, then every replica's rows."""
    p = st.params
    tied = not (cfg.is_encoder or not cfg.tie_embeddings)
    w = p["tok_embed"] if tied else p["head"]
    parts = [torch.einsum("bsd,vd->bsv", x, t) if tied else
             torch.einsum("bsd,dv->bsv", x, t)
             for x, t in zip(h, w.shards)]
    if w.spec[0 if tied else 1]:
        parts = st.gather_model(parts, -1)
    return st.to_primary(parts)


def _layers(st: _Step, cfg, cache: dict, x: list[torch.Tensor],
            positions: torch.Tensor, tables: torch.Tensor,
            valid: torch.Tensor | None) -> list[torch.Tensor]:
    """Every layer on every shard.  positions (B, C); ``valid`` (B,) for a
    chunk (prefill / verify), None for a decode step (C = 1).  Returns each
    shard's hidden states after the final norm."""
    L = cfg.num_layers
    lay = st.params["layers"]
    ap, mp = lay["attn"], lay["mlp"]
    C = positions.shape[1]
    chunk = valid is not None
    pos_loc = st.local(positions)
    pos_all = st.local(positions, all_rows=True)
    tab_loc = st.local(tables)
    tab_all = st.local(tables, all_rows=True)
    if chunk:
        inchunk = torch.arange(C, device=valid.device)[None, :] \
            < valid[:, None]
        inchunk_all = st.local(inchunk, all_rows=True)
        starts = positions[:, 0].to(torch.int32).contiguous()
        row_ops = (starts, (starts + valid).to(torch.int32))
    else:
        inchunk_all = [None] * len(st.devs)
        row_ops = ((positions[:, 0] + 1).to(torch.int32),)
    row_ops = [Sharded(st.mesh, (st.bspec,), st.local(r), (st.B,))
               for r in row_ops]
    tab_sh = Sharded(st.mesh, (st.bspec, ()), tab_loc, tuple(tables.shape))
    heads = ap["wq"].spec[2]
    H = ap["wq"].shape[2]
    q_spec = (st.bspec, (), heads, ()) if chunk else (st.bspec, heads, ())
    quant = "k_scale" in cache
    # the step's K/V write index and RoPE tables depend on the positions
    # only: each shard takes them once for every layer
    widx = [kv_write_index(t, p, cache["k"].shape[2], c)
            for t, p, c in zip(tab_all, pos_all, inchunk_all)]
    rope = [None] * len(st.devs)
    h = x
    for l in range(L):
        hn = [rms_norm(t, w, cfg.norm_eps)
              for t, w in zip(h, st.weights(lay["ln1"], l))]
        qs, ks, vs = [], [], []
        for k, t in enumerate(hn):
            q = torch.einsum("bsd,dhk->bshk", t, ap["wq"].shards[k][l])
            kk = torch.einsum("bsd,dhk->bshk", t, ap["wk"].shards[k][l])
            vv = torch.einsum("bsd,dhk->bshk", t, ap["wv"].shards[k][l])
            if cfg.qk_norm:
                q = rms_norm(q, ap["q_norm"].shards[k][l], cfg.norm_eps)
                kk = rms_norm(kk, ap["k_norm"].shards[k][l], cfg.norm_eps)
            if rope[k] is None:
                rope[k] = rope_sin_cos(q, pos_loc[k], cfg.rope_theta)
            qs.append(rotate(q, *rope[k]))
            ks.append(rotate(kk, *rope[k]))
            vs.append(vv)
        ks, vs = st.all_rows(ks), st.all_rows(vs)
        pools = {n: [t[l] for t in cache[n].shards] for n in cache}
        for k in range(len(st.devs)):
            scatter_kv_at({n: pools[n][k] for n in pools}, ks[k], vs[k],
                          widx[k])
        pool_sh = {n: Sharded(st.mesh, cache[n].spec[1:], pools[n],
                              cache[n].shape[1:]) for n in pools}
        q_sh = Sharded(st.mesh, q_spec,
                       [q if chunk else q[:, 0] for q in qs],
                       (st.B, C, H, cfg.head_dim_) if chunk
                       else (st.B, H, cfg.head_dim_))
        attend = paged_prefill_attention if chunk else paged_attention
        o = attend(q_sh, pool_sh["k"], pool_sh["v"], tab_sh, *row_ops,
                   use_kernel=cfg.use_kernels,
                   k_scale=pool_sh["k_scale"] if quant else None,
                   v_scale=pool_sh["v_scale"] if quant else None)
        o = coll.reshard(o, q_spec).shards
        part = [torch.einsum("bshk,hkd->bsd", t if chunk else t[:, None],
                             w) for t, w in zip(o, st.weights(ap["wo"], l))]
        if heads:
            part = st.reduce_model(part)
        h = [a + b for a, b in zip(h, part)]
        hn = [rms_norm(t, w, cfg.norm_eps)
              for t, w in zip(h, st.weights(lay["ln2"], l))]
        part = [swiglu({n: mp[n].shards[k][l] for n in mp}, t)
                for k, t in enumerate(hn)]
        if mp["w_gate"].spec[2]:
            part = st.reduce_model(part)
        h = [a + b for a, b in zip(h, part)]
    return [rms_norm(t, w, cfg.norm_eps)
            for t, w in zip(h, st.weights(st.params["final_norm"]))]


def paged_decode_step(params: dict, cfg, cache: dict, tokens: torch.Tensor,
                      positions: torch.Tensor, block_tables: torch.Tensor,
                      active: torch.Tensor | None = None):
    """``models.transformer.paged_decode_step`` over the active mesh:
    ``params`` and ``cache`` are trees of ``Sharded``, the row operands
    global tensors on the mesh's first device.  Returns (logits (B, V) on
    that device, the cache, written in place)."""
    del active                      # only the recurrent state reads it
    st = _Step(params, tokens.shape[0])
    h = _layers(st, cfg, cache, _embed(st, tokens[:, None]),
                positions[:, None], block_tables, None)
    return _logits(st, h, cfg)[:, 0], cache


def _chunk(params, cfg, cache, tokens, positions, block_tables, valid):
    st = _Step(params, tokens.shape[0])
    return st, _layers(st, cfg, cache, _embed(st, tokens), positions,
                       block_tables, valid)


def paged_prefill_step(params: dict, cfg, cache: dict, tokens, positions,
                       slots, block_tables, valid):
    """``models.transformer.paged_prefill_step`` over the active mesh: the
    logits of each row's last valid token (B, V) on the first device."""
    del slots                       # only the recurrent state reads it
    st, h = _chunk(params, cfg, cache, tokens, positions, block_tables,
                   valid)
    last = st.local((valid.long() - 1).clamp(min=0))
    h = [torch.gather(t, 1, i[:, None, None].expand(-1, 1, t.shape[-1]))
         for t, i in zip(h, last)]
    return _logits(st, h, cfg)[:, 0], cache


def paged_verify_step(params: dict, cfg, cache: dict, tokens, positions,
                      slots, block_tables, valid):
    """``models.transformer.paged_verify_step`` over the active mesh: the
    logits of every position (B, C, V) on the first device."""
    del slots
    st, h = _chunk(params, cfg, cache, tokens, positions, block_tables,
                   valid)
    return _logits(st, h, cfg), cache
