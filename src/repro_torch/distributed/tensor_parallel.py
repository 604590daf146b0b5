"""Tensor parallelism of the decoder families over a serving mesh: the
paged decode, prefill and verify steps of ``models.transformer`` run shard
by shard on parameters and pools placed by ``distributed.sharding.place``.

The counterpart of the reference engine's GSPMD-partitioned jit
(``repro/serve/engine.py``'s ``_jit_shardings`` / ``_trace_ctx``): where
XLA partitions one program and inserts the collectives, the port runs
every shard's part of each layer in mesh order and calls the explicit
collectives of ``distributed.collectives``.  A layer is composed of halves
as ``models.transformer._decode_layer`` composes them (attention; the SSD
block; attention and the SSD block, added in that order; then SwiGLU or the
MoE block).  Each half reduces only where the serve rules split its
weights (a dimension that does not divide the model axis replicates, and
its product needs no reduction):

- attention: ``wq`` by heads, ``wk`` / ``wv`` by kv heads (columns); ``wo``
  by rows (heads), then an all-reduce; K1 once per shard through the
  paged-attention shard wrap, at the layer's static window;
- the SSD block by ``ssm_heads``: ``w_z`` / ``w_x`` / ``w_dt`` / ``dt_bias``
  / ``A_log`` / ``D`` by heads, ``w_B`` / ``w_C`` / ``conv_w`` replicated.
  The ``conv`` window is replicated over ``model``, so the shards' pre-conv
  x channels are all-gathered and every shard keeps the whole window; the
  scan runs on the shard's heads of the ``state`` pool; the gated RMSNorm
  adds the shards' sums of squares (``split_rms_norm``); ``w_out`` by rows,
  then an all-reduce;
- SwiGLU: ``w_gate`` / ``w_up`` by ``mlp`` columns, ``w_down`` by rows,
  then an all-reduce;
- the MoE block by ``expert`` (``_moe``): router columns all-gathered,
  routing and dispatch on every shard, each shard's experts' rows of the
  dispatch buffer, the expert outputs all-gathered; the shared experts by
  ``mlp``, then an all-reduce.  With the rows split over ``data``, every
  replica's rows join one dispatch (the reference's gspmd capacity);
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
writes all of them — the replicas stay byte-equal.  The per-slot SSM
state splits over the data axis with the rows.  The logits of every row
are gathered to the mesh's first device, where the engine samples as on
one device.

On a one-shard mesh every collective is the identity, no half is split,
and each step computes exactly what the unsharded step computes, in its
order: the unsplit SSD and MoE halves call the unsharded blocks.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (
    Sharded, active_mesh, active_rules)
from repro_torch.kernels.paged_attention import (
    paged_attention, paged_prefill_attention)
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.attention import kv_write_index, scatter_kv_at
from repro_torch.models.layers import rms_norm, rope_sin_cos, rotate, swiglu


def supports(cfg) -> bool:
    """Whether ``cfg``'s family is partitioned here: the decoder families
    that serve (dense, moe, ssm, hybrid), not the encoders."""
    return cfg.family in ("dense", "moe", "ssm", "hybrid") and \
        not cfg.is_encoder


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

    def reduce_model(self, parts: list[torch.Tensor],
                     kind: str = "all-reduce") -> list[torch.Tensor]:
        """All-reduce over the model axis within each data replica."""
        out = [None] * len(parts)
        for g in self.groups():
            for k, t in zip(g, coll.all_reduce([parts[n] for n in g],
                                               kind=kind)):
                out[k] = t
        return out

    def gather_model(self, parts: list[torch.Tensor], dim: int,
                     kind: str = "all-gather") -> list[torch.Tensor]:
        out = [None] * len(parts)
        for g in self.groups():
            for k, t in zip(g, coll.all_gather([parts[n] for n in g], dim,
                                               kind=kind)):
                out[k] = t
        return out

    def all_rows(self, parts: list[torch.Tensor],
                 kind: str = "row-broadcast") -> list[torch.Tensor]:
        """Every row of a per-replica row tensor on every shard: the row
        broadcast between data replicas (nothing moves when every replica
        already runs every row)."""
        if not self.bspec or self.d == 1:
            return parts
        out = [None] * len(parts)
        for j in range(self.m):
            g = [i * self.m + j for i in range(self.d)]
            for k, t in zip(g, coll.broadcast_rows([parts[n] for n in g],
                                                   kind=kind)):
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


def _add(h: list[torch.Tensor], parts: list[torch.Tensor]
         ) -> list[torch.Tensor]:
    return [a + b for a, b in zip(h, parts)]


def _at(tree: dict, k: int, layer: int) -> dict:
    """Shard ``k``'s tensors of layer ``layer`` of a tree of ``Sharded``
    (views)."""
    return {n: _at(v, k, layer) if isinstance(v, dict) else
            v.shards[k][layer] for n, v in tree.items()}


class _Attention:
    """The attention half of every layer of one step: what the layers
    share (positions, tables, the K/V write index, RoPE tables) per
    shard."""

    def __init__(self, st: _Step, cfg, cache: dict, positions, tables,
                 valid):
        self.st, self.cfg, self.cache = st, cfg, cache
        C = positions.shape[1]
        self.chunk = chunk = valid is not None
        self.pos_loc = st.local(positions)
        pos_all = st.local(positions, all_rows=True)
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
        self.row_ops = [Sharded(st.mesh, (st.bspec,), st.local(r), (st.B,))
                        for r in row_ops]
        self.tab_sh = Sharded(st.mesh, (st.bspec, ()), st.local(tables),
                              tuple(tables.shape))
        ap = st.params["layers"]["attn"]
        self.heads = ap["wq"].spec[2]
        self.shape = (st.B, C, ap["wq"].shape[2], cfg.head_dim_) if chunk \
            else (st.B, ap["wq"].shape[2], cfg.head_dim_)
        self.q_spec = (st.bspec, (), self.heads, ()) if chunk else \
            (st.bspec, self.heads, ())
        # the step's K/V write index and RoPE tables depend on the
        # positions only: each shard takes them once for every layer
        self.widx = [kv_write_index(t, p, cache["k"].shape[2], c)
                     for t, p, c in zip(tab_all, pos_all, inchunk_all)]
        self.rope = [None] * len(st.devs)

    def __call__(self, l: int, hn: list[torch.Tensor], window: int
                 ) -> list[torch.Tensor]:
        """Layer ``l``'s attention output on every shard (reduced over the
        model axis when the heads are split)."""
        st, cfg, cache, chunk = self.st, self.cfg, self.cache, self.chunk
        ap = st.params["layers"]["attn"]
        qs, ks, vs = [], [], []
        for k, t in enumerate(hn):
            q = torch.einsum("bsd,dhk->bshk", t, ap["wq"].shards[k][l])
            kk = torch.einsum("bsd,dhk->bshk", t, ap["wk"].shards[k][l])
            vv = torch.einsum("bsd,dhk->bshk", t, ap["wv"].shards[k][l])
            if cfg.qk_norm:
                q = rms_norm(q, ap["q_norm"].shards[k][l], cfg.norm_eps)
                kk = rms_norm(kk, ap["k_norm"].shards[k][l], cfg.norm_eps)
            if self.rope[k] is None:
                self.rope[k] = rope_sin_cos(q, self.pos_loc[k],
                                            cfg.rope_theta)
            qs.append(rotate(q, *self.rope[k]))
            ks.append(rotate(kk, *self.rope[k]))
            vs.append(vv)
        ks, vs = st.all_rows(ks), st.all_rows(vs)
        names = [n for n in tf._KV_POOL_KEYS if n in cache]
        pools = {n: [t[l] for t in cache[n].shards] for n in names}
        for k in range(len(st.devs)):
            scatter_kv_at({n: pools[n][k] for n in pools}, ks[k], vs[k],
                          self.widx[k])
        pool_sh = {n: Sharded(st.mesh, cache[n].spec[1:], pools[n],
                              cache[n].shape[1:]) for n in pools}
        q_sh = Sharded(st.mesh, self.q_spec,
                       [q if chunk else q[:, 0] for q in qs], self.shape)
        attend = paged_prefill_attention if chunk else paged_attention
        o = attend(q_sh, pool_sh["k"], pool_sh["v"], self.tab_sh,
                   *self.row_ops, window=window, use_kernel=cfg.use_kernels,
                   k_scale=pool_sh.get("k_scale"),
                   v_scale=pool_sh.get("v_scale"))
        o = coll.reshard(o, self.q_spec).shards
        part = [torch.einsum("bshk,hkd->bsd", t if chunk else t[:, None],
                             w) for t, w in zip(o, st.weights(ap["wo"], l))]
        return st.reduce_model(part) if self.heads else part


class _Recurrent:
    """The SSM half of every layer of one step (``models.transformer``'s
    ``ssm_decode_rows`` / ``ssm_chunk_rows`` on each shard's rows of the
    per-slot state), and the tensor-parallel split of the SSD block over
    ``ssm_heads`` when the rules split it."""

    def __init__(self, st: _Step, cfg, cache: dict, positions, valid,
                 active, slots):
        self.st, self.cfg, self.cache = st, cfg, cache
        self.chunk = valid is not None
        self.fresh = st.local(positions[:, 0] == 0)
        if self.chunk:
            self.fed = st.local(valid > 0)
            self.valid = st.local(valid)
            # a data replica's pool holds its own rows' state
            self.slots = [s.long() - (st.rows[k // st.m].start or 0)
                          for k, s in enumerate(st.local(slots))]
        else:
            self.active = [None] * len(st.devs) if active is None \
                else st.local(active)

    def _rows(self, k: int, sp: dict, hn, lc: dict, stages=None):
        cfg = self.cfg
        if self.chunk:
            return tf.ssm_chunk_rows(sp, cfg, hn, lc, self.slots[k],
                                     self.fresh[k], self.fed[k],
                                     self.valid[k], stages)
        return tf.ssm_decode_rows(sp, cfg, hn, lc, self.fresh[k],
                                  self.active[k], stages)

    def __call__(self, l: int, hn: list[torch.Tensor]
                 ) -> list[torch.Tensor]:
        st, cfg = self.st, self.cfg
        sp = st.params["layers"]["ssm"]
        n = len(st.devs)
        sps = [_at(sp, k, l) for k in range(n)]
        lcs = [{c: self.cache[c].shards[k][l] for c in ("conv", "state")}
               for k in range(n)]
        if not sp["w_x"].spec[2]:            # heads replicated: whole
            return [self._rows(k, sps[k], hn[k], lcs[k]) for k in range(n)]
        # the in-projections of the shard's heads; the conv runs over every
        # x channel (its window is replicated over ``model``), so the
        # shards' x channels are all-gathered first
        proj = [ssm_mod._project(p, cfg, x) for p, x in zip(sps, hn)]
        xs = st.gather_model([pr[1].reshape(pr[1].shape[:2] + (-1,))
                              for pr in proj], -1, kind="ssm-conv-all-gather")
        nl = sp["w_x"].shape[2] // st.m
        gated = []
        for k in range(n):
            z, _, Bv, Cv, dt = proj[k]
            heads = slice((k % st.m) * nl, (k % st.m + 1) * nl)
            conv_in = torch.cat([xs[k], Bv, Cv], dim=-1)

            def stages(sc, k=k, z=z, dt=dt, heads=heads, conv_in=conv_in):
                if self.chunk:
                    y, xin, new = ssm_mod.prefill_scan(
                        sps[k], cfg, conv_in, dt, sc, self.valid[k], heads)
                    return ssm_mod._gated(sps[k], y, z, xin), new
                y, xin, new = ssm_mod.decode_scan(sps[k], cfg, conv_in, dt,
                                                  sc, heads)
                return ssm_mod._gated(sps[k], y[:, None], z,
                                      xin[:, None].float()), new
            gated.append(self._rows(k, sps[k], hn[k], lcs[k], stages))
        normed = split_rms_norm(st, gated, [p["norm"] for p in sps],
                                cfg.norm_eps)
        return st.reduce_model([ssm_mod._out_proj(p, t)
                                for p, t in zip(sps, normed)])


def split_rms_norm(st: _Step, parts: list[torch.Tensor],
                   scales: list[torch.Tensor], eps: float
                   ) -> list[torch.Tensor]:
    """``layers.rms_norm`` over channels split over ``model``: each shard's
    f32 sum of squares of its slice, added over ``model`` in shard order,
    divided by the global width; each shard scales its own slice of the
    replicated ``scales``."""
    sq = st.reduce_model([g.float().square().sum(-1, keepdim=True)
                          for g in parts], kind="ssm-norm-all-reduce")
    w = parts[0].shape[-1]
    width = w * st.m
    out = []
    for k, (g, s, scale) in enumerate(zip(parts, sq, scales)):
        j = k % st.m
        out.append((g.float() * torch.rsqrt(s / width + eps)
                    * scale[j * w:(j + 1) * w].float()).to(g.dtype))
    return out


def _mlp(st: _Step, cfg, l: int, h: list[torch.Tensor]
         ) -> list[torch.Tensor]:
    """The SwiGLU half: ``mlp`` columns split, then the all-reduce."""
    lay = st.params["layers"]
    mp = lay["mlp"]
    hn = [rms_norm(t, w, cfg.norm_eps)
          for t, w in zip(h, st.weights(lay["ln2"], l))]
    part = [swiglu(_at(mp, k, l), t) for k, t in enumerate(hn)]
    if mp["w_gate"].spec[2]:
        part = st.reduce_model(part)
    return _add(h, part)


class _MoeExchange(moe_mod.Exchange):
    """``models.moe``'s exchanges over the model axis: the router's columns
    and the experts split over ``expert`` are all-gathered, the shared
    experts split over ``mlp`` all-reduced; an unsplit piece is left as it
    is."""

    def __init__(self, st: _Step, cfg, mp: dict):
        self.st = st
        self.ep = bool(mp["w_gate"].spec[1])
        self.El = cfg.n_experts // st.m if self.ep else cfg.n_experts
        shared = mp.get("shared")
        self.split_shared = shared is not None and \
            bool(shared["w_gate"].spec[2])

    def router_logits(self, parts):
        if not self.ep:
            return parts
        return self.st.gather_model(parts, -1, kind="moe-router-all-gather")

    def local_experts(self, k, buf):
        if not self.ep:
            return buf
        j = k % self.st.m
        return buf[j * self.El:(j + 1) * self.El]

    def expert_outputs(self, parts):
        if not self.ep:
            return parts
        return self.st.gather_model(parts, 0, kind="moe-expert-all-gather")

    def shared_outputs(self, parts):
        return self.st.reduce_model(parts) if self.split_shared else parts


def _moe(st: _Step, cfg, l: int, h: list[torch.Tensor], mask
         ) -> list[torch.Tensor]:
    """The MoE half (``models.moe.moe_shards`` with ``_MoeExchange``).
    Every shard holds every token of its data replica; when the rows are
    split over ``data``, every replica's rows join one dispatch (the
    capacity counts the step's global tokens, as the reference's gspmd
    step does) and each replica keeps its own rows of the output.  Routing
    and dispatch run identically on every shard, each shard runs its
    experts' rows of the dispatch buffer, and dropped assignments are
    counted once."""
    lay = st.params["layers"]
    mp = lay["moe"]
    hn = [rms_norm(t, w, cfg.norm_eps)
          for t, w in zip(h, st.weights(lay["ln2"], l))]
    gather = bool(st.bspec) and st.d > 1
    xs = st.all_rows(hn, kind="moe-row-gather") if gather else hn
    masks = [None] * len(xs) if mask is None else \
        st.local(mask, all_rows=gather)
    ys, _, _ = moe_mod.moe_shards(
        [_at(mp, k, l) for k in range(len(xs))], cfg,
        [x.reshape(-1, x.shape[-1]) for x in xs], masks,
        _MoeExchange(st, cfg, mp))
    out = [y.to(x.dtype).reshape(x.shape) for y, x in zip(ys, xs)]
    if gather:
        out = [o[st.rows[k // st.m]] for k, o in enumerate(out)]
    return _add(h, out)


def _layers(st: _Step, cfg, cache: dict, x: list[torch.Tensor],
            positions: torch.Tensor, tables: torch.Tensor,
            valid: torch.Tensor | None, active: torch.Tensor | None = None,
            slots: torch.Tensor | None = None) -> list[torch.Tensor]:
    """Every layer on every shard, composed as ``models.transformer.
    _decode_layer`` composes them: the SSD block alone (ssm), attention
    then the FFN (dense, moe), or attention and the SSD block on the same
    normed input, added in that order, then the FFN (hybrid).  positions
    (B, C); ``valid`` (B,) for a chunk (prefill / verify), None for a
    decode step (C = 1); ``active`` (B,) the decode step's fed slots
    (None: all); ``slots`` (B,) a chunk's state rows.  Returns each shard's
    hidden states after the final norm."""
    lay = st.params["layers"]
    chunk = valid is not None
    attend = None if cfg.family == "ssm" else _Attention(
        st, cfg, cache, positions, tables, valid)
    recur = _Recurrent(st, cfg, cache, positions, valid, active, slots) \
        if cfg.family == "ssm" or cfg.hybrid else None
    if chunk:
        mask = torch.arange(positions.shape[1], device=valid.device
                            )[None, :] < valid[:, None]
    else:
        mask = None if active is None else active[:, None]
    h = x
    for l in range(cfg.num_layers):
        hn = [rms_norm(t, w, cfg.norm_eps)
              for t, w in zip(h, st.weights(lay["ln1"], l))]
        if cfg.family == "ssm":
            h = _add(h, recur(l, hn))
            continue
        h = _add(h, attend(l, hn, tf.layer_window(cfg, l)))
        if cfg.hybrid:
            h = _add(h, recur(l, hn))
        if cfg.n_experts:
            h = _moe(st, cfg, l, h, mask)
        elif cfg.d_ff:
            h = _mlp(st, cfg, l, h)
    return [rms_norm(t, w, cfg.norm_eps)
            for t, w in zip(h, st.weights(st.params["final_norm"]))]


def paged_decode_step(params: dict, cfg, cache: dict, tokens: torch.Tensor,
                      positions: torch.Tensor, block_tables: torch.Tensor,
                      active: torch.Tensor | None = None):
    """``models.transformer.paged_decode_step`` over the active mesh:
    ``params`` and ``cache`` are trees of ``Sharded``, the row operands
    global tensors on the mesh's first device.  Returns (logits (B, V) on
    that device, the cache, written in place)."""
    st = _Step(params, tokens.shape[0])
    h = _layers(st, cfg, cache, _embed(st, tokens[:, None]),
                positions[:, None], block_tables, None, active=active)
    return _logits(st, h, cfg)[:, 0], cache


def _chunk(params, cfg, cache, tokens, positions, slots, block_tables,
           valid):
    st = _Step(params, tokens.shape[0])
    return st, _layers(st, cfg, cache, _embed(st, tokens), positions,
                       block_tables, valid, slots=slots)


def paged_prefill_step(params: dict, cfg, cache: dict, tokens, positions,
                       slots, block_tables, valid):
    """``models.transformer.paged_prefill_step`` over the active mesh: the
    logits of each row's last valid token (B, V) on the first device."""
    st, h = _chunk(params, cfg, cache, tokens, positions, slots,
                   block_tables, valid)
    last = st.local((valid.long() - 1).clamp(min=0))
    h = [torch.gather(t, 1, i[:, None, None].expand(-1, 1, t.shape[-1]))
         for t, i in zip(h, last)]
    return _logits(st, h, cfg)[:, 0], cache


def paged_verify_step(params: dict, cfg, cache: dict, tokens, positions,
                      slots, block_tables, valid):
    """``models.transformer.paged_verify_step`` over the active mesh: the
    logits of every position (B, C, V) on the first device."""
    st, h = _chunk(params, cfg, cache, tokens, positions, slots,
                   block_tables, valid)
    return _logits(st, h, cfg), cache
