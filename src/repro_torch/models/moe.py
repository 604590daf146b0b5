"""Mixture-of-Experts layer with sort-based token dispatch, as the
reference's ``models/moe.py`` computes it.

Dispatch is "dropping" MoE: each token's top-k (token, expert) assignments
are sorted by expert (a stable sort, as ``jnp.argsort`` is), ranked within
their expert, and those past the capacity ``C`` are dropped; the expert
SwiGLUs then run as one batched ``(E, G, C, d) x (E, d, f)`` product each.
Shared experts (qwen2-moe) are one dense SwiGLU of width
``n_shared_experts * shared_d_ff`` that every token passes, scaled by a
sigmoid gate.  The router and the shared gate are f32 whatever the model
dtype.

Where torch differs from ``jnp`` the code keeps the reference's values:
- the per-expert counts are a one-hot sum of fixed length ``E``
  (``torch.bincount`` would grow to E + 1 for the virtual expert of masked
  tokens, and its shape depends on the data, which the fake-tensor analysis
  trace refuses);
- out-of-range gathers clamp, as XLA's do; scatter indices past the buffer
  go to its last row, the one the reference's ``mode="drop"`` cuts off;
- the combine gathers each token's k rows back through the inverse
  permutation and adds them in order k = 0, 1, ... (the reference's
  ``.at[].add`` would be ``index_add_``, whose CUDA atomics add in any
  order), so a token's output does not depend on its batch.

``dropped`` counts, on the device, the real tokens' assignments cut by the
capacity in calls that pass a ``token_mask`` (the serving steps), with one
reduction a layer: reading it (``dropped_assignments``) is the only host
synchronisation it costs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, dtype_of

# device -> int64 count of real (token, expert) assignments past capacity
dropped: dict[torch.device, torch.Tensor] = {}


def dropped_assignments() -> int:
    return int(sum(int(t) for t in dropped.values()))


def reset_dropped() -> None:
    dropped.clear()


def count_dropped(sizes: list[torch.Tensor], C: int) -> None:
    """Add to ``dropped`` the assignments past capacity ``C``: each group's
    per-expert counts ``sizes`` (E,) beyond C, in one reduction.  The
    counts leave out the masked tokens' virtual expert, so only real
    tokens' drops count."""
    lost = (torch.stack(sizes) - C).clamp_(min=0).sum()
    dev = lost.device
    if dev in dropped:
        dropped[dev].add_(lost)
    else:
        dropped[dev] = lost


def moe_init(gen: torch.Generator, cfg) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = dtype_of(cfg.dtype)
    p = {
        "router": dense_init(gen, (d, E), torch.float32),
        "w_gate": dense_init(gen, (E, d, f), dt),
        "w_up": dense_init(gen, (E, d, f), dt),
        "w_down": dense_init(gen, (E, f, d), dt, fan_in=f),
    }
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * cfg.shared_d_ff
        p["shared"] = {
            "w_gate": dense_init(gen, (d, sf), dt),
            "w_up": dense_init(gen, (d, sf), dt),
            "w_down": dense_init(gen, (sf, d), dt, fan_in=cfg.shared_d_ff),
            "gate": dense_init(gen, (d, 1), torch.float32),
        }
    return p


MOE_AXES = {
    "router": ("fsdp", "expert"),
    "w_gate": ("expert", "fsdp", "expert_mlp"),
    "w_up": ("expert", "fsdp", "expert_mlp"),
    "w_down": ("expert", "expert_mlp", "fsdp"),
    "shared": {
        "w_gate": ("fsdp", "mlp"),
        "w_up": ("fsdp", "mlp"),
        "w_down": ("mlp", "fsdp"),
        "gate": ("fsdp", None),
    },
}


def _capacity(cfg, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)   # round up to 8


def _dispatch_group(xt, top_e, top_w, E: int, C: int):
    """Sort-based dispatch of one token group.

    xt (T, d); top_e / top_w (T, k).  Returns (buf (E, C, d), slot, st, sw,
    keep, order, sizes): index arrays (T*k,) in sorted order, local to the
    group, and each expert's count of assignments (E,)."""
    T, d = xt.shape
    k = top_e.shape[1]
    dev = xt.device
    flat_e = top_e.reshape(T * k)
    flat_t = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(T * k)
    flat_w = top_w.reshape(T * k)
    se, order = torch.sort(flat_e, stable=True)
    st, sw = flat_t[order], flat_w[order]
    sizes = (se[:, None] == torch.arange(E, device=dev)).sum(0)   # (E,)
    starts = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(T * k, device=dev) - starts[se.clamp(max=E - 1)]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)            # E*C: dropped
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=dev)
    buf = buf.index_put((slot.clamp(max=E * C),), xt[st])
    return buf[:-1].reshape(E, C, d), slot, st, sw, keep, order, sizes


def _combine_group(out_buf, slot, sw, keep, order, T: int):
    """Inverse of ``_dispatch_group``: out_buf (E, C, d) -> (T, d) f32, each
    token's k contributions added in the order of its top-k."""
    E, C, d = out_buf.shape
    flat_out = out_buf.reshape(E * C, d)
    picked = torch.where(keep[:, None],
                         flat_out[slot.clamp(max=E * C - 1)], 0)
    part = picked.float() * sw[:, None]                        # sorted order
    inv = torch.argsort(order)                # a permutation: exact inverse
    part = part[inv].reshape(T, -1, d)                         # (T, k, d)
    y = part[:, 0]
    for j in range(1, part.shape[1]):
        y = y + part[:, j]
    return y


def route(logits: torch.Tensor, cfg, token_mask: torch.Tensor | None
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits (T, E) f32 -> (probs (T, E), top_w (T, k)
    renormalised, top_e (T, k)); a masked token's experts are the virtual
    expert ``E``."""
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)         # (T, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    if token_mask is not None:
        top_e = torch.where(token_mask.reshape(-1)[:, None], top_e,
                            cfg.n_experts)
    return probs, top_w, top_e


def dispatch(xt: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor,
             cfg) -> tuple[torch.Tensor, list, int]:
    """Grouped sort-based dispatch of xt (T, d): (buf (E, G, C, d), each
    group's ``_dispatch_group`` results, C).  ``C`` counts every token of
    the call, padding included, as the reference does."""
    T = xt.shape[0]
    G = max(cfg.moe_dispatch_groups, 1)
    assert T % G == 0, (T, G)
    TG = T // G
    C = max(8, _capacity(cfg, T) // G)
    parts = [slice(g * TG, (g + 1) * TG) for g in range(G)]
    groups = [_dispatch_group(xt[p], top_e[p], top_w[p], cfg.n_experts, C)
              for p in parts]
    return torch.stack([gr[0] for gr in groups], 1), groups, C


def experts(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLUs on a dispatch buffer (E', G, C, d), with the
    weights of those E' experts -> (E', G, C, d)."""
    gate = torch.einsum("egcd,edf->egcf", buf, params["w_gate"])
    up = torch.einsum("egcd,edf->egcf", buf, params["w_up"])
    h = F.silu(gate.float()).to(buf.dtype) * up
    return torch.einsum("egcf,efd->egcd", h, params["w_down"])


def combine(out_buf: torch.Tensor, groups: list, T: int) -> torch.Tensor:
    """(E, G, C, d) expert outputs of ``dispatch``'s groups -> (T, d) f32."""
    TG = T // len(groups)
    return torch.cat([_combine_group(out_buf[:, g], slot, sw, keep, order,
                                     TG)
                      for g, (_, slot, _, sw, keep, order, _) in
                      enumerate(groups)], 0)


def shared_expert(sp: dict, xt: torch.Tensor) -> torch.Tensor:
    """The shared experts' SwiGLU (T, d) in xt's dtype, before its gate."""
    g_ = xt @ sp["w_gate"]
    u = xt @ sp["w_up"]
    hh = F.silu(g_.float()).to(xt.dtype) * u
    return hh @ sp["w_down"]


class Exchange:
    """The exchanges between the shards of one dispatch, each the identity
    on one device; ``distributed.tensor_parallel`` passes the mesh's
    collectives.  ``router_logits`` joins the shards' router columns,
    ``local_experts`` cuts shard ``k``'s experts from the dispatch buffer,
    ``expert_outputs`` joins the shards' expert rows and ``shared_outputs``
    adds the shards' parts of the shared experts."""

    def router_logits(self, parts: list) -> list:
        return parts

    def local_experts(self, k: int, buf: torch.Tensor) -> torch.Tensor:
        return buf

    def expert_outputs(self, parts: list) -> list:
        return parts

    def shared_outputs(self, parts: list) -> list:
        return parts


ONE_DEVICE = Exchange()


def moe_shards(ps: list[dict], cfg, xts: list[torch.Tensor], masks: list,
               ex: Exchange = ONE_DEVICE
               ) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The block's composition over the shards of one dispatch: shard k
    holds weights ``ps[k]``, every token of the dispatch ``xts[k]`` (T, d)
    and its ``masks[k]`` (or None); ``ex`` joins what the weights split.
    Routing, dispatch and combine run identically on every shard, and the
    dispatch's dropped assignments are counted once.  Returns each shard's
    output (T, d) f32 and the first shard's (probs, top_e)."""
    T = xts[0].shape[0]
    logits = ex.router_logits([xt.float() @ p["router"]        # (T, E) f32
                               for xt, p in zip(xts, ps)])
    outs, disp = [], []
    for k, (xt, p, lg, mk) in enumerate(zip(xts, ps, logits, masks)):
        probs, top_w, top_e = route(lg, cfg, mk)
        buf, groups, C = dispatch(xt, top_e, top_w, cfg)        # (E, G, C, d)
        outs.append(experts(p, ex.local_experts(k, buf)))
        disp.append((groups, C))
        if k == 0:
            routed = probs, top_e
    outs = ex.expert_outputs(outs)
    ys = [combine(o, groups, T) for o, (groups, _) in zip(outs, disp)]

    if masks[0] is not None:
        groups, C = disp[0]
        count_dropped([gr[-1] for gr in groups], C)

    if cfg.n_shared_experts:
        shared_out = ex.shared_outputs([shared_expert(p["shared"], xt)
                                        for p, xt in zip(ps, xts)])
        ys = [y + s.float() * torch.sigmoid(xt.float() @ p["shared"]["gate"])
              for y, s, xt, p in zip(ys, shared_out, xts, ps)]
    return ys, *routed


def moe_block(params: dict, cfg, x: torch.Tensor,
              token_mask: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar f32).

    ``token_mask`` (B, S) bool marks real tokens: the serving engine's
    fixed-shape steps carry padding rows (idle slots, a chunk's tail),
    which must not take expert capacity from real tokens.  Masked tokens
    route to a virtual expert ``E``: the sort ranks them last, the counts
    never see them and the scatter drops them.  ``C`` counts every token of
    the step, padding included, as the reference does."""
    B, S, d = x.shape
    E = cfg.n_experts
    (y,), probs, top_e = moe_shards([params], cfg, [x.reshape(B * S, d)],
                                    [token_mask])

    # load-balance aux loss (Switch-style); a masked token's row is zero
    density = (top_e[:, :1] == torch.arange(E, device=x.device)
               ).float().mean(0)
    aux = E * (density * probs.mean(0)).sum() * cfg.router_aux_weight
    return y.to(x.dtype).reshape(B, S, d), aux
