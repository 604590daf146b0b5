"""Transformer backbone of the port: the dense family (GQA attention +
SwiGLU), the moe family (GQA attention + routed experts, with shared
experts for qwen2-moe), the ssm family (Mamba-2: SSD blocks only, no
attention and no separate FFN), the hybrid family (Hymba: attention and
SSD heads in parallel on the same normed input, then SwiGLU), the audio
family (encoders: HuBERT, and the paper's vit-mini / distilbert-mini —
stub frame embeddings in through ``frame_proj``, bidirectional attention,
an untied ``head``) and the vlm family (PaliGemma: stub patch embeddings
through ``vision_proj`` prepended to the token embeddings, a prefix-LM
mask), as the reference's ``models/transformer.py`` runs them.

Parameters are a nested dict of tensors with the reference's key paths;
``params["layers"]`` holds every per-layer leaf stacked on a leading
``(L, ...)`` axis, and a Python loop over that axis takes the place of
``lax.scan``.  Because the loop is in Python, a hybrid layer's attention
window is a static int (``layer_window``): ``cfg.sliding_window`` on the
windowed layers, 0 (plain causal) on ``cfg.global_layers``.  The reference
makes it data (``2**30`` on global layers) only because it scans its
layers.  The cnn family runs in ``models/cnn.py`` (``require_ported``
admits it for the port's entry points).  Encoders and the vlm family have
no decode path, as in the reference: the serving steps below run the
causal families only.

The moe family's layers return the router's load-balancing loss beside the
hidden states; ``forward`` sums it over the layers and ``loss_fn`` adds it
to the cross entropy.  The serving steps pass each step's real tokens to
the MoE block (``moe_mask``), so padding takes no expert capacity.

In-place updates: the contiguous cache, the paged pools and the per-slot
SSM ``conv``/``state`` tensors are written in place by every decode /
prefill / verify step (the reference donates those buffers to its jitted
steps); the returned cache is the object passed in.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import AUDIO_FRAME_DIM, ArchConfig
from repro_torch.kernels.paged_attention import is_quantized, pool_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    SWIGLU_AXES, cross_entropy, dense_init, dtype_of, embed_init, rms_norm,
    swiglu, swiglu_init)

PORTED = ("dense", "moe", "ssm", "hybrid", "cnn", "audio", "vlm")


def require_ported(cfg: ArchConfig) -> None:
    """Admit the families the reference registers (dense, moe, ssm,
    hybrid, audio, vlm, and cnn, which ``models/cnn.py`` runs) in the
    combinations its configs use: experts only in the moe family, the
    parallel SSD heads only in the hybrid one, and ``is_encoder`` only in
    the audio one."""
    if cfg.family not in PORTED or cfg.hybrid != (cfg.family == "hybrid") \
            or bool(cfg.n_experts) != (cfg.family == "moe") \
            or cfg.is_encoder != (cfg.family == "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the port has no model of family {cfg.family!r} "
            f"(hybrid={cfg.hybrid}, n_experts={cfg.n_experts}, "
            f"is_encoder={cfg.is_encoder})")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree, as views (no copy)."""
    return _tree_map(lambda a: a[i], tree)


def layer_window(cfg: ArchConfig, i: int) -> int:
    """Attention window of layer ``i``: ``cfg.sliding_window`` on a hybrid
    layer outside ``cfg.global_layers``, else 0 (plain causal)."""
    if cfg.hybrid and i not in cfg.global_layers:
        return int(cfg.sliding_window)
    return 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def layer_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt = dtype_of(cfg.dtype)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    p: dict[str, Any] = {"ln1": ones()}
    if cfg.family == "ssm":
        p["ssm"] = ssm_mod.ssm_init(gen, cfg)
        return p
    p["attn"] = attn.attn_init(gen, cfg)
    if cfg.hybrid:
        p["ssm"] = ssm_mod.ssm_init(gen, cfg)
    if cfg.n_experts:
        p["ln2"] = ones()
        p["moe"] = moe_mod.moe_init(gen, cfg)
    elif cfg.d_ff:
        p["ln2"] = ones()
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def layer_axes(cfg: ArchConfig) -> dict:
    """Logical sharding axes of one layer's parameters (the tree
    ``layer_init`` builds)."""
    p: dict[str, Any] = {"ln1": (None,)}
    if cfg.family != "ssm":
        a = dict(attn.ATTN_AXES)
        if not cfg.qk_norm:
            a.pop("q_norm"), a.pop("k_norm")
        p["attn"] = a
    if cfg.family == "ssm" or cfg.hybrid:
        p["ssm"] = dict(ssm_mod.SSM_AXES)
    if cfg.n_experts:
        p["ln2"] = (None,)
        m = dict(moe_mod.MOE_AXES)
        if not cfg.n_shared_experts:
            m.pop("shared")
        p["moe"] = m
    elif cfg.d_ff:
        p["ln2"] = (None,)
        p["mlp"] = dict(SWIGLU_AXES)
    return p


def _stack(trees: list[dict]) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _stacked_layers(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Every layer drawn in turn and copied into ``(L, ...)`` tensors as it
    comes, so that the device never holds the layers twice."""
    L = cfg.num_layers
    out = None
    for i in range(L):
        lp = layer_init(gen, cfg)
        if out is None:
            out = _tree_map(lambda t: t.new_empty((L,) + tuple(t.shape)), lp)
        _tree_map2(lambda dst, src, i=i: dst[i].copy_(src), out, lp)
    return out


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_map2(fn, a[k], b[k])
    else:
        fn(a, b)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device``: the audio
    family's ``frame_proj (AUDIO_FRAME_DIM, d)`` in place of
    ``tok_embed``, the vlm family's ``vision_proj (vision_embed_dim, d)``
    beside it, and an encoder's classifier ``head (d, vocab)`` whatever
    ``tie_embeddings`` says."""
    require_ported(cfg)
    dt = dtype_of(cfg.dtype)
    params: dict[str, Any] = {}
    if cfg.family == "audio":
        params["frame_proj"] = dense_init(
            gen, (AUDIO_FRAME_DIM, cfg.d_model), dt)
    else:
        params["tok_embed"] = embed_init(
            gen, (cfg.vocab_size, cfg.d_model), dt)
    if cfg.family == "vlm":
        params["vision_proj"] = dense_init(
            gen, (cfg.vision_embed_dim, cfg.d_model), dt)
    params["layers"] = _stacked_layers(gen, cfg)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                      device=gen.device)
    if cfg.is_encoder or not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return params


def param_axes(cfg: ArchConfig) -> dict:
    """Logical sharding axes of the tree ``init_params`` builds: every
    per-layer leaf gains the leading ``"layers"`` axis."""
    axes: dict[str, Any] = {}
    if cfg.family == "audio":
        axes["frame_proj"] = (None, "fsdp")
    else:
        axes["tok_embed"] = ("vocab", "fsdp")
    if cfg.family == "vlm":
        axes["vision_proj"] = (None, "fsdp")
    axes["layers"] = _tree_map(lambda t: ("layers",) + tuple(t),
                               layer_axes(cfg))
    axes["final_norm"] = (None,)
    if cfg.is_encoder or not cfg.tie_embeddings:
        axes["head"] = ("fsdp", "vocab")
    return axes


# ---------------------------------------------------------------------------
# Per-layer forward and full forward (train / prefill)
# ---------------------------------------------------------------------------

def _ffn(lp: dict, cfg: ArchConfig, h: torch.Tensor, moe_mask=None
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The second half of a layer: routed experts or SwiGLU after ``ln2``
    (nothing when the config has neither).  Returns (h, the MoE aux loss
    or None)."""
    if cfg.n_experts:
        h2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
        m_out, aux = moe_mod.moe_block(lp["moe"], cfg, h2,
                                       token_mask=moe_mask)
        return h + m_out, aux
    if cfg.d_ff:
        h2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
        return h + swiglu(lp["mlp"], h2), None
    return h, None


def mask_mode(cfg: ArchConfig) -> str:
    """The full-sequence attention mask of a config: ``bidir`` for an
    encoder, ``prefix`` (bidirectional over the image tokens, causal after)
    for the vlm family, else ``causal``."""
    if cfg.is_encoder:
        return "bidir"
    if cfg.family == "vlm":
        return "prefix"
    return "causal"


def layer_forward(lp: dict, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, window: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer; ``window`` is ``layer_window(cfg, i)``.  Returns (x, the
    MoE aux loss, or None for the families without experts)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return x + ssm_mod.ssm_block(lp["ssm"], cfg, h), None
    a_out = attn.attention_block(lp["attn"], cfg, h, positions,
                                 "sliding" if window else mask_mode(cfg),
                                 window=window, prefix_len=cfg.vision_tokens)
    if cfg.hybrid:
        x = x + a_out + ssm_mod.ssm_block(lp["ssm"], cfg, h)
    else:
        x = x + a_out
    return _ffn(lp, cfg, x)


def embed_inputs(params: dict, cfg: ArchConfig, batch: dict
                 ) -> torch.Tensor:
    """(B, S, d) inputs of the first layer: ``frames @ frame_proj`` for the
    audio family (frames cast to the model's dtype first), else the token
    embeddings, with the vlm family's ``patches @ vision_proj`` prepended
    (S = vision_tokens + text tokens)."""
    if cfg.family == "audio":
        fp = params["frame_proj"]
        h = batch["frames"].to(fp.dtype) @ fp
    else:
        h = params["tok_embed"][batch["tokens"].long()]
    if cfg.family == "vlm":
        vis = batch["patches"].to(h.dtype) @ params["vision_proj"]
        h = torch.cat([vis, h], dim=1)
    return h


def forward(params: dict, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hidden states (B, S, d) after the final norm, the MoE aux loss
    summed over the layers: an f32 zero for the families without experts).
    ``params["layers"]`` may be the stacked tree or a list of per-layer
    trees (``unstack_layers``).

    With ``cfg.remat`` and grad enabled, each layer keeps only its input
    for the backward pass and is recomputed there
    (``torch.utils.checkpoint``), as the reference wraps every layer in
    ``jax.checkpoint`` with nothing saveable: the same gradients, one more
    forward, and no layer's activations held across the model.  It needs
    ``torch.autograd`` (the trainer's); ``torch.func`` transforms refuse
    it, so their callers pass ``remat=False``."""
    require_ported(cfg)
    h = embed_inputs(params, cfg, batch)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device
                             )[None].expand(B, S)
    layers = params["layers"]
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_layers):
        lp = layers[i] if isinstance(layers, list) else _layer(layers, i)
        win = layer_window(cfg, i)
        if remat:
            h, a = torch.utils.checkpoint.checkpoint(
                layer_forward, lp, cfg, h, positions, win,
                use_reentrant=False)
        else:
            h, a = layer_forward(lp, cfg, h, positions, win)
        if a is not None:
            aux = aux + a
    return rms_norm(h, params["final_norm"], cfg.norm_eps), aux


def logits_from_hidden(params, cfg, h) -> torch.Tensor:
    if cfg.is_encoder or not cfg.tie_embeddings:
        return torch.einsum("bsd,dv->bsv", h, params["head"])
    return torch.einsum("bsd,vd->bsv", h, params["tok_embed"])


def loss_fn(params: dict, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """(CE + the MoE aux loss, metrics).  An encoder with at most 16
    classes classifies the sequence from its mean hidden state (targets
    (B,)); other encoders predict a target per frame (targets (B, S)); a
    decoder predicts the next token, for the vlm family on the text
    positions only."""
    h, aux = forward(params, cfg, batch)
    if cfg.is_encoder:
        if cfg.vocab_size <= 16:
            ce = cross_entropy(h.mean(dim=1) @ params["head"],
                               batch["targets"])
        else:
            ce = cross_entropy(logits_from_hidden(params, cfg, h),
                               batch["targets"])
    else:
        logits = logits_from_hidden(params, cfg, h)
        if cfg.family == "vlm":
            logits = logits[:, cfg.vision_tokens:]
        ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode over a contiguous cache (the sequential oracle's step)
# ---------------------------------------------------------------------------

def _ssm_state(cfg: ArchConfig, L: int, rows: int, device) -> dict:
    """Per-row recurrent state of every layer: ``conv (L, rows, K-1, ch)``
    in the model dtype and ``state (L, rows, h, p, n)`` f32, zeros."""
    sc = ssm_mod.init_ssm_cache(cfg, rows, dtype_of(cfg.dtype), device)
    return {"conv": sc.conv[None].repeat(L, 1, 1, 1),
            "state": sc.state[None].repeat(L, 1, 1, 1, 1)}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """Contiguous KV cache ``k``/``v`` (L, batch, max_len, KH, hd/vhd) and,
    for the ssm and hybrid families, the per-row recurrent state."""
    require_ported(cfg)
    L = cfg.num_layers
    cache: dict[str, Any] = {}
    if cfg.family != "ssm":
        kv = attn.init_layer_cache(cfg, batch, max_len, dtype_of(cfg.dtype),
                                   device)
        cache["k"] = kv.k[None].repeat(L, 1, 1, 1, 1)
        cache["v"] = kv.v[None].repeat(L, 1, 1, 1, 1)
    if cfg.family == "ssm" or cfg.hybrid:
        cache.update(_ssm_state(cfg, L, batch, device))
    return cache


def _decode_layer(lp: dict, lc: dict, h: torch.Tensor, cfg: ArchConfig,
                  attn_fn, ssm_fn, window: int, moe_mask=None
                  ) -> torch.Tensor:
    """One incremental layer, shared by the contiguous decode, paged decode
    and chunked paged-prefill paths.  ``attn_fn(attn_params, hn, lc,
    window) -> a_out`` and ``ssm_fn(ssm_params, hn, lc) -> delta``
    encapsulate everything the cache layouts / step widths disagree on (and
    write ``lc`` in place); the residual/FFN scaffolding stays
    single-source.  ``moe_mask`` (B, S) marks the real tokens for expert
    dispatch (``moe.moe_block``)."""
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return h + ssm_fn(lp["ssm"], hn, lc)
    a_out = attn_fn(lp["attn"], hn, lc, window)
    if cfg.hybrid:
        h = h + a_out + ssm_fn(lp["ssm"], hn, lc)
    else:
        h = h + a_out
    return _ffn(lp, cfg, h, moe_mask)[0]


def _run_decode_layers(params: dict, cfg: ArchConfig, cache: dict,
                       x: torch.Tensor, attn_fn, ssm_fn, moe_mask=None
                       ) -> torch.Tensor:
    """Layer loop + final norm shared by the incremental paths.  Each
    layer's cache slice is a view into ``cache``, so its in-place writes
    land in the stacked tensors.  Returns hidden (B, S, d)."""
    h = x
    for i in range(cfg.num_layers):
        h = _decode_layer(_layer(params["layers"], i), _layer(cache, i), h,
                          cfg, attn_fn, ssm_fn, layer_window(cfg, i),
                          moe_mask)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def _keep_rows(rows: torch.Tensor | None, new, old: torch.Tensor
               ) -> torch.Tensor:
    """``new`` (a tensor like ``old``, or a scalar) on the rows marked True,
    ``old`` elsewhere; all of ``new`` when ``rows`` is None."""
    if rows is None:
        return new
    return torch.where(rows.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)


def ssm_decode_rows(sp: dict, cfg: ArchConfig, hn: torch.Tensor, lc: dict,
                    fresh: torch.Tensor, active: torch.Tensor | None,
                    stages=None) -> torch.Tensor:
    """A paged decode step's SSM half on one layer's per-slot state ``lc``
    (``conv``, ``state``, written in place): the ``fresh`` rows start from
    zeros, and only the ``active`` rows (all when None) keep their new
    state.  ``stages`` is the tensor-parallel steps' hook (``None``: the
    whole SSD block on this tensor)."""
    sc = ssm_mod.SSMCache(_keep_rows(fresh, 0.0, lc["conv"]),
                          _keep_rows(fresh, 0.0, lc["state"]))
    out, new = ssm_mod.ssm_decode(sp, cfg, hn, sc) if stages is None \
        else stages(sc)
    lc["conv"].copy_(_keep_rows(active, new.conv, lc["conv"]))
    lc["state"].copy_(_keep_rows(active, new.state, lc["state"]))
    return out


def ssm_chunk_rows(sp: dict, cfg: ArchConfig, hn: torch.Tensor, lc: dict,
                   rows: torch.Tensor, fresh: torch.Tensor, fed: torch.Tensor,
                   valid: torch.Tensor, stages=None) -> torch.Tensor:
    """A prefill / verify chunk's SSM half on the state rows ``rows`` of
    ``lc``: ``fresh`` rows start from zeros, and rows with no token
    (``fed`` False) keep their state."""
    conv0, state0 = lc["conv"][rows], lc["state"][rows]
    sc = ssm_mod.SSMCache(_keep_rows(fresh, 0.0, conv0),
                          _keep_rows(fresh, 0.0, state0))
    out, new = ssm_mod.ssm_prefill(sp, cfg, hn, sc, valid) \
        if stages is None else stages(sc)
    lc["conv"][rows] = _keep_rows(fed, new.conv, conv0)
    lc["state"][rows] = _keep_rows(fed, new.state, state0)
    return out


def cache_axes(cfg: ArchConfig, long_context: bool = False) -> dict:
    """Logical axes of the contiguous cache tree.  "kv_seq" defaults to
    replicated; rules override it for long-context (data) or kv-replicated
    (model)."""
    del long_context
    axes: dict[str, Any] = {}
    if cfg.family != "ssm":
        axes["k"] = ("layers", "batch", "kv_seq", "kv_heads", None)
        axes["v"] = ("layers", "batch", "kv_seq", "kv_heads", None)
    if cfg.family == "ssm" or cfg.hybrid:
        axes["conv"] = ("layers", "batch", None, None)
        axes["state"] = ("layers", "batch", "ssm_heads", None, None)
    return axes


def decode_step(params: dict, cfg: ArchConfig, cache: dict,
                tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B,) int, pos python int.

    Returns (logits (B, V), the cache, updated in place).
    """
    require_ported(cfg)
    x = params["tok_embed"][tokens.long()[:, None]]             # (B,1,d)
    pos = int(pos)

    def attn_fn(ap, hn, lc, window):
        a_out, _ = attn.attention_decode(
            ap, cfg, hn, pos, attn.KVCache(lc["k"], lc["v"]),
            "sliding" if window else "causal", window=window)
        return a_out

    def ssm_fn(sp, hn, lc):
        out, new = ssm_mod.ssm_decode(
            sp, cfg, hn, ssm_mod.SSMCache(lc["conv"], lc["state"]))
        lc["conv"].copy_(new.conv)
        lc["state"].copy_(new.state)
        return out

    h = _run_decode_layers(params, cfg, cache, x, attn_fn, ssm_fn)
    return logits_from_hidden(params, cfg, h)[:, 0], cache


# ---------------------------------------------------------------------------
# Paged decode (continuous-batching serving)
# ---------------------------------------------------------------------------

# one layer's KV-pool leaves, in cache-dict order (scale pools exist only
# when the pool is quantized — ServeConfig.cache_dtype)
_KV_POOL_KEYS = ("k", "v", "k_scale", "v_scale")


def init_paged_cache(cfg: ArchConfig, num_blocks: int, block_size: int,
                     max_seqs: int, dtype: str | None = None,
                     device=None) -> dict:
    """Block-pool KV cache + per-slot SSM state.

    KV lives in a shared pool of ``num_blocks`` blocks of ``block_size``
    tokens (block 0 is the reserved null block that idle slots write into).
    ``dtype`` overrides the KV pool element type: a plain narrow dtype
    ("bfloat16") casts on write; a quantized dtype ("int8", "fp8_e4m3")
    additionally allocates per-(block, token, kv-head) f32 scale pools
    mirroring the KV pools' block layout, written by ``_scatter_kv`` and
    consumed by the kernel's fused dequant.  Pools start as zeros (never
    uninitialised memory): masked keys multiply ``p = 0`` by whatever a
    block holds, so every cell must be finite from the start.
    The ssm family holds no KV pools, the hybrid family both: SSM/conv
    state is O(1) per sequence, a plain per-slot tensor ``conv (L,
    max_seqs, K-1, ch)`` in the model dtype and ``state (L, max_seqs, h, p,
    n)`` f32 (carried, not re-derived, so ``dtype`` does not narrow it).
    """
    require_ported(cfg)
    ssm_state = (_ssm_state(cfg, cfg.num_layers, max_seqs, device)
                 if cfg.family == "ssm" or cfg.hybrid else {})
    if cfg.family == "ssm":
        return ssm_state
    quant = is_quantized(dtype)
    dt = pool_dtype(dtype) if quant else dtype_of(dtype or cfg.dtype)
    L, KH = cfg.num_layers, cfg.n_kv_heads
    cache: dict[str, Any] = {
        "k": torch.zeros((L, num_blocks, block_size, KH, cfg.head_dim_),
                         dtype=dt, device=device),
        "v": torch.zeros((L, num_blocks, block_size, KH, cfg.v_head_dim_),
                         dtype=dt, device=device),
    }
    if quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((L, num_blocks, block_size, KH),
                                      dtype=torch.float32, device=device)
    cache.update(ssm_state)
    return cache


def paged_cache_axes(cfg: ArchConfig, quantized: bool = False) -> dict:
    """Logical axes of the paged-pool cache tree.  The block-address axes
    (``serve_blocks``, block offset) stay replicated — any slot's blocks
    must be readable from every data shard; KV shards over kv_heads (tensor
    parallel) and the per-slot SSM state over the slot (``serve_batch``)
    axis.  ``quantized`` adds the scale-pool leaves, which shard exactly
    like their KV pools minus the head_dim axis."""
    axes: dict[str, Any] = {}
    if cfg.family != "ssm":
        axes["k"] = ("layers", "serve_blocks", None, "kv_heads", None)
        axes["v"] = ("layers", "serve_blocks", None, "kv_heads", None)
        if quantized:
            axes["k_scale"] = ("layers", "serve_blocks", None, "kv_heads")
            axes["v_scale"] = ("layers", "serve_blocks", None, "kv_heads")
    if cfg.family == "ssm" or cfg.hybrid:
        axes["conv"] = ("layers", "serve_batch", None, None)
        axes["state"] = ("layers", "serve_batch", "ssm_heads", None, None)
    return axes


def paged_decode_step(params: dict, cfg: ArchConfig, cache: dict,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      block_tables: torch.Tensor,
                      active: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """One continuous-batching decode step.

    tokens (B,) int32; positions (B,) int32 per-slot write index (slots may
    be at different depths); block_tables (B, NB) int32; active (B,) bool
    marks the slots actually fed this step (None = all).  Inactive slots —
    idle, or mid chunked-prefill and advancing through
    ``paged_prefill_step`` instead — keep their recurrent SSM/conv state
    untouched; their K/V writes are already harmless because the engine
    hands them a zeroed table row (everything lands in the null block).
    Returns (logits (B, V), the cache, written in place).
    """
    require_ported(cfg)
    x = params["tok_embed"][tokens.long()[:, None]]             # (B,1,d)
    # slots at position 0 start a (re-)prefill: their recurrent state is
    # from a previous occupant (or idle-step garbage) and is zeroed before
    # use — KV needs no such reset, reads are length-masked
    fresh = positions == 0
    memo: dict = {}           # the layers' shared RoPE tables, write index

    def attn_fn(ap, hn, lc, window):
        a_out, _ = attn.attention_paged_decode(
            ap, cfg, hn, positions, lc, block_tables, window=window,
            memo=memo)
        return a_out

    def ssm_fn(sp, hn, lc):
        return ssm_decode_rows(sp, cfg, hn, lc, fresh, active)

    h = _run_decode_layers(params, cfg, cache, x, attn_fn, ssm_fn,
                           None if active is None else active[:, None])
    return logits_from_hidden(params, cfg, h)[:, 0], cache


def _paged_chunk_forward(params: dict, cfg: ArchConfig, cache: dict,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         slots: torch.Tensor, block_tables: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Shared core of chunked prefill and speculative verify: push a
    fixed-width chunk of tokens per sequence through the layer stack,
    scattering K/V of the valid tokens into the paged pool (padding lands
    in the null block) and advancing the recurrent SSM state of rows
    ``slots`` through the valid prefix.  Returns hidden (B, C, d)."""
    require_ported(cfg)
    x = params["tok_embed"][tokens.long()]                      # (B,C,d)
    fresh = positions[:, 0] == 0      # first chunk: reset recurrent state
    # rows riding the fixed-shape chunk batch with no tokens this step
    # (valid == 0: idle or decode-phase slots) keep their recurrent state
    fed = valid > 0
    memo: dict = {}           # the layers' shared RoPE tables, write index

    def attn_fn(ap, hn, lc, window):
        a_out, _ = attn.attention_paged_prefill(
            ap, cfg, hn, positions, lc, block_tables, valid, window=window,
            memo=memo)
        return a_out

    rows = slots.long()

    def ssm_fn(sp, hn, lc):
        return ssm_chunk_rows(sp, cfg, hn, lc, rows, fresh, fed, valid)

    inchunk = torch.arange(tokens.shape[1], device=valid.device
                           )[None, :] < valid[:, None]          # real tokens
    return _run_decode_layers(params, cfg, cache, x, attn_fn, ssm_fn,
                              inchunk)


def paged_prefill_step(params: dict, cfg: ArchConfig, cache: dict,
                       tokens: torch.Tensor, positions: torch.Tensor,
                       slots: torch.Tensor, block_tables: torch.Tensor,
                       valid: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Chunked prefill: push a fixed-size chunk of known tokens through the
    layer stack, scattering K/V into the paged pool — O(P/chunk) engine
    steps for a P-token prompt.

    tokens (B, C) int32, right-padded; positions (B, C) absolute indices
    (``num_cached + arange(C)``); slots (B,) int32; block_tables (B, NB);
    valid (B,) real-token counts.  Returns (logits of each sequence's last
    valid token (B, V), cache) — rows with ``valid == 0`` produce logits
    the engine ignores.
    """
    h = _paged_chunk_forward(params, cfg, cache, tokens, positions, slots,
                             block_tables, valid)
    last = (valid.long() - 1).clamp(min=0)[:, None, None]
    h_last = torch.gather(h, 1, last.expand(-1, 1, h.shape[-1]))  # (B,1,d)
    return logits_from_hidden(params, cfg, h_last)[:, 0], cache


def paged_verify_step(params: dict, cfg: ArchConfig, cache: dict,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      slots: torch.Tensor, block_tables: torch.Tensor,
                      valid: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Speculative-verify scoring step: same contract as
    ``paged_prefill_step`` but the full (B, K+1, V) logits come back, so a
    caller can accept/reject each drafted token against the exact
    distribution a token-by-token decode would have produced."""
    h = _paged_chunk_forward(params, cfg, cache, tokens, positions, slots,
                             block_tables, valid)
    return logits_from_hidden(params, cfg, h), cache


# ---------------------------------------------------------------------------
# stack/unstack helpers for the pruning engine's unrolled analysis mode
# ---------------------------------------------------------------------------

def unstack_layers(params: dict, num_layers: int) -> dict:
    out = dict(params)
    out["layers"] = [_layer(params["layers"], i) for i in range(num_layers)]
    return out


def stack_layers(params: dict) -> dict:
    out = dict(params)
    out["layers"] = _stack(list(params["layers"]))
    return out
