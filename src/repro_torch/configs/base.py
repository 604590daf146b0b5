"""Architecture config system (framework-free; the PyTorch port's own copy).

One ``ArchConfig`` describes any model in the zoo (dense / moe / vlm /
hybrid / ssm / audio transformer backbones, plus the CNNs used for the
paper-faithful pruning experiments).  Configs are plain frozen dataclasses:
the pruner emits *new* configs with smaller dims, which is how structured
pruning becomes a real shape change rather than masking.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio", "cnn")
AUDIO_FRAME_DIM = 512   # stub conv-frontend output width (w2v2-style)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    # --- transformer backbone ---
    num_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads
    v_head_dim: int = 0            # 0 -> head_dim; SPA can prune V/output
                                   # head_dim separately (it is not RoPE'd)
    d_ff: int = 0                  # dense FFN hidden (SwiGLU)
    vocab_size: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    is_encoder: bool = False       # bidirectional attn, no decode path
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # per routed expert
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch_groups: int = 1   # hierarchical dispatch: one local group
                                   # per DP shard -> collective-optimal
                                   # expert all-to-all (see DESIGN.md §4)
    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_heads_override: int = 0    # set by the pruner when SSD heads shrink
    # --- hybrid (Hymba-style parallel attn + ssm heads) ---
    hybrid: bool = False
    sliding_window: int = 0        # 0 -> full attention
    global_layers: tuple[int, ...] = ()
    # --- VLM stub frontend ---
    vision_tokens: int = 0
    vision_embed_dim: int = 0
    # --- audio stub frontend ---
    audio_frontend: bool = False
    # --- CNN (paper-faithful experiments) ---
    cnn_stem: int = 0
    cnn_stages: tuple[tuple[int, int], ...] = ()   # (channels, blocks) per stage
    cnn_kind: str = ""            # "resnet" | "vgg"
    num_classes: int = 0
    image_size: int = 32
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: bool = True
    use_scan: bool = True
    use_kernels: bool = True       # CUDA tensors go through the hand-written
                                   # kernels; False asks for the plain
                                   # PyTorch versions explicitly

    # ----- derived -----
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def v_head_dim_(self) -> int:
        return self.v_head_dim or self.head_dim_

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        if not self.ssm_state:
            return 0
        return self.ssm_heads_override or self.d_inner // self.ssm_head_dim

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM / hybrid-with-SWA)"""
        return self.family == "ssm" or (self.hybrid and self.sliding_window > 0)

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder and self.family != "cnn"

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ----- parameter counting (analytic; validated against real pytrees) -----
    def param_count(self) -> int:
        if self.family == "cnn":
            return -1  # counted from the pytree directly
        d, hd = self.d_model, self.head_dim_
        L = self.num_layers
        per_layer = 0
        if self.family != "ssm":
            # attention: q, k, v, o (+ qk_norm scales); v and o at the V head
            # dim, which pruning may narrow on its own (the reference counts
            # them at head_dim)
            vhd = self.v_head_dim_
            per_layer += d * self.n_heads * hd + d * self.n_kv_heads * hd \
                + d * self.n_kv_heads * vhd + self.n_heads * vhd * d
            if self.qk_norm:
                per_layer += 2 * hd
        if self.family == "ssm" or self.hybrid:
            # the SSD heads' width, which pruning narrows (the reference
            # counts expand * d_model, which a pruned config no longer has)
            nh, ns = self.ssm_n_heads, self.ssm_state
            di = nh * self.ssm_head_dim
            # in_proj produces [x, z, B, C, dt]; out_proj back to d
            per_layer += d * (2 * di + 2 * ns + nh) + di * d
            per_layer += self.ssm_conv * (di + 2 * ns)      # conv1d
            per_layer += 3 * nh + di            # A_log, D, dt_bias; norm
        if self.n_experts:
            per_layer += d * self.n_experts                   # router
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
            per_layer += self.n_shared_experts * 3 * d * self.shared_d_ff
            if self.n_shared_experts:
                per_layer += d                                # shared gate
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff                    # SwiGLU
        # RMSNorms: ln1, and ln2 before an FFN (an ssm layer has none)
        per_layer += d if self.family == "ssm" else 2 * d
        embed = (AUDIO_FRAME_DIM * d if self.family == "audio"
                 else self.vocab_size * d)
        total = L * per_layer + embed + d                     # embed + final norm
        if not self.tie_embeddings and not self.is_encoder:
            total += self.vocab_size * d                      # lm head
        if self.is_encoder:
            total += d * self.vocab_size                      # classifier head
        if self.vision_tokens:
            total += self.vision_embed_dim * d                # stub projection
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        dense_like = self.replace(
            n_experts=0, top_k=0, moe_d_ff=0, n_shared_experts=0, shared_d_ff=0)
        base = dense_like.param_count()
        d = self.d_model
        per_layer = d * self.n_experts \
            + self.top_k * 3 * d * self.moe_d_ff \
            + self.n_shared_experts * 3 * d * self.shared_d_ff
        if self.n_shared_experts:
            per_layer += d
        return base + self.num_layers * per_layer


# ---------------------------------------------------------------------------
# Input-shape grid (the 4 assigned LM shapes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"
    cache_dtype: str = ""          # paged-cell KV pool dtype override:
                                   # "int8"/"fp8_e4m3" quantize the pool
                                   # (+ f32 scale pools, DESIGN.md §11)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
    # serving-engine steps (repro.serve): block-pool cache + block tables;
    # for paged_prefill seq_len is the prefill *chunk* length per slot
    "paged_decode_32k": ShapeConfig("paged_decode_32k", 32_768, 128,
                                    "paged_decode"),
    "paged_prefill_512": ShapeConfig("paged_prefill_512", 512, 8,
                                     "paged_prefill"),
    # speculative verify: 8 tokens (1 sampled + 7 drafts) scored per slot
    # in one multi-token pass against a 32k paged history (DESIGN.md §9)
    "spec_verify_8": ShapeConfig("spec_verify_8", 32_768, 128,
                                 "spec_verify"),
    # mesh-aware serving step (DESIGN.md §10): same shape as
    # paged_decode_32k but lowered under the *serve* rule set — slots
    # data-parallel, pools tensor-parallel over kv_heads — with the mesh
    # threaded through so the engine-identical sharded step is what the
    # grid measures
    "paged_decode_sharded": ShapeConfig("paged_decode_sharded", 32_768, 128,
                                        "paged_decode_sharded"),
    # quantized-cache serving step (DESIGN.md §11): paged_decode_32k with
    # an int8 KV pool + per-(block, token, kv-head) f32 scale pools and
    # the dequant fused into the paged-attention kernel — the roofline
    # must show the ~4x lower cache bytes/token vs the f32 cell
    "paged_decode_q8": ShapeConfig("paged_decode_q8", 32_768, 128,
                                   "paged_decode", cache_dtype="int8"),
}

# verify chunk width of the spec_verify grid cell (the K of its name);
# single source for the input spec (models/api.py) and the analytic
# FLOPs model (benchmarks/roofline.py)
SPEC_VERIFY_CHUNK = 8

DECODE_KINDS = ("decode", "paged_decode", "paged_prefill", "spec_verify",
                "paged_decode_sharded")


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) a runnable dry-run cell?  Returns (ok, reason)."""
    if shape.kind in DECODE_KINDS and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch cannot serve 500k ctx (see DESIGN.md)"
    if shape.kind == "spec_verify" and (cfg.family == "ssm" or cfg.hybrid):
        return False, ("speculative rollback drops KV cursor positions; "
                       "recurrent SSM/conv state cannot be rewound "
                       "(DESIGN.md §9 capability matrix)")
    if shape.cache_dtype and cfg.family == "ssm":
        return False, ("no KV pool to quantize: the recurrent state is "
                       "carried, not re-derived, so it stays full "
                       "precision (DESIGN.md §11)")
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    # late import so `configs.<arch>` modules self-register
    from repro_torch import configs as _pkg  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from repro_torch import configs as _pkg  # noqa: F401
    return sorted(_REGISTRY)


ASSIGNED_ARCHS = (
    "qwen3-1.7b", "tinyllama-1.1b", "phi3-medium-14b", "granite-20b",
    "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "paligemma-3b", "hymba-1.5b",
    "mamba2-1.3b", "hubert-xlarge",
)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family variant for CPU smoke tests."""
    if cfg.family == "cnn":
        # keep >=1px after all downsamples (vgg pools once per stage)
        img = max(16, 2 ** (len(cfg.cnn_stages) + 1))
        return cfg.replace(name=cfg.name + "-reduced",
                           cnn_stem=8,
                           cnn_stages=tuple((max(8, c // 16), min(b, 2))
                                            for c, b in cfg.cnn_stages),
                           image_size=img)
    kw: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=64,
        head_dim=16,
        vocab_size=min(cfg.vocab_size, 256),   # keep small class counts
        dtype="float32",
        remat=False,
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1))
    if cfg.d_ff:
        kw["d_ff"] = 128
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=32)
        if cfg.n_shared_experts:
            kw.update(n_shared_experts=2, shared_d_ff=64)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.vision_tokens:
        kw.update(vision_tokens=8, vision_embed_dim=32)
    if cfg.sliding_window:
        kw.update(sliding_window=32, global_layers=(0,))
    return cfg.replace(**kw)
