"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.

SigLIP vision frontend (STUB per spec: ``input_specs`` provides precomputed
patch embeddings) + gemma decoder backbone.  [arXiv:2407.07726; hf-verified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("paligemma-3b")
def paligemma_3b() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16_384,
        vocab_size=257_216,
        rope_theta=10_000.0,
        tie_embeddings=True,
        vision_tokens=256,          # 224px / 14 patch -> 16x16
        vision_embed_dim=1152,      # SigLIP-so400m width
    )
