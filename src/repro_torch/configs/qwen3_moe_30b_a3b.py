"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768,
vocab=151936, MoE 128 experts top-8.  qk_norm.  [hf:Qwen/Qwen3-30B-A3B; hf-verified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen3-moe-30b-a3b")
def qwen3_moe_30b_a3b() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        n_experts=128,
        top_k=8,
        moe_d_ff=768,
    )
