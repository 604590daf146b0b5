"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) per-expert d_ff=1408,
vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf-verified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen2-moe-a2.7b")
def qwen2_moe_a2_7b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        vocab_size=151_936,
        rope_theta=1_000_000.0,
        n_experts=60,
        top_k=4,
        moe_d_ff=1408,
        n_shared_experts=4,
        shared_d_ff=5632,
    )
