"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.

llama2-arch small.  [arXiv:2401.02385; hf-verified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("tinyllama-1.1b")
def tinyllama_1_1b() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab_size=32_000,
        rope_theta=10_000.0,
    )
