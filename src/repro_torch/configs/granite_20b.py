"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

llama-arch, code model, multi-query attention.  [arXiv:2405.04324; hf-verified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("granite-20b")
def granite_20b() -> ArchConfig:
    return ArchConfig(
        name="granite-20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24_576,
        vocab_size=49_152,
        rope_theta=10_000.0,
    )
