"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16.  Parallel attention + mamba heads in each layer; sliding-window
attention except for a few global layers.  [arXiv:2411.13676; hf-verified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("hymba-1.5b")
def hymba_1_5b() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        hybrid=True,
        num_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32_001,
        rope_theta=10_000.0,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        sliding_window=1024,
        global_layers=(0, 15, 31),
    )
