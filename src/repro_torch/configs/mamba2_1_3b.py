"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128.  SSD (state-space duality).  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("mamba2-1.3b")
def mamba2_1_3b() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        vocab_size=50_280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=128,
        tie_embeddings=True,
        norm_eps=1e-5,
    )
