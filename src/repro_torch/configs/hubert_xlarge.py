"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only transformer backbone (same arch as wav2vec2); the conv waveform
frontend is a STUB per spec (``input_specs`` provides precomputed frame
embeddings).  Predicts 504 cluster targets.  [arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import ArchConfig, register


@register("hubert-xlarge")
def hubert_xlarge() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        is_encoder=True,
        audio_frontend=True,
        norm_eps=1e-5,
    )
