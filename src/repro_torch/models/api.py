"""Model facade: one object per ArchConfig binding the pure functions of
``models/transformer.py``, or of ``models/cnn.py`` for the cnn family
(``{"params", "state"}`` trees).  Encoders, the vlm family and CNNs have
no decode path (``serve.Engine`` refuses them).  ``init`` and the cache
constructors take an explicit ``device``; ``None`` means the CUDA device and
raises when there is none (ask for ``device="cpu"`` explicitly)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import AUDIO_FRAME_DIM, ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ----- init -----
    def init(self, seed: int = 0, device=None) -> dict:
        """Random parameters from a ``torch.Generator`` seeded with ``seed``
        on the target device."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
        if self.cfg.family == "cnn":
            params, state = cnn_mod.cnn_init(self.cfg, gen)
            return {"params": params, "state": state}
        return tf.init_params(self.cfg, gen)

    def param_axes(self) -> dict:
        """Logical sharding axes of ``init``'s tree (none for a CNN)."""
        if self.cfg.family == "cnn":
            raise ValueError("CNNs are CPU-scale; no sharding axes")
        return tf.param_axes(self.cfg)

    # ----- training -----
    def loss(self, params, batch):
        """(loss, metrics).  A CNN runs its BatchNorm in eval mode here, on
        the running statistics in ``params["state"]``, as the reference's
        ``Model.loss`` does (so a trainer moves those statistics by their
        gradients; only ``recalibrate_bn`` refreshes them from data)."""
        if self.cfg.family == "cnn":
            loss, (_, metrics) = cnn_mod.cnn_loss(
                self.cfg, params["params"], params["state"], batch,
                train=False)
            return loss, metrics
        return tf.loss_fn(params, self.cfg, batch)

    def forward(self, params, batch):
        if self.cfg.family == "cnn":
            logits, _ = cnn_mod.cnn_forward(
                self.cfg, params["params"], params["state"], batch["images"])
            return logits
        h, _ = tf.forward(params, self.cfg, batch)
        return tf.logits_from_hidden(params, self.cfg, h)

    # ----- serving -----
    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        return tf.init_cache(self.cfg, batch, max_len,
                             resolve_device(device))

    def cache_axes(self, long_context: bool = False) -> dict:
        return tf.cache_axes(self.cfg, long_context)

    def decode_step(self, params, cache, tokens, pos):
        return tf.decode_step(params, self.cfg, cache, tokens, pos)

    # ----- paged serving (continuous batching; repro_torch.serve) -----
    def init_paged_cache(self, num_blocks: int, block_size: int,
                         max_seqs: int, dtype: str | None = None,
                         device=None) -> dict:
        return tf.init_paged_cache(self.cfg, num_blocks, block_size, max_seqs,
                                   dtype=dtype,
                                   device=resolve_device(device))

    def paged_decode_step(self, params, cache, tokens, positions,
                          block_tables, active=None):
        """``active`` (B,) bool marks the slots fed this step; the others
        keep their recurrent state (ssm family)."""
        return tf.paged_decode_step(params, self.cfg, cache, tokens,
                                    positions, block_tables, active)

    def paged_prefill_step(self, params, cache, tokens, positions, slots,
                           block_tables, valid):
        return tf.paged_prefill_step(params, self.cfg, cache, tokens,
                                     positions, slots, block_tables, valid)

    def paged_verify_step(self, params, cache, tokens, positions, slots,
                          block_tables, valid):
        """Multi-token scoring step: logits at every position (B, K+1, V),
        not just the last valid one."""
        return tf.paged_verify_step(params, self.cfg, cache, tokens,
                                    positions, slots, block_tables, valid)

    def paged_cache_axes(self, quantized: bool = False) -> dict:
        return tf.paged_cache_axes(self.cfg, quantized=quantized)

    # ----- concrete dummy data (analysis traces, smoke tests) -----
    def dummy_batch(self, batch: int, seq: int, seed: int = 0,
                    device=None) -> dict:
        """Seeded random inputs in the reference's shapes, drawn with numpy
        so that every device sees the same values: tokens ``(batch, seq)``
        int32; for the audio family frames ``(batch, seq,
        AUDIO_FRAME_DIM)`` in the model's dtype and targets ``(batch,)``
        (at most 16 classes) or ``(batch, seq)``; for the vlm family
        patches ``(batch, vision_tokens, vision_embed_dim)`` and tokens
        ``(batch, max(seq - vision_tokens, 4))``; for a CNN images
        ``(batch, size, size, 3)`` f32 and labels ``(batch,)`` int32
        (``seq`` unused)."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        dev = resolve_device(device)
        T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        dt = dtype_of(cfg.dtype)
        if cfg.family == "cnn":
            s = cfg.image_size
            imgs = rng.standard_normal((batch, s, s, 3)).astype(np.float32)
            labels = rng.integers(0, cfg.num_classes, batch)
            return {"images": T(imgs), "labels": T(labels.astype(np.int32))}
        if cfg.family == "audio":
            frames = rng.standard_normal((batch, seq, AUDIO_FRAME_DIM))
            shape = (batch,) if cfg.vocab_size <= 16 else (batch, seq)
            targets = rng.integers(0, cfg.vocab_size, shape)
            return {"frames": T(frames.astype(np.float32)).to(dt),
                    "targets": T(targets.astype(np.int32))}
        out = {}
        if cfg.family == "vlm":
            nv = cfg.vision_tokens
            patches = rng.standard_normal((batch, nv, cfg.vision_embed_dim))
            out["patches"] = T(patches.astype(np.float32)).to(dt)
            seq = max(seq - nv, 4)
        toks = rng.integers(0, cfg.vocab_size, size=(batch, seq))
        out["tokens"] = T(toks.astype(np.int32))
        return out


def build(cfg: ArchConfig) -> Model:
    tf.require_ported(cfg)
    return Model(cfg)
