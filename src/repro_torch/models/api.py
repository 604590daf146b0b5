"""Model facade: one object per ArchConfig binding the pure functions of
``models/transformer.py``, or of ``models/cnn.py`` for the cnn family
(``{"params", "state"}`` trees; no decode path).  ``init`` and the cache
constructors take an explicit ``device``; ``None`` means the CUDA device and
raises when there is none (ask for ``device="cpu"`` explicitly)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import transformer as tf


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

    # ----- concrete dummy data (analysis traces, smoke tests) -----
    def dummy_batch(self, batch: int, seq: int, seed: int = 0,
                    device=None) -> dict:
        """Seeded random tokens ``(batch, seq)`` int32 — for a CNN, images
        ``(batch, size, size, 3)`` f32 and labels ``(batch,)`` int32 (``seq``
        unused) — drawn with numpy so that every device sees the same
        values."""
        rng = np.random.default_rng(seed)
        dev = resolve_device(device)
        if self.cfg.family == "cnn":
            s = self.cfg.image_size
            imgs = rng.standard_normal((batch, s, s, 3)).astype(np.float32)
            labels = rng.integers(0, self.cfg.num_classes, batch)
            return {"images": torch.from_numpy(imgs).to(dev),
                    "labels": torch.from_numpy(
                        labels.astype(np.int32)).to(dev)}
        toks = rng.integers(0, self.cfg.vocab_size, size=(batch, seq))
        return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(dev)}


def build(cfg: ArchConfig) -> Model:
    tf.require_ported(cfg)
    return Model(cfg)
