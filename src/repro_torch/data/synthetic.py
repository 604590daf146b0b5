"""Deterministic synthetic data for every family: learnable tasks and the
calibration samplers, drawn with numpy exactly as the reference's
``repro/data/synthetic.py`` draws them, so a seed gives identical tokens,
frames, patches and images.

The paper's OBSPA experiments need three calibration regimes (§3.3):
  ID       — samples from the training distribution
  OOD      — samples from a *different* distribution of the same modality
  DataFree — uniform noise, no data access at all

LM tasks are order-2 Markov chains (learnable bigram structure).  The task's
``(vocab, vocab)`` transition matrix is built only when the mode samples from
it: ``datafree`` never does, and at a 32000-token vocabulary the matrix
alone is 8 GB (at paligemma's 257216, 529 GB: its ID / OOD batches cannot
be built at full width, here or in the reference).  Vision tasks are class
prototypes + noise; their DataFree images are uniform in [-1, 1).  The
audio family's task (``FrameTask``; the encoders vit-mini and
distilbert-mini too) labels Gaussian frames by quantile buckets of a fixed
random projection; its DataFree frames are uniform in [-1, 1) with uniform
targets.  The vlm family's batches are an LM batch cut to leave room for
Gaussian patch embeddings.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import AUDIO_FRAME_DIM
from repro_torch.device import resolve_device


@dataclasses.dataclass
class MarkovLM:
    vocab: int
    seed: int = 0
    temp: float = 3.0      # peaked transitions -> argmax acc is learnable

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        logits = rng.normal(size=(self.vocab, self.vocab)) * self.temp
        self.T = np.exp(logits - logits.max(-1, keepdims=True))
        self.T /= self.T.sum(-1, keepdims=True)

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, batch)
        for t in range(1, seq):
            p = self.T[out[:, t - 1]]
            c = p.cumsum(-1)
            u = rng.random((batch, 1))
            out[:, t] = (u < c).argmax(-1)
        return out


@dataclasses.dataclass
class PrototypeImages:
    n_classes: int
    image_size: int
    seed: int = 0
    noise: float = 0.6

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.protos = rng.normal(
            size=(self.n_classes, self.image_size, self.image_size, 3)
        ).astype(np.float32)

    def sample(self, rng: np.random.Generator, batch: int):
        labels = rng.integers(0, self.n_classes, batch)
        imgs = self.protos[labels] + rng.normal(
            size=(batch, self.image_size, self.image_size, 3)
        ).astype(np.float32) * self.noise
        return imgs.astype(np.float32), labels.astype(np.int32)


@dataclasses.dataclass
class FrameTask:
    """Audio / encoder task: Gaussian frames whose targets are quantile
    buckets of a fixed random projection of the frame (learnable); with at
    most 16 classes, one label a sequence from the pooled projection."""
    vocab: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.proj = rng.normal(size=(AUDIO_FRAME_DIM,)).astype(np.float32)

    def sample(self, rng: np.random.Generator, batch: int, seq: int):
        frames = rng.normal(size=(batch, seq, AUDIO_FRAME_DIM)
                            ).astype(np.float32)
        score = frames @ self.proj
        if self.vocab <= 16:
            # sequence classification: the bucket of the pooled signal
            pooled = score.mean(axis=1) * np.sqrt(seq)
            qs = np.quantile(pooled, np.linspace(0, 1, self.vocab + 1)[1:-1])
            return frames, np.digitize(pooled, qs).astype(np.int32)
        # per-frame prediction (HuBERT-style)
        qs = np.quantile(score, np.linspace(0, 1, self.vocab + 1)[1:-1])
        return frames, np.digitize(score, qs).astype(np.int32)


def make_task(cfg, mode: str = "id", seed: int = 0):
    """A data source for (cfg, mode).  OOD = different seed."""
    s = seed if mode == "id" else seed + 7919
    if cfg.family == "cnn":
        return PrototypeImages(cfg.num_classes, cfg.image_size, seed=s)
    if cfg.family == "audio":
        return FrameTask(cfg.vocab_size, seed=s)
    return MarkovLM(cfg.vocab_size, seed=s)


def batches(cfg, mode: str, n_batches: int, batch: int, seq: int,
            seed: int = 0, task_seed: int = 0, device=None) -> list[dict]:
    """Calibration / training batches on ``device`` (None: the CUDA
    device): ``{"tokens": (batch, seq) int32}``; for the audio family
    ``{"frames": (batch, seq, AUDIO_FRAME_DIM) f32, "targets": (batch,) or
    (batch, seq) int32}``; for the vlm family ``{"patches": (batch,
    vision_tokens, vision_embed_dim) f32, "tokens": (batch, max(seq -
    vision_tokens, 4)) int32}``; for a CNN ``{"images": (batch, size,
    size, 3) f32, "labels": (batch,) int32}`` (``seq`` unused).  mode: id
    | ood | datafree | eval.

    ``task_seed`` fixes the task identity (transition matrix / prototypes);
    ``seed`` only drives sampling — so every batch draws from the SAME
    learnable distribution.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + {"id": 0, "ood": 1, "datafree": 2,
                                        "eval": 3}[mode])
    task = None
    if mode != "datafree":
        task = make_task(cfg, "ood" if mode == "ood" else "id",
                         seed=task_seed)
    out = []
    for _ in range(n_batches):
        if cfg.family == "cnn":
            if task is None:
                size = (batch, cfg.image_size, cfg.image_size, 3)
                imgs = rng.random(size, dtype=np.float32) * 2 - 1
                labels = rng.integers(0, cfg.num_classes,
                                      batch).astype(np.int32)
            else:
                imgs, labels = task.sample(rng, batch)
            out.append({"images": torch.from_numpy(imgs).to(dev),
                        "labels": torch.from_numpy(labels).to(dev)})
            continue
        if cfg.family == "audio":
            if task is None:
                frames = rng.random((batch, seq, AUDIO_FRAME_DIM),
                                    dtype=np.float32) * 2 - 1
                targets = rng.integers(0, cfg.vocab_size,
                                       (batch, seq)).astype(np.int32)
            else:
                frames, targets = task.sample(rng, batch, seq)
            if cfg.vocab_size <= 16 and targets.ndim == 2:
                targets = targets[:, 0]   # the reference's DataFree label
            out.append({"frames": torch.from_numpy(frames).to(dev),
                        "targets": torch.from_numpy(targets).to(dev)})
            continue
        if task is None:
            toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        else:
            toks = task.sample(rng, batch, seq)
        b = {}
        if cfg.family == "vlm":
            nv = cfg.vision_tokens
            b["patches"] = torch.from_numpy(rng.normal(
                size=(batch, nv, cfg.vision_embed_dim)).astype(np.float32)
            ).to(dev)
            toks = toks[:, :max(seq - nv, 4)]
        b["tokens"] = torch.from_numpy(np.ascontiguousarray(toks)).to(dev)
        out.append(b)
    return out
