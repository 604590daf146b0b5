"""Fault-tolerant checkpointing: atomic, checksummed, framework-free (the
port of ``repro.train.checkpoint``; the two read each other's files).

  - *Logical* arrays are saved (full, device-free) under the reference's
    dotted key paths (``params.layers.attn.wq``, ``opt.m...``, ``opt.step``
    an int32 scalar), in its sorted-key order.
  - Atomic: write to ``<name>.tmp`` then ``os.replace`` — a crash mid-write
    can never corrupt the latest checkpoint.
  - Checksummed: CRC32 (big-endian) over the compressed payload;
    ``latest_checkpoint`` skips corrupt files, so restore falls back to the
    newest *valid* step.
  - Rolling retention keeps the last K plus periodic milestones.

File layout: ``SPA1`` | CRC32 | codec byte | compressed msgpack of
``{"step", "meta", "arrays": {path: {"dtype", "shape", "data"}}}``.  The
port always writes the zlib codec (``b"D"``); it reads zstd (``b"Z"``) only
where the ``zstandard`` package imports.  ``bfloat16`` arrays are their raw
16-bit words, as ``ml_dtypes`` writes them.
"""
from __future__ import annotations

import os
import re
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.graph import tree_map_paths, tree_paths
from repro_torch.train import msgpack

_MAGIC = b"SPA1"
_CODEC_ZSTD = b"Z"
_CODEC_ZLIB = b"D"

_NP_NAMES = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.bfloat16: "bfloat16",
             torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
             torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


class CheckpointError(Exception):
    pass


def _zstandard():
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


def _decompress(blob: bytes) -> bytes:
    codec, payload = blob[:1], blob[1:]
    if codec == _CODEC_ZLIB:
        return zlib.decompress(payload)
    zstd = _zstandard()
    if codec == _CODEC_ZSTD:
        if zstd is None:
            raise CheckpointError("checkpoint is zstd-compressed but the "
                                  "zstandard package is not installed")
        return zstd.ZstdDecompressor().decompress(payload)
    # legacy blobs (before the codec byte) are zstd with no prefix
    if zstd is not None:
        return zstd.ZstdDecompressor().decompress(blob)
    raise CheckpointError("unknown checkpoint codec")


def _record(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    if t.dtype not in _NP_NAMES:
        raise CheckpointError(f"cannot save a {t.dtype} tensor")
    raw = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
    return {"dtype": _NP_NAMES[t.dtype], "shape": list(t.shape),
            "data": raw.numpy().tobytes()}


def _tensor(rec: dict) -> torch.Tensor:
    """A tensor of the recorded dtype and shape (bf16 through its 16-bit
    words)."""
    if rec["dtype"] == "bfloat16":
        arr = np.frombuffer(rec["data"], dtype=np.uint16)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        arr = np.frombuffer(rec["data"], dtype=np.dtype(rec["dtype"]))
        t = torch.from_numpy(arr.copy())
    return t.reshape(rec["shape"])


def save_checkpoint(path: str, step: int, tree: Any,
                    meta: dict | None = None) -> str:
    payload = {
        "step": int(step),
        "meta": meta or {},
        "arrays": {k: _record(v) for k, v in tree_paths(tree)},
    }
    comp = _CODEC_ZLIB + zlib.compress(msgpack.packb(payload), level=3)
    blob = _MAGIC + zlib.crc32(comp).to_bytes(4, "big") + comp
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_raw(path: str) -> dict:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != _MAGIC:
        raise CheckpointError(f"{path}: bad magic")
    crc = int.from_bytes(blob[4:8], "big")
    comp = blob[8:]
    if zlib.crc32(comp) != crc:
        raise CheckpointError(f"{path}: checksum mismatch")
    try:
        return msgpack.unpackb(_decompress(comp))
    except (zlib.error, msgpack.MsgpackError) as e:
        raise CheckpointError(f"{path}: {e}") from e


def load_checkpoint(path: str, template: Any) -> tuple[int, Any, dict]:
    """Restore into the nesting of ``template``: each leaf takes the
    template leaf's dtype and device.  Leaves missing from the file keep the
    template's value and are reported in ``meta["missing"]``; arrays the
    template lacks are reported in ``meta["extra"]``."""
    payload = load_raw(path)
    arrays = payload["arrays"]
    missing = []

    def fill(key, tmpl):
        if key not in arrays:
            missing.append(key)
            return tmpl
        return _tensor(arrays[key]).to(device=tmpl.device, dtype=tmpl.dtype)

    tree = tree_map_paths(fill, template)
    extra = set(arrays) - {k for k, _ in tree_paths(template)}
    meta = dict(payload["meta"], missing=missing, extra=sorted(extra))
    return payload["step"], tree, meta


_CKPT_RE = re.compile(r"step_(\d+)\.ckpt$")


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.search(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """Newest *valid* checkpoint (corrupt files are skipped)."""
    for step in reversed(checkpoint_steps(ckpt_dir)):
        path = ckpt_path(ckpt_dir, step)
        try:
            load_raw(path)
            return path
        except (CheckpointError, OSError):
            continue
    return None


def prune_old(ckpt_dir: str, keep: int = 3, milestone_every: int = 0):
    steps = checkpoint_steps(ckpt_dir)
    if len(steps) <= keep:
        return
    for step in steps[:-keep]:
        if milestone_every and step % milestone_every == 0:
            continue
        try:
            os.remove(ckpt_path(ckpt_dir, step))
        except OSError:
            pass
