"""ResNet / VGG at CIFAR scale — the paper's own experiment models (the port
of the reference's ``models/cnn.py``).

BatchNorm running statistics live in a separate ``state`` tree (they are
recalibrated, not trained — OBSPA's BN-recalibration, paper App. B.3,
forwards calibration data through train-mode BN and keeps the new
statistics).

The reference's layouts and key paths are kept: activations NHWC, conv
weights HWIO ``(kh, kw, C_in, C_out)``, so SPA's group keys come out letter
for letter the same.  Each convolution views its input as NCHW and its
weight as OIHW (``permute``, no copy of the activation: an NHWC tensor seen
as NCHW is channels-last, which cuDNN takes as it is) and views the output
back; the trace's ``permute`` rule carries the axes through.

Where torch's defaults differ from the reference's arithmetic, the
reference's is written out:
  - "SAME" padding is asymmetric where its total is odd — (0, 1) for a 3x3
    stride-2 convolution of an even map — which ``F.conv2d``'s symmetric
    ``padding`` cannot express, so such a convolution pads with ``F.pad``
    first and convolves with no padding;
  - train-mode BatchNorm normalises by the biased batch variance and
    updates the running statistics as ``0.9·old + 0.1·new`` with that
    biased variance (``F.batch_norm`` would update with the unbiased one).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import cross_entropy

CNN_KINDS = ("resnet", "vgg")


def _conv_init(gen: torch.Generator, kh, kw, cin, cout) -> torch.Tensor:
    std = (2.0 / (kh * kw * cin)) ** 0.5
    return torch.randn((kh, kw, cin, cout), generator=gen,
                       device=gen.device) * std


def _fc_init(gen: torch.Generator, cin, classes) -> torch.Tensor:
    return torch.randn((cin, classes), generator=gen,
                       device=gen.device) * (1.0 / cin ** 0.5)


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME" for one spatial axis."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC, "SAME" padding."""
    (top, bottom), (left, right) = (
        same_pads(x.shape[1], w.shape[0], stride),
        same_pads(x.shape[2], w.shape[1], stride))
    xc = x.permute(0, 3, 1, 2)
    if top == bottom and left == right:
        pad = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        pad = (0, 0)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool with stride 2 ("VALID") of an NHWC map."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _bn_init(c: int, device) -> tuple[dict, dict]:
    return ({"scale": torch.ones((c,), device=device),
             "bias": torch.zeros((c,), device=device)},
            {"mean": torch.zeros((c,), device=device),
             "var": torch.ones((c,), device=device)})


def _bn(x, p, s, train: bool, eps=1e-5):
    if train:
        mu = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), correction=0)
        new_s = {"mean": 0.9 * s["mean"] + 0.1 * mu,
                 "var": 0.9 * s["var"] + 0.1 * var}
    else:
        mu, var = s["mean"], s["var"]
        new_s = s
    y = (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y, new_s


# ---------------------------------------------------------------------------
# ResNet (basic blocks)
# ---------------------------------------------------------------------------

def _resnet_init(cfg: ArchConfig, gen: torch.Generator):
    params: dict[str, Any] = {}
    state: dict[str, Any] = {}
    dev = gen.device
    stem = cfg.cnn_stem
    params["stem_conv"] = _conv_init(gen, 3, 3, 3, stem)
    params["stem_bn"], state["stem_bn"] = _bn_init(stem, dev)
    cin = stem
    for si, (ch, blocks) in enumerate(cfg.cnn_stages):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk: dict[str, Any] = {"conv1": _conv_init(gen, 3, 3, cin, ch),
                                   "conv2": _conv_init(gen, 3, 3, ch, ch)}
            st: dict[str, Any] = {}
            blk["bn1"], st["bn1"] = _bn_init(ch, dev)
            blk["bn2"], st["bn2"] = _bn_init(ch, dev)
            if stride != 1 or cin != ch:
                blk["proj"] = _conv_init(gen, 1, 1, cin, ch)
                blk["proj_bn"], st["proj_bn"] = _bn_init(ch, dev)
            params[f"s{si}b{bi}"], state[f"s{si}b{bi}"] = blk, st
            cin = ch
    params["fc"] = _fc_init(gen, cin, cfg.num_classes)
    return params, state


def _resnet_forward(cfg, params, state, x, train):
    new_state: dict[str, Any] = {}
    h = _conv(x, params["stem_conv"])
    h, new_state["stem_bn"] = _bn(h, params["stem_bn"], state["stem_bn"],
                                  train)
    h = torch.relu(h)
    for si, (_, blocks) in enumerate(cfg.cnn_stages):
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            blk, st = params[name], state[name]
            stride = 2 if (bi == 0 and si > 0) else 1
            ns: dict[str, Any] = {}
            y = _conv(h, blk["conv1"], stride)
            y, ns["bn1"] = _bn(y, blk["bn1"], st["bn1"], train)
            y = torch.relu(y)
            y = _conv(y, blk["conv2"])
            y, ns["bn2"] = _bn(y, blk["bn2"], st["bn2"], train)
            if "proj" in blk:
                sc = _conv(h, blk["proj"], stride)
                sc, ns["proj_bn"] = _bn(sc, blk["proj_bn"], st["proj_bn"],
                                        train)
            else:
                sc = h
            h = torch.relu(y + sc)
            new_state[name] = ns
    h = h.mean(dim=(1, 2))
    return h @ params["fc"], new_state


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

def _vgg_init(cfg: ArchConfig, gen: torch.Generator):
    params: dict[str, Any] = {}
    state: dict[str, Any] = {}
    cin = 3
    for si, (ch, convs) in enumerate(cfg.cnn_stages):
        for ci in range(convs):
            name = f"s{si}c{ci}"
            params[name] = {"conv": _conv_init(gen, 3, 3, cin, ch)}
            params[name]["bn"], state[name] = _bn_init(ch, gen.device)
            cin = ch
    params["fc"] = _fc_init(gen, cin, cfg.num_classes)
    return params, state


def _vgg_forward(cfg, params, state, x, train):
    new_state: dict[str, Any] = {}
    h = x
    for si, (_, convs) in enumerate(cfg.cnn_stages):
        for ci in range(convs):
            name = f"s{si}c{ci}"
            h = _conv(h, params[name]["conv"])
            h, new_state[name] = _bn(h, params[name]["bn"], state[name],
                                     train)
            h = torch.relu(h)
        h = _max_pool(h)
    h = h.mean(dim=(1, 2))
    return h @ params["fc"], new_state


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def cnn_init(cfg: ArchConfig, gen: torch.Generator):
    """(params, state) drawn from ``gen`` on ``gen.device``, f32."""
    if cfg.cnn_kind == "resnet":
        return _resnet_init(cfg, gen)
    if cfg.cnn_kind == "vgg":
        return _vgg_init(cfg, gen)
    raise ValueError(f"cnn_kind {cfg.cnn_kind!r} is not one of {CNN_KINDS}")


def cnn_forward(cfg: ArchConfig, params, state, x, train: bool = False):
    """(logits (B, classes), new state); ``train`` normalises by the batch
    statistics and returns the updated running statistics."""
    if cfg.cnn_kind == "resnet":
        return _resnet_forward(cfg, params, state, x, train)
    return _vgg_forward(cfg, params, state, x, train)


def stage_widths(cfg: ArchConfig, params) -> list[list[int]]:
    """Output channels of every convolution of each stage, in order
    (ResNet: each block's ``conv1``, ``conv2``; VGG: each ``conv``) — the
    channels a pruned CNN kept."""
    out = []
    for si, (_, n) in enumerate(cfg.cnn_stages):
        if cfg.cnn_kind == "resnet":
            blocks = [params[f"s{si}b{bi}"] for bi in range(n)]
            out.append([int(b[k].shape[3]) for b in blocks
                        for k in ("conv1", "conv2")])
        else:
            out.append([int(params[f"s{si}c{ci}"]["conv"].shape[3])
                        for ci in range(n)])
    return out


def cnn_loss(cfg, params, state, batch, train: bool = False):
    logits, new_state = cnn_forward(cfg, params, state, batch["images"],
                                    train)
    loss = cross_entropy(logits, batch["labels"])
    return loss, (new_state, {"ce": loss})
