"""The plain PyTorch version of full-sequence flash attention (GQA + causal /
sliding window), the port of ``repro.kernels.flash_attention.ref``.

Shapes (kernel layout, batch-heads-major):
  q (B, H,  Sq, D)    k (B, KH, Sk, D)    v (B, KH, Sk, DV)
  H = KH * G (grouped queries: head h reads KV head h // G); out (B, H, Sq,
  DV) in q's dtype.  Logits, softmax and PV in f32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, KH, G, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) * scale
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)
