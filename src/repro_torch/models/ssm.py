"""Mamba-2 SSD (state-space duality) block — the port of the reference's
``models/ssm.py``.

Layout follows arXiv:2405.21060 ("minimal SSD"): per layer
  in-projections  d -> z (gate, d_inner), x (d_inner), B (n), C (n), dt (heads)
  causal depthwise conv1d over [x, B, C]
  chunked SSD scan  y = SSD(dt◦x, exp(dtA), B, C) + D ◦ x
  gated RMSNorm(y * silu(z)) -> out-projection d_inner -> d

Projections are stored per head, ``w_x``/``w_z`` ``(d, n_heads, head_dim)``
and ``w_out`` ``(n_heads, head_dim, d)``, so SPA head pruning acts on a real
axis; ``A_log``, ``D`` and ``dt_bias`` are f32.

The full-sequence forward (``ssm_block``) runs its chunked scan through the
hand-written kernel K3 (``kernels/ssd_scan``) on CUDA tensors when
``cfg.use_kernels``; otherwise, and on the CPU, through ``ssd_reference``
below, the plain version.  Chunked prefill (``ssm_prefill``) needs an
initial state in and the final state out, which the kernel does not take,
so it runs ``ssd_reference`` on every device, as the reference does.
``SSM_AXES`` holds the reference's logical sharding axes of these
parameters (``distributed.sharding`` maps them to mesh axes).  The serving
steps are staged (``decode_scan`` / ``prefill_scan`` between the
projections and ``_gated`` / ``_out_proj``) so that the tensor-parallel
steps of ``distributed.tensor_parallel`` run the same code on a shard's
heads, with their collectives between the stages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, dtype_of, rms_norm


def ssm_init(gen: torch.Generator, cfg) -> dict:
    d, n = cfg.d_model, cfg.ssm_state
    nh, hp = cfg.ssm_n_heads, cfg.ssm_head_dim
    di = nh * hp
    dt = dtype_of(cfg.dtype)
    dev = gen.device
    conv_ch = di + 2 * n
    f32 = torch.float32
    return {
        "w_z": dense_init(gen, (d, nh, hp), dt),
        "w_x": dense_init(gen, (d, nh, hp), dt),
        "w_B": dense_init(gen, (d, n), dt),
        "w_C": dense_init(gen, (d, n), dt),
        "w_dt": dense_init(gen, (d, nh), dt),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                          device=dev)),
        "D": torch.ones((nh,), dtype=f32, device=dev),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), dt,
                             fan_in=cfg.ssm_conv),
        "norm": torch.ones((di,), dtype=dt, device=dev),
        "w_out": dense_init(gen, (nh, hp, d), dt, fan_in=di),
    }


SSM_AXES = {
    "w_z": ("fsdp", "ssm_heads", "head_dim"),
    "w_x": ("fsdp", "ssm_heads", "head_dim"),
    "w_B": ("fsdp", "ssm_state"),
    "w_C": ("fsdp", "ssm_state"),
    "w_dt": ("fsdp", "ssm_heads"),
    "dt_bias": ("ssm_heads",),
    "A_log": ("ssm_heads",),
    "D": ("ssm_heads",),
    "conv_w": (None, None),
    "norm": (None,),
    "w_out": ("ssm_heads", "head_dim", "fsdp"),
}


def _conv_valid(win: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise conv1d without padding.  win (B, T, Ch), w (K, Ch) ->
    (B, T-K+1, Ch): out[t] = sum_k win[t+k] * w[k]."""
    Ch = w.shape[1]
    out = F.conv1d(win.transpose(1, 2), w.t()[:, None, :], groups=Ch)
    return out.transpose(1, 2)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x (B,S,Ch), w (K,Ch)."""
    return _conv_valid(F.pad(x, (0, 0, w.shape[0] - 1, 0)), w)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) with out[i,j] = sum_{j<k<=i} x[k], -inf
    above the diagonal (selected, so exp gives exactly 0 there)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssd_reference(x, dt, A, B, C, chunk: int,
                  init_state: torch.Tensor | None = None):
    """Chunked SSD scan, the plain version.

    x  (b, l, h, p)   — already includes the dt factor (dt ◦ x)
    dt (b, l, h)      — positive step sizes (post-softplus)
    A  (h,)           — negative decay rates
    B, C (b, l, n)
    Returns y (b, l, h, p), final_state (b, h, p, n), both f32 — or float64
    when x is float64 (the oracle run that a check holds the f32 result
    against).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    assert l % chunk == 0, (l, chunk)
    c, Q = l // chunk, chunk
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32

    xc = x.reshape(b, c, Q, h, p).to(acc)
    dtc = dt.reshape(b, c, Q, h).to(acc)
    Bc = B.reshape(b, c, Q, n).to(acc)
    Cc = C.reshape(b, c, Q, n).to(acc)

    dA = torch.einsum("bcqh,h->bhcq", dtc, A.to(acc))          # (b,h,c,Q)
    dA_cs = torch.cumsum(dA, dim=-1)

    L = torch.exp(_segsum(dA))                                 # (b,h,c,Q,Q)
    y_diag = torch.einsum("bcqn,bckn,bhcqk,bckhp->bcqhp", Cc, Bc, L, xc)

    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)          # (b,h,c,Q)
    states = torch.einsum("bcqn,bhcq,bcqhp->bchpn", Bc, decay_states, xc)

    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=acc, device=x.device)
    chunk_sums = dA_cs[..., -1]                                # (b,h,c)
    padded = F.pad(chunk_sums, (1, 0))
    decay_chunk = torch.exp(_segsum(padded))                   # (b,h,c+1,c+1)
    states_cat = torch.cat([init_state.to(acc)[:, None], states], dim=1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states_cat)
    states_in = new_states[:, :-1]                             # entering each chunk
    final_state = new_states[:, -1]

    state_decay = torch.exp(dA_cs)                             # (b,h,c,Q)
    y_off = torch.einsum("bcqn,bchpn,bhcq->bcqhp", Cc, states_in, state_decay)

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, final_state


def _project(params, cfg, x):
    """Shared in-projection; returns z, xin, Bv, Cv, dt (pre-conv)."""
    z = torch.einsum("bsd,dhp->bshp", x, params["w_z"])
    xin = torch.einsum("bsd,dhp->bshp", x, params["w_x"])
    Bv = x @ params["w_B"]
    Cv = x @ params["w_C"]
    dt_raw = torch.einsum("bsd,dh->bsh", x, params["w_dt"])
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    return z, xin, Bv, Cv, dt


def _finish(params, cfg, y, z, xin):
    """D-skip, gated norm, out-projection.  y, z, xin (B, S, h, p)."""
    return _out_proj(params, rms_norm(_gated(params, y, z, xin),
                                      params["norm"], cfg.norm_eps))


def _gated(params, y, z, xin):
    """The D-skip and the gate: (B, S, h·p) in z's dtype, the gated norm's
    input."""
    nh, hp = params["w_x"].shape[1], params["w_x"].shape[2]
    y = y + params["D"].float()[:, None] * xin.float()
    y = y * F.silu(z.float())
    return y.reshape(y.shape[:-2] + (nh * hp,)).to(z.dtype)


def _out_proj(params, flat):
    """(B, S, h·p) normed -> (B, S, d)."""
    nh, hp = params["w_x"].shape[1], params["w_x"].shape[2]
    y = flat.reshape(flat.shape[:-1] + (nh, hp))
    return torch.einsum("bshp,hpd->bsd", y, params["w_out"])


def _on_kernel(cfg, x: torch.Tensor) -> bool:
    """Whether the full-sequence scan goes to K3: CUDA tensors, unless the
    config asks for the plain version (``use_kernels=False``, which the
    pruning trace always does)."""
    return cfg.use_kernels and x.is_cuda


def _split_conv(conv_out, nh: int, hp: int, n: int):
    """(…, nh*hp + 2n) conv output -> xin (…, nh, hp), B (…, n), C (…, n)."""
    xin = conv_out[..., :nh * hp].reshape(conv_out.shape[:-1] + (nh, hp))
    return (xin, conv_out[..., nh * hp:nh * hp + n],
            conv_out[..., nh * hp + n:])


def ssm_block(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD block.  x (B,S,d) -> (B,S,d)."""
    S = x.shape[1]
    nh, hp = params["w_x"].shape[1], params["w_x"].shape[2]
    n = params["w_B"].shape[1]
    z, xin, Bv, Cv, dt = _project(params, cfg, x)

    conv_in = _conv_input(xin, Bv, Cv)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"]).float()
                      ).to(x.dtype)
    xin, Bv, Cv = _split_conv(conv_out, nh, hp, n)

    A = -torch.exp(params["A_log"].float())
    xdt = xin.float() * dt[..., None]
    # pad the sequence to a chunk multiple if needed
    pad = (-S) % cfg.ssm_chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dtp = F.pad(dt, (0, 0, 0, pad))
        Bp = F.pad(Bv, (0, 0, 0, pad))
        Cp = F.pad(Cv, (0, 0, 0, pad))
    else:
        dtp, Bp, Cp = dt, Bv, Cv
    if _on_kernel(cfg, xdt):
        # imported here: the kernel package's ref.py imports this module
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        y = ssd_ops.ssd_scan(xdt, dtp, A, Bp, Cp, cfg.ssm_chunk)
    else:
        y, _ = ssd_reference(xdt, dtp, A, Bp, Cp, cfg.ssm_chunk)
    y = y[:, :S]
    return _finish(params, cfg, y, z, xin)


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, K-1, conv_channels)
    state: torch.Tensor   # (B, h, p, n) f32


def init_ssm_cache(cfg, batch: int, dtype, device=None) -> SSMCache:
    nh, hp, n = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = nh * hp + 2 * n
    return SSMCache(
        torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                    device=device),
        torch.zeros((batch, nh, hp, n), dtype=torch.float32, device=device))


def ssm_prefill(params: dict, cfg, x: torch.Tensor, cache: SSMCache,
                valid: torch.Tensor) -> tuple[torch.Tensor, SSMCache]:
    """Chunked prefill: advance the recurrent state by ``valid`` tokens.

    x (B, C, d) — a fixed-size chunk, right-padded; valid (B,) int counts
    the real tokens.  Padded positions are neutralized by forcing dt = 0
    there (decay exp(0·A) = 1, zero input), so the state after the scan is
    *exactly* the state after the valid prefix.  The conv window continues
    from ``cache.conv`` (the last K-1 inputs of the previous chunk) and the
    SSD scan from ``cache.state``.  Returns (y (B, C, d), new cache) — y at
    padded positions is garbage the caller discards.
    """
    z, xin, Bv, Cv, dt = _project(params, cfg, x)
    y, xin, new = prefill_scan(params, cfg, _conv_input(xin, Bv, Cv), dt,
                               cache, valid)
    return _finish(params, cfg, y, z, xin), new


def _conv_input(xin, Bv, Cv):
    """The conv's input channels [x (h·p), B (n), C (n)]."""
    return torch.cat([xin.reshape(xin.shape[:2] + (-1,)), Bv, Cv], dim=-1)


def prefill_scan(params, cfg, conv_in, dt, cache: SSMCache, valid,
                 heads: slice = slice(None)):
    """The conv and the SSD scan of a prefill chunk.  ``conv_in`` holds
    every x channel; ``params``, ``dt`` and ``cache.state`` the heads
    ``heads`` of them (all by default: a tensor-parallel shard passes its
    own).  Returns (y (B, C, h', p) f32, x after the conv (B, C, h', p),
    the new cache)."""
    C = conv_in.shape[1]
    hp = params["w_x"].shape[2]
    n = params["w_B"].shape[1]
    K = params["conv_w"].shape[0]
    win = torch.cat([cache.conv.to(conv_in.dtype), conv_in], dim=1)
    conv_out = F.silu(_conv_valid(win, params["conv_w"]).float()
                      ).to(conv_in.dtype)
    # next chunk's left context: the last K-1 *valid* rows of the window
    rows = valid.long()[:, None] + torch.arange(K - 1, device=win.device)
    new_conv = torch.gather(win, 1, rows[..., None].expand(
        -1, -1, win.shape[-1]))

    nh_all = (conv_out.shape[-1] - 2 * n) // hp
    xin, Bv, Cv = _split_conv(conv_out, nh_all, hp, n)
    xin = xin[:, :, heads]
    inchunk = torch.arange(C, device=win.device)[None, :, None] \
        < valid[:, None, None]
    dt = torch.where(inchunk, dt, 0.0)
    A = -torch.exp(params["A_log"].float())
    xdt = xin.float() * dt[..., None]
    y, state = ssd_reference(xdt, dt, A, Bv, Cv, chunk=C,
                             init_state=cache.state)
    return y, xin, SSMCache(new_conv, state)


def ssm_decode(params: dict, cfg, x: torch.Tensor, cache: SSMCache
               ) -> tuple[torch.Tensor, SSMCache]:
    """Single-token recurrent step.  x (B,1,d)."""
    z, xin, Bv, Cv, dt = _project(params, cfg, x)
    y, xin1, new = decode_scan(params, cfg, _conv_input(xin, Bv, Cv), dt,
                               cache)
    out = _finish(params, cfg, y[:, None], z, xin1[:, None].float())
    return out, new


def decode_scan(params, cfg, conv_in, dt, cache: SSMCache,
                heads: slice = slice(None)):
    """The conv and the recurrence of one decode step, ``prefill_scan``'s
    counterpart: conv_in (B, 1, ch) holds every x channel.  Returns (y (B,
    h', p) f32, x after the conv (B, h', p), the new cache)."""
    hp = params["w_x"].shape[2]
    n = params["w_B"].shape[1]
    win = torch.cat([cache.conv, conv_in], dim=1)              # (B, K, ch)
    conv_out = torch.einsum("bkc,kc->bc", win, params["conv_w"])
    conv_out = F.silu(conv_out.float()).to(conv_in.dtype)
    new_conv = win[:, 1:]

    nh_all = (conv_out.shape[-1] - 2 * n) // hp
    xin1, Bv1, Cv1 = _split_conv(conv_out, nh_all, hp, n)
    xin1 = xin1[:, heads]
    Bv1, Cv1 = Bv1.float(), Cv1.float()
    dt1 = dt[:, 0]                                             # (B, h)

    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt1 * A)                                    # (B, h)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt1, Bv1, xin1.float())
    state = cache.state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", state, Cv1)               # (B, h, p)
    return y, xin1, SSMCache(new_conv, state)
