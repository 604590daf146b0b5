"""Wrapper of the hand-written CUDA flash attention (``kernels/csrc/
flash_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention.flash_attention_bhsd``.

One thread block per (64-row query tile, head, batch) keeps the query tile
and the online-softmax state on chip and streams K/V tiles through shared
memory; logits, running max / sum and the accumulator are f32, the output
in q's dtype.  bf16 inputs go to the tensor-core instance (wgmma, K/V
double-buffered by cp.async), f32 inputs to the CUDA-core one; ``plan``
picks the instance and the copy path per launch.  The kernel reads the
model's (B, S, H, D) tensors through their strides (only the last axis must
be contiguous), so the wrapper neither transposes nor copies them.  The
plain PyTorch version is ``ref.attention_reference``
(``ops.flash_attention_ref``).

Forward only, as in the reference: the wrapper raises when autograd would
need a gradient through it (training differentiates the model's plain
attention).  It takes CUDA tensors only and launches the kernel or raises —
there is no fallback to the plain version here (``ops.py`` routes CPU
tensors to it).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
_TYPES = (torch.float32, torch.bfloat16)
# accumulator widths of the tensor-core instances: DV picks the narrowest
# that holds it
DV_TILES = (32, 64, 128, 256)

launches = 0                # kernel launches made by this process
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launches``."""
    return launches


def ensure_built() -> None:
    """Build (if need be) and load the kernel library now, not at the first
    launch."""
    _launcher()


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 4 + [i] * 7 + [ll] * 12
                       + [ctypes.c_float, i, i, i, i, i, i, p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int = 0) -> None:
    """What the kernel takes, checked on any device (the dispatch in
    ``ops.py`` holds both routes to it): q (B, Sq, H, D), k (B, Sk, KH, D),
    v (B, Sk, KH, DV), all of one type, f32 or bf16, on one device; H a
    multiple of KH; 1 <= D, DV <= 256; Sq, Sk >= 1; window >= 0."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, S, heads, dim), got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q is on {q.device}")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, KH, D):
        raise ValueError(f"k must be (B, Sk, KH, D) = (B={B}, ..., D={D}), "
                         f"got {tuple(k.shape)}")
    if tuple(v.shape[:3]) != (B, Sk, KH):
        raise ValueError(f"v must be (B, Sk, KH, DV) with k's (B, Sk, KH) = "
                         f"{(B, Sk, KH)}, got {tuple(v.shape)}")
    DV = v.shape[3]
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be all float32 or all bfloat16, "
                        f"got {q.dtype} / {k.dtype} / {v.dtype}")
    if KH < 1 or H % KH:
        raise ValueError(f"{H} query heads are not a multiple of {KH} KV "
                         f"heads")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= DV <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, DV={DV} must lie in 1.."
                         f"{MAX_HEAD_DIM}")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"empty sequence: Sq={Sq}, Sk={Sk}")
    if window < 0:
        raise ValueError(f"window {window} must be >= 0 (0: none)")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} or heads {H} exceed the grid's 65535")


class Plan(NamedTuple):
    """Which instance of the kernel a launch takes: ``"wgmma"`` (bf16,
    tensor cores, ``dv_tile`` accumulator columns) or ``"cuda_core"`` (f32);
    ``vec16``: every q / k / v row starts on 16 bytes, so tiles are copied
    by 16-byte ``cp.async``, else element by element (the narrow path);
    ``heads``: query heads of one KV head per block, which share its K/V
    tiles (2 where the group size is even)."""
    instance: str
    dv_tile: int
    vec16: bool
    heads: int


def rows_aligned16(t: torch.Tensor) -> bool:
    """Whether every (batch, position, head) row of ``t`` starts on a
    16-byte boundary: the data pointer and every stride of an axis longer
    than 1, in bytes, are multiples of 16."""
    esz = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (st * esz) % 16 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
        if n > 1)


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The instance and copy path for these (checked) inputs."""
    if q.dtype == torch.float32:
        return Plan("cuda_core", 0, False, 1)
    DV = v.shape[3]
    tile = next(t for t in DV_TILES if DV <= t)
    group = q.shape[2] // k.shape[2]
    return Plan("wgmma", tile, all(rows_aligned16(t) for t in (q, k, v)),
                2 if group % 2 == 0 else 1)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, scale: float | None = None
                           ) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Sk, KH, D), v (B, Sk, KH, DV) -> out (B, Sq,
    H, DV) in q's dtype, contiguous, on the CUDA device of q."""
    global launches
    if not q.is_cuda:
        raise ValueError("the flash-attention kernel takes CUDA tensors; CPU "
                         "tensors go through ops.flash_attention")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash-attention kernel is forward only (as "
                           "the reference's): differentiate the model's "
                           "plain attention (use_kernels=False), or call it "
                           "under torch.no_grad()")
    check_args(q, k, v, window)
    # the kernel reads any strides whose last one is 1
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    B, Sq, H, D = q.shape
    Sk, KH, DV = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, Sq, H, DV), dtype=q.dtype, device=q.device)
    pl = plan(q, k, v)
    fn, errstr = _launcher()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KH, Sq, Sk, D, DV, *strides, float(scale), int(causal),
            int(window), int(q.dtype == torch.bfloat16), pl.dv_tile,
            int(pl.vec16), pl.heads)
    dev = q.device
    if dev.index in (None, torch.cuda.current_device()):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        what = errstr(rc).decode() if rc > 0 else "arguments refused"
        raise RuntimeError(f"flash_attention launch failed ({rc}): {what}")
    launches += 1
    return out
