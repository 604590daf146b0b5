"""Wrapper of the hand-written CUDA paged-attention kernel
(``kernels/csrc/paged_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_attention._paged_attention``.

One kernel serves decode (one query token per sequence) and chunked prefill
/ speculative verify (C query tokens per sequence): row ``r = c*G + g`` of
the ``(C*G, D)`` tile of a (sequence, kv-head) pair masks against its
absolute position ``q_start + c``.  K/V blocks are fetched through the block
table; dead blocks (past ``kv_len``, or wholly left of the chunk's sliding
window) are never loaded, and a per-(sequence, kv-head) visit counter is
returned beside the output.  Quantized pools are dequantized inside the
kernel.  The plain PyTorch version is ``ref.py``; ``expected_visits`` is the
visit count in plain torch.

The wrapper takes CUDA tensors only and launches the kernel or raises —
there is no fallback to the plain version here (``ops.py`` routes CPU
tensors to ``ref.py``).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256          # D and DV the kernel takes (any value up to it)

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}

launches = 0                # kernel launches made by this process ...
launches_by_entry = {"decode": 0, "prefill": 0}     # ... and by entry point
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0
    for k in launches_by_entry:
        launches_by_entry[k] = 0


def launch_counts() -> dict[str, int]:
    """{"total", "decode", "prefill"}: kernel launches since the last
    ``reset_launches``."""
    return {"total": launches, **launches_by_entry}


def ensure_built() -> None:
    """Build (if need be) and load the kernel library now, not at the first
    launch."""
    _launcher()


def _launcher():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 9 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.paged_attention_error_string)
    return _fn


def expected_visits(q_starts, kv_lens, num_table_blocks: int,
                    block_size: int, window: int = 0) -> torch.Tensor:
    """Blocks the reference's liveness predicate keeps, per sequence: block
    ``j`` is live iff ``j*bs < kv_len`` and, under a sliding window,
    ``j*bs + bs - 1 > q_start - window``.  Returns (B,) int32 (the kernel
    reports the same number for every kv-head)."""
    q_starts = torch.as_tensor(q_starts, dtype=torch.int64)
    kv_lens = torch.as_tensor(kv_lens, dtype=torch.int64)
    first = torch.arange(num_table_blocks, dtype=torch.int64,
                         device=kv_lens.device)[None, :] * block_size
    live = first < kv_lens[:, None]
    if window:
        live &= first + block_size - 1 > (q_starts[:, None] - window)
    return live.sum(dim=1).to(torch.int32)


def _check(name: str, t: torch.Tensor, device, dtype=None, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q is on {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _paged_attention(q, k_pool, v_pool, block_tables, q_starts, kv_lens, *,
                     window: int, scale: float | None,
                     k_scale=None, v_scale=None, entry: str = "prefill"):
    """q (B, C, H, D); pools (P, bs, KH, D/DV); tables (B, NB) int32;
    q_starts/kv_lens (B,) int32; k/v_scale (P, bs, KH) f32 when the pools
    are quantized.  Returns (out (B, C, H, DV) in q.dtype, visits (B, KH))."""
    global launches
    if not q.is_cuda:
        raise ValueError("the paged-attention kernel takes CUDA tensors; "
                         "CPU tensors go through ops.paged_attention")
    if not isinstance(window, int) or window < 0:
        raise TypeError("the kernel takes a static python-int window >= 0")
    if q.ndim != 4 or k_pool.ndim != 4 or v_pool.ndim != 4:
        raise ValueError("q must be (B, C, H, D), pools (P, bs, KH, D|DV)")
    dev = q.device
    B, C, H, D = q.shape
    P, bs, KH, DV = v_pool.shape
    NB = block_tables.shape[1] if block_tables.ndim == 2 else -1
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_DTYPES)}")
    if k_pool.dtype not in _KV_DTYPES:
        raise TypeError(f"pool dtype {k_pool.dtype} not in "
                        f"{list(_KV_DTYPES)}")
    if KH == 0 or H % KH:
        raise ValueError(f"H={H} is not a multiple of KH={KH}")
    if not (0 < D <= MAX_HEAD_DIM and 0 < DV <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, DV={DV} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if min(B, C, NB, bs) <= 0:
        raise ValueError("empty batch, chunk, table or block")
    _check("q", q, dev)
    _check("k_pool", k_pool, dev, shape=(P, bs, KH, D))
    _check("v_pool", v_pool, dev, dtype=k_pool.dtype)
    _check("block_tables", block_tables, dev, torch.int32, (B, NB))
    _check("q_starts", q_starts, dev, torch.int32, (B,))
    _check("kv_lens", kv_lens, dev, torch.int32, (B,))
    quantized = k_pool.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized != (k_scale is not None) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale/v_scale must be given exactly when the "
                         "pools are int8 or fp8-e4m3")
    if quantized:
        _check("k_scale", k_scale, dev, torch.float32, (P, bs, KH))
        _check("v_scale", v_scale, dev, torch.float32, (P, bs, KH))
    scale = float(scale) if scale is not None else D ** -0.5

    out = torch.empty((B, C, H, DV), dtype=q.dtype, device=dev)
    visits = torch.empty((B, KH), dtype=torch.int32, device=dev)
    fn, errstr = _launcher()
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if quantized else None,
                v_scale.data_ptr() if quantized else None,
                block_tables.data_ptr(), q_starts.data_ptr(),
                kv_lens.data_ptr(), out.data_ptr(), visits.data_ptr(),
                B, C, H, KH, D, DV, bs, NB, window, scale,
                _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        what = errstr(rc).decode() if rc > 0 else "arguments refused"
        raise RuntimeError(f"paged_attention launch failed ({rc}): {what}")
    launches += 1
    launches_by_entry[entry] += 1
    return out, visits


def paged_attention_kernel(q, k_pool, v_pool, block_tables, kv_lens, *,
                           window: int = 0, scale: float | None = None,
                           return_visits: bool = False,
                           k_scale=None, v_scale=None):
    """Decode entry point: q (B, H, D), one query token at ``kv_len - 1``."""
    out, visits = _paged_attention(
        q[:, None], k_pool, v_pool, block_tables, kv_lens - 1, kv_lens,
        window=window, scale=scale, k_scale=k_scale, v_scale=v_scale,
        entry="decode")
    out = out[:, 0]
    return (out, visits) if return_visits else out


def paged_prefill_attention_kernel(q, k_pool, v_pool, block_tables,
                                   q_starts, kv_lens, *, window: int = 0,
                                   scale: float | None = None,
                                   return_visits: bool = False,
                                   k_scale=None, v_scale=None):
    """Prefill entry point: q (B, C, H, D), C query tokens starting at
    ``q_starts``; ``kv_lens = q_starts + valid`` (rows past a sequence's
    valid count produce finite values the caller discards)."""
    out, visits = _paged_attention(
        q, k_pool, v_pool, block_tables, q_starts, kv_lens,
        window=window, scale=scale, k_scale=k_scale, v_scale=v_scale)
    return (out, visits) if return_visits else out
