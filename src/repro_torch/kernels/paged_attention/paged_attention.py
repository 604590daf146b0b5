"""Wrapper of the hand-written CUDA paged-attention kernel
(``kernels/csrc/paged_attention.cu``), which replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_attention._paged_attention``.

One wrapper serves decode (one query token per sequence) and chunked prefill
/ speculative verify (C query tokens per sequence): row ``r = c*G + g`` of
the ``(C*G, D)`` tile of a (sequence, kv-head) pair masks against its
absolute position ``q_start + c``.  K/V blocks are fetched through the block
table; dead blocks (past ``kv_len``, or wholly left of the chunk's sliding
window) are never loaded, and a per-(sequence, kv-head) visit counter is
returned beside the output.  Quantized pools are read as their narrow bytes
and scaled inside the kernel.  The plain PyTorch version is ``ref.py``;
``expected_visits`` is the visit count in plain torch.

``plan`` picks the kernel instance per launch from shapes and dtypes alone
(never from the lengths, so a serving step reads nothing back from the
device): bf16 q over a bf16 / int8 / fp8 pool runs on the tensor cores —
at ``C*G <= 8`` (decode) a split-KV instance, whose split count follows from
(B, KH, NB, bs) and the SM count, with an f32 workspace allocated here at
the size the C library gives — and f32 q or an f32 pool on the CUDA cores.

The wrapper takes CUDA tensors only and launches the kernel or raises —
there is no fallback to the plain version here (``ops.py`` routes CPU
tensors to ``ref.py``).  ``launches`` counts wrapper calls that launched
(the decode instance is two device kernels: its splits and their combine).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256          # D and DV the kernel takes (any value up to it)

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}

# the instances' shapes: accumulator widths of the tensor-core instances and
# of the CUDA-core instance (DV picks the narrowest that holds it), and the
# most rows (C*G) the decode instance takes
TC_DV_TILES = (32, 64, 128, 256)
CC_DV_TILES = (64, 256)
DECODE_ROWS = 8
H100_SMS = 132              # streaming multiprocessors of an H100 SXM
MIN_SPLIT_KEYS = 256        # table positions per decode split, at least
_INSTANCES = {"cuda_core": 0, "wgmma": 1, "split_kv_mma": 2}

launches = 0                # wrapper calls that launched, by this process ...
launches_by_entry = {"decode": 0, "prefill": 0}     # ... and by entry point
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0
    for k in launches_by_entry:
        launches_by_entry[k] = 0


def launch_counts() -> dict[str, int]:
    """{"total", "decode", "prefill"}: wrapper calls that launched since the
    last ``reset_launches``."""
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
        fn.argtypes = ([p] * 11 + [ctypes.c_longlong] * 2 + [i] * 9
                       + [ctypes.c_float] + [i] * 6 + [p])
        fn.restype = ctypes.c_int
        ws = lib.paged_attention_workspace_floats
        ws.argtypes = [i] * 8
        ws.restype = ctypes.c_longlong
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, ws, lib.paged_attention_error_string)
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


class Plan(NamedTuple):
    """The instance a launch takes.  bf16 q over a bf16, int8 or fp8 pool
    runs on the tensor cores: decode (``C*G <= 8``) as ``"split_kv_mma"``
    (``mma.sync``, ``splits`` blocks per (sequence, kv-head), then their
    combine), prefill / verify as ``"wgmma"`` (``warpgroups`` 64-row tiles
    a block).  f32 q or an f32 pool runs on the CUDA cores,
    ``"cuda_core"``, at any C*G.  ``dv_tile``: the accumulator columns (>=
    DV)."""
    instance: str
    dv_tile: int
    warpgroups: int
    splits: int


def decode_splits(B: int, KH: int, NB: int, bs: int,
                  sm_count: int = H100_SMS) -> int:
    """Blocks each (sequence, kv-head) of a decode call is split over: at
    most three blocks for every SM in all (one wave of the bf16 instance at
    TinyLlama's widths), while each split covers at least
    ``MIN_SPLIT_KEYS`` positions of the table (``NB * bs``).  Shapes only:
    no sequence length is read."""
    want = 3 * sm_count // (B * KH)
    return max(1, min(want, NB * bs // MIN_SPLIT_KEYS))


def plan(B: int, C: int, H: int, KH: int, D: int, DV: int, bs: int, NB: int,
         q_dtype: torch.dtype, kv_dtype: torch.dtype,
         sm_count: int = H100_SMS) -> Plan:
    """The instance for these shapes and dtypes (checked by the caller)."""
    rows = C * (H // KH)
    tensor_cores = q_dtype == torch.bfloat16 and kv_dtype != torch.float32
    tile = next(t for t in (TC_DV_TILES if tensor_cores else CC_DV_TILES)
                if DV <= t)
    if not tensor_cores:
        return Plan("cuda_core", tile, 0, 0)
    if rows <= DECODE_ROWS:
        return Plan("split_kv_mma", tile, 0,
                    decode_splits(B, KH, NB, bs, sm_count))
    return Plan("wgmma", tile, 2 if rows > 64 else 1, 0)


_sm_counts: dict[int, int] = {}


def sm_count(dev: torch.device) -> int:
    """The card's SM count (asked once per device)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


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
    q_starts/kv_lens (B,) int32 (q_starts None: one token at kv_len - 1);
    k/v_scale (P, bs, KH) f32 when the pools are quantized.  Returns (out
    (B, C, H, DV) in q.dtype, visits (B, KH))."""
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
    if q_starts is not None:
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
    pl = plan(B, C, H, KH, D, DV, bs, NB, q.dtype, k_pool.dtype,
              sm_count(dev))

    out = torch.empty((B, C, H, DV), dtype=q.dtype, device=dev)
    visits = torch.empty((B, KH), dtype=torch.int32, device=dev)
    fn, ws_floats, errstr = _launcher()
    ws, n_ws = None, 0
    if pl.splits:
        # every warp's (acc, m, l) per row, merged by the combine kernel
        n_ws = ws_floats(B, C, H, KH, D, DV, _KV_DTYPES[k_pool.dtype],
                         pl.splits)
        ws = torch.empty(max(n_ws, 0), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if quantized else None,
                v_scale.data_ptr() if quantized else None,
                block_tables.data_ptr(),
                None if q_starts is None else q_starts.data_ptr(),
                kv_lens.data_ptr(), out.data_ptr(), visits.data_ptr(),
                None if ws is None else ws.data_ptr(), n_ws, P * bs * KH,
                B, C, H, KH, D, DV, bs, NB, window, scale,
                _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype],
                _INSTANCES[pl.instance], pl.dv_tile, pl.warpgroups,
                pl.splits, torch.cuda.current_stream(dev).cuda_stream)
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
        q[:, None], k_pool, v_pool, block_tables, None, kv_lens,
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
