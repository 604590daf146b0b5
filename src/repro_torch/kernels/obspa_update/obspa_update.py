"""Wrapper of the hand-written CUDA OBSPA in-block sweep
(``kernels/csrc/obspa_update.cu``), which replaces the Pallas TPU kernel
``repro.kernels.obspa_update.obspa_update.inblock_sweep``.

For one 128-column block of the weight view, its diagonal Hinv block and the
block's prune mask, the kernel runs the serial chain ``err = W[:,j] /
Hinv[j,j]; W[:,j:] -= m_j·err ⊗ Hinv[j,j:]; E[:,j] = m_j·err`` and returns
``(W, E)`` in f32.  A batch axis rides on the grid (``obspa_sweep_batched``).
The plain PyTorch version is ``ref.inblock_sweep_plain``.  ``plan`` mirrors
how the CUDA source lays out a launch (rows a warp, warps and blocks, shared
memory); the source plans and refuses on its own.

The wrapper takes CUDA tensors only and launches the kernel or raises —
there is no fallback to the plain version here (``ops.py`` routes CPU
tensors to it).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

BLOCK = 128                 # columns per block; the kernel takes no other
ROWS_PER_WARP = 2
WARPS = 8                   # warps a thread block
# the staged Hinv rows (at most BLOCK of BLOCK f32) and four mbarriers
SMEM_BYTES = BLOCK * BLOCK * 4 + 4 * 8
MAX_SMEM = 232448           # bytes of shared memory a block may opt into

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
        lib = _build.load("obspa_update")
        fn = lib.obspa_inblock_launch
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [p, i64, i64, p, i64, i64, p, p, i64, i64, p, i, i, p]
        fn.restype = ctypes.c_int
        lib.obspa_inblock_error_string.argtypes = [ctypes.c_int]
        lib.obspa_inblock_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.obspa_inblock_error_string)
    return _fn


class Plan(NamedTuple):
    rows_per_warp: int
    warps: int
    blocks: int             # thread blocks a batch entry (grid x)
    smem_bytes: int


def plan(R: int, nb: int = 1) -> Plan:
    """The launch the CUDA source makes for R rows and nb batch entries
    (mirror of its ``RW``, ``WARPS`` and grid): two rows a warp, 8 warps a
    block, nb on grid y, the staged rows' shared memory at its largest."""
    if R < 1 or not 1 <= nb <= 65535:
        raise ValueError(f"{R} rows and {nb} batch entries: the kernel takes "
                         f"R >= 1 and 1 <= nb <= 65535 (grid y)")
    rows = ROWS_PER_WARP * WARPS
    return Plan(ROWS_PER_WARP, WARPS, -(-R // rows), SMEM_BYTES)


def _as3(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.ndim == 2:
        return t[None]
    if t.ndim != 3:
        raise ValueError(f"{name} must be 2-D or 3-D, got {tuple(t.shape)}")
    return t


def _check_view(name: str, t: torch.Tensor, device, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, w is on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.stride(-1) != 1 or t.stride(-2) < BLOCK:
        raise ValueError(f"{name} must have unit column stride and a row "
                         f"stride >= {BLOCK}")


def check_args(w: torch.Tensor, hinv: torch.Tensor, mask: torch.Tensor,
               out: torch.Tensor | None = None,
               e_out: torch.Tensor | None = None):
    """What the kernel takes, checked on any device (the dispatch in
    ``ops.py`` holds both routes to it): f32 views with a unit column
    stride; hinv on 16 bytes with row and batch strides that are multiples
    of 4 (the kernel copies its rows 16 bytes at a time); ``e_out``
    contiguous.  Returns the 3-D views (w, hinv, out or None, e_out or
    None)."""
    w3, h3 = _as3(w, "w"), _as3(hinv, "hinv")
    nb, R, B = w3.shape
    if B != BLOCK:
        raise ValueError(f"the kernel sweeps blocks of {BLOCK} columns, "
                         f"got {B}")
    if h3.shape[0] not in (1, nb):
        raise ValueError(f"hinv batch {h3.shape[0]} is neither 1 nor {nb}")
    dev = w.device
    _check_view("w", w3, dev, (nb, R, BLOCK))
    _check_view("hinv", h3, dev, (h3.shape[0], BLOCK, BLOCK))
    if h3.data_ptr() % 16 or h3.stride(1) % 4 or \
            (h3.shape[0] > 1 and h3.stride(0) % 4):
        raise ValueError("hinv must start on 16 bytes, with row and batch "
                         "strides that are multiples of 4 elements")
    if w3.shape[1] > 2**31 - 1:
        raise ValueError(f"{w3.shape[1]} rows exceed the kernel's int range")
    if mask.device != dev or tuple(mask.shape) != (BLOCK,) or \
            mask.dtype not in (torch.bool, torch.uint8) or mask.stride(0) != 1:
        raise ValueError(f"mask must be a contiguous ({BLOCK},) bool or "
                         f"uint8 tensor on {dev}")
    o3 = e3 = None
    if out is not None:
        o3 = _as3(out, "out")
        _check_view("out", o3, dev, (nb, R, BLOCK))
    if e_out is not None:
        e3 = _as3(e_out, "e_out")
        _check_view("e_out", e3, dev, (nb, R, BLOCK))
        if not e3.is_contiguous():
            raise ValueError("e_out must be contiguous")
    if plan(R, nb).smem_bytes > MAX_SMEM:
        raise ValueError("the staged Hinv rows do not fit in shared memory")
    return w3, h3, o3, e3


def inblock_sweep_kernel(w: torch.Tensor, hinv: torch.Tensor,
                         mask: torch.Tensor, out: torch.Tensor | None = None,
                         e_out: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """w (nb, R, 128) or (R, 128) f32; hinv (nb or 1, 128, 128) or
    (128, 128) f32; mask (128,) bool.  Views with a unit column stride are
    taken as they are (no copy).  ``out`` receives the updated block (it may
    be ``w`` itself: the sweep in place), ``e_out`` E; else new tensors
    do.

    Returns (updated w, E), shaped like ``w``."""
    global launches
    if not w.is_cuda:
        raise ValueError("the OBSPA sweep kernel takes CUDA tensors; CPU "
                         "tensors go through ops.inblock_sweep")
    squeeze = w.ndim == 2
    w3, h3, o3, e = check_args(w, hinv, mask, out, e_out)
    nb, R, _ = w3.shape
    dev = w.device
    if o3 is None:
        o3 = torch.empty((nb, R, BLOCK), dtype=torch.float32, device=dev)
    if e is None:
        e = torch.empty((nb, R, BLOCK), dtype=torch.float32, device=dev)
    fn, errstr = _launcher()
    # a bool mask is read as its bytes (torch stores bool as one byte)
    args = (w3.data_ptr(), w3.stride(1), w3.stride(0), o3.data_ptr(),
            o3.stride(1), o3.stride(0), e.data_ptr(), h3.data_ptr(),
            h3.stride(1), h3.stride(0) if h3.shape[0] == nb and nb > 1 else 0,
            mask.data_ptr(), R, nb)
    if dev.index in (None, torch.cuda.current_device()):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        what = errstr(rc).decode() if rc > 0 else "arguments refused"
        raise RuntimeError(f"obspa_inblock launch failed ({rc}): {what}")
    launches += 1
    if squeeze:
        return o3[0], e[0]
    return o3, e
