"""Wrapper of the hand-written CUDA SSD chunked scan (``kernels/csrc/
ssd_scan.cu``), which replaces the Pallas TPU kernel
``repro.kernels.ssd_scan.ssd_scan.ssd_scan_pallas``.

One thread block per (batch, head) stream loops over the chunks, 64 rows at
a time, with the f32 ``(p, n)`` state in shared memory; the products run on
the tensor cores at f32 accuracy by split TF32 (see the source's notes);
``y`` comes back in x's dtype.  The plain PyTorch version is
``ref.ssd_reference`` (``ops.ssd_scan_ref``).  The chunk must be a multiple
of 16; p and n may be anything (the kernel pads them to 16 with zeros
inside shared memory).

The wrapper takes CUDA tensors only and launches the kernel or raises —
there is no fallback to the plain version here (``ops.py`` routes CPU
tensors to it).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_SMEM = 232448           # bytes of shared memory a block may opt into
_TYPES = (torch.float32, torch.bfloat16)

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
        lib = _build.load("ssd_scan")
        fn = lib.ssd_scan_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.ssd_scan_error_string)
    return _fn


def sub_chunk(Q: int) -> int:
    """Rows the kernel takes at a time (mirror of ``sub_chunk`` in the CUDA
    source): the largest of 64, 48, 32, 16 that divides the chunk.  The
    scan's result does not depend on where chunks fall, so a chunk of 128
    runs as two of 64."""
    for d in (4, 3, 2):
        if (Q // 16) % d == 0:
            return 16 * d
    return 16


def smem_bytes(Q: int, p: int, n: int, x_bf16: bool, bc_bf16: bool) -> int:
    """Dynamic shared memory of one block (mirror of ``layout`` in the CUDA
    source), for q = ``sub_chunk(Q)`` rows: C and B rows of n rounded up to
    16 plus 16 bytes, x rows of p rounded up to 16 plus 16 bytes, the f32
    state with rows of n16 + 8, the hi / lo fragments of M (1 KB for each
    of the (q/16)(q/16 + 1) tiles of the lower triangle), and four vectors
    of q (cs in double, exp(cs), the decays, dt)."""
    q = sub_chunk(Q)
    p16, n16 = -(-p // 16) * 16, -(-n // 16) * 16
    ex, eb = (2 if x_bf16 else 4), (2 if bc_bf16 else 4)
    sx, sbc, rt = p16 * ex + 16, n16 * eb + 16, q // 16
    return (2 * q * sbc + q * sx + 4 * p16 * (n16 + 8)
            + 1024 * rt * (rt + 1) + 20 * q)


def check_args(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, chunk: int) -> None:
    """What the kernel takes, checked on any device (the dispatch in
    ``ops.py`` holds both routes to it): x (b, l, h, p) f32 or bf16, dt
    (b, l, h) f32, A (h,) f32, B and C (b, l, n) of one type, f32 or bf16,
    all contiguous on x's device; ``l % chunk == 0`` and ``chunk % 16 ==
    0``; a block's tiles fit in shared memory (``smem_bytes``; the CUDA
    source works out its own layout and refuses what does not fit)."""
    if x.ndim != 4:
        raise ValueError(f"x must be (b, l, h, p), got {tuple(x.shape)}")
    b, l, h, p = x.shape
    n = B.shape[-1] if B.ndim == 3 else -1
    want = {"dt": (dt, (b, l, h)), "A": (A, (h,)), "B": (B, (b, l, n)),
            "C": (C, (b, l, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _TYPES or B.dtype not in _TYPES:
        raise TypeError(f"x and B/C must be float32 or bfloat16, got "
                        f"{x.dtype} / {B.dtype}")
    if C.dtype != B.dtype:
        raise TypeError(f"B and C differ in type: {B.dtype} / {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype} / "
                        f"{A.dtype}")
    if chunk < 16 or chunk % 16 or l % chunk:
        raise ValueError(f"the chunk {chunk} must be a multiple of 16 that "
                         f"divides the sequence length {l}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's 65535")
    need = smem_bytes(chunk, p, n, x.dtype == torch.bfloat16,
                      B.dtype == torch.bfloat16)
    if need > MAX_SMEM:
        raise ValueError(f"chunk {chunk}, head_dim {p}, state {n}: the "
                         f"tiles need {need} bytes of shared memory, more "
                         f"than {MAX_SMEM}")


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int
                    ) -> torch.Tensor:
    """x (b, l, h, p) with dt applied, dt (b, l, h), A (h,), B/C (b, l, n)
    -> y (b, l, h, p) in x's dtype, on the CUDA device of x."""
    global launches
    if not x.is_cuda:
        raise ValueError("the SSD scan kernel takes CUDA tensors; CPU "
                         "tensors go through ops.ssd_scan")
    check_args(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    fn, errstr = _launcher()
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), b, l, h, p, n, chunk,
            int(x.dtype == torch.bfloat16), int(B.dtype == torch.bfloat16))
    dev = x.device
    if dev.index in (None, torch.cuda.current_device()):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        what = errstr(rc).decode() if rc > 0 else "arguments refused"
        raise RuntimeError(f"ssd_scan launch failed ({rc}): {what}")
    launches += 1
    return y
