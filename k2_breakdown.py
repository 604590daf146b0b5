#!/usr/bin/env python3
"""Where the flash-attention kernel K2 spends its time on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 k2_breakdown.py

It compiles copies of ``src/repro_torch/kernels/csrc/flash_attention.cu``
with one part of the bf16 tensor-core kernel removed or changed (the next
tile's K/V copies, the Q·Kᵀ or P·V products, the lo term of P, exp2, the
proxy fence, the longest-first block order) and times each against the
unchanged kernel at the main path's shape (``chip_smoke.K2_MAIN``: B 8, S
512, H 32 / KH 4 x 64, causal, bf16), together with one and four query
heads a block in place of two.  Variants that remove work give wrong
outputs: they measure what that work costs, nothing else.  Every variant is
timed in three alternating rounds by the profiler's device time per launch
(CUDA events beside it); the card's name and power limit come first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402

K2_MODULE = sys.modules["repro_torch.kernels.flash_attention.flash_attention"]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"

# name -> ((text in the tensor-core half of the source, its replacement),
# ...), query heads a block
VARIANTS = {
    "as built": ((), 2),
    "one head a block": ((), 1),
    "four heads a block": (
        (("__launch_bounds__(2 * WG, DVI <= 64 ? 2 : 1)",
          "__launch_bounds__(4 * WG, 1)"),
         ("(heads != 1 && heads != 2)",
          "(heads != 1 && heads != 2 && heads != 4)")), 4),
    "blocks in grid order": (
        (("(gridDim.z - 1 - blockIdx.z) * BQ", "blockIdx.z * BQ"),), 2),
    "no next-tile K/V copies": (
        (("      load_kv(k0 + BK, st ^ 1);", "      ;"),), 2),
    "no Q·Kᵀ": (
        (("for (int kk = 0; kk < Dp / 16; ++kk)\n      wgmma_ss_n64",
          "for (int kk = 0; kk < 0; ++kk)\n      wgmma_ss_n64"),), 2),
    "no P·V": (
        (("        wgmma_rs(o[c], phi[kk], dv);\n"
          "        wgmma_rs(o[c], plo[kk], dv);\n", ""),), 2),
    "no lo term of P": (
        (("        wgmma_rs(o[c], plo[kk], dv);\n", ""),), 2),
    "no exp2": (
        (("exp2f(s[4 * j + e] - (e < 2 ? mn0 : mn1))",
          "(s[4 * j + e] - (e < 2 ? mn0 : mn1))"),), 2),
    "no proxy fence": (
        (("    fence_async_proxy();\n    __syncthreads();",
          "    __syncthreads();"),), 2),
}


def variant_source(edits) -> str:
    src = SOURCE.read_text()
    cut = src.index("// bf16: tensor cores")
    head, tail = src[:cut], src[cut:]
    for old, new in edits:
        if old not in tail:
            raise RuntimeError(f"k2_breakdown: {old!r} is not in the source")
        tail = tail.replace(old, new)
    return head + tail


def build(name: str, edits, out: Path) -> Path:
    stem = "".join(c if c.isalnum() else "_" for c in name)
    cu, so = out / f"{stem}.cu", out / f"lib{stem}.so"
    cu.write_text(variant_source(edits))
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return so


def use_library(so: Path, heads: int) -> None:
    """Point K2's wrapper at this library and this many heads a block."""
    lib = ctypes.CDLL(str(so))
    fn = lib.flash_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 4 + [i] * 7 + [ll] * 12 + [ctypes.c_float] + \
        [i] * 6 + [p]
    fn.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    K2_MODULE._fn = (fn, lib.flash_attention_error_string)
    plan = K2_MODULE.__dict__.setdefault("_planned", K2_MODULE.plan)
    K2_MODULE.plan = lambda q, k, v: plan(q, k, v)._replace(heads=heads)


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_breakdown: no CUDA device; this script runs on the GPU "
              "only", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    out = ROOT / "build" / "k2_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(min(len(VARIANTS), os.cpu_count() or 1)) as ex:
        futs = {n: ex.submit(build, n, e, out)
                for n, (e, _) in VARIANTS.items()}
        libs = {n: f.result() for n, f in futs.items()}
    B, S, H, KH, D, DV, causal, window, dt = cs.K2_MAIN
    cases = [cs.k2_case(400 + i, B, S, H, KH, D, DV, dt) for i in range(4)]
    ref = k2.flash_attention_ref(*cases[0])
    times: dict[str, list] = {n: [] for n in VARIANTS}
    for _ in range(3):
        for name, (_, heads) in VARIANTS.items():
            use_library(libs[name], heads)
            fn = lambda i: k2.flash_attention_kernel(*cases[i % 4])  # noqa
            err = float((fn(0).float() - ref.float()).abs().max())
            dev = cs.kernel_device_ms(fn, "flash_attention_kernel", 20)
            times[name].append((float("nan") if dev is None else dev,
                                cs.time_ms(fn, 40), err))
    base = float(np.median([t[0] for t in times["as built"]]))
    print(f"K2 at B{B} S{S} H{H} KH{KH} D{D} causal bf16, device ms per "
          f"launch (median of 3 rounds; events beside):", flush=True)
    for name, ts in times.items():
        dev = float(np.median([t[0] for t in ts]))
        ev = float(np.median([t[1] for t in ts]))
        print(f"  {name:26s} {dev:.4f} ms ({dev - base:+.4f}; events "
              f"{ev:.4f} ms; max abs err vs plain {ts[0][2]:.2e})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
