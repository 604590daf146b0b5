#!/usr/bin/env python3
"""Where a hand-written kernel spends its time on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 breakdown.py k2
    python3 breakdown.py k3 [--parent DIR]
    python3 breakdown.py k4 [--parent DIR]

It compiles copies of the kernel's source with one part removed or changed
(the kernel's table of variants below) and times each against the unchanged
kernel at the main path's shapes, in three rounds that alternate the order
of the variants, by the profiler's device time per launch (CUDA events
beside it).  Variants that remove work give wrong outputs: they measure
what that work costs, nothing else; a variant marked exact must give the
unchanged kernel's bits, or the script says so.  The card's name and power
limit come first.

k2, the flash-attention kernel (``kernels/csrc/flash_attention.cu``, its
bf16 tensor-core half) at ``chip_smoke.K2_MAIN`` (B 8, S 512, H 32 / KH 4 x
64, causal, bf16): the next tile's K/V copies, the Q·Kᵀ or P·V products,
the lo term of P, exp2, the proxy fence, the longest-first block order, and
one or four query heads a block in place of two.

k3, the SSD chunked scan (``kernels/csrc/ssd_scan.cu``) at Mamba-2 1.3B's
full width and two pruned widths (``chip_smoke.K3_FULL``, ``K3_PRUNED``,
``K3_PRUNED_ODD``; x f32, B/C bf16): C stateᵀ, M = (C Bᵀ) ⊙ L, M x, the
state update, all four at once; the specialized instances, or p16 or n16
left to the plan in them; the sub-chunk of 64 rows changed to 32 or to the
whole chunk; the TF32 rounding done by ``cvt.rna.tf32.f32`` in place of two
integer operations.  First the rate ``mma.sync`` reaches on this card with
no loads at all (TF32 m16n8k8 and bf16 m16n8k16, 16 warps an SM of 4
independent accumulators each), the ceiling of the kernel's products.
``--parent DIR`` adds the kernel of another checkout (its ``src/repro_torch/
kernels/csrc/ssd_scan.cu``; the CUDA-core design, whose launch takes a row
block after the chunk, gets 32), built and timed in the same rounds.

k4, the OBSPA in-block sweep (``kernels/csrc/obspa_update.cu``) at the
three tiles of ``chip_smoke.k4_tiles`` (R 2048, one 128-column block, f32:
67, 64 contiguous and all 128 columns pruned): the Hinv rows read from
global memory in the chain in place of the staged ones, the copies
skipped, issued by warp 0 alone, or of whole rows; the walk of all 128
columns with a branch each, or of the set bits with one row buffer (a
move a step); the divide in place of the reciprocal; 1 or 4 rows a warp;
4 or 16 warps a block; no walk at all (loads, copies and stores).
``--parent DIR`` adds the kernel of another checkout and, for the first
design (Hinv staged whole by 4-byte loads, every column walked, a divide
a row and step, four rows a warp, four warps a block), copies of it with
one suspect removed, all built and timed in the same rounds.
"""
from __future__ import annotations

import argparse
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
from repro_torch.kernels import obspa_update as k4  # noqa: E402
from repro_torch.kernels import ssd_scan as k3  # noqa: E402

# the packages re-export the dispatch functions over the modules' names
K2_MODULE = sys.modules["repro_torch.kernels.flash_attention.flash_attention"]
K3_MODULE = sys.modules["repro_torch.kernels.ssd_scan.ssd_scan"]
K4_MODULE = sys.modules["repro_torch.kernels.obspa_update.obspa_update"]
CSRC = ROOT / "src/repro_torch/kernels/csrc"

# name -> ((text in the tensor-core half of the source, its replacement),
# ...), query heads a block
K2_VARIANTS = {
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

K3_NO_YOFF = ("      if (on) {  // y_off", "      if (false) {  // y_off")
K3_NO_M = ("for (int tau = w; tau < L.tiles; tau += WARPS) {",
           "for (int tau = w; tau < 0; tau += WARPS) {")
K3_NO_DIAG = ("for (int cc = 0; cc <= 2 * r0 + 1; ++cc) {",
              "for (int cc = 0; cc < 0; ++cc) {")
K3_NO_STATE = ("for (int s = w; s < L.strips; s += WARPS) {",
               "for (int s = w; s < 0; s += WARPS) {")
K3_SUB_CHUNK = ("  for (int d = 4; d > 1; --d)\n"
                "    if ((Q / 16) % d == 0) return 16 * d;")
K3_FIXED_LAYOUT = "    return layout(QF, PF, NF, EX, EB);"

# name -> ((text in the source, its replacement), ...), and whether y must
# stay bitwise equal to the unchanged kernel's
K3_VARIANTS = {
    "as built": ((), True),
    "no specialized instances": (
        (("if (P.L.Q == 64 && P.L.p16 <= 64", "if (false && P.L.p16 <= 64"),),
        True),
    "p16 from the plan": (
        ((K3_FIXED_LAYOUT, K3_FIXED_LAYOUT.replace("PF", "P.L.p16")),), True),
    "n16 from the plan": (
        ((K3_FIXED_LAYOUT, K3_FIXED_LAYOUT.replace("NF", "P.L.n16")),), True),
    "cvt.rna.tf32.f32 rounding": (
        (("  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
          "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : "
          "\"f\"(v));\n  return r;"),), True),
    "sub-chunks of 32": (
        ((K3_SUB_CHUNK, K3_SUB_CHUNK.replace("d = 4", "d = 2")),), False),
    "whole chunks (no sub-chunks)": (((K3_SUB_CHUNK, "  return Q;"),), False),
    "no C stateᵀ": ((K3_NO_YOFF,), False),
    "no M = (C Bᵀ) ⊙ L": ((K3_NO_M,), False),
    "no M x": ((K3_NO_DIAG,), False),
    "no state update": ((K3_NO_STATE,), False),
    "copies and barriers only": (
        (K3_NO_YOFF, K3_NO_M, K3_NO_DIAG, K3_NO_STATE), False),
}

# K4: the edits the variants below share
K4_EXPECT = ("mbar_arrive_expect_tx(&bar[k],\n"
             "                            __popc(bits[k]) * (BLK - "
             "row_col0(k)) * 4);", "mbar_arrive_expect_tx(&bar[k], 0);")
K4_NO_COPY = ("bulk_g2s(hs + c * BLK", "if (false) bulk_g2s(hs + c * BLK")
# the walk of one quarter in other forms, around the same load_row and step
K4_WALKS = {
    "whole walk": (
        "    for (int jj = 0; jj < 32; ++jj) {\n"
        "      if (!(left >> jj & 1u)) continue;\n"
        "      float hr[CPL];\n"
        "      load_row(hr, staged(c, kk, jj), kk, lane);\n"
        "      ++c;\n"
        "      step(wr, er, hr, rinv[kk], kk, jj, lane);\n"
        "    }\n"),
    "one buffer": (
        "    float hn[CPL];\n"
        "    int jn = __ffs(left) - 1;\n"
        "    if (left) load_row(hn, staged(c, kk, jn), kk, lane);\n"
        "    while (left) {\n"
        "      float hr[CPL];\n#pragma unroll\n"
        "      for (int k = 0; k < CPL; ++k) hr[k] = hn[k];\n"
        "      const int j = jn;\n"
        "      left &= left - 1u;\n"
        "      ++c;\n"
        "      if (left) {\n"
        "        jn = __ffs(left) - 1;\n"
        "        load_row(hn, staged(c, kk, jn), kk, lane);\n"
        "      }\n"
        "      step(wr, er, hr, rinv[kk], kk, j, lane);\n"
        "    }\n"),
    "no walk": "",
}


def k4_branchy(j: str, buf: str) -> tuple[str, str]:
    """The walk's read of the next row, and the same behind ``if (left)``."""
    read = (f"      {j} = __ffs(left) - 1;\n"
            f"      load_row({buf}, staged(c, kk, {j}), kk, lane);\n")
    return read, ("      if (left) {\n" + read.replace("      ", "        ")
                  + "      }\n")


def k4_walk(src: str) -> str:
    """The ballot walk of one quarter, between the source's markers."""
    a, b = "    // walk: begin\n", "    // walk: end\n"
    return src[src.index(a):src.index(b)]


# name -> ((text in the source, its replacement), ...), and whether W and
# E must stay bitwise equal to the unchanged kernel's (a name of K4_WALKS in
# place of the edits: that walk in place of the ballot walk)
K4_VARIANTS = {
    "as built": ((), True),
    "no staging (rows from global)": (
        (K4_EXPECT, K4_NO_COPY,
         ("return hs + min(c, BLK - 1) * BLK;",
          "return h + (32 * kk + max(j, 0)) * a.h_ld;")),
        True),
    "copies skipped": ((K4_EXPECT, K4_NO_COPY), False),
    "copies issued by warp 0 alone": (
        (("c % WARPS == warp", "warp == 0"),), True),
    "whole rows staged": (
        (("constexpr bool TRIANGLE = true;",
          "constexpr bool TRIANGLE = false;"),), True),
    "whole 128-column walk": ("whole walk", True),
    "one row buffer (a move a step)": ("one buffer", True),
    "next row read behind a branch": (
        (k4_branchy("jb", "hb"), k4_branchy("ja", "ha")), True),
    "divide for the reciprocal": (
        (("wj * rinv", "wj / rinv"), ("rinv[kk], kk,", "hd[kk], kk,")),
        False),
    "1 row a warp": (
        (("constexpr int RW = 2;", "constexpr int RW = 1;"),), True),
    "4 rows a warp": (
        (("constexpr int RW = 2;", "constexpr int RW = 4;"),), True),
    "4 warps a block": (
        (("constexpr int WARPS = 8;", "constexpr int WARPS = 4;"),), True),
    "16 warps a block": (
        (("constexpr int WARPS = 8;", "constexpr int WARPS = 16;"),), True),
    "no walk (loads, copies, stores)": ("no walk", False),
}

# the first design, with one suspect removed (``--parent``; the texts are its
# source's): exact unless marked False
K4_FIRST_STAGE = "    hs[i] = h[(i / BLK) * a.h_ld + (i % BLK)];"
K4_FIRST_VARIANTS = {
    "first design": ((), True),
    "first design, rows read from global": (
        ((K4_FIRST_STAGE, "    ;"),
         ("hs[j * BLK + j]", "h[j * a.h_ld + j]"),
         ("hs[j * BLK + lane + 32 * k]", "h[j * a.h_ld + lane + 32 * k]")),
        True),
    "first design, staging skipped": (((K4_FIRST_STAGE, "    ;"),), False),
    "first design, a multiply for the divide": (
        (("__shfl_sync(FULL, wr[r][kk], jj) / hjj",
          "__shfl_sync(FULL, wr[r][kk], jj) * hjj"),), False),
    "first design, no chain": (
        (("if (!ms[j]) continue;", "if (true) continue;"),), False),
    "first design, loads and stores only": (
        ((K4_FIRST_STAGE, "    ;"),
         ("if (!ms[j]) continue;", "if (true) continue;")), False),
    "first design, 2 rows a warp": (
        (("constexpr int RW = 4;", "constexpr int RW = 2;"),), True),
    "first design, 1 row a warp": (
        (("constexpr int RW = 4;", "constexpr int RW = 1;"),), True),
    "first design, 8 warps a block": (
        (("constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),), True),
}

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int BF16>
__global__ void bench(float* out, int iters) {
  float d[4][4] = {};
  const uint32_t a0 = threadIdx.x, one = BF16 ? 0x3f803f80u : 0x3f800000u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a0), "r"(one));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%5}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a0), "r"(one));
    }
  float s = 0.f;
  for (int c = 0; c < 4; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float mma_ms(int bf16, int blocks, int iters) {
  float* out;
  cudaMalloc(&out, blocks * 512 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {  // the first is a warm-up
    cudaEventRecord(e0);
    if (bf16) bench<1><<<blocks, 512>>>(out, iters);
    else bench<0><<<blocks, 512>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return ms;
}
"""


def variant_source(src: str, edits, cut: str | None = None) -> str:
    """``src`` with each (old, new) edit made after the marker ``cut``."""
    head, tail = ("", src) if cut is None else \
        (src[:src.index(cut)], src[src.index(cut):])
    for old, new in edits:
        if old not in tail:
            raise RuntimeError(f"breakdown: {old!r} is not in the source")
        tail = tail.replace(old, new)
    return head + tail


def build(name: str, text: str, out: Path) -> tuple[Path, str]:
    """Compile ``text`` as one CUDA source: the library and ptxas's log."""
    stem = "".join(c if c.isalnum() else "_" for c in name)
    cu, so = out / f"{stem}.cu", out / f"lib{stem}.so"
    cu.write_text(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return so, proc.stdout + proc.stderr


def build_all(texts: dict, out: Path) -> dict:
    with ThreadPoolExecutor(min(len(texts), os.cpu_count() or 1)) as ex:
        futs = {n: ex.submit(build, n, t, out) for n, t in texts.items()}
        return {n: f.result() for n, f in futs.items()}


def time_rounds(names, calls: dict, use, kernel: str, iters: int,
                check=None, rounds: int = 3) -> dict:
    """times[name][label] = [(device ms, event ms), ...], one a round, the
    variants in alternating order; ``calls[label](i)`` launches the kernel
    at one shape, ``use(name)`` switches to a variant, ``check(name, label,
    out)`` sees the first output of every round."""
    times = {n: {lab: [] for lab in calls} for n in names}
    for rnd in range(rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            use(name)
            for lab, fn in calls.items():
                if check is not None:
                    check(name, lab, fn(0))
                dev = cs.kernel_device_ms(fn, kernel, iters)
                times[name][lab].append(
                    (float("nan") if dev is None else dev,
                     cs.time_ms(fn, 2 * iters)))
    return times


def report(times: dict, notes: dict) -> None:
    """Each variant's median device ms, its difference from the unchanged
    kernel's, and the median event ms."""
    base = {lab: float(np.median([t[0] for t in ts]))
            for lab, ts in times["as built"].items()}
    for name, per in times.items():
        cols = []
        for lab, ts in per.items():
            dev = float(np.median([t[0] for t in ts]))
            ev = float(np.median([t[1] for t in ts]))
            cols.append(f"{lab} {dev:.4f} ({dev - base[lab]:+.4f}; events "
                        f"{ev:.4f})")
        print(f"  {name:30s} " + " | ".join(cols) + notes.get(name, ""),
              flush=True)


def run_k2(args, out: Path) -> None:
    built = build_all({n: variant_source(
        (CSRC / "flash_attention.cu").read_text(), e, "// bf16: tensor cores")
        for n, (e, _) in K2_VARIANTS.items()}, out)
    plan = K2_MODULE.plan

    def use(name: str) -> None:
        """Point K2's wrapper at this variant's library and heads a block."""
        lib = ctypes.CDLL(str(built[name][0]))
        fn = lib.flash_attention_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 7 + [ll] * 12 + [ctypes.c_float] + \
            [i] * 6 + [p]
        fn.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        K2_MODULE._fn = (fn, lib.flash_attention_error_string)
        heads = K2_VARIANTS[name][1]
        K2_MODULE.plan = lambda q, k, v: plan(q, k, v)._replace(heads=heads)

    B, S, H, KH, D, DV, causal, window, dt = cs.K2_MAIN
    cases = [cs.k2_case(400 + i, B, S, H, KH, D, DV, dt) for i in range(4)]
    ref = k2.flash_attention_ref(*cases[0])
    err: dict[str, float] = {}

    def check(name, lab, o):
        err.setdefault(name, float((o.float() - ref.float()).abs().max()))

    times = time_rounds(
        list(K2_VARIANTS),
        {"main": lambda i: k2.flash_attention_kernel(*cases[i % 4])},
        use, "flash_attention_kernel", 20, check)
    print(f"K2 at B{B} S{S} H{H} KH{KH} D{D} causal bf16, device ms per "
          f"launch (median of 3 rounds; events beside):", flush=True)
    report(times, {n: f"; max abs err vs plain {e:.2e}"
                   for n, e in err.items()})


def mma_ceiling(out: Path) -> None:
    """TFLOP/s of mma.sync alone, and cycles per instruction per SM
    sub-partition at the card's maximum SM clock."""
    so, _ = build("mma bench", MMA_BENCH, out)
    lib = ctypes.CDLL(str(so))
    lib.mma_ms.argtypes = [ctypes.c_int] * 3
    lib.mma_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = cs.gpu_clocks()["max_sm_mhz"]
    iters = 4096
    for bf16, name, k in ((0, "TF32 m16n8k8", 8), (1, "bf16 m16n8k16", 16)):
        ms = lib.mma_ms(bf16, sms, iters)
        n = sms * 16 * 4 * iters                  # instructions issued
        print(f"mma.sync {name}: {2 * 16 * 8 * k * n / ms / 1e9:.1f} "
              f"TFLOP/s, {ms * 1e-3 * mhz * 1e6 / (n / sms / 4):.2f} cycles "
              f"per instruction per sub-partition at {mhz:.0f} MHz",
              flush=True)


def k3_launcher(so: Path, extra: int | None = None):
    """The library's launch, called as K3's wrapper calls it; ``extra``: the
    int an older launch takes after the chunk."""
    lib = ctypes.CDLL(str(so))
    fn = lib.ssd_scan_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * (8 if extra is None else 9) + [p]
    fn.restype = i
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    if extra is not None:
        return (lambda *a: fn(*a[:12], extra, *a[12:]),
                lib.ssd_scan_error_string)
    return fn, lib.ssd_scan_error_string


def run_k3(args, out: Path) -> None:
    mma_ceiling(out)
    src = (CSRC / "ssd_scan.cu").read_text()
    texts = {n: variant_source(src, e) for n, (e, _) in K3_VARIANTS.items()}
    if args.parent is not None:
        texts["parent"] = (args.parent / "src/repro_torch/kernels/csrc/"
                           "ssd_scan.cu").read_text()
    built = build_all(texts, out)
    for name in ("as built", "parent"):
        if name in built:
            ks = cs.ptxas_kernels(built[name][1])
            print(f"{name}: {len(ks)} instances, " + "; ".join(
                f"{k['name'].split('(')[0]} {k['registers']} registers, "
                f"{k['spill_bytes']} bytes spilled" for k in ks), flush=True)
    libs = {n: k3_launcher(so, 32 if n == "parent" else None)
            for n, (so, _) in built.items()}
    shapes = {"full": cs.K3_FULL, "pruned": cs.K3_PRUNED,
              "pruned odd": cs.K3_PRUNED_ODD}
    cases = {}
    for label, sh in shapes.items():
        d = dict(sh)
        Q = d.pop("Q")
        cases[label] = (cs.ssd_case(230, **d, x_dtype=torch.float32,
                                    bc_dtype=torch.bfloat16), Q)
    K3_MODULE._fn = libs["as built"]
    ref = {lab: k3.ssd_scan_kernel(*a, Q) for lab, (a, Q) in cases.items()}
    same = {n: True for n in libs}

    def use(name):
        K3_MODULE._fn = libs[name]

    def check(name, lab, y):
        same[name] &= bool(torch.equal(y, ref[lab]))

    times = time_rounds(
        list(libs), {lab: (lambda i, a=a, Q=Q: k3.ssd_scan_kernel(*a, Q))
                     for lab, (a, Q) in cases.items()},
        use, "ssd_scan_kernel", 10, check)
    print("K3 device ms per launch (median of 3 rounds; events beside), x "
          "f32, B/C bf16: " + ", ".join(f"{lab} {tuple(sh.values())}"
                                        for lab, sh in shapes.items()),
          flush=True)
    report(times, {n: "; y bitwise equal" if same[n] else "; y DIFFERS"
                   for n, (_, exact) in K3_VARIANTS.items() if exact})


def k4_launcher(so: Path):
    """The library's launch, as K4's wrapper calls it (one C interface for
    every design)."""
    lib = ctypes.CDLL(str(so))
    fn = lib.obspa_inblock_launch
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, i64, i64, p, i64, i64, p, p, i64, i64, p, i, i, p]
    fn.restype = i
    lib.obspa_inblock_error_string.argtypes = [i]
    lib.obspa_inblock_error_string.restype = ctypes.c_char_p
    return fn, lib.obspa_inblock_error_string


def run_k4(args, out: Path) -> None:
    src = (CSRC / "obspa_update.cu").read_text()
    walk = k4_walk(src)
    texts = {n: variant_source(src, ((walk, K4_WALKS[e]),)
                               if isinstance(e, str) else e)
             for n, (e, _) in K4_VARIANTS.items()}
    exact = {n: ex for n, (_, ex) in K4_VARIANTS.items()}
    if args.parent is not None:
        src = (args.parent / "src/repro_torch/kernels/csrc/"
               "obspa_update.cu").read_text()
        if K4_FIRST_STAGE in src:
            texts.update({n: variant_source(src, e)
                          for n, (e, _) in K4_FIRST_VARIANTS.items()})
            exact.update({n: ex for n, (_, ex) in K4_FIRST_VARIANTS.items()})
        else:
            texts["parent"], exact["parent"] = src, False
    built = build_all(texts, out)
    for name, (_, log) in built.items():
        print(f"{name}: " + "; ".join(
            f"{k['name'].split('(')[0]} {k['registers']} registers, "
            f"{k['spill_bytes']} bytes spilled"
            for k in cs.ptxas_kernels(log)), flush=True)
    libs = {n: k4_launcher(so) for n, (so, _) in built.items()}
    tiles = cs.k4_tiles()
    outs = {lab: (torch.empty_like(w), torch.empty_like(w))
            for lab, (w, _, _) in tiles.items()}
    K4_MODULE._fn = libs["as built"]
    plain = {lab: k4.inblock_sweep_plain(t[0][None], t[1][None], t[2])
             for lab, t in tiles.items()}
    # the unchanged kernel of each design is the yardstick of its variants
    base = {n: "first design" if n.startswith("first design")
            else "as built" for n in libs}
    first: dict = {}
    err: dict = {}

    def use(name):
        K4_MODULE._fn = libs[name]

    def check(name, lab, res):
        first.setdefault((name, lab), tuple(t.clone() for t in res))
        p = plain[lab]
        err[(name, lab)] = max(float((res[0] - p[0][0]).abs().max()),
                               float((res[1] - p[1][0]).abs().max()))

    def call(lab):
        w, h, m = tiles[lab]
        o, e = outs[lab]
        return lambda i: k4.inblock_sweep_kernel(w, h, m, out=o, e_out=e)

    times = time_rounds(list(libs), {lab: call(lab) for lab in tiles}, use,
                        "inblock_sweep_kernel", 50, check)
    notes = {}
    for n in libs:
        worst = max(err[(n, lab)] for lab in tiles)
        notes[n] = f"; max abs err vs plain {worst:.2e}"
        if exact[n] and n != base[n]:
            same = all(torch.equal(a, b) for lab in tiles for a, b in
                       zip(first[(n, lab)], first[(base[n], lab)]))
            notes[n] += (f"; bitwise equal to {base[n]}" if same else
                         f"; DIFFERS from {base[n]}")
    print("K4 device ms per launch (median of 3 rounds; events beside), "
          "R 2048, one 128-column block, f32: " + ", ".join(tiles),
          flush=True)
    report(times, notes)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("k2", "k3", "k4"))
    ap.add_argument("--parent", type=Path, default=None,
                    help="k3, k4: a checkout whose kernel is timed beside "
                         "this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    out = ROOT / "build" / "breakdown" / args.kernel
    out.mkdir(parents=True, exist_ok=True)
    {"k2": run_k2, "k3": run_k3, "k4": run_k4}[args.kernel](args, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
