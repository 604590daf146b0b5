#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs a CUDA device, ``nvcc`` and nothing from the network, and imports
nothing of JAX or of the JAX package.  Phases:

 1. environment: the card (name, power limit), torch / CUDA / nvcc versions;
 2. build of the kernel libraries from ``src/repro_torch/kernels/csrc``;
    every kernel instance with its registers, spills and stack
    (``ptxas -v``) and the count of tensor-core instructions in their SASS
    (``cuobjdump``);
 3. the paged-attention kernel K1 against its plain PyTorch version on the
    card, each shape on the instance the wrapper plans (split-KV decode
    and prefill on the tensor cores for bf16 q over a bf16 / int8 / fp8
    pool, the CUDA cores otherwise): decode and prefill at TinyLlama
    width, windows, int8 / fp8 pools, pruned-looking shapes, poisoned null
    blocks, C*G off the 64-row grid, blocks of 4 and 8, D 256 / DV 200, one
    2048-token sequence beside kv_len 0 and 1, the speculative verify's
    prefill entry at C = 1, 2 and 4 with histories ending anywhere (G 8
    over bf16 and int8 pools, G 1 at head_dim 128) and the pruned draft's
    decode and prefill; visit counts exact and two calls bitwise equal;
    then (3b) its time beside the plain version, three
    ``scaled_dot_product_attention`` yardsticks (on the history gathered
    and repeated to all heads; on the kv-heads with ``enable_gqa`` and on
    the kv-heads with the query heads folded into rows, both with the keys
    cut to the longest live length), in alternating rounds by the
    profiler's device time per call, SM clock, power and temperature read
    around each, and the card's bound, at the decode, prefill and verify
    (C = 4) shapes;
 4. the main path at full width: ``tinyllama-1.1b`` (22 layers, bf16, random
    weights from a seed) served by ``repro_torch.serve.Engine``, checked by
    teacher forcing against ``Model.forward``, and its model steps against
    the same steps on the plain version; plus a short int8-pool run;
    then (4b) the front door and crash safety on the same model (a
    generator of its own): (a) phase 4's request mix served again with
    telemetry on, lockstep and through the double-buffered ``step_async``
    (each twice, alternating),
    the async tokens held to the lockstep run's (exactly where a request's
    prefix hits, chunk count and preemptions match, else by teacher
    forcing), the step phases side by side; (b) both engines'
    ``_submit_step`` (plan, uploads, dispatch, the fetch's start) under
    ``torch.cuda.set_sync_debug_mode("error")``, and which of a pageable
    blocking upload, a pinned non-blocking one and ``torch.multinomial``
    synchronize; (c) ``stream()``, two cancels mid-flight, an expiring
    deadline and ``EngineOverloaded``; (d) 16 requests under a step-pinned
    fault schedule with full audits, lockstep and async; (e) a snapshot
    saved to a file at step K - 1, the injected crash at K, and a fresh
    engine restored from the file run to the end against an uninterrupted
    run, lockstep and async;
 5. times of the device code around the kernel (KV scatter, sampling, COW);
 6. the OBSPA sweep kernel K4 against its plain PyTorch version and the
    float64 oracle (the reference's test shapes, identity Hessian, a batched
    case, the main path's R=2048 x K=2048 / 5632 at half the columns
    pruned, phase 13's 60 experts in one launch at K 1408 and its shared
    expert at K 22528, phase 14's conv consumers R 512 x K 4608 and R 64 x
    K 576 with whole channels — runs of 9 columns — pruned at 50 %, and
    its classifier R 10 x K 512, phase 15's hubert-xlarge attn.wo R 1280 x
    K 1280 with whole heads pruned and w_down R 1280 x K 5120, and
    paligemma-3b's w_down R 2048 x K 16384), then K4 alone on one column
    block at
    the design's edge cases
    (no, one, 64 contiguous, all 128, the first or the last column pruned;
    R 1, 17, 2051; nb 4 with one shared Hinv), each call repeated bitwise,
    in place and counted; then (6b) its profiler device time at three
    tiles of R 2048 (67, 64 contiguous and all 128 columns pruned) beside
    the plain version, the card's bound and a triangular solve and product
    (``k4_yardstick``), and the whole sweep of a (2048, 5632) view with its
    kernels counted; the same for phase 14's R 512 x K 4608 conv view (its
    first column block and its whole sweep);
 7. the prune-then-serve path at full width: ``tinyllama-1.1b`` OBSPA-pruned
    on the card at ratio 0.5 with data-free calibration (its sweeps launch
    K4), every reconstructed layer's output error held below plain slicing,
    logit MSE against the dense model for OBSPA and for magnitude pruning,
    then the pruned model (D != DV) served by ``Engine`` through K1 and
    checked by teacher forcing against its own ``Model.forward``;
 8. the SSD chunked-scan kernel K3 against its plain PyTorch version and a
    float64 run of it (the reference's four test shapes, full-width and
    pruned Mamba-2 shapes with x f32 and B/C bf16, the float32 model's
    full width, an odd pruned width, a large-dt case whose exp above the
    diagonal would overflow), each call counted once and repeated bitwise;
    then (8b) its time at the full-width and pruned shapes beside the plain
    version and two bounds (the f32 CUDA cores', and the tensor cores' for
    the split-TF32 passes);
 9. the main path of the ssm family at full width: ``mamba2-1.3b`` (cut to
    24 of its 48 layers; d 2048, 64 SSM heads x 64, state 128, bf16, random
    weights from a seed) — ``Model.forward`` on K3 against the plain scan,
    16 requests served by ``Engine`` (a third behind a shared prefix that
    must not be aliased), every served token checked by teacher forcing
    through ``Model.forward`` (K3); then SPA-pruned by magnitude (L1) at
    ratio 0.5 on the card and the same checks on the pruned model; then
    OBSPA-pruned at ratio 0.5 with data-free calibration (K4 on
    ``ssm.w_out``) and the same checks again;
10. the flash-attention kernel K2 against its plain PyTorch version (the
    reference's six test shapes, the main path's 8 x 512 TinyLlama shape
    and its pruned D 64 / DV 32 form, a length that is not a multiple of
    the tile, a window, bidirectional, f32; in bf16 on the tensor-core
    instance D = DV 128, D 256 / DV 200, D 48 / DV 20, D 20, S 2048, a
    window at S 1024, and views one element into their storage), each on
    the instance the wrapper plans; and its time beside the plain version,
    one ``scaled_dot_product_attention`` call (in alternating rounds, SM
    clock, power and temperature read around each), its profiler device
    time, the card's bound, and the f32 CUDA-core instance at the same
    shape;
11. train, prune any time, fine-tune at full width: ``tinyllama-1.1b``
    trained from random weights by ``repro_torch.train.Trainer`` (every
    layer rematerialised, as the config's ``remat`` asks) on the
    "id" Markov task (8 x 512-token batches), then the paper's three
    regimes — SPA-SNIP at init then trained, SPA-L1 after training then
    fine-tuned, OBSPA after training with data-free calibration (K4) —
    every model evaluated by a no-grad ``Model.loss`` on K2 and once on the
    plain attention, held to the plain version's own rounding spread (the
    mean per-token |CE bf16 - CE f32 twin|); RF/RP, step time, tokens/s
    and peak memory of each; then (11b) the trained dense model served as
    the target of its own drafts, self-speculative at K 4 with greedy
    verify: 16 requests whose prompts are 192-320-token prefixes of rows
    no model trained on, 64 new tokens each — (a) dense only, (b) the L1
    + fine-tuned draft on a bf16 draft pool, run twice, (c) on an int8
    draft pool, (d) the OBSPA draft, (e) (b) with telemetry on — each held
    lossless by teacher forcing against ``Model.forward`` (a limit set
    before the runs from the plain bf16 forward's shortfall against its
    float32 twin), (e) to (b) token for token, host fetches to the
    sampling steps and K1's launches to their formula, with acceptance,
    tok/s, TTFT, draft pool bytes, peak memory and (e)'s phase timers;
    and a checkpoint-and-restart drill (``run_with_restarts``) at the
    reduced config;
12. the hybrid family at full width: ``hymba-1.5b`` (cut to 16 of its 32
    layers, ``HYMBA_LAYERS``; d 1600, 25 query heads over 5 KV heads of 64,
    window 1024 except on the global layers 0 and 15, 50 SSM heads x 64,
    state 16, bf16, random weights from a seed), attention and SSD heads
    in parallel in every layer, so K1, K2
    and K3 run in one model — 16 requests of 256-1600 tokens served (four
    longer than the window), K1's visit counts held to the liveness
    predicate at each layer's window and shown below the unwindowed counts;
    each layer's attention half (K2) and SSD half (K3) against their plain
    versions in bf16, the model cut to 2 layers served in bf16, the float32
    twin served at full depth, all checked by teacher forcing; then
    L1-pruned and OBSPA-pruned (K4) at ratio 0.5 on the card, each checked
    the same way, with every reconstructed consumer's layer-output error
    against plain slicing recorded, and the four kernels' launches held to
    their formulas; its prompts come from a generator of its own;
13. the moe family at full width: ``qwen2-moe-a2.7b`` (24 layers, d 2048,
    16 heads of 128 over 16 KV heads, 60 routed experts top-4 of width
    1408 and 4 shared experts of 5632, bf16, random weights from a seed) —
    each layer's attention on K2 against its plain version and its MoE
    block against the block's float32 twin (2 x 1600 tokens); 16 requests
    served at the published capacity factor (1.25), with the real tokens'
    (token, expert) assignments that the capacity dropped counted; the
    no-drop twin (capacity factor 15, float32, first 2 layers) served and
    held to the sequential oracle token for token; in bf16 through the
    engine, teacher-forced against ``Model.forward`` on K2: the published
    routing at 2 layers read only (a router near-tie flips an expert
    between the two roundings), the all-experts twin (top-60, capacity
    factor 1: no choice, no drop) held at 2 layers and at 24; the drop
    counter's time in a decode step; then L1-pruned at ratio
    0.5 at all 24 layers and OBSPA-pruned at ratio 0.5 at its first 8
    (every consumer's Hessian is held at once: ~60 GB at 24 layers), the
    experts' ``w_down`` swept by K4 all 60 at once, every reconstructed
    consumer's layer-output error held below plain slicing; each pruned
    model checked layer by layer and served again, and the launches of K1,
    K2 and K4 held to their formulas;
14. the cnn family at full width (float32, random init from a seed, data
    from a generator of its own): ``resnet50-cifar`` (21,282,112
    parameters) trained by ``Trainer`` 100 steps of 128 ``PrototypeImages``
    and pruned at the paper's three times — SPA-SNIP at init then trained,
    SPA-L1 (global) after training then fine-tuned 50 steps, OBSPA after
    training with ID, OOD and DataFree calibration (16 x 64 images; every
    conv consumer's (C_out, 9·C_in) view swept by K4; BatchNorm statistics
    re-estimated for ID and OOD) — and ``vgg19-cifar`` (20,081,088) trained,
    then L1 and OBSPA ID; each model's accuracy on 8 x 256 "eval" images,
    RF / RP (> 1.15), seconds by prune phase, peak memory and kept
    channels a stage; the trained and OBSPA-pruned forwards against
    float64; the dense resnet50 with its BatchNorm recalibrated alone;
    VGG also trained at the reference lr (its dead channels); every
    consumer's layer-output error against plain slicing, those not below
    redone by a float64 plain sweep, and resnet50's ID and OOD errors
    summed over the model held below slicing's; K4's launches held to the
    sum of ⌈K / 128⌉ over the swept consumers;
15. the encoder and VLM families (random init from a seed, data from a
    generator of its own): ``hubert-xlarge`` at full width (48 layers, d
    1280, 16 heads of 80, bidirectional, 504 targets, bf16) — every layer's
    attention on K2 against its plain version on 2 x 1000 frames, trained
    by ``Trainer`` on ``FrameTask`` (24 steps of 8 x 512 frames, every
    layer rematerialised), frame accuracy, then L1 and OBSPA ID at 0.5 on
    its first ``HUBERT_PRUNE_LAYERS`` layers (K4 on ``attn.wo`` and
    ``mlp.w_down``), each consumer's layer-output error against slicing
    (summed, held below), the OBSPA-pruned model at 2 layers against its
    float32 twin; ``vit-mini`` (196 patches) and ``distilbert-mini`` (128
    tokens) at their registered size in float32 (K2's CUDA-core
    instance), trained 100 steps and pruned at the paper's three times
    (SNIP at init, L1 then fine-tuned, OBSPA ID / OOD / DataFree);
    ``paligemma-3b`` at full width (18 layers, d 2048, MQA, 256 patches of
    1152, vocab 257216, bf16) — the prefix mask's property on the card
    with K2 launched 0 times (the reference runs ``prefix`` on its plain
    attention), a few ``Trainer`` steps on DataFree tokens, L1 and OBSPA
    DataFree, and the engine's refusal; accuracy or loss, RF / RP, prune
    seconds and peak memory of each, and K2's and K4's launches held to
    their formulas.

Phases 3, 8 and 10 also hold K1, K3 and K2 at Hymba's shapes (G = 5, the
window of 1024 over 2048 tokens, 50 SSM heads x 64 x state 16), K1 and K2
at qwen2-moe's (16 heads of 128, G = 1; phase 2 prints the registers and
spills of the instances this picks, and raises if one spills; phases 3b
and 10b time them), K2 at hubert-xlarge's (bidirectional, 16 heads of 80,
G = 1, 4 x 1000 frames; phase 2 prints its instances, 10b times it) and
at the widths pruning leaves; phase 6 holds K4 at phase 15's views.

Every full-sequence ``Model.forward`` / ``Model.loss`` of an attention model
on the card runs K2 (teacher forcing in phases 4 and 7, every evaluation in
phases 11 and 15), except a vlm's prefix mask, which runs the plain
attention as the reference's does; training and the gradient criteria differentiate the plain
attention, as the reference trains with ``use_pallas=False``.

The kernels are built in parallel (one ``nvcc`` per source).  Any failing
phase raises, so the exit code is non-zero and no ``"ok"`` line
is printed.  TF32 is off for matmuls and cuDNN throughout.

``--quick`` cuts phases 4, 7, 9, 11, 12 and 13 to 4 layers and a few requests
or steps, phase 14 to resnet18-cifar and vgg19-cifar at 10 steps, and phase
15 to its reduced configs (for a first look at a new kernel); ``--profile``
adds a
``torch.profiler`` trace of one decode and one prefill step (device busy
share, K1's time per step, top kernels).  The default is the full run without the trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.obspa import (  # noqa: E402
    DAMPING as OBSPA_DAMPING, _dot_w2d, _flat_columns, find_consumers,
    hessian_sums, hkey, layer_output_errors, obspa_prune, recalibrate_bn)
from repro_torch.core.pruner import (  # noqa: E402
    delete_positions, prune_model, trace_model)
from repro_torch.data.synthetic import batches  # noqa: E402
from repro_torch.core.flops import rf_rp  # noqa: E402
from repro_torch.core.graph import tree_paths  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.kernels import obspa_update as k4  # noqa: E402
from repro_torch.kernels import ssd_scan as k3  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    ensure_built, expected_visits, launch_counts, paged_attention,
    paged_prefill_attention, quantize, reset_launches)
from repro_torch.kernels.paged_attention import plan as k1_plan  # noqa: E402
from repro_torch.kernels.paged_attention.paged_attention import (  # noqa: E402
    sm_count as k1_sm_count)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.attention import _scatter_kv  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    attention_block as attn_block)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.cnn import stage_widths  # noqa: E402
from repro_torch.models.layers import rms_norm, swiglu  # noqa: E402
from repro_torch.models.ssm import ssd_reference, ssm_block  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    CrashError, Engine, EngineOverloaded, Fault, FaultInjector, ServeConfig,
    load_snapshot, save_snapshot)
from repro_torch.train.loop import (  # noqa: E402
    Trainer, TrainerConfig, run_with_restarts)
from repro_torch.train.optim import OptConfig  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12

# Tolerances of kernel vs plain version, err <= atol + rtol * |plain|.  Both
# sides accumulate in f32, so f32 outputs differ only in summation order (up
# to 2048 keys per row): 1e-5 absolute, as the reference's kernel tests use.
# bf16 outputs are the same f32 sums rounded to bf16, so they differ by at
# most one bf16 step of the value (2^-7 relative); the absolute part covers
# values near zero.  A limit relative to the value cannot be passed by
# outputs that are themselves far below it (long histories average to
# |out| ~ 0.05).
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-4, 2.0 ** -7)}


def tol_text(dtype) -> str:
    atol, rtol = TOL[dtype]
    return f"{atol:g}" + (f" + {rtol:g}*|plain|" if rtol else "")


def excess_over_tol(err, ref) -> float:
    """Largest amount by which ``err`` exceeds the limit of ``ref``'s dtype
    (<= 0 when every element is within it)."""
    atol, rtol = TOL[ref.dtype]
    return float((err - (atol + rtol * ref.float().abs())).max())


K1_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
K1_REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:130"
K4_SOURCE = "src/repro_torch/kernels/csrc/obspa_update.cu"
K4_REPLACES = "src/repro/kernels/obspa_update/obspa_update.py:50"
# K4 vs the float64 oracle: error relative to |oracle|.max(), the limit
# tests/test_kernels.py holds the reference's sweep to (f32 chains of up to
# K rank-1 steps round differently from float64)
K4_RTOL = 1e-4
K3_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
K3_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:71"
# K3 vs its plain version: max|Δ| / max|plain|, the reference's limits
# (tests/test_kernels.py::test_ssd_scan) by the type of y (x's): both sides
# compute in f32 from the same (possibly bf16-valued) inputs, in another
# order; a bf16 y adds one bf16 rounding
K3_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
K2_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
K2_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:69"

DEV = "cuda"


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------------------
# Phase 3: kernel vs plain version
# ---------------------------------------------------------------------------

def make_case(rng, *, B, C, H, KH, D, DV, bs, NB, q_dtype, pool, kv_lens,
              q_starts=None, poison_null=False):
    """Pools, tables and queries for one comparison.  ``pool`` is a torch
    dtype or "int8"/"fp8_e4m3".  Every sequence gets its own shuffled blocks
    (block 0 stays the null block)."""
    P = B * NB + 1
    k = torch.from_numpy(rng.standard_normal((P, bs, KH, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((P, bs, KH, DV), np.float32))
    if poison_null:
        k[0] = 1e4
        v[0] = -1e4
    perm = rng.permutation(np.arange(1, P)).reshape(B, NB).astype(np.int32)
    kv_lens = np.asarray(kv_lens, np.int32)
    live = (np.arange(NB)[None, :] * bs) < kv_lens[:, None]
    tables = np.where(live, perm, 0).astype(np.int32)   # dead entries -> null
    q = torch.from_numpy(rng.standard_normal((B, C, H, D), np.float32))
    case = {"tables": torch.from_numpy(tables).to(DEV),
            "kv_lens": torch.from_numpy(kv_lens).to(DEV),
            "q": q.to(DEV).to(q_dtype), "k_scale": None, "v_scale": None}
    if q_starts is not None:
        case["q_starts"] = torch.from_numpy(
            np.asarray(q_starts, np.int32)).to(DEV)
    k, v = k.to(DEV), v.to(DEV)
    if isinstance(pool, str):
        dt = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}[pool]
        case["k"], case["k_scale"] = quantize(k, dt)
        case["v"], case["v_scale"] = quantize(v, dt)
    else:
        case["k"], case["v"] = k.to(pool), v.to(pool)
    return case


def run_pair(case, *, window=0, prefill=False, repeat=False):
    """(kernel out, visits, plain out) for one case, synchronised; with
    ``repeat`` the kernel runs twice and must give the same bits."""
    kw = dict(window=window, k_scale=case["k_scale"], v_scale=case["v_scale"])
    if prefill:
        args = (case["q"], case["k"], case["v"], case["tables"],
                case["q_starts"], case["kv_lens"])
        fn = paged_prefill_attention
    else:
        args = (case["q"][:, 0], case["k"], case["v"], case["tables"],
                case["kv_lens"])
        fn = paged_attention
    out, visits = fn(*args, return_visits=True, **kw)
    torch.cuda.synchronize()
    if repeat:
        again, visits2 = fn(*args, return_visits=True, **kw)
        torch.cuda.synchronize()
        def bits(t):
            return t.view(torch.int16 if t.element_size() == 2
                          else torch.int32)
        if not (torch.equal(bits(out), bits(again))
                and torch.equal(visits, visits2)):
            raise AssertionError("two calls on the same inputs differ")
    ref = fn(*args, use_kernel=False, **kw)
    torch.cuda.synchronize()
    return out, visits, ref


def check_case(name, case, *, window=0, prefill=False, valid=None):
    """Compare on the rows that stand for real tokens; demand finite values
    everywhere (padded rows and idle sequences flow on through the model)."""
    out, visits, ref = run_pair(case, window=window, prefill=prefill,
                                repeat=True)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: kernel produced non-finite values")
    B = out.shape[0]
    if prefill:
        C = out.shape[1]
        rows = torch.arange(C, device=DEV)[None, :] < torch.as_tensor(
            valid, device=DEV)[:, None]                      # (B, C)
        q_starts = case["q_starts"]
    else:
        rows = case["kv_lens"] > 0                           # (B,)
        q_starts = case["kv_lens"] - 1
    err = (out.float() - ref.float()).abs()
    if rows.any():
        err, ref = err[rows], ref[rows]
    else:
        err, ref = err.new_zeros(1), ref.new_zeros(1)
    max_err = float(err.max())
    over = excess_over_tol(err, ref)
    want = expected_visits(q_starts.cpu(), case["kv_lens"].cpu(),
                           case["tables"].shape[1], case["k"].shape[1],
                           window)
    KH = case["k"].shape[2]
    if not torch.equal(visits.cpu(), want[:, None].expand(B, KH)):
        raise AssertionError(f"{name}: visit counts differ from the "
                             f"liveness predicate")
    status = "ok" if over <= 0 else "FAIL"
    q = case["q"] if prefill else case["q"][:, :1]
    B_, C_, H_, D_ = q.shape
    P_, bs_, KH_, DV_ = case["v"].shape
    pl = k1_plan(B_, C_, H_, KH_, D_, DV_, bs_, case["tables"].shape[1],
                 q.dtype, case["k"].dtype, k1_sm_count(q.device))
    print(f"  {name:40s} [{k1_plan_text(pl)}] max_abs_err {max_err:.3e} "
          f"(tol {tol_text(out.dtype)}) visits {int(visits.sum())} "
          f"bitwise repeat {status}", flush=True)
    if over > 0:
        raise AssertionError(f"{name}: error exceeds {tol_text(out.dtype)} "
                             f"by {over} (max abs err {max_err})")
    return max_err


def k1_plan_text(pl) -> str:
    if pl.splits:
        return f"{pl.instance} DV{pl.dv_tile} x{pl.splits}"
    if pl.instance == "wgmma":
        return f"wgmma DV{pl.dv_tile} wg{pl.warpgroups}"
    return f"cuda_core DV{pl.dv_tile}"


def ragged(rng, B, lo, hi):
    return rng.integers(lo, hi + 1, size=B).astype(np.int32)


def phase_kernel_checks(rng, seed: int) -> float:
    print("phase 3: paged-attention kernel vs plain PyTorch version", flush=True)
    tl = dict(B=32, H=32, KH=4, D=64, DV=64, bs=16, NB=128)
    worst = 0.0
    lens = ragged(rng, 32, 1, 2048)
    lens[0], lens[1], lens[2] = 2048, 1, 17
    for dt in (torch.bfloat16, torch.float32):
        c = make_case(rng, C=1, q_dtype=dt, pool=dt, kv_lens=lens, **tl)
        worst = max(worst, check_case(f"decode {dt}".replace("torch.", ""), c))
    for pool in ("int8", "fp8_e4m3"):
        c = make_case(rng, C=1, q_dtype=torch.bfloat16, pool=pool,
                      kv_lens=lens, **tl)
        worst = max(worst, check_case(f"decode bf16 q, {pool} pool", c))
    c = make_case(rng, C=1, q_dtype=torch.float32, pool=torch.float32,
                  kv_lens=lens, **tl)
    worst = max(worst, check_case("decode f32 window 100", c, window=100))
    c = make_case(rng, C=1, q_dtype=torch.float32, pool=torch.bfloat16,
                  kv_lens=lens, poison_null=True, **tl)
    worst = max(worst, check_case("decode f32 q, bf16 pool, null=1e4", c))
    idle = lens.copy()
    idle[3:9] = 0
    c = make_case(rng, C=1, q_dtype=torch.bfloat16, pool=torch.bfloat16,
                  kv_lens=idle, poison_null=True, **tl)
    worst = max(worst, check_case("decode bf16 idle rows (kv_len 0)", c))

    # prefill: C = 32, ragged valid with 0 and a partial last chunk
    starts = (ragged(rng, 32, 0, 60) * 16).astype(np.int32)
    valid = ragged(rng, 32, 1, 32)
    valid[0], valid[1], valid[2], starts[2] = 0, 32, 7, 0
    starts[0] = 0                      # a wholly idle row: kv_len 0
    valid[3], starts[3] = 0, 320       # no new tokens over a live history
    for dt in (torch.bfloat16, torch.float32):
        c = make_case(rng, C=32, q_dtype=dt, pool=dt, kv_lens=starts + valid,
                      q_starts=starts, **tl)
        worst = max(worst, check_case(
            f"prefill C=32 {dt}".replace("torch.", ""), c, prefill=True,
            valid=valid))
    c = make_case(rng, C=32, q_dtype=torch.float32, pool=torch.float32,
                  kv_lens=starts + valid, q_starts=starts,
                  poison_null=True, **tl)
    worst = max(worst, check_case("prefill C=32 f32 window 48, null=1e4", c,
                                  prefill=True, valid=valid, window=48))
    c = make_case(rng, C=32, q_dtype=torch.bfloat16, pool="int8",
                  kv_lens=starts + valid, q_starts=starts, **tl)
    worst = max(worst, check_case("prefill C=32 bf16 q, int8 pool", c,
                                  prefill=True, valid=valid))
    # main-path prefill shape: C = 128 over a longer history
    starts128 = (ragged(rng, 32, 0, 7) * 128).astype(np.int32)
    valid128 = ragged(rng, 32, 0, 128)
    valid128[0] = 128
    for dt in (torch.bfloat16, torch.float32):
        c = make_case(rng, C=128, q_dtype=dt, pool=dt,
                      kv_lens=starts128 + valid128, q_starts=starts128,
                      **dict(tl, NB=80))
        worst = max(worst, check_case(
            f"prefill C=128 NB=80 {dt}".replace("torch.", ""), c,
            prefill=True, valid=valid128))

    # a pruned-looking shape: odd head dims, DV != D, G = 3, tiny blocks
    pr = dict(B=5, H=6, KH=2, D=48, DV=40, bs=4, NB=40)
    plen = ragged(rng, 5, 1, 160)
    for pool in (torch.float32, "int8", "fp8_e4m3"):
        c = make_case(rng, C=1, q_dtype=torch.float32, pool=pool,
                      kv_lens=plen, **pr)
        worst = max(worst, check_case(f"pruned decode D=48 DV=40 {pool}"
                                      .replace("torch.", ""), c))
    pst = ragged(rng, 5, 0, 100)
    pva = ragged(rng, 5, 0, 9)
    c = make_case(rng, C=9, q_dtype=torch.float32, pool=torch.float32,
                  kv_lens=pst + pva, q_starts=pst, **pr)
    worst = max(worst, check_case("pruned prefill C=9 window 10", c,
                                  prefill=True, valid=pva, window=10))
    # reduced-config shape and the widest head the kernel takes
    c = make_case(rng, B=3, C=1, H=4, KH=1, D=16, DV=16, bs=4, NB=16,
                  q_dtype=torch.float32, pool=torch.float32,
                  kv_lens=[1, 33, 64])
    worst = max(worst, check_case("reduced decode D=16 KH=1", c))
    c = make_case(rng, B=2, C=3, H=2, KH=1, D=256, DV=200, bs=8, NB=16,
                  q_dtype=torch.bfloat16, pool=torch.bfloat16,
                  kv_lens=[40, 128], q_starts=[37, 125])
    worst = max(worst, check_case("wide prefill D=256 DV=200", c,
                                  prefill=True, valid=[3, 3]))

    # shapes that reach every instance of the Hopper design: tensor-core
    # prefill with C*G off the 64-row grid, narrow pools under a window,
    # small blocks, wide heads, pruned widths; split-KV decode of one long
    # sequence beside kv_len 0 and 1 rows.  Their inputs come from a
    # generator of their own, so the later phases draw what they drew
    # before these shapes were added.
    rng = np.random.default_rng([seed, 3])
    for C_ in (9, 13):
        st = (ragged(rng, 32, 0, 60) * 16).astype(np.int32)
        va = ragged(rng, 32, 0, C_)
        va[0], st[0] = 0, 0
        c = make_case(rng, C=C_, q_dtype=torch.bfloat16, pool=torch.bfloat16,
                      kv_lens=st + va, q_starts=st, poison_null=True, **tl)
        worst = max(worst, check_case(f"prefill C={C_} bf16 null=1e4", c,
                                      prefill=True, valid=va))
    for pool, win in (("int8", 48), ("fp8_e4m3", 100)):
        c = make_case(rng, C=32, q_dtype=torch.bfloat16, pool=pool,
                      kv_lens=starts + valid, q_starts=starts,
                      poison_null=True, **tl)
        worst = max(worst, check_case(f"prefill C=32 {pool} window {win}", c,
                                      prefill=True, valid=valid, window=win))
    c = make_case(rng, C=32, q_dtype=torch.bfloat16, pool="fp8_e4m3",
                  kv_lens=starts + valid, q_starts=starts, **tl)
    worst = max(worst, check_case("prefill C=32 bf16 q, fp8 pool", c,
                                  prefill=True, valid=valid))
    for bs_, NB_ in ((4, 256), (8, 128)):
        for pool in (torch.bfloat16, "int8"):
            c = make_case(rng, C=32, q_dtype=torch.bfloat16, pool=pool,
                          kv_lens=starts + valid, q_starts=starts,
                          **dict(tl, bs=bs_, NB=NB_))
            worst = max(worst, check_case(
                f"prefill C=32 bs={bs_} {pool}".replace("torch.", ""), c,
                prefill=True, valid=valid))
        c = make_case(rng, C=1, q_dtype=torch.bfloat16, pool=torch.bfloat16,
                      kv_lens=np.minimum(lens, NB_ * bs_),
                      **dict(tl, bs=bs_, NB=NB_))
        worst = max(worst, check_case(f"decode bs={bs_} bf16", c))
    for pool in (torch.bfloat16, "int8", "fp8_e4m3"):
        c = make_case(rng, C=9, q_dtype=torch.bfloat16, pool=pool,
                      kv_lens=pst + pva, q_starts=pst, **pr)
        worst = max(worst, check_case(
            f"pruned prefill C=9 bf16 {pool} window 10"
            .replace("torch.", ""), c, prefill=True, valid=pva, window=10))
    c = make_case(rng, B=2, C=40, H=2, KH=1, D=256, DV=200, bs=8, NB=24,
                  q_dtype=torch.bfloat16, pool=torch.bfloat16,
                  kv_lens=[80, 190], q_starts=[40, 150])
    worst = max(worst, check_case("wide prefill C=40 D=256 DV=200", c,
                                  prefill=True, valid=[40, 40]))
    c = make_case(rng, B=2, C=40, H=2, KH=1, D=256, DV=200, bs=8, NB=24,
                  q_dtype=torch.bfloat16, pool="int8",
                  kv_lens=[80, 190], q_starts=[40, 150])
    worst = max(worst, check_case("wide prefill C=40 D=256 DV=200 int8", c,
                                  prefill=True, valid=[40, 40]))
    for dt, pool in ((torch.bfloat16, torch.bfloat16),
                     (torch.bfloat16, "int8"), (torch.float32,
                                                torch.float32)):
        c = make_case(rng, B=3, C=1, H=32, KH=4, D=64, DV=64, bs=16, NB=128,
                      q_dtype=dt, pool=pool, kv_lens=[2048, 0, 1],
                      poison_null=True)
        worst = max(worst, check_case(
            f"decode 2048 | 0 | 1 {dt} q, {pool} pool"
            .replace("torch.", ""), c))
    c = make_case(rng, B=3, C=1, H=32, KH=4, D=64, DV=64, bs=16, NB=128,
                  q_dtype=torch.bfloat16, pool=torch.bfloat16,
                  kv_lens=[2048, 0, 1])
    worst = max(worst, check_case("decode 2048 | 0 | 1 bf16 window 300", c,
                                  window=300))

    # Hymba-1.5B's shapes (phase 12): G = 5 (25 query heads over 5 KV heads
    # of 64), its window of 1024 over histories up to 2048 (decode splits
    # that lie wholly below the window add nothing; prefill chunks start on
    # both sides of it), its global layers (window 0), and the heads that
    # pruning at 0.5 leaves (15 over 3, DV 32).  Own generator, as above.
    rng = np.random.default_rng([seed, 12])
    bf16, f32 = torch.bfloat16, torch.float32
    for tag, hy in (("hymba", dict(B=16, H=25, KH=5, D=64, DV=64, bs=16,
                                    NB=128)),
                    ("hymba pruned", dict(B=16, H=15, KH=3, D=64, DV=32,
                                          bs=16, NB=128))):
        hl = ragged(rng, 16, 1, 2048)
        hl[:4] = (2048, 1025, 1024, 1)
        hst = np.asarray([0, 128, 512, 896, 1024, 1040, 1152, 1280, 1536,
                          1664, 1792, 1900, 1920, 0, 256, 640], np.int32)
        hva = ragged(rng, 16, 1, 128)
        hva[0], hva[13] = 128, 0                  # a full chunk, an idle row
        runs = [(bf16, 1024, False), (bf16, 1024, True)]
        if tag == "hymba":
            runs += [(f32, 1024, False), (f32, 1024, True), (bf16, 0, False),
                     (bf16, 0, True)]
        for dt, win, pre in runs:
            c = make_case(rng, C=128 if pre else 1, q_dtype=dt, pool=dt,
                          kv_lens=hst + hva if pre else hl,
                          q_starts=hst if pre else None, **hy)
            worst = max(worst, check_case(
                f"{tag} {'prefill C=128' if pre else 'decode'} "
                f"{str(dt)[6:]} window {win}", c, window=win, prefill=pre,
                valid=hva if pre else None))

    # qwen2-moe-a2.7b's shapes (phase 13): 16 heads over 16 KV heads of
    # 128 (G = 1, so every decode row is one row of the split-KV instance
    # and a prefill chunk of 128 fills two warpgroups), histories up to 512
    # in 32 blocks of 16, the float32 twin (CUDA cores), and the heads that
    # pruning at 0.5 leaves (8 over 8, DV 64).  Own generator, as above.
    rng = np.random.default_rng([seed, 13])
    for tag, mo in (("qwen2-moe", dict(B=16, H=16, KH=16, D=128, DV=128,
                                       bs=16, NB=32)),
                    ("qwen2-moe pruned", dict(B=16, H=8, KH=8, D=128, DV=64,
                                              bs=16, NB=32))):
        ml = ragged(rng, 16, 1, 512)
        ml[:3] = (512, 1, 129)
        mst = (ragged(rng, 16, 0, 3) * 128).astype(np.int32)
        mva = ragged(rng, 16, 1, 128)
        mva[0], mva[5], mst[5] = 128, 0, 0        # a full chunk, an idle row
        dts = (bf16, f32) if tag == "qwen2-moe" else (bf16,)
        for dt in dts:
            for pre in (False, True):
                c = make_case(rng, C=128 if pre else 1, q_dtype=dt, pool=dt,
                              kv_lens=mst + mva if pre else ml,
                              q_starts=mst if pre else None, **mo)
                worst = max(worst, check_case(
                    f"{tag} {'prefill C=128' if pre else 'decode'} "
                    f"{str(dt)[6:]}", c, prefill=pre,
                    valid=mva if pre else None))

    # speculative verify (phase 11b): the prefill entry at C = K, each row's
    # history ending anywhere — q_starts off the 16-row grid and off the
    # block, so the causal diagonal cuts through a block — beside a wholly
    # idle row (start 0, valid 0, as the engine sends an inactive slot) and
    # a live history with no new rows; the null block poisoned.  C 2 and 4
    # at G 8 over bf16 and int8 pools, C 4 at G 1 (qwen2-moe's heads: the
    # split-KV instance with q_starts), C 1 through the prefill entry; then
    # the pruned draft's shapes (16 heads over 2 KV heads, DV 32): its
    # decode over bf16 and int8 pools and its C 128 prefill over int8.  Own
    # generator, as above.
    rng = np.random.default_rng([seed, 3, 2])

    def verify_rows(B, C, hi):
        st = ragged(rng, B, 1, hi)
        st[:4] = (17, 33, 255, 1)
        st[st % 16 == 0] += 3            # no start on the 16-row grid
        va = ragged(rng, B, 1, C)
        va[0] = C
        st[4], va[4] = 0, 0              # a wholly idle row
        st[5], va[5] = 301, 0            # a live history, no new rows
        return st.astype(np.int32), va.astype(np.int32)

    vt = dict(B=16, H=32, KH=4, D=64, DV=64, bs=16, NB=32)
    vm = dict(B=16, H=16, KH=16, D=128, DV=128, bs=16, NB=32)
    for C_, pool, shp, tag in ((2, torch.bfloat16, vt, "G=8"),
                               (4, torch.bfloat16, vt, "G=8"),
                               (2, "int8", vt, "G=8"), (4, "int8", vt, "G=8"),
                               (4, torch.bfloat16, vm, "G=1 D=128"),
                               (1, torch.bfloat16, vt, "G=8")):
        st, va = verify_rows(shp["B"], C_, 500)
        c = make_case(rng, C=C_, q_dtype=torch.bfloat16, pool=pool,
                      kv_lens=st + va, q_starts=st, poison_null=True, **shp)
        worst = max(worst, check_case(
            f"verify C={C_} {tag} {pool}".replace("torch.", ""), c,
            prefill=True, valid=va))
    dr = dict(B=16, H=16, KH=2, D=64, DV=32, bs=16, NB=32)
    dl = ragged(rng, 16, 1, 500)
    dl[:3] = (512, 1, 0)
    for pool in (torch.bfloat16, "int8"):
        c = make_case(rng, C=1, q_dtype=torch.bfloat16, pool=pool,
                      kv_lens=dl, poison_null=True, **dr)
        worst = max(worst, check_case(
            f"draft decode H=16 KH=2 DV=32 {pool}".replace("torch.", ""), c))
    st = (ragged(rng, 16, 0, 2) * 128).astype(np.int32)
    va = ragged(rng, 16, 0, 128)
    va[0] = 128
    c = make_case(rng, C=128, q_dtype=torch.bfloat16, pool="int8",
                  kv_lens=st + va, q_starts=st, poison_null=True, **dr)
    worst = max(worst, check_case("draft prefill C=128 DV=32 int8", c,
                                  prefill=True, valid=va))
    return worst


def gathered_history(case, n_rep):
    """Contiguous (B, H, S, D) K/V and a boolean mask for the library call
    (gathered outside the timed region: the call is a yardstick only)."""
    tab = case["tables"].long()
    B, NB = tab.shape
    bs, KH = case["k"].shape[1], case["k"].shape[2]
    k = case["k"][tab].reshape(B, NB * bs, KH, -1).permute(0, 2, 1, 3)
    v = case["v"][tab].reshape(B, NB * bs, KH, -1).permute(0, 2, 1, 3)
    k = k.repeat_interleave(n_rep, dim=1).contiguous()
    v = v.repeat_interleave(n_rep, dim=1).contiguous()
    return k, v


def attention_work(case, *, prefill: bool):
    """(bytes that must cross HBM, floating-point operations) for one call,
    from this run's lengths: every live K/V row (and scale) read once, q read
    once, out written once, the live table entries and lengths read once."""
    q = case["q"]
    B, C, H, D = q.shape
    bs, KH, DV = case["v"].shape[1:]
    NB = case["tables"].shape[1]
    lens = case["kv_lens"].cpu().numpy().astype(np.int64)
    lens = np.minimum(lens, NB * bs)
    esz = case["k"].element_size()
    kv_bytes = int(lens.sum()) * KH * (D + DV) * esz
    if case["k_scale"] is not None:
        kv_bytes += int(lens.sum()) * KH * 2 * 4
    tbl_bytes = int(np.ceil(lens / bs).sum()) * 4 + B * 8
    io_bytes = B * C * H * (D + DV) * q.element_size()
    if prefill:
        starts = case["q_starts"].cpu().numpy().astype(np.int64)
        qpos = starts[:, None] + np.arange(C)[None, :]
        keys = np.minimum(qpos + 1, lens[:, None]).clip(min=0).sum()
    else:
        keys = lens.sum()
    flops = 2 * int(keys) * H * (D + DV)
    return kv_bytes + tbl_bytes + io_bytes, flops


# K1's timed shapes: TinyLlama's (phase 4) and qwen2-moe-a2.7b's (phase 13:
# 16 heads of 128, G = 1, 16 slots of histories up to 512)
K1_TIMED = dict(B=32, H=32, KH=4, D=64, bs=16, decode_lens=(256, 1088),
                chunks=(2, 7))
K1_TIMED_MOE = dict(B=16, H=16, KH=16, D=128, bs=16, decode_lens=(64, 512),
                    chunks=(0, 3))
# the speculative verify (phase 11b): C = K = 4 rows a sequence after
# histories of phase 11b's prompts and outputs, 192-383 tokens, anywhere
K1_TIMED_VERIFY = dict(B=16, H=32, KH=4, D=64, bs=16, starts=(192, 383))


def time_kernel(name, rng, *, C, NB, prefill, iters, rounds=6,
                shape=K1_TIMED):
    """K1, its plain version and one ``scaled_dot_product_attention`` call on
    the gathered history (gathered outside the timed region: a yardstick
    only) at a path's ``shape``, rotating over distinct pools so that each
    call finds the L2 cold, as a layer of the model does.  K1 and SDPA take
    turns over ``rounds`` rounds, each timed by the profiler's device time
    per call (K1: its kernels added up, the decode instance's splits and
    combine alike; SDPA: every kernel of the call) and by CUDA events, the
    SM clock, power and temperature read around each round; plain, then
    the rounds, then plain."""
    B, H, KH, D, bs = (shape[k] for k in ("B", "H", "KH", "D", "bs"))
    dt = torch.bfloat16
    if prefill:
        starts = (ragged(rng, B, *shape["starts"]) if "starts" in shape
                  else ragged(rng, B, *shape["chunks"]) * 128
                  ).astype(np.int32)
        valid = np.full(B, C, np.int32)
        lens = starts + valid
    else:
        starts = None
        lens = ragged(rng, B, *shape["decode_lens"])
    n_rot = 4
    cases = [make_case(rng, B=B, C=C, H=H, KH=KH, D=D, DV=D, bs=bs, NB=NB,
                       q_dtype=dt, pool=dt, kv_lens=lens, q_starts=starts)
             for _ in range(n_rot)]

    def call(use_kernel):
        def fn(i):
            c = cases[i % n_rot]
            if prefill:
                paged_prefill_attention(c["q"], c["k"], c["v"], c["tables"],
                                        c["q_starts"], c["kv_lens"],
                                        use_kernel=use_kernel)
            else:
                paged_attention(c["q"][:, 0], c["k"], c["v"], c["tables"],
                                c["kv_lens"], use_kernel=use_kernel)
        return fn

    # library yardsticks, one scaled_dot_product_attention call each per
    # rotation: "lib" on the whole table's history repeated to all H heads
    # (it reads G times K1's K/V bytes); "gqa" on the KH heads with
    # enable_gqa and the keys cut to the batch's longest live length; "fold"
    # on the KH heads with the G heads folded into the query rows (r = c*G
    # + g, as K1 takes them) and the keys cut alike — no K/V row repeated
    G = H // KH
    lib, gqa, fold = [], [], []
    for c in cases:
        k, v = gathered_history(c, G)
        S = k.shape[2]
        idx = torch.arange(S, device=DEV)[None, None, :]
        if prefill:
            qpos = (c["q_starts"][:, None] + torch.arange(C, device=DEV)
                    )[:, :, None]
            mask = (idx <= qpos) & (idx < c["kv_lens"][:, None, None])
        else:
            mask = (idx < c["kv_lens"][:, None, None])
        qh = c["q"].permute(0, 2, 1, 3).contiguous()
        lib.append((qh, k, v, mask[:, None].contiguous(), {}))
        live = int(c["kv_lens"].max())
        k, v = gathered_history(c, 1)
        k, v = k[:, :, :live].contiguous(), v[:, :, :live].contiguous()
        mask = mask[:, None, :, :live].contiguous()
        gqa.append((qh, k, v, mask, {"enable_gqa": True}))
        qf = c["q"].reshape(B, C, KH, G, D).permute(0, 2, 1, 3, 4).reshape(
            B, KH, C * G, D).contiguous()
        fold.append((qf, k, v, mask.repeat_interleave(G, dim=2), {}))

    def sdpa(tensors):
        def fn(i):
            q, k, v, mask, kw = tensors[i % n_rot]
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  **kw)
        return fn

    lib_fn, gqa_fn, fold_fn = sdpa(lib), sdpa(gqa), sdpa(fold)

    out, _, ref = run_pair(cases[0], prefill=prefill)
    err = (out.float() - ref.float()).abs()
    max_err = float(err.max())
    if excess_over_tol(err, ref) > 0:
        raise AssertionError(f"{name}: max abs err {max_err} exceeds "
                             f"{tol_text(dt)}")
    # the yardsticks compute K1's function: their distance from the plain
    # version on rotation 0, in (B, C, H, DV)
    yard_diff = {
        "library": lib_fn(0).permute(0, 2, 1, 3),
        "library_gqa": gqa_fn(0).permute(0, 2, 1, 3),
        "library_fold": fold_fn(0).reshape(B, KH, C, G, D).permute(
            0, 2, 1, 3, 4).reshape(B, C, H, D)}
    yard_diff = {n: float((y.float() - ref.reshape(B, C, H, D).float()
                           ).abs().max()) for n, y in yard_diff.items()}
    kern, plain = call(True), call(False)
    plain_a = time_ms(plain, iters=max(iters // 4, 3))
    rounds_ = []
    for _ in range(rounds):
        before = gpu_clocks()
        kp = device_profile(kern, iters, "paged_attention")
        lp = device_profile(lib_fn, iters)
        gp = device_profile(gqa_fn, iters)
        fp = device_profile(fold_fn, iters)
        rounds_.append({
            "k1_device_ms": None if kp is None else kp["ms"],
            "k1_kernels_per_call": None if kp is None
            else kp["kernels_per_call"],
            "k1_events_per_call": None if kp is None
            else kp["events_per_call"],
            "library_device_ms": None if lp is None else lp["ms"],
            "library_gqa_device_ms": None if gp is None else gp["ms"],
            "library_fold_device_ms": None if fp is None else fp["ms"],
            "k1_event_ms": time_ms(kern, iters=iters),
            "library_event_ms": time_ms(lib_fn, iters=iters),
            "before": before, "after": gpu_clocks()})
    plain_b = time_ms(plain, iters=max(iters // 4, 3))
    measured = all(x["k1_device_ms"] is not None
                   and x["library_device_ms"] is not None for x in rounds_)
    key_k, key_l = (("k1_device_ms", "library_device_ms") if measured
                    else ("k1_event_ms", "library_event_ms"))
    k_ms = [x[key_k] for x in rounds_]
    l_ms = [x[key_l] for x in rounds_]
    kern_ms, lib_ms = float(np.median(k_ms)), float(np.median(l_ms))

    def median_of(key):
        xs = [x[key] for x in rounds_]
        return None if None in xs else float(np.median(xs))
    nbytes, flops = attention_work(cases[0], prefill=prefill)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dt] * 1e3
    bound = max(t_bytes, t_flops)
    q0 = cases[0]["q"]
    pl = k1_plan(B, C, H, KH, D, D, bs, NB, dt, dt, k1_sm_count(q0.device))
    entry = {
        "name": name, "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": 0, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": (plain_a + plain_b) / 2,
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": lib_ms,
        "library_gqa_ms": median_of("library_gqa_device_ms"),
        "library_fold_ms": median_of("library_fold_device_ms"),
        "yardstick_max_abs_diff": yard_diff,
        "timing": ("profiler device time per call, median of rounds"
                   if measured else "CUDA events (device time not "
                   "measured), median of rounds"),
        "instance": k1_plan_text(pl), "share_of_bound": bound / kern_ms,
        "event_ms": float(np.median([x["k1_event_ms"] for x in rounds_])),
        "library_event_ms": float(np.median([x["library_event_ms"]
                                             for x in rounds_])),
        "shape": {"B": B, "C": C, "H": H, "KH": KH, "D": D, "bs": bs,
                  "NB": NB, "dtype": "bfloat16",
                  "mean_kv_len": float(np.mean(lens))},
        "bytes": nbytes, "flops": flops, "rounds": rounds_,
    }
    print(f"  {name} [{entry['instance']}], {rounds} alternating rounds of "
          f"{iters} calls:", flush=True)
    for i, x in enumerate(rounds_):
        b_, a_ = x["before"], x["after"]
        dk = ("not measured" if x["k1_device_ms"] is None
              else f"{x['k1_device_ms']:.4f}")
        dl, dg, df = ("not measured" if x[k] is None else f"{x[k]:.4f}"
                      for k in ("library_device_ms", "library_gqa_device_ms",
                                "library_fold_device_ms"))
        print(f"    round {i}: device K1 {dk} ms | SDPA {dl} ms, GQA {dg} "
              f"ms, folded {df} ms; events K1 "
              f"{x['k1_event_ms']:.4f} | SDPA {x['library_event_ms']:.4f} "
              f"ms | SM clock {b_['sm_mhz']:.0f} -> {a_['sm_mhz']:.0f} MHz "
              f"(max {b_['max_sm_mhz']:.0f}), power {b_['power_w']:.0f} -> "
              f"{a_['power_w']:.0f} W, {b_['temp_c']:.0f} -> "
              f"{a_['temp_c']:.0f} C", flush=True)
    print(f"  {name}: K1 {spread(k_ms)} | SDPA {spread(l_ms)} "
          f"({entry['timing']}) | plain {entry['plain_ms']:.4f} ms | bound "
          f"{bound:.5f} ms ({entry['bound_by']}: {nbytes / 1e6:.2f} MB at "
          f"3.35 TB/s = {t_bytes:.5f} ms; {flops / 1e9:.3f} GFLOP at 989 "
          f"TFLOP/s = {t_flops:.5f} ms) -> {100 * entry['share_of_bound']:.1f}"
          f" % of bound | max abs err {max_err:.2e}", flush=True)
    print(f"  {name}: SDPA on the KH heads, keys cut to the longest live "
          f"length: GQA {entry['library_gqa_ms']} ms, folded "
          f"{entry['library_fold_ms']} ms (device, median of rounds); "
          f"yardsticks' max abs diff from plain {yard_diff}", flush=True)
    del cases, lib, gqa, fold
    torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------

def make_requests(rng, vocab, n, gen, lo, hi, prefix_len):
    """A third of the requests share a ``prefix_len``-token prefix; the last
    two of them are exactly the prefix, so they arrive when its blocks are
    cached, alias every one and must copy the last on write.  The rest are
    independent."""
    prefix = rng.integers(0, vocab, size=prefix_len).tolist()
    reqs = []
    for i in range(n):
        length = int(rng.integers(lo, hi + 1))
        if i % 3 == 0:
            if i >= n - 6:
                tail = []
            else:
                tail = rng.integers(0, vocab,
                                    size=max(length - prefix_len, 1)).tolist()
            prompt = prefix + tail
        else:
            prompt = rng.integers(0, vocab, size=length).tolist()
        reqs.append({"prompt": prompt, "max_new_tokens": gen})
    return reqs


def teacher_forced_gap(model, params, rec) -> tuple[float, float]:
    """Feed prompt + output through ``Model.forward`` and return (the largest
    amount by which an emitted token's reference logit falls short of the
    reference maximum at its position, the share of emitted tokens that are
    the reference argmax)."""
    seq = list(rec.prompt) + list(rec.tokens)
    toks = torch.tensor([seq], dtype=torch.int32, device=DEV)
    with torch.no_grad():
        logits = model.forward(params, {"tokens": toks})[0].float()
    return forced_gap(logits, rec)


def forced_gap(logits, rec) -> tuple[float, float]:
    """``teacher_forced_gap`` on the logits (S, V) of prompt + output."""
    P = len(rec.prompt)
    at = logits[P - 1:P - 1 + len(rec.tokens)]
    emitted = torch.tensor(rec.tokens, device=DEV)
    got = at.gather(1, emitted[:, None])[:, 0]
    gap = at.max(dim=1).values - got
    return float(gap.max()), float((at.argmax(1) == emitted).float().mean())


def steps_vs_plain(model, params, scfg, rng, tol) -> float:
    """The model's paged steps on the kernel and on the plain version, fed
    the same tokens, positions and tables as an engine would feed them:
    ragged prompts stream in as chunks (rows whose prompt has ended, and one
    slot that never holds a request, ride along idle on a zeroed table row),
    then every live slot takes one decode step.  Each side writes its own
    pools.  Returns the largest logit difference on the rows that were fed.
    """
    B, C, NB = scfg.max_seqs, scfg.chunk_size, scfg.blocks_per_seq
    V = model.cfg.vocab_size
    plain = build(model.cfg.replace(use_kernels=False))
    lens = rng.integers(C + 2, 3 * C + C // 2, size=B)
    lens[0], lens[1], lens[min(3, B - 1)] = 3 * C, 2 * C + 1, 0
    n_chunks = -(-int(lens.max()) // C)
    toks = rng.integers(0, V, size=(B, (n_chunks + 1) * C)).astype(np.int32)
    own = (1 + np.arange(B * NB, dtype=np.int32)).reshape(B, NB)
    slots = torch.arange(B, dtype=torch.int32, device=DEV)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(DEV)

    worst = 0.0
    with torch.no_grad():
        ca, cb = (m.init_paged_cache(scfg.pool_blocks(), scfg.block_size, B)
                  for m in (model, plain))
        for start in range(0, n_chunks * C, C):
            valid = np.clip(lens - start, 0, C)
            fed = valid > 0
            chunk = np.where(np.arange(C)[None] < valid[:, None],
                             toks[:, start:start + C], 0)
            pos = np.where(fed[:, None], start + np.arange(C)[None], 0)
            args = (dev(chunk), dev(pos), slots,
                    dev(np.where(fed[:, None], own, 0)), dev(valid))
            la, ca = model.paged_prefill_step(params, ca, *args)
            lb, cb = plain.paged_prefill_step(params, cb, *args)
            rows = torch.from_numpy(fed).to(DEV)
            worst = max(worst, float((la.float() - lb.float())[rows]
                                     .abs().max()))
        live = lens > 0
        args = (dev(np.where(live, toks[np.arange(B), lens], 0)),
                dev(np.where(live, lens, 0)),
                dev(np.where(live[:, None], own, 0)))
        la, ca = model.paged_decode_step(params, ca, *args)
        lb, cb = plain.paged_decode_step(params, cb, *args)
        rows = torch.from_numpy(live).to(DEV)
        worst = max(worst, float((la.float() - lb.float())[rows].abs().max()))
        if not (torch.isfinite(la.float()).all()
                and torch.isfinite(lb.float()).all()):
            raise AssertionError("non-finite logits on an idle row")
    torch.cuda.synchronize()
    if worst > tol:
        raise AssertionError(f"kernel vs plain step logits differ by "
                             f"{worst} > {tol}")
    del ca, cb
    torch.cuda.empty_cache()
    return worst


def count_sampling_steps(engine) -> list[int]:
    """Wrap the engine's scheduler so that every planned step that samples a
    token is counted: one with a decode row, or with a prefill chunk that
    reaches the end of its prompt.  Those are the steps that owe the host a
    fetch, one each.  Returns a one-element list that holds the count."""
    count = [0]
    plan_step = engine.scheduler.plan_step

    def counted(*args, **kw):
        plan = plan_step(*args, **kw)
        if plan.decode or any(s.num_cached + n == s.seq_len
                              for s, n in plan.prefill):
            count[0] += 1
        return plan

    engine.scheduler.plan_step = counted
    return count


def phase_main_path(rng, quick: bool, profile: bool = False,
                    seed: int = 0) -> dict:
    print("phase 4: main path — tinyllama-1.1b through repro_torch.serve."
          "Engine", flush=True)
    cfg = get_config("tinyllama-1.1b")
    if quick:
        cfg = cfg.replace(num_layers=4)
    n_req, gen = (12, 16) if quick else (48, 64)
    model = build(cfg)
    t0 = time.time()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    print(f"  model: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"H={cfg.n_heads} KH={cfg.n_kv_heads} hd={cfg.head_dim_} "
          f"ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}; init "
          f"{time.time() - t0:.2f}s", flush=True)
    scfg = ServeConfig(max_seqs=8 if quick else 32, block_size=16,
                       max_len=1280, chunk_size=128)
    reqs = make_requests(rng, cfg.vocab_size, n_req, gen, 256, 1024, 512)

    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, params, scfg)
    sampling_steps = count_sampling_steps(eng)
    reset_launches()                         # counts = the main path's only
    out, stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = launch_counts()
    total_launches = launches.pop("total")
    peak = torch.cuda.max_memory_allocated()

    if len(out) != n_req or any(len(r.tokens) != gen for r in out.values()):
        raise AssertionError("not every request finished with its tokens")
    L = cfg.num_layers
    want = L * int(stats["decode_calls"] + stats["prefill_calls"])
    if total_launches != want or launches["decode"] != \
            L * int(stats["decode_calls"]):
        raise AssertionError(f"kernel launches {total_launches} "
                             f"({launches}) != layers x device calls {want}")
    if total_launches == 0:
        raise AssertionError("the main path never launched the kernel")
    # one fetch for every step that samples, and none besides: a step whose
    # prefill chunks all end before their prompts do, and that has no decode
    # row, samples nothing and owes the host nothing
    if stats["host_syncs"] != sampling_steps[0] or \
            not 0 < sampling_steps[0] <= stats["steps"]:
        raise AssertionError(f"{stats['host_syncs']:.0f} host fetches over "
                             f"{sampling_steps[0]} sampling steps of "
                             f"{stats['steps']:.0f}")
    if stats["cow_copies"] < 1 or eng.cache_host.prefix_hits < 1:
        raise AssertionError("no prefix hit / copy-on-write happened")

    # Tolerances on bf16 logits (|logit| ~ 1 at random init): 22 layers of
    # bf16 activations rounded at different places by the paged steps and
    # the full-sequence forward.
    tf_tol, plain_tol = 0.25, 0.25
    k2.reset_launches()         # K2: every teacher-forcing forward below
    gaps = [teacher_forced_gap(model, params, out[r])
            for r in sorted(out)[:: max(n_req // 6, 1)]]
    tf_gap = max(g for g, _ in gaps)
    tf_match = float(np.mean([m for _, m in gaps]))
    print(f"  teacher forcing vs Model.forward over {len(gaps)} requests: "
          f"max logit shortfall {tf_gap:.4f} (tol {tf_tol}), "
          f"argmax agreement {tf_match:.3f}", flush=True)
    if tf_gap > tf_tol:
        raise AssertionError(f"teacher-forced shortfall {tf_gap} > {tf_tol}")
    plain_gap = steps_vs_plain(model, params, scfg, rng, plain_tol)
    print(f"  model steps on kernel vs on plain version, logits of every "
          f"prefill chunk and the first decode step: max abs diff "
          f"{plain_gap:.4f} (tol {plain_tol})", flush=True)

    # a short run on int8 pools through the same engine and kernel
    reset_launches()
    q8 = Engine(model, params, dataclasses.replace(scfg, cache_dtype="int8"))
    out8, st8 = q8.run(make_requests(rng, cfg.vocab_size, 8, 16, 200, 400, 128))
    if len(out8) != 8 or any(len(r.tokens) != 16 for r in out8.values()):
        raise AssertionError("int8 run: not every request finished")
    n8 = launch_counts()["total"]
    if n8 != L * int(st8["decode_calls"] + st8["prefill_calls"]):
        raise AssertionError("int8 run: launch count mismatch")
    gap8 = max(teacher_forced_gap(model, params, out8[r])[0] for r in (0, 5))
    k2_launches = k2.launch_count()
    if k2_launches != L * (len(gaps) + 2):
        raise AssertionError(f"K2 launches {k2_launches} != {L} layers x "
                             f"{len(gaps) + 2} teacher-forcing forwards")
    print(f"  int8 pools: 8 requests x 16 tokens, {n8} launches, "
          f"teacher-forced shortfall {gap8:.4f} (tol 0.5: one more rounding "
          f"of every K/V row to 8 bits)", flush=True)
    if gap8 > 0.5:
        raise AssertionError(f"int8 teacher-forced shortfall {gap8} > 0.5")
    del q8

    res = {
        "model": cfg.name, "layers": L, "requests": n_req, "gen": gen,
        "steps": stats["steps"], "decode_calls": stats["decode_calls"],
        "prefill_calls": stats["prefill_calls"],
        "decode_tok_per_s": stats["decode_tok_per_s"],
        "total_tok_per_s": stats["total_tok_per_s"],
        "mean_ttft_s": stats["mean_ttft_s"], "wall_s": stats["wall_s"],
        "prefill_tokens": stats["prefill_tokens"],
        "decode_tokens": stats["decode_tokens"],
        "cow_copies": stats["cow_copies"],
        "prefix_hits": eng.cache_host.prefix_hits,
        "host_syncs": stats["host_syncs"],
        "sampling_steps": sampling_steps[0],
        "k1_launches": launches, "peak_mem_bytes": peak,
        "k2_launches_teacher_forcing": k2_launches,
        "teacher_forced_shortfall": tf_gap, "argmax_agreement": tf_match,
        "kernel_vs_plain_step_logits": plain_gap,
    }
    print(f"  served {n_req} requests x {gen} tokens in {stats['wall_s']:.2f}s:"
          f" decode {stats['decode_tok_per_s']:.1f} tok/s | prefill+decode "
          f"{stats['total_tok_per_s']:.1f} tok/s | mean TTFT "
          f"{stats['mean_ttft_s'] * 1e3:.1f} ms | {stats['steps']:.0f} steps "
          f"({stats['decode_calls']:.0f} decode, {stats['prefill_calls']:.0f} "
          f"prefill calls) | K1 launches {launches} | peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    res["step_ms"] = time_steps(model, params, scfg, profile)
    del eng
    torch.cuda.empty_cache()
    res["front_door"] = phase_front_door(model, params, scfg, reqs, out,
                                         seed)
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 4b: the front door and crash safety at full width
# ---------------------------------------------------------------------------

# (c) the front door's requests; (d) the chaos run's; (e) the crash run's:
# greedy and temperature-0.8 requests, crashed at step CRASH_STEP after a
# snapshot at CRASH_STEP - 1
FRONT = dict(requests=6, gen=64, lo=256, hi=512, stream_gen=16,
             deadline_s=0.3)
CHAOS = dict(requests=16, gen=32, lo=256, hi=512)
CRASH = dict(greedy=16, sampled=4, gen=32, lo=256, hi=512, step=10)
# (a)'s runs: each mode twice, alternating
FD_ORDER = ("lockstep", "async", "async", "lockstep")
# the phases printed side by side for lockstep and async
FD_PHASES = ("step", "plan", "overlap", "prefill_dispatch", "decode_dispatch",
             "sync", "fold", "audit")


def schedule_signature(engine) -> dict:
    """Per request, what decides its arithmetic besides its tokens: the
    cursor at each admission (the prefix it hit) and its prefill chunks,
    recorded by wrapping the scheduler's ``plan_step``; preemptions come
    from the records.  Returns {rid: [admission cursors, chunks]}."""
    sig: dict = {}
    plan_step = engine.scheduler.plan_step

    def recorded(*args, **kw):
        plan = plan_step(*args, **kw)
        for s in plan.admitted:
            sig.setdefault(s.req.rid, [[], 0])[0].append(s.num_cached)
        for s, _ in plan.prefill:
            sig.setdefault(s.req.rid, [[], 0])[1] += 1
        return plan

    engine.scheduler.plan_step = recorded
    return sig


def forbid_syncs(engine) -> None:
    """Run the engine's host half of a step (plan, uploads, dispatch, the
    fetch's start) under ``torch.cuda.set_sync_debug_mode("error")``: any
    synchronization there raises."""
    inner = engine._submit_step

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine._submit_step = guarded


def sync_probe() -> dict:
    """Which host<->device calls synchronize, by the same debug mode: the
    blocking copy of a pageable buffer (the engine's upload before the
    pinned staging), a pinned non-blocking copy (the engine's upload now),
    and ``torch.multinomial`` (the engine's draw at temperature > 0)."""
    flat = np.arange(4096, dtype=np.int32)
    probs = torch.softmax(torch.randn(32, 32000, device=DEV), dim=-1)
    calls = {
        "pageable blocking .to()": lambda: torch.from_numpy(flat).to(DEV),
        "pinned non_blocking .to()": lambda: torch.from_numpy(
            flat).pin_memory().to(DEV, non_blocking=True),
        "torch.multinomial": lambda: torch.multinomial(probs, 1),
    }
    out = {}
    for label, fn in calls.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            out[label] = False
        except RuntimeError:
            out[label] = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def phase_table(tel) -> dict:
    """p50 / mean ms and counts of the step phases, and the sync share."""
    hists = tel.registry.histograms
    out = {}
    for name in FD_PHASES:
        h = hists.get("phase/" + name)
        if h is not None and h.count:
            sm = h.summary()
            out[name] = {"p50_ms": sm["p50"] * 1e3, "mean_ms": sm["mean"] * 1e3,
                         "count": sm["count"]}
    step, sync = hists.get("phase/step"), hists.get("phase/sync")
    out["sync_share"] = sync.total / step.total if step and sync else 0.0
    return out


def check_tokens(label, model, params, out, ref, sig, ref_sig, tol,
                 prefix_ok=()) -> dict:
    """The rule 4b holds a run's tokens to a reference run by: a request
    whose admission cursors, chunk count and preemptions equal the
    reference's gives the same tokens exactly (a prefix of them for the
    rids in ``prefix_ok``, cut short by a fault); any other (a prefix block
    registers one step later under overlap) is held to ``tol`` by teacher
    forcing."""
    exact, forced, worst = [], [], 0.0
    for r in sorted(out):
        same = (sig.get(r), out[r].preemptions) == \
            (ref_sig.get(r), ref[r].preemptions)
        if same:
            want = ref[r].tokens[:len(out[r].tokens)] if r in prefix_ok \
                else ref[r].tokens
            if out[r].tokens != want:
                raise AssertionError(f"4b {label}: rid {r} has the reference's "
                                     f"schedule but other tokens")
            exact.append(r)
        else:
            gap = teacher_forced_gap(model, params, out[r])[0]
            worst = max(worst, gap)
            if gap > tol:
                raise AssertionError(f"4b {label}: rid {r} teacher-forced "
                                     f"shortfall {gap} > {tol}")
            forced.append(r)
    print(f"  4b {label}: {len(exact)} requests with the reference's "
          f"schedule equal token for token, {len(forced)} with another "
          f"held by teacher forcing (max shortfall {worst:.4f}, tol {tol})",
          flush=True)
    return {"exact": len(exact), "teacher_forced": len(forced),
            "max_shortfall": worst}


def random_requests(rng, vocab, n, gen, lo, hi, **kw) -> list[dict]:
    """``n`` independent random prompts (no shared prefix)."""
    return [{"prompt": rng.integers(0, vocab, size=int(rng.integers(
        lo, hi + 1))).tolist(), "max_new_tokens": gen, **kw}
        for _ in range(n)]


def no_leaks(label, engine) -> None:
    engine.cache_host.check()
    a = engine.cache_host.allocator
    if a.num_live or a.num_held:
        raise AssertionError(f"4b {label}: {a.num_live} live and "
                             f"{a.num_held} held blocks after the run")


def fd_async_vs_lockstep(model, params, scfg, reqs, lock_out) -> dict:
    """(a) and (b): phase 4's mix served lockstep and async with telemetry
    on, in the order ``FD_ORDER`` (each mode twice, alternating, so that a
    drift of the host's speed falls on both), both engines' host halves
    under the sync debug mode.  The tokens of the first run of each mode
    are compared; a mode's second run is recorded against its first."""
    L = model.cfg.num_layers
    gen = reqs[0]["max_new_tokens"]
    runs: dict[str, list] = {"lockstep": [], "async": []}
    for mode in FD_ORDER:
        tel = Telemetry(enabled=True)
        eng = Engine(model, params, dataclasses.replace(
            scfg, async_step=mode == "async"), telemetry=tel)
        sampling = count_sampling_steps(eng)
        sig = schedule_signature(eng)
        forbid_syncs(eng)
        reset_launches()
        out, st = eng.run([dict(r) for r in reqs])
        torch.cuda.synchronize()
        lc = launch_counts()
        if len(out) != len(reqs) or any(len(r.tokens) != gen
                                        for r in out.values()):
            raise AssertionError(f"4b {mode}: not every request finished")
        if st["host_syncs"] != sampling[0]:
            raise AssertionError(f"4b {mode}: {st['host_syncs']:.0f} host "
                                 f"fetches over {sampling[0]} sampling steps")
        dec, pre = int(st["decode_calls"]), int(st["prefill_calls"])
        if lc["decode"] != L * dec or lc["prefill"] != L * pre:
            raise AssertionError(f"4b {mode}: K1 launches {lc} != {L} layers "
                                 f"x {dec} decode / {pre} prefill calls")
        table = phase_table(tel)
        if mode == "async" and table.get("overlap", {}).get("count", 0) < 1:
            raise AssertionError("4b async: the overlap never engaged")
        runs[mode].append({"out": out, "sig": sig, "record": {
            "steps": st["steps"], "wall_s": st["wall_s"],
            "decode_tok_per_s": st["decode_tok_per_s"],
            "total_tok_per_s": st["total_tok_per_s"],
            "mean_ttft_s": st["mean_ttft_s"],
            "host_syncs": st["host_syncs"], "sampling_steps": sampling[0],
            "decode_calls": dec, "prefill_calls": pre,
            "k1_launches": {"decode": lc["decode"], "prefill": lc["prefill"]},
            "phases": table, "syncs_in_submit_step": 0}})
        print(f"  4b (a) {mode:8s} {st['steps']:.0f} steps in "
              f"{st['wall_s']:.2f} s | decode {st['decode_tok_per_s']:.1f} "
              f"tok/s | TTFT {st['mean_ttft_s'] * 1e3:.1f} ms | step p50 "
              f"{table['step']['p50_ms']:.2f} ms | host fetches "
              f"{st['host_syncs']:.0f} = sampling steps | K1 {lc['decode']} "
              f"decode / {lc['prefill']} prefill = {L} x calls | 0 syncs in "
              f"_submit_step (sync debug mode 'error')", flush=True)
        del eng
        torch.cuda.empty_cache()
    lock, asy = runs["lockstep"][0], runs["async"][0]
    same_as_phase4 = sum(lock["out"][r].tokens == lock_out[r].tokens
                         for r in lock_out)
    repeats = {m: sum(rs[0]["out"][r].tokens == rs[-1]["out"][r].tokens
                      for r in rs[0]["out"]) for m, rs in runs.items()}
    print(f"  4b (a) lockstep with telemetry vs phase 4's run: "
          f"{same_as_phase4} of {len(lock_out)} requests token for token; "
          f"each mode's two runs: {repeats}", flush=True)
    rule = check_tokens("(a) async vs lockstep", model, params, asy["out"],
                        lock["out"], asy["sig"], lock["sig"], 0.25)

    def each(mode, name, key):
        return " / ".join(
            f"{r['record']['phases'].get(name, {}).get(key, 0.0):.3f}"
            for r in runs[mode])

    # p50: the registry histogram's bucket estimate; mean: total / count
    for key in ("p50_ms", "mean_ms"):
        print(f"  4b (a) step phases, {key[:-3]} ms of each run (lockstep "
              f"| async): " + "; ".join(
                  f"{n} {each('lockstep', n, key)} | {each('async', n, key)}"
                  for n in FD_PHASES[:-1]), flush=True)
    print("  4b (a) sync share of a step: " + " / ".join(
        f"{r['record']['phases']['sync_share']:.4f}"
        for r in runs["lockstep"]) + " | " + " / ".join(
        f"{r['record']['phases']['sync_share']:.4f}"
        for r in runs["async"]), flush=True)
    return {"order": list(FD_ORDER),
            "lockstep": [r["record"] for r in runs["lockstep"]],
            "async": [r["record"] for r in runs["async"]],
            "token_rule": rule, "lockstep_equal_to_phase_4": same_as_phase4,
            "repeat_equal": repeats}


def fd_front_door(model, params, scfg, rng) -> dict:
    """(c): backpressure, two cancels mid-flight, a deadline, a stream."""
    V, gen = model.cfg.vocab_size, FRONT["gen"]
    reqs = random_requests(rng, V, FRONT["requests"], gen, FRONT["lo"],
                           FRONT["hi"])
    eng = Engine(model, params, dataclasses.replace(
        scfg, async_step=True, max_waiting=2))
    a = eng.add_request(**reqs[0])
    b = eng.add_request(**reqs[1])
    try:
        eng.add_request(**reqs[2])
        raise AssertionError("4b (c): a third waiting request was admitted "
                             "past max_waiting 2")
    except EngineOverloaded:
        pass
    eng.step_async()
    c = eng.add_request(**reqs[2], deadline_s=FRONT["deadline_s"])
    d = eng.add_request(**reqs[3])
    for _ in range(10):
        eng.step_async()
    if not (eng.cancel(a) and eng.cancel(b)) or eng.cancel(a):
        raise AssertionError("4b (c): cancel of a running request")
    streamed = list(eng.stream(reqs[4]["prompt"],
                               max_new_tokens=FRONT["stream_gen"]))
    while eng.scheduler.has_work or eng.pending_step:
        eng.step_async()
    recs = eng.pop_finished()
    no_leaks("(c)", eng)
    e = max(recs)
    want = {a: "cancelled", b: "cancelled", c: "deadline", d: "length",
            e: "length"}
    got = {r: recs[r].finish_reason for r in want}
    if got != want or recs[e].tokens != streamed or \
            len(streamed) != FRONT["stream_gen"] or \
            len(recs[d].tokens) != gen or \
            not all(0 < len(recs[r].tokens) < gen for r in (a, b)) or \
            len(recs[c].tokens) >= gen:
        raise AssertionError(f"4b (c): finish reasons {got} (want {want}), "
                             f"lengths { {r: len(recs[r].tokens) for r in want} }"
                             f", streamed {len(streamed)}")
    res = {"finish_reasons": {str(r): v for r, v in got.items()},
           "tokens": {str(r): len(recs[r].tokens) for r in want},
           "streamed": len(streamed)}
    print(f"  4b (c) EngineOverloaded past max_waiting 2; cancelled 2 running "
          f"requests at {len(recs[a].tokens)} and {len(recs[b].tokens)} of "
          f"{gen} tokens; deadline {FRONT['deadline_s']} s at "
          f"{len(recs[c].tokens)} tokens; stream() gave "
          f"{len(streamed)} tokens = its record; allocator check clean, 0 "
          f"live / 0 held", flush=True)
    del eng
    torch.cuda.empty_cache()
    return res


def fd_chaos(model, params, rng) -> dict:
    """(d): one step-pinned fault schedule, full audits, lockstep and
    async, against a fault-free lockstep run."""
    V = model.cfg.vocab_size
    reqs = random_requests(rng, V, CHAOS["requests"], CHAOS["gen"],
                           CHAOS["lo"], CHAOS["hi"])
    ccfg = ServeConfig(max_seqs=CHAOS["requests"], block_size=16,
                       max_len=CHAOS["hi"] + CHAOS["gen"], chunk_size=128,
                       audit_level="full")
    victim = 3
    want_fired = {"alloc_hold": 1, "sync_error": 1, "callback_error": 1,
                  "slow_step": 1}

    def run(mode, faults):
        tel = Telemetry(enabled=True)
        eng = Engine(model, params, dataclasses.replace(
            ccfg, async_step=mode == "async"), telemetry=tel, faults=faults)
        sig = schedule_signature(eng)
        out, st = eng.run([dict(r, on_token=lambda t, d: None)
                           for r in reqs])
        torch.cuda.synchronize()
        no_leaks(f"(d) {mode}", eng)
        del eng
        torch.cuda.empty_cache()
        return out, st, sig, phase_table(tel)

    ref, _, ref_sig, _ = run("lockstep", None)
    res = {}
    for mode in ("lockstep", "async"):
        fi = FaultInjector([Fault("alloc_hold", step=5, hold_steps=3),
                            Fault("sync_error", step=9),
                            Fault("callback_error", rate=1.0, rid=victim),
                            Fault("slow_step", step=12, delay_s=0.02)],
                           seed=0)
        out, st, sig, table = run(mode, fi)
        reasons = {r: out[r].finish_reason for r in out}
        want = {r: "error" if r == victim else "length" for r in out}
        if reasons != want or dict(fi.fired) != want_fired or \
                st["faults_injected"] != 4 or st["recoveries"] != 1 or \
                st["callback_errors"] != 1:
            raise AssertionError(
                f"4b (d) {mode}: reasons {reasons}, fired {dict(fi.fired)}, "
                f"faults_injected {st['faults_injected']}, recoveries "
                f"{st['recoveries']}, callback_errors "
                f"{st['callback_errors']}")
        rule = check_tokens(f"(d) {mode} vs fault-free", model, params, out,
                            ref, sig, ref_sig, 0.25, prefix_ok=(victim,))
        audit = table.get("audit", {})
        res[mode] = {"fired": dict(fi.fired),
                     "faults_injected": st["faults_injected"],
                     "recoveries": st["recoveries"], "token_rule": rule,
                     "audit_ms_per_step": audit.get("mean_ms", 0.0),
                     "audits": audit.get("count", 0), "steps": st["steps"]}
        print(f"  4b (d) {mode:8s} faults {dict(fi.fired)} -> rid {victim} "
              f"'error', the rest 'length'; faults_injected 4, recoveries 1; "
              f"full audit {audit.get('mean_ms', 0.0):.3f} ms host a step "
              f"(p50 {audit.get('p50_ms', 0.0):.3f}) over "
              f"{audit.get('count', 0)} steps; allocator clean, 0 held",
              flush=True)
    return res


def fd_crash_restore(model, params, rng) -> dict:
    """(e): snapshot to a file at step K - 1, crash at K, restore into a
    fresh engine, run to the end; against an uninterrupted run."""
    V, gen, K = model.cfg.vocab_size, CRASH["gen"], CRASH["step"]
    reqs = random_requests(rng, V, CRASH["greedy"], gen, CRASH["lo"],
                           CRASH["hi"]) + random_requests(
        rng, V, CRASH["sampled"], gen, CRASH["lo"], CRASH["hi"],
        temperature=0.8)
    sampled = set(range(CRASH["greedy"], len(reqs)))
    ecfg = ServeConfig(max_seqs=len(reqs), block_size=16,
                       max_len=CRASH["hi"] + gen, chunk_size=128)
    res = {}
    for mode in ("lockstep", "async"):
        cfg = dataclasses.replace(ecfg, async_step=mode == "async")
        eng = Engine(model, params, cfg)
        ref, _ = eng.run([dict(r) for r in reqs])
        eng.reset()
        eng.faults = FaultInjector([Fault("crash", step=K)])
        for r in reqs:
            eng.add_request(**r)
        step = eng.step_async if cfg.async_step else eng.step
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "engine.rsrv")
            save_s = None
            try:
                while eng.scheduler.has_work or eng.pending_step:
                    if eng._steps == K - 1 and save_s is None:
                        t0 = time.perf_counter()
                        save_snapshot(eng, path)
                        save_s = time.perf_counter() - t0
                    step()
                raise AssertionError(f"4b (e) {mode}: no crash at step {K}")
            except CrashError:
                pass
            size = os.path.getsize(path)
            del eng
            torch.cuda.empty_cache()
            eng = Engine(model, params, cfg)
            t0 = time.perf_counter()
            eng.restore(load_snapshot(path))
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        out, _ = eng.run()
        recs = {**eng.pop_finished(), **out}
        no_leaks(f"(e) {mode}", eng)
        if set(recs) != set(ref) or any(len(recs[r].tokens) != gen
                                        for r in recs):
            raise AssertionError(f"4b (e) {mode}: not every request finished "
                                 f"after the restore")
        must = set(ref) if mode == "lockstep" else set(ref) - sampled
        diff = [r for r in must if recs[r].tokens != ref[r].tokens]
        if diff:
            raise AssertionError(f"4b (e) {mode}: rids {diff} differ from "
                                 f"the uninterrupted run")
        same_sampled = sum(recs[r].tokens == ref[r].tokens for r in sampled)
        res[mode] = {"snapshot_bytes": size, "save_s": save_s,
                     "load_restore_s": load_s,
                     "sampled_equal": same_sampled}
        print(f"  4b (e) {mode:8s} snapshot at step {K - 1}: {size} bytes, "
              f"saved in {save_s:.3f} s; crash at step {K}; loaded and "
              f"restored into a fresh engine in {load_s:.3f} s; "
              f"{len(must)} requests equal the uninterrupted run token for "
              f"token ({same_sampled} of {len(sampled)} at temperature 0.8 "
              f"equal, all finished)", flush=True)
        del eng
        torch.cuda.empty_cache()
    return res


def phase_front_door(model, params, scfg, reqs, lock_out, seed: int) -> dict:
    """Phase 4b on phase 4's model; its own generator ``[seed, 4, 2]``."""
    t_start = time.time()
    card = nvidia_smi_line()
    print(f"phase 4b: the front door and crash safety at full width ({card})",
          flush=True)
    rng = np.random.default_rng([seed, 4, 2])
    probe = sync_probe()
    print("  4b (b) sync debug mode 'error': " + "; ".join(
        f"{k} {'synchronizes' if v else 'does not'}"
        for k, v in probe.items()), flush=True)
    res = {"card": card, "sync_probe": probe}
    res["async_vs_lockstep"] = fd_async_vs_lockstep(model, params, scfg,
                                                    reqs, lock_out)
    res["front_door"] = fd_front_door(model, params, scfg, rng)
    res["chaos"] = fd_chaos(model, params, rng)
    res["crash_restore"] = fd_crash_restore(model, params, rng)
    res["seconds"] = time.time() - t_start
    print(f"  4b: {res['seconds']:.1f} s ({card})", flush=True)
    return res


def time_steps(model, params, scfg, profile: bool = False) -> dict:
    """Device time of one decode step and one prefill step of the model at
    the engine's shapes, on the kernel and on the plain version.  With
    ``profile``, the kernel steps are also traced with ``torch.profiler``
    (device activity only) for the device's busy share and its top kernels.
    """
    B, C, NB = scfg.max_seqs, scfg.chunk_size, scfg.blocks_per_seq
    tables = (1 + torch.arange(B * NB, dtype=torch.int32, device=DEV)
              ).view(B, NB)
    pos = torch.full((B,), 700, dtype=torch.int32, device=DEV)
    tok = torch.zeros((B,), dtype=torch.int32, device=DEV)
    ptok = torch.zeros((B, C), dtype=torch.int32, device=DEV)
    ppos = (512 + torch.arange(C, dtype=torch.int32, device=DEV)
            )[None].expand(B, C).contiguous()
    valid = torch.full((B,), C, dtype=torch.int32, device=DEV)
    slots = torch.arange(B, dtype=torch.int32, device=DEV)
    res = {}
    with torch.no_grad():
        for label, m in (("kernel", model),
                         ("plain", build(model.cfg.replace(
                             use_kernels=False)))):
            cache = m.init_paged_cache(scfg.pool_blocks(), scfg.block_size,
                                       B)
            res[f"decode_step_{label}_ms"] = time_ms(
                lambda i: m.paged_decode_step(params, cache, tok, pos,
                                              tables), iters=10, warmup=2)
            res[f"prefill_step_{label}_ms"] = time_ms(
                lambda i: m.paged_prefill_step(params, cache, ptok, ppos,
                                               slots, tables, valid),
                iters=5, warmup=1)
            if profile and label == "kernel":
                res["profile"] = {
                    "decode": profile_step(lambda: m.paged_decode_step(
                        params, cache, tok, pos, tables), 10),
                    "prefill": profile_step(lambda: m.paged_prefill_step(
                        params, cache, ptok, ppos, slots, tables, valid), 4)}
            del cache
    print("  model steps at B=32, history 700 (decode) / 512+128 (prefill): "
          + " | ".join(f"{k} {v:.3f}" for k, v in res.items()
                       if k != "profile"), flush=True)
    return res


def profile_step(fn, iters: int) -> dict:
    """Busy share of the device over ``iters`` back-to-back calls of ``fn``
    and the kernels that take most of its time, from a CUPTI trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    if busy_us <= 0:
        print("  profile: the trace shows no device time (not measured)",
              flush=True)
        return {"measured": False}
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    k1_us = sum(e.self_device_time_total for e in evs
                if "paged_attention" in e.key)
    out = {"measured": True, "iters": iters, "wall_ms_per_call":
           wall_us / iters / 1e3, "device_busy_ms_per_call":
           busy_us / iters / 1e3, "device_idle_share": 1 - busy_us / wall_us,
           "k1_ms_per_call": k1_us / iters / 1e3,
           "kernel_launches_per_call": sum(e.count for e in evs) / iters,
           "top_kernels": [{"name": e.key[:60], "ms_per_call":
                            e.self_device_time_total / iters / 1e3,
                            "launches_per_call": e.count / iters}
                           for e in top]}
    print(f"  profile: wall {out['wall_ms_per_call']:.2f} ms/call, device "
          f"busy {out['device_busy_ms_per_call']:.2f} ms/call, idle share "
          f"{out['device_idle_share']:.3f}, "
          f"{out['kernel_launches_per_call']:.0f} kernel launches/call, K1 "
          f"{out['k1_ms_per_call']:.3f} ms/call", flush=True)
    for k in out["top_kernels"]:
        print(f"    {k['ms_per_call']:8.3f} ms x{k['launches_per_call']:6.1f}"
              f"  {k['name']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 5: device code around the kernel
# ---------------------------------------------------------------------------

def phase_device_code(rng) -> dict:
    print("phase 5: device code around the kernel (plain PyTorch)", flush=True)
    B, C, KH, D, bs, NB, L = 32, 128, 4, 64, 16, 80, 22
    P = B * NB + 1
    res = {}
    tables = (1 + torch.arange(B * NB, dtype=torch.int32, device=DEV)
              ).view(B, NB)
    for label, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        kv = {"k": torch.zeros((P, bs, KH, D), dtype=dt, device=DEV),
              "v": torch.zeros((P, bs, KH, D), dtype=dt, device=DEV)}
        if dt == torch.int8:
            kv["k_scale"] = torch.zeros((P, bs, KH), device=DEV)
            kv["v_scale"] = torch.zeros((P, bs, KH), device=DEV)
        for shape, c in (("decode", 1), ("prefill", C)):
            kn = torch.randn((B, c, KH, D), device=DEV, dtype=torch.bfloat16)
            pos = (600 + torch.arange(c, device=DEV))[None].expand(B, c)
            res[f"scatter_kv_{shape}_{label}_ms"] = time_ms(
                lambda i: _scatter_kv(kv, kn, kn, tables, pos))
    logits = torch.randn((B, 32000), device=DEV, dtype=torch.bfloat16)
    small = build(reduced(get_config("tinyllama-1.1b")))
    eng = Engine(small, small.init(seed=0), ServeConfig(max_seqs=B))
    zeros, warm = np.zeros(B, np.float32), np.full(B, 0.8, np.float32)
    res["sample_greedy_ms"] = time_ms(lambda i: eng._sample(logits, zeros))
    res["sample_temperature_ms"] = time_ms(lambda i: eng._sample(logits, warm))
    pools = {n: torch.zeros((L, P, bs, KH, D), dtype=torch.bfloat16,
                            device=DEV) for n in ("k", "v")}
    res["cow_copy_bf16_ms"] = time_ms(lambda i: eng._cow_impl(pools, 5, 9))
    for k, v in res.items():
        print(f"  {k} {v:.4f}", flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 6: the OBSPA sweep kernel (K4) vs its plain version
# ---------------------------------------------------------------------------

def sweep_case(seed, R, K, frac, nb=None, samples=None):
    """W, Hinv (inverse of a damped sample covariance of ``samples`` rows,
    4K by default; float64 inverse) and a prune mask, made on the card from
    a seeded generator.  Returns CUDA tensors (f32, f32, bool)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    lead = () if nb is None else (nb,)
    n = samples or 4 * K
    W = torch.randn(lead + (R, K), generator=gen, device=DEV)
    X = torch.randn(lead + (K, n), generator=gen, device=DEV,
                    dtype=torch.float64)
    H = X @ X.transpose(-1, -2) / n + 0.01 * torch.eye(
        K, device=DEV, dtype=torch.float64)
    del X
    Hinv = torch.linalg.inv(H).float()
    mask = torch.rand(K, generator=gen, device=DEV) < frac
    return W, Hinv, mask


# (name, R, K, columns a pruned unit, calibration rows) of phase 14's
# consumers: resnet50-cifar's last-stage 3x3 conv (512 x 9·512), its first
# stage's (64 x 9·64) and the classifier (10 classes x 512)
CNN_SWEEPS = (("cnn conv, last stage", 512, 4608, 9, 16 * 1024),
              ("cnn conv, first stage", 64, 576, 9, 4 * 576),
              ("cnn fc", 10, 512, 1, 1024))


# (name, R, K, columns a pruned unit, calibration rows) of phase 15's
# consumers
ENCODER_SWEEPS = (("hubert attn.wo", 1280, 1280, 80, 4 * 4 * 512),
                  ("hubert mlp.w_down", 1280, 5120, 1, 4 * 4 * 512),
                  ("paligemma mlp.w_down", 2048, 16384, 1, 2 * 2 * 320))


def channel_mask(seed, K, run, frac):
    """A prune mask of whole channels: runs of ``run`` columns, each run
    pruned with probability ``frac`` (on the card, from a seeded
    generator)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return (torch.rand(K // run, generator=gen, device=DEV) < frac
            ).repeat_interleave(run)


def sweep_rel_err(out, gold) -> float:
    return float((out.double() - gold.double()).abs().max()
                 / gold.double().abs().max().clamp(min=1e-30))


def check_sweep(name, W, Hinv, mask, oracle="plain64"):
    """Kernel-path sweep against the plain PyTorch sweep (f32, same card)
    and the float64 oracle (numpy on the host for small shapes, the plain
    sweep in float64 on the card for the main path's)."""
    batched = W.ndim == 3
    fn = k4.obspa_sweep_batched if batched else k4.obspa_sweep
    out = fn(W, Hinv, mask)
    torch.cuda.synchronize()
    plain = k4.sweep_plain(W, Hinv, mask)
    if oracle == "numpy":
        gold = torch.from_numpy(k4.sweep_oracle(W, Hinv, mask)).to(DEV)
    else:
        gold = k4.sweep_plain(W.double(), Hinv.double(), mask)
    e_gold, e_plain = sweep_rel_err(out, gold), sweep_rel_err(out, plain)
    ok = e_gold < K4_RTOL and e_plain < K4_RTOL and \
        bool(torch.isfinite(out).all())
    print(f"  {name:40s} rel err vs oracle {e_gold:.3e}, vs plain "
          f"{e_plain:.3e} (tol {K4_RTOL:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"K4 {name}: rel err {e_gold} / {e_plain}")
    return out, max(e_gold, e_plain)


def phase_k4_checks() -> float:
    print("phase 6: OBSPA sweep kernel (K4) vs plain PyTorch version",
          flush=True)
    worst = 0.0
    for i, (R, K, frac) in enumerate([(64, 96, 0.3), (100, 256, 0.5),
                                      (17, 130, 0.7), (256, 128, 0.25)]):
        _, e = check_sweep(f"R={R} K={K} frac={frac}",
                           *sweep_case(100 + i, R, K, frac), oracle="numpy")
        worst = max(worst, e)
    W = torch.randn((32, 64), device=DEV)
    mask = torch.zeros(64, dtype=torch.bool, device=DEV)
    mask[[3, 10, 50]] = True
    out, e = check_sweep("identity Hinv, 3 of 64 pruned", W,
                         torch.eye(64, device=DEV), mask, oracle="numpy")
    if float(out[:, mask].abs().max()) > 1e-6 or \
            float((out[:, ~mask] - W[:, ~mask]).abs().max()) > 1e-6:
        raise AssertionError("K4 identity case: pruned columns not zeroed "
                             "or kept columns changed")
    worst = max(worst, e)
    _, e = check_sweep("batched nb=4 R=96 K=300",
                       *sweep_case(110, 96, 300, 0.5, nb=4))
    worst = max(worst, e)
    for K in (2048, 5632):
        _, e = check_sweep(f"main path R=2048 K={K} half pruned",
                           *sweep_case(120 + K, 2048, K, 0.5))
        worst = max(worst, e)
    # phase 13's OBSPA shapes: the 60 experts' w_down in one launch a
    # column block (grid y 60, each expert its own W and Hinv), and the
    # shared w_down at K 22528; Hessians of the calibration's 8192 rows
    # (4 x 4 x 512), of which each expert sees 8192 x 4 / 60 on average
    n_cal = 4 * 4 * 512
    moe = get_config("qwen2-moe-a2.7b")
    cases = (("moe experts nb=60", moe.n_experts, moe.moe_d_ff,
              n_cal * moe.top_k // moe.n_experts),
             ("moe shared", None, moe.n_shared_experts * moe.shared_d_ff,
              n_cal))
    for i, (name, nb, K, n) in enumerate(cases):
        _, e = check_sweep(f"{name} R={moe.d_model} K={K} half pruned",
                           *sweep_case(150 + i, moe.d_model, K, 0.5, nb=nb,
                                       samples=n))
        worst = max(worst, e)
        torch.cuda.empty_cache()
    # phase 14's OBSPA shapes: a conv consumer's (C_out, 9·C_in) view with
    # whole input channels pruned (runs of 9 columns, the 3x3 taps) at 50 %,
    # its Hessian from the calibration's patch rows (1024 images: 16 a map
    # in resnet50-cifar's last stage, 1024 in its first), and the
    # classifier's (classes, 512) view with one row an image
    for i, (name, R, K, run, n) in enumerate(CNN_SWEEPS):
        W, Hinv, _ = sweep_case(160 + i, R, K, 0.5, samples=n)
        _, e = check_sweep(f"{name} R={R} K={K} runs of {run}, half pruned",
                           W, Hinv, channel_mask(170 + i, K, run, 0.5))
        worst = max(worst, e)
        del W, Hinv
    torch.cuda.empty_cache()
    # phase 15's OBSPA shapes: hubert-xlarge's attn.wo (R 1280 x K 16·80)
    # and mlp.w_down (R 1280 x K 5120) on the calibration's 8192 frames (4 x
    # 4 x 512), whole heads (runs of 80 columns) pruned at 50 % from wo;
    # paligemma-3b's w_down (R 2048 x K 16384) on its 1280 DataFree rows
    # (2 x 2 x 320), fewer rows than columns: the damping alone makes H
    # invertible
    for i, (name, R, K, run, n) in enumerate(ENCODER_SWEEPS):
        W, Hinv, _ = sweep_case(180 + i, R, K, 0.5, samples=n)
        _, e = check_sweep(f"{name} R={R} K={K} runs of {run}, half pruned",
                           W, Hinv, channel_mask(190 + i, K, run, 0.5))
        worst = max(worst, e)
        del W, Hinv
        torch.cuda.empty_cache()
    print("  one column block (the kernel alone; W and E vs float64 and "
          "plain, two calls and the sweep in place bitwise equal):",
          flush=True)
    for name, (w, h, mask) in k4_edge_cases().items():
        worst = max(worst, check_inblock(name, w, h, mask))
    return worst


def k4_edge_cases() -> dict:
    """The design's edge cases at the card's sizes: (w, hinv, mask) of one
    128-column block — the masks none, one column, 64 contiguous, all 128,
    the first and the last column alone at R 2048; R 1, 17 and 2051 (a
    tail of 3 rows) half pruned; nb 4 with one Hinv block for all (the
    launch's h_bs = 0)."""
    B = k4.BLOCK
    W, Hinv, _ = sweep_case(130, 2048, B, 0.5)
    Hinv = Hinv.contiguous()        # torch.linalg.inv's are column-major
    cols = {"no column": [], "one column (37)": [37],
            "64 contiguous": list(range(64, B)), "all 128": list(range(B)),
            "first column alone": [0], "last column alone": [B - 1]}
    cases = {}
    for name, cs in cols.items():
        mask = torch.zeros(B, dtype=torch.bool, device=DEV)
        mask[cs] = True
        cases[f"R=2048 {name}"] = (W, Hinv, mask)
    for R in (1, 17, 2051):
        w, h, m = sweep_case(131 + R, R, B, 0.5)
        cases[f"R={R} half pruned"] = (w, h.contiguous(), m)
    W4, H4, m4 = sweep_case(140, 2048, B, 0.5, nb=4)
    cases["nb=4 R=2048 one shared Hinv"] = (W4, H4[:1].contiguous(), m4)
    return cases


def check_inblock(name, w, h, mask) -> float:
    """K4 on one column block against the plain version (f32) and the same
    in float64: W and E each relative to its float64 oracle's largest
    value (W's residue relative to the input's when every column is
    pruned, its oracle being zero); two calls bitwise equal and one launch
    each; the sweep in place (out = w) equal to them bit for bit."""
    n0 = k4.launch_count()
    kw, ke = k4.inblock_sweep_kernel(w, h, mask)
    kw2, ke2 = k4.inblock_sweep_kernel(w, h, mask)
    ip = w.clone()
    iw, ie = k4.inblock_sweep_kernel(ip, h, mask, out=ip)
    torch.cuda.synchronize()
    launches = k4.launch_count() - n0
    w3, h3 = (w, h) if w.ndim == 3 else (w[None], h[None])
    pw, pe = k4.inblock_sweep_plain(w3, h3, mask)
    gw, ge = k4.inblock_sweep_plain(w3.double(), h3.double(), mask)
    kw3, ke3 = kw.reshape(pw.shape).double(), ke.reshape(pe.shape).double()
    sw = float((w.abs() if bool(mask.all()) else gw.abs()).max())
    e_w = max(float((kw3 - gw).abs().max()),
              float((kw3 - pw.double()).abs().max())) / max(sw, 1e-30)
    if bool(mask.any()):
        e_e = max(float((ke3 - ge).abs().max()),
                  float((ke3 - pe.double()).abs().max())) / max(
            float(ge.abs().max()), 1e-30)
    else:
        e_e = float(ke3.abs().max())
    same = all(torch.equal(a, b) for a, b in
               ((kw, kw2), (ke, ke2), (iw, kw), (ie, ke)))
    ok = e_w < K4_RTOL and e_e < K4_RTOL and same and launches == 3 and \
        bool(torch.isfinite(kw).all() and torch.isfinite(ke).all())
    print(f"    {name:36s} W {e_w:.2e}, E {e_e:.2e} (tol {K4_RTOL:g}), "
          f"bitwise repeats {same}, launches {launches} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K4 {name}: W {e_w}, E {e_e}, bitwise {same}, "
                             f"launches {launches}")
    return max(e_w, e_e)


def device_profile(fn, iters: int, name: str | None = None,
                   tries: int = 3) -> dict | None:
    """Device time per call of ``fn(i)`` from a CUPTI trace of ``iters``
    calls: for every kernel whose name holds ``name`` (every device kernel
    when None), its mean time per launch times its launches per call, added
    up (a call may launch several kernels: K1's decode launches its splits
    and their combine).  Means per launch, not sums over the trace divided
    by the calls, because a trace of a long run was seen to lose about a
    third of its events.  ``events_per_call`` says what the trace kept.  A
    trace with no device time is taken again, up to ``tries`` times; None:
    not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count
               and e.self_device_time_total > 0
               and (name is None or name in e.key)]
        if evs:
            per_call = {e.key: max(1, round(e.count / iters)) for e in evs}
            us = sum(e.self_device_time_total / e.count * per_call[e.key]
                     for e in evs)
            return {"ms": us / 1e3,
                    "kernels_per_call": sum(per_call.values()),
                    "events_per_call": sum(e.count for e in evs) / iters,
                    "launches_per_call": per_call}
    return None


def kernel_device_ms(fn, name: str, iters: int) -> float | None:
    """Device time per call of the kernels whose name holds ``name`` (see
    ``device_profile``; None: not measured)."""
    prof = device_profile(fn, iters, name)
    return None if prof is None else prof["ms"]


def inblock_work(R: int, mask) -> tuple[int, int]:
    """(bytes, flops) of one in-block sweep, from this mask: W read and
    written once, E written once, the mask read once, and of Hinv the row
    of each pruned column j from j on (what the chain reads); per pruned
    column a reciprocal, and a multiply and a multiply-add over columns
    j..127 of every row."""
    B = k4.BLOCK
    cols = torch.nonzero(mask.cpu())[:, 0].tolist()
    nbytes = 3 * R * B * 4 + sum((B - j) * 4 for j in cols) + B
    flops = sum(R * (1 + 2 * (B - j)) for j in cols)
    return nbytes, flops


def k4_yardstick(w, h, mask):
    """The sweep of one block as a triangular solve and a product (an
    informative yardstick, not one call: E_P = W_P · triu(Hinv[P, P])⁻¹,
    then W − E_P · (Hinv[P, :] from each row's own column on)); the two
    matrices of Hinv are made before, as the kernel's copies are not."""
    P = torch.nonzero(mask)[:, 0]
    U = torch.triu(h[P][:, P])
    cols = torch.arange(k4.BLOCK, device=DEV)
    Hm = torch.where(cols[None, :] >= P[:, None], h[P], 0.0)

    def fn(i):
        ep = torch.linalg.solve_triangular(U, w.index_select(1, P),
                                           upper=True, left=False)
        return torch.addmm(w, ep, Hm, alpha=-1), ep
    return fn


def k4_tiles(R: int = 2048) -> dict:
    """The three timed tiles (R rows, one 128-column block, f32) as
    (w, hinv, mask) on the card: tile 0 of ``sweep_case(7, R, 5632, 0.5)``
    (phase 6b's; 67 of 128 columns pruned), the same w and hinv with 64
    contiguous columns pruned (a head of ``wo`` at head_dim 64), and with
    all 128 pruned."""
    B = k4.BLOCK
    W, Hinv, mask = sweep_case(7, R, 5632, 0.5)
    w, h = W[:, :B].contiguous(), Hinv[:B, :B].contiguous()
    head = torch.zeros(B, dtype=torch.bool, device=DEV)
    head[64:] = True
    return {f"{int(mask[:B].sum())} pruned": (w, h, mask[:B].contiguous()),
            "64 contiguous": (w, h, head),
            "all 128": (w, h, torch.ones(B, dtype=torch.bool, device=DEV))}


def time_k4_tile(label: str, w, h, m, iters: int = 50) -> dict:
    """K4 on one tile (R rows, one 128-column block, f32): the profiler's
    device time per launch, CUDA events around the kernel, its plain
    version and the yardstick ``k4_yardstick`` in the order plain, kernel,
    yardstick, yardstick, kernel, plain, beside the bound from this mask."""
    R = w.shape[0]
    o, e = torch.empty_like(w), torch.empty_like(w)
    kern = (lambda i, w=w, h=h, m=m, o=o, e=e:
            k4.inblock_sweep_kernel(w, h, m, out=o, e_out=e))
    plain = lambda i, w=w, h=h, m=m: k4.inblock_sweep_plain(  # noqa: E731
        w[None], h[None], m)
    lib = k4_yardstick(w, h, m)
    kw, ke = kern(0)
    pw, pe = plain(0)
    lw, _ = lib(0)
    torch.cuda.synchronize()
    max_err = max(float((kw - pw[0]).abs().max()),
                  float((ke - pe[0]).abs().max()))
    lib_err = float((lw - pw[0]).abs().max())
    plain_a = time_ms(plain, iters=5, warmup=1)
    kern_a = time_ms(kern, iters=iters)
    lib_a = time_ms(lib, iters=iters)
    lib_b = time_ms(lib, iters=iters)
    kern_b = time_ms(kern, iters=iters)
    plain_b = time_ms(plain, iters=5, warmup=1)
    device = kernel_device_ms(kern, "inblock_sweep_kernel", iters)
    lib_prof = device_profile(lib, iters)
    nbytes, flops = inblock_work(R, m)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[torch.float32] * 1e3
    bound = max(t_bytes, t_flops)
    t = {"rows": R, "pruned_columns": int(m.sum()), "device_ms": device,
         "event_ms": (kern_a + kern_b) / 2,
         "plain_ms": (plain_a + plain_b) / 2, "bound_ms": bound,
         "bound_by": "bytes" if t_bytes >= t_flops else "operations",
         "bytes": nbytes, "flops": flops, "max_abs_err": max_err,
         "yardstick_device_ms": None if lib_prof is None else lib_prof["ms"],
         "yardstick_event_ms": (lib_a + lib_b) / 2,
         "yardstick_max_abs_err": lib_err, "plan": k4.plan(R)._asdict()}
    dev_txt = "not measured" if device is None else (
        f"{device:.4f} ms, {bound / device:.1%} of the bound")
    yd = t["yardstick_device_ms"]
    print(f"  obspa_sweep.inblock {label} (R={R}, 128 columns): device "
          f"{dev_txt} | events {t['event_ms']:.4f} ms | plain "
          f"{t['plain_ms']:.4f} ms | library none | bound {bound:.5f} ms "
          f"({t['bound_by']}; {nbytes / 1e6:.3f} MB, {flops / 1e6:.1f} "
          f"MFLOP) | max abs err {max_err:.2e} | solve_triangular + "
          f"addmm: device "
          f"{'not measured' if yd is None else f'{yd:.4f} ms'}, events "
          f"{t['yardstick_event_ms']:.4f} ms, max abs err vs plain "
          f"{lib_err:.2e} | {k4.plan(R).blocks} thread blocks", flush=True)
    return t


def time_k4_sweep(label: str, W, Hinv, mask) -> dict:
    """The whole sweep of a (R, K) view on the kernel path vs the plain
    sweep (events, plain, kernel, kernel, plain), with the kernels of one
    sweep from the profiler (no copy kernel may run once a column
    block)."""
    R, K = W.shape
    sweep = {"shape": [R, K], "pruned_columns": int(mask.sum())}
    k4_path = lambda i: k4.obspa_sweep(W, Hinv, mask)  # noqa: E731
    plain_path = lambda i: k4.sweep_plain(W, Hinv, mask)  # noqa: E731
    pa = time_ms(plain_path, iters=2, warmup=1)
    ka = time_ms(k4_path, iters=5, warmup=1)
    kb = time_ms(k4_path, iters=5, warmup=1)
    pb = time_ms(plain_path, iters=2, warmup=1)
    prof = device_profile(k4_path, 3)
    per = {} if prof is None else prof["launches_per_call"]
    blocks = math.ceil(K / k4.BLOCK)
    copies = {k: n for k, n in per.items() if "copy" in k.lower()}
    sweep.update({"k4_path_ms": (ka + kb) / 2, "plain_sweep_ms": (pa + pb) / 2,
                  "k4_launches_per_sweep": blocks,
                  "device_ms": None if prof is None else prof["ms"],
                  "kernels_per_sweep": per})
    dev_txt = "not measured" if prof is None else f"{prof['ms']:.3f} ms"
    print(f"  whole sweep {label} R={R} K={K}: K4 path "
          f"{sweep['k4_path_ms']:.3f} ms (events; device {dev_txt}; {blocks} "
          f"K4 launches + {blocks - 1} panel GEMMs in place) | plain "
          f"unblocked sweep {sweep['plain_sweep_ms']:.3f} ms", flush=True)
    for k, n in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"    {n:3d} a sweep: {k[:110]}", flush=True)
    if any(n >= blocks - 1 for n in copies.values()):
        raise AssertionError(f"a copy kernel runs once a column block: "
                             f"{copies}")
    return sweep


def time_k4(iters: int = 50) -> tuple[dict, dict]:
    """K4 at the three tiles of ``k4_tiles`` (R 2048) and the whole sweep
    of a (2048, 5632) view (``time_k4_tile``, ``time_k4_sweep``); then the
    same at phase 14's largest conv consumer, R 512 x K 4608 with whole
    channels (runs of 9 columns) pruned at 50 %: its first column block
    and its whole sweep."""
    R, B = 2048, k4.BLOCK
    tiles = {label: time_k4_tile(label, w, h, m, iters)
             for label, (w, h, m) in k4_tiles(R).items()}
    main = tiles[next(iter(tiles))]
    entry = {
        "name": "obspa_sweep.inblock", "route": "cuda", "source": K4_SOURCE,
        "replaces": K4_REPLACES, "launches": 0,
        "max_abs_err": main["max_abs_err"],
        "ms": main["event_ms"] if main["device_ms"] is None
        else main["device_ms"],
        "ms_from": "events" if main["device_ms"] is None else "profiler",
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "shape": {"R": R, "block": B, "pruned_columns":
                  main["pruned_columns"], "dtype": "float32"},
        "plan": k4.plan(R)._asdict(), "tiles": tiles,
    }
    W, Hinv, mask = sweep_case(7, R, 5632, 0.5)
    sweep = time_k4_sweep("main path", W, Hinv, mask)
    del W, Hinv
    name, R, K, run, n = CNN_SWEEPS[0]
    W, Hinv, _ = sweep_case(160, R, K, 0.5, samples=n)
    mask = channel_mask(170, K, run, 0.5)
    entry["cnn"] = {
        "consumer": name,
        "tile": time_k4_tile(f"{name}, first block", W[:, :B].contiguous(),
                             Hinv[:B, :B].contiguous(),
                             mask[:B].contiguous(), iters),
        "sweep": time_k4_sweep(name, W, Hinv, mask)}
    del W, Hinv
    torch.cuda.empty_cache()
    return entry, sweep


# ---------------------------------------------------------------------------
# Phase 7: prune then serve, at full width
# ---------------------------------------------------------------------------

def phase_prune_path(rng, quick: bool) -> dict:
    print("phase 7: prune then serve — tinyllama-1.1b OBSPA-pruned on the "
          "card (K4), served through K1", flush=True)
    cfg = get_config("tinyllama-1.1b")
    if quick:
        cfg = cfg.replace(num_layers=4)
    L = cfg.num_layers
    model = build(cfg)
    params = model.init(seed=0)
    calib = batches(cfg, "datafree", 4, 4, 512, seed=5)
    evalb = model.dummy_batch(4, 128, seed=9)
    k2.reset_launches()        # K2: every full-sequence forward of phase 7
    with torch.no_grad():
        dense_logits = model.forward(params, evalb).float()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k4.reset_launches()                      # counts = this path's only
    reset_launches()
    t0 = time.time()
    pr = obspa_prune(model, params, 0.5, calib, calib_mode="datafree")
    torch.cuda.synchronize()
    prune_s = time.time() - t0
    k4_launches = k4.launch_count()
    peak = torch.cuda.max_memory_allocated()
    pc = pr.cfg
    secs = pr.report["seconds"]
    print(f"  pruned config: heads {cfg.n_heads}->{pc.n_heads}, kv heads "
          f"{cfg.n_kv_heads}->{pc.n_kv_heads}, head_dim {cfg.head_dim_}->"
          f"{pc.head_dim_}, v_head_dim {cfg.v_head_dim_}->{pc.v_head_dim_}, "
          f"d_ff {cfg.d_ff}->{pc.d_ff}; params {cfg.param_count()}->"
          f"{pc.param_count()}", flush=True)
    print(f"  obspa_prune {prune_s:.2f}s: " + " | ".join(
        f"{k} {v:.3f}s" for k, v in secs.items())
        + f" | K4 launches {k4_launches} | peak memory "
        f"{peak / 2**30:.2f} GiB", flush=True)
    want = (pc.n_heads * 2 == cfg.n_heads and pc.n_kv_heads * 2 ==
            cfg.n_kv_heads and pc.v_head_dim_ * 2 == cfg.v_head_dim_ and
            pc.d_ff * 2 == cfg.d_ff and pc.head_dim_ == cfg.head_dim_)
    if not want:
        raise AssertionError(f"unexpected pruned config {pc}")
    # one launch per 128-column block of every reconstructed consumer:
    # wo (K = H * v_head_dim) and w_down (K = d_ff) of every layer
    blocks = L * (math.ceil(cfg.n_heads * cfg.v_head_dim_ / k4.BLOCK)
                  + math.ceil(cfg.d_ff / k4.BLOCK))
    if k4_launches != blocks:
        raise AssertionError(f"K4 launches {k4_launches} != {blocks} column "
                             f"blocks of the reconstructed consumers")

    errs = layer_output_errors(model, params, pr, calib)
    ratios = [e_ob / e_cut for e_ob, e_cut in errs.values()]
    bad = [k for k, (e_ob, e_cut) in errs.items() if not e_ob < e_cut]
    print(f"  layer output error ‖X(W-W')‖² over {len(errs)} reconstructed "
          f"consumers: OBSPA / plain slicing of the same columns = "
          f"{min(ratios):.4f}..{max(ratios):.4f}", flush=True)
    if len(errs) != 2 * L or bad:
        raise AssertionError(f"OBSPA not below plain slicing at {bad} "
                             f"({len(errs)} consumers)")

    mag = prune_model(model, params, 0.5, criterion="l1")
    with torch.no_grad():
        ob_logits = build(pc).forward(pr.params, evalb).float()
        mag_logits = build(mag.cfg).forward(mag.params, evalb).float()
    mse_ob = float(((ob_logits - dense_logits) ** 2).mean())
    mse_mag = float(((mag_logits - dense_logits) ** 2).mean())
    print(f"  logit MSE vs the dense model on 4 x 128 tokens: OBSPA "
          f"{mse_ob:.6f} | magnitude (l1) {mse_mag:.6f} (dense logit "
          f"variance {float(dense_logits.var()):.6f})", flush=True)
    if not (math.isfinite(mse_ob) and math.isfinite(mse_mag)):
        raise AssertionError("non-finite logits after pruning")
    del mag, mag_logits, ob_logits, dense_logits

    pm = build(pc)
    n_req, gen = (6, 8) if quick else (16, 32)
    scfg = ServeConfig(max_seqs=16, block_size=16, max_len=640,
                       chunk_size=128)
    reqs = make_requests(rng, pc.vocab_size, n_req, gen, 128, 512, 256)
    eng = Engine(pm, pr.params, scfg)
    reset_launches()
    out, stats = eng.run(reqs)
    torch.cuda.synchronize()
    k1 = launch_counts()
    if len(out) != n_req or any(len(r.tokens) != gen for r in out.values()):
        raise AssertionError("pruned serve: not every request finished")
    if k1["total"] != L * int(stats["decode_calls"] + stats["prefill_calls"]) \
            or k1["decode"] < 1 or k1["prefill"] < 1:
        raise AssertionError(f"pruned serve: K1 launches {k1}")
    gaps = [teacher_forced_gap(pm, pr.params, out[r]) for r in sorted(out)]
    tf_gap = max(g for g, _ in gaps)
    tf_match = float(np.mean([m for _, m in gaps]))
    print(f"  served the pruned model (D={pc.head_dim_}, DV={pc.v_head_dim_},"
          f" KH={pc.n_kv_heads}): {n_req} requests x {gen} tokens in "
          f"{stats['wall_s']:.2f}s, decode {stats['decode_tok_per_s']:.1f} "
          f"tok/s, K1 launches {k1}; teacher forcing vs its Model.forward: "
          f"max logit shortfall {tf_gap:.4f} (tol 0.25), argmax agreement "
          f"{tf_match:.3f}", flush=True)
    if tf_gap > 0.25:
        raise AssertionError(f"pruned teacher-forced shortfall {tf_gap}")
    k2_launches = k2.launch_count()
    if k2_launches != L * (3 + len(gaps)):
        raise AssertionError(f"K2 launches {k2_launches} != {L} layers x "
                             f"{3 + len(gaps)} forwards")
    res = {
        "model": cfg.name, "layers": L, "ratio": 0.5,
        "calibration": "datafree 4 x 4 x 512, seed 5",
        "pruned_cfg": {"n_heads": pc.n_heads, "n_kv_heads": pc.n_kv_heads,
                       "head_dim": pc.head_dim_, "v_head_dim": pc.v_head_dim_,
                       "d_ff": pc.d_ff, "params": pc.param_count()},
        "dense_params": cfg.param_count(),
        "prune_s": prune_s, "seconds": secs, "k4_launches": k4_launches,
        "k2_launches": k2_launches, "peak_mem_bytes": peak,
        "layer_error_ratio_min": min(ratios),
        "layer_error_ratio_max": max(ratios),
        "logit_mse_obspa": mse_ob, "logit_mse_magnitude": mse_mag,
        "serve": {"requests": n_req, "gen": gen, "wall_s": stats["wall_s"],
                  "decode_tok_per_s": stats["decode_tok_per_s"],
                  "total_tok_per_s": stats["total_tok_per_s"],
                  "k1_launches": k1, "teacher_forced_shortfall": tf_gap,
                  "argmax_agreement": tf_match},
    }
    del eng, pr, params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 8: the SSD chunked-scan kernel (K3) vs its plain version
# ---------------------------------------------------------------------------

# the full-width shape and the 50 %-pruned one (SPA at ratio 0.5 halves the
# SSM heads, their head_dim and the state; phase 9 checks that infer_config
# gives these): x f32 (dt applied in f32), B/C in the bf16 model dtype; and
# the same cut by 37.5 %, whose p 40 the kernel pads to 48
K3_FULL = dict(b=4, l=1024, h=64, p=64, n=128, Q=128)
K3_PRUNED = dict(b=4, l=1024, h=32, p=32, n=64, Q=128)
K3_PRUNED_ODD = dict(b=4, l=1024, h=40, p=40, n=80, Q=128)


def ssd_case(seed, b, l, h, p, n, x_dtype, bc_dtype, dt_lo=0.05,
             dt_span=0.5, model_A=False):
    """x·dt, dt, A, B, C on the card from a seeded generator, drawn as the
    reference's test draws them (``model_A``: A = -linspace(1, 16), the
    model's initial decay rates)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    x = torch.randn((b, l, h, p), generator=gen, device=DEV)
    dt = torch.rand((b, l, h), generator=gen, device=DEV) * dt_span + dt_lo
    A = -torch.randn((h,), generator=gen, device=DEV).abs() - 0.1
    if model_A:
        A = -torch.linspace(1.0, 16.0, h, device=DEV)
    B = torch.randn((b, l, n), generator=gen, device=DEV).to(bc_dtype)
    C = torch.randn((b, l, n), generator=gen, device=DEV).to(bc_dtype)
    return (x * dt[..., None]).to(x_dtype), dt, A, B, C


def ssd_rel(a, b) -> float:
    """max|a - b| / max|b| (the reference's measure)."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


def check_ssd(name, Q, args) -> float:
    """K3 against the plain version (f32, same card) at the reference's
    tolerance, and both against the plain version run in float64 on the
    same inputs, so that a miss says which side errs; the call is made
    twice, must launch the kernel once each time and give the same bits."""
    before = k3.launch_count()
    y, again = k3.ssd_scan(*args, Q), k3.ssd_scan(*args, Q)
    torch.cuda.synchronize()
    calls = k3.launch_count() - before
    same = torch.equal(y, again)
    plain = k3.ssd_scan_ref(*args, Q)
    gold = ssd_reference(*[t.double() for t in args], Q)[0]
    tol = K3_TOL[args[0].dtype]         # y comes back in x's dtype
    e_plain, e_gold = ssd_rel(y, plain), ssd_rel(y, gold)
    e_pg = ssd_rel(plain, gold)
    ok = (e_plain < tol and e_gold < tol and bool(torch.isfinite(y).all())
          and same and calls == 2)
    print(f"  {name:46s} rel err vs plain {e_plain:.2e}, vs float64 "
          f"{e_gold:.2e} (plain vs float64 {e_pg:.2e}; tol {tol:g}); "
          f"bitwise repeat {'yes' if same else 'NO'}, launches {calls}/2 "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K3 {name}: rel err {e_plain} / {e_gold}, "
                             f"repeat equal {same}, launches {calls}")
    return max(e_plain, e_gold)


def phase_k3_checks() -> float:
    print("phase 8: SSD chunked-scan kernel (K3) vs plain PyTorch version",
          flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    # the reference's grid (tests/test_kernels.py::test_ssd_scan)
    for i, (b, l, h, p, n, Q, dt_) in enumerate([
            (2, 64, 4, 16, 16, 16, f32), (1, 256, 2, 32, 64, 64, f32),
            (2, 128, 8, 64, 128, 32, f32), (1, 64, 2, 16, 32, 32, bf16)]):
        worst = max(worst, check_ssd(
            f"b={b} l={l} h={h} p={p} n={n} Q={Q} {str(dt_)[6:]}", Q,
            ssd_case(200 + i, b, l, h, p, n, dt_, dt_)))
    for label, sh in (("full width", K3_FULL), ("pruned", K3_PRUNED)):
        d = dict(sh)
        Q = d.pop("Q")
        worst = max(worst, check_ssd(
            f"{label} {tuple(d.values())} Q={Q} x f32, B/C bf16", Q,
            ssd_case(210, **d, x_dtype=f32, bc_dtype=bf16)))
    d = dict(K3_FULL, b=2, l=512)
    Q = d.pop("Q")
    # phase 9's float32 model: B and C split too
    worst = max(worst, check_ssd(
        f"full width {tuple(d.values())} all f32", Q,
        ssd_case(212, **d, x_dtype=f32, bc_dtype=f32)))
    # widths another pruning ratio leaves: 16-byte rows (p 40, n 48), and
    # rows off the 16-byte grid (p 11, n 13), copied element by element
    worst = max(worst, check_ssd(
        "odd width (2, 512, 8, 40, 48) Q=128 x f32, B/C bf16", 128,
        ssd_case(213, 2, 512, 8, 40, 48, x_dtype=f32, bc_dtype=bf16)))
    worst = max(worst, check_ssd(
        "odd width (1, 256, 4, 11, 13) Q=64 bf16", 64,
        ssd_case(214, 1, 256, 4, 11, 13, x_dtype=bf16, bc_dtype=bf16)))
    # a head of 128: two items a warp, so C is read after M is whole
    worst = max(worst, check_ssd(
        "wide head (1, 256, 4, 128, 64) Q=128 x f32, B/C bf16", 128,
        ssd_case(215, 1, 256, 4, 128, 64, x_dtype=f32, bc_dtype=bf16)))
    # dt in [1, 4] with A down to -16: dt·|A|·Q reaches 8192, so exp above
    # the diagonal would overflow; the kernel must select it away
    worst = max(worst, check_ssd(
        f"large dt (dt 1..4, A -1..-16, Q={Q}), finite", Q,
        ssd_case(220, **d, x_dtype=f32, bc_dtype=bf16, dt_lo=1.0,
                 dt_span=3.0, model_A=True)))
    # Hymba-1.5B's SSD heads (phase 12): 50 x 64 with state 16, B/C bf16
    # and (its float32 twin) f32, and the widths pruning at 0.5 leaves
    for i, (label, h, p, n, bc) in enumerate((
            ("hymba", 50, 64, 16, bf16), ("hymba", 50, 64, 16, f32),
            ("hymba pruned", 25, 32, 8, bf16))):
        worst = max(worst, check_ssd(
            f"{label} (2, 2048, {h}, {p}, {n}) Q=128 x f32, B/C "
            f"{str(bc)[6:]}", 128,
            ssd_case(230 + i, 2, 2048, h, p, n, x_dtype=f32, bc_dtype=bc)))
    return worst


def ssd_work(b, l, h, p, n, rows, x_dtype, bc_dtype) -> dict:
    """Bytes and operations of one scan taken ``rows`` rows at a time, and
    the least times they allow.  Bytes: x read and y written once, dt, A,
    B, C read once.  Operations, over the lower triangle i >= j of each
    piece of ``rows`` only (above it M is 0 by definition): C Bᵀ once per
    (batch, piece) — B and C carry no head axis — and per (batch, head,
    piece) M x, C stateᵀ and the state update.  The scan's result does not
    depend on where the pieces fall; M x and C Bᵀ grow with ``rows``, the
    others do not, so one row at a time needs the fewest.  ``old_s``
    prices C Bᵀ at the peak of B/C's type and the rest at the f32 CUDA
    cores' 67 TFLOP/s (the bound of the CUDA-core design); ``tc_s`` prices
    each product by the split-TF32 passes it needs at 495 TFLOP/s (C Bᵀ one
    bf16 pass at 989 when B/C are bf16; M x three passes, two for bf16 x;
    C stateᵀ and the update two, three for f32 B/C)."""
    x_bytes = torch.tensor([], dtype=x_dtype).element_size()
    bc_bytes = torch.tensor([], dtype=bc_dtype).element_size()
    nbytes = 2 * b * l * h * p * x_bytes + 2 * b * l * n * bc_bytes \
        + b * l * h * 4 + h * 4
    tri, chunks = rows * (rows + 1) // 2, b * (l // rows)
    cb = chunks * 2 * tri * n
    diag = chunks * h * 2 * tri * p
    off = upd = chunks * h * 2 * rows * n * p
    bc16 = bc_dtype == torch.bfloat16
    old_s = cb / PEAK_FLOPS[bc_dtype] + (diag + off + upd) / 67e12
    passes = {"cb": 1 if bc16 else 3,
              "diag": 2 if x_dtype == torch.bfloat16 else 3,
              "off": 2 if bc16 else 3, "upd": 2 if bc16 else 3}
    tc_s = (cb / PEAK_FLOPS[torch.bfloat16] if bc16 else 3 * cb / PEAK_TF32) \
        + (passes["diag"] * diag + passes["off"] * off
           + passes["upd"] * upd) / PEAK_TF32
    return {"bytes": nbytes, "flops_cb": cb, "flops_diag": diag,
            "flops_off": off, "flops_update": upd, "passes": passes,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "old_ms": old_s * 1e3, "tc_ms": tc_s * 1e3}


def time_k3(iters: int = 10) -> dict:
    """K3 and its plain version at the full-width shape of the main path's
    forward and at two pruned shapes (x f32, B/C bf16), interleaved plain,
    kernel, kernel, plain by CUDA events, and the profiler's device time
    per call; the bound (``ssd_work``) at one row at a time, beside the
    tensor-core time of the kernel's own sub-chunks and the old bound of
    the CUDA-core design (whole chunks)."""
    res = {}
    for label, sh in (("full", K3_FULL), ("pruned", K3_PRUNED),
                      ("pruned odd", K3_PRUNED_ODD)):
        d = dict(sh)
        Q = d.pop("Q")
        args = ssd_case(230, **d, x_dtype=torch.float32,
                        bc_dtype=torch.bfloat16)
        sub = k3.sub_chunk(Q)
        smem = k3.smem_bytes(Q, d["p"], d["n"], False, True)
        y = k3.ssd_scan_kernel(*args, Q)
        plain_y = k3.ssd_scan_ref(*args, Q)
        torch.cuda.synchronize()
        max_err = float((y - plain_y).abs().max())
        kern = lambda i: k3.ssd_scan_kernel(*args, Q)
        plain = lambda i: k3.ssd_scan_ref(*args, Q)
        plain_a = time_ms(plain, iters=3, warmup=1)
        kern_a = time_ms(kern, iters=iters)
        kern_b = time_ms(kern, iters=iters)
        plain_b = time_ms(plain, iters=3, warmup=1)
        device = kernel_device_ms(kern, "ssd_scan_kernel", iters)
        kw = dict(x_dtype=torch.float32, bc_dtype=torch.bfloat16)
        work = ssd_work(**d, rows=1, **kw)
        at_sub = ssd_work(**d, rows=sub, **kw)
        old = ssd_work(**d, rows=Q, **kw)["old_ms"]
        bound = max(work["tc_ms"], work["bytes_ms"])
        r = {"ms": (kern_a + kern_b) / 2, "plain_ms": (plain_a + plain_b) / 2,
             "device_ms": device, "max_abs_err": max_err, "sub_chunk": sub,
             "smem_bytes": smem, "bound_ms": bound,
             "bound_by": "bytes" if work["bytes_ms"] >= work["tc_ms"]
             else "operations", **work, "tc_ms_at_sub_chunk": at_sub["tc_ms"],
             "old_ms": old}
        res[label] = r
        dev_txt = "not measured" if device is None else f"{device:.4f} ms"
        print(f"  ssd_scan {label} {tuple(d.values())} Q={Q} (sub-chunks of "
              f"{sub}, {smem} bytes of shared memory): device {dev_txt} | "
              f"events {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
              f"library none | bound {bound:.4f} ms ({r['bound_by']}): "
              f"{work['bytes'] / 1e6:.1f} MB at 3.35 TB/s = "
              f"{work['bytes_ms']:.4f} ms, tensor cores a row at a time "
              f"{work['tc_ms']:.4f} ms, in sub-chunks of {sub} "
              f"{at_sub['tc_ms']:.4f} ms (passes {work['passes']}); old "
              f"bound (f32 CUDA cores, chunks of {Q}) {old:.4f} ms | max abs "
              f"err {max_err:.2e}", flush=True)
        if device is not None:
            print(f"    share of the bound {bound / device:.1%}, of the old "
                  f"bound {max(old, work['bytes_ms']) / device:.1%}",
                  flush=True)
        del args, y, plain_y
        torch.cuda.empty_cache()
    full = res["full"]
    return {
        "name": "ssd_scan", "route": "cuda", "source": K3_SOURCE,
        "replaces": K3_REPLACES, "launches": 0,
        "max_abs_err": full["max_abs_err"], "ms": full["ms"],
        "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"], "library_ms": None,
        "device_ms": full["device_ms"],
        "bound_ms_cuda_cores": max(full["old_ms"], full["bytes_ms"]),
        "shape": dict(K3_FULL, x="float32", bc="bfloat16"),
        "peak": "TF32 495 TFLOP/s, bf16 989 TFLOP/s, HBM 3.35 TB/s; old "
                "bound: f32 CUDA cores 67 TFLOP/s",
        "full": full, "pruned": res["pruned"],
        "pruned_odd": res["pruned odd"],
    }


# ---------------------------------------------------------------------------
# Phase 9: Mamba-2 prune then serve, at full width
# ---------------------------------------------------------------------------

def n_params(tree) -> int:
    """Parameters held by a tree of tensors, counted from the tensors."""
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    return tree.numel()


def f32_tree(tree):
    """The same nesting of tensors, in float32."""
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    return tree.float()


def first_layers(params, n: int):
    """The parameters of a model cut to its first ``n`` layers (views of the
    stacked layer tensors)."""
    out = dict(params)
    out["layers"] = tf._tree_map(lambda a: a[:n], params["layers"])
    return out


# bf16 checks at a depth where rounding has not grown yet.  Layer by layer,
# each SSD block gets the same bf16 input on K3 and on the plain scan; both
# round f32 scans that agree to ~1e-6 to bf16, so where a rounding falls
# differently an output is one bf16 step apart: max|Δ| / max|plain| is held
# to 2^-7.  The model cut to its first SHALLOW_LAYERS layers is served in
# bf16; its forward on K3 vs the plain one, and every served token's
# teacher-forced shortfall, are held to two bf16 steps of the largest logit
# (2^-6 · max|logit|): at this depth the plain version's own rounding
# spread (chunk 64 vs 128) is one step, by 4 layers it is seven.
BF16_BLOCK_TOL = 2.0 ** -7
SHALLOW_LAYERS = 2
BF16_SHALLOW_TOL = 2.0 ** -6


def blocks_vs_plain(model, params) -> dict:
    """Every layer's SSD block on K3 against the plain scan, on the input
    the plain forward gives that layer (2 x 512 tokens): max|Δ| / max|plain|
    per layer.  Launches K3 once per layer."""
    cfg = model.cfg
    plain = cfg.replace(use_kernels=False)
    toks = model.dummy_batch(2, 512, seed=12)["tokens"]
    errs = []
    with torch.no_grad():
        h = params["tok_embed"][toks.long()]
        for lp in tf.unstack_layers(params, cfg.num_layers)["layers"]:
            hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
            a = ssm_block(lp["ssm"], cfg, hn)
            b = ssm_block(lp["ssm"], plain, hn)
            if not torch.isfinite(a).all():
                raise AssertionError(f"{cfg.dtype} SSD block on K3, layer "
                                     f"{len(errs)}: non-finite output")
            errs.append(ssd_rel(a, b))
            h = h + b
    return {"max_rel": max(errs), "worst_layer": int(np.argmax(errs)),
            "per_layer": errs}


def forward_vs_plain(model, params, seq: int = 512,
                     f32_twin: bool = False) -> dict:
    """``Model.forward`` on the kernels (K3; K2 too for a hybrid) against the
    plain versions (``use_kernels=False``) on 2 x ``seq`` tokens: the max
    logit difference, beside the same plain forward with SSM chunk 64
    instead of 128 — a change of rounding only, which measures how far this
    model's logits move under rounding alone.  ``f32_twin`` adds the
    distance (max and mean) of each from the plain float32 forward of the
    same weights, which says which of the two rounds further."""
    batch = model.dummy_batch(2, seq, seed=11)
    cfg = model.cfg
    with torch.no_grad():
        a = model.forward(params, batch).float()
        b = build(cfg.replace(use_kernels=False)).forward(params,
                                                          batch).float()
        c = build(cfg.replace(use_kernels=False, ssm_chunk=64)).forward(
            params, batch).float()
        f = None if not f32_twin else build(cfg.replace(
            dtype="float32", use_kernels=False)).forward(
                f32_tree(params), batch).float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{cfg.dtype} forward on K3: non-finite logits")
    res = {"k3_vs_plain": float((a - b).abs().max()),
           "plain_vs_plain_chunk64": float((b - c).abs().max()),
           "plain_max_abs": float(b.abs().max()),
           "argmax_agreement_k3_plain": float(
               (a.argmax(-1) == b.argmax(-1)).float().mean()),
           "argmax_agreement_plain_chunk64": float(
               (b.argmax(-1) == c.argmax(-1)).float().mean())}
    if f is not None:
        for name, x in (("kernels", a), ("plain", b)):
            res[f"{name}_vs_f32_max"] = float((x - f).abs().max())
            res[f"{name}_vs_f32_mean"] = float((x - f).abs().mean())
    return res


def serve_and_force(model, params, reqs, scfg) -> dict:
    """Serve ``reqs`` through the engine, then feed every served sequence
    through ``Model.forward`` (which runs K3) and measure, per emitted token,
    how far its logit falls short of the forward's maximum.  The shared
    prefix of a third of the prompts must alias nothing: the recurrent
    family's prefix gate is off."""
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, params, scfg)
    out, stats = eng.run(reqs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    gen = reqs[0]["max_new_tokens"]
    if len(out) != len(reqs) or any(len(r.tokens) != gen
                                    for r in out.values()):
        raise AssertionError("not every request finished with its tokens")
    if eng.cache_host.prefix_hits or stats["cow_copies"] or \
            eng.cache_host.allocator.total_allocated < sum(
                -(-(len(r["prompt"]) + gen - 1) // scfg.block_size)
                for r in reqs):
        raise AssertionError("a block was shared: prefix caching must be "
                             "off for the ssm family")
    gaps = [teacher_forced_gap(model, params, out[r]) for r in sorted(out)]
    return {"requests": len(out), "gen": gen, "wall_s": stats["wall_s"],
            "steps": stats["steps"], "decode_calls": stats["decode_calls"],
            "prefill_calls": stats["prefill_calls"],
            "decode_tok_per_s": stats["decode_tok_per_s"],
            "total_tok_per_s": stats["total_tok_per_s"],
            "mean_ttft_s": stats["mean_ttft_s"],
            "prefix_hits": eng.cache_host.prefix_hits,
            "peak_mem_bytes": peak,
            "teacher_forced_shortfall": max(g for g, _ in gaps),
            "argmax_agreement": float(np.mean([m for _, m in gaps])),
            "forced_forwards": len(gaps)}


def check_mamba2(label, model, params, reqs, scfg) -> tuple[dict, int]:
    """Forward and serve checks of one model: in bf16 (the deployment type)
    layer by layer and at full depth, in bf16 cut to its first
    SHALLOW_LAYERS layers, and in float32 on the same weights.  At random
    init this deep model amplifies rounding (one bf16 step in an early
    layer grows to logit moves of ~2 by the last), so at full depth in bf16
    the forward is held against the plain version's own rounding spread; the
    sharp bf16 checks run where rounding has not grown (each block alone,
    and the shallow model), and at full depth the sharp checks (phases 4
    and 7's teacher-forcing criterion) run in float32, where one rounding
    is ~1e-7.  Returns (results, K3 launches these checks make)."""
    res = {}
    cfg = model.cfg
    m32 = build(cfg.replace(dtype="float32"))
    p32 = f32_tree(params)
    n = SHALLOW_LAYERS
    shallow = build(cfg.replace(num_layers=n))
    p_sh = first_layers(params, n)
    blocks = blocks_vs_plain(model, params)
    print(f"  {label} bfloat16 layer by layer: SSD block on K3 vs plain, "
          f"2 x 512 tokens, max|Δ|/max|plain| {blocks['max_rel']:.2e} "
          f"(layer {blocks['worst_layer']}; tol {BF16_BLOCK_TOL:.2e}, one "
          f"bf16 step)", flush=True)
    launches = cfg.num_layers
    for name, m, p in (("bfloat16", model, params),
                       (f"bfloat16 first {n} layers", shallow, p_sh),
                       ("float32", m32, p32)):
        fwd = forward_vs_plain(m, p)
        r = serve_and_force(m, p, reqs, scfg)
        r["forward"] = fwd
        res[name] = r
        launches += m.cfg.num_layers * (1 + r["forced_forwards"])
        print(f"  {label} {name}: forward on K3 vs plain, 2 x 512 tokens: "
              f"max logit diff {fwd['k3_vs_plain']:.4f} (plain vs plain at "
              f"chunk 64: {fwd['plain_vs_plain_chunk64']:.4f}), argmax "
              f"agreement {fwd['argmax_agreement_k3_plain']:.3f} "
              f"({fwd['argmax_agreement_plain_chunk64']:.3f}) | served "
              f"{r['requests']} x {r['gen']} tokens in {r['wall_s']:.2f}s, "
              f"decode {r['decode_tok_per_s']:.1f} tok/s, prefill+decode "
              f"{r['total_tok_per_s']:.1f} tok/s, mean TTFT "
              f"{r['mean_ttft_s'] * 1e3:.1f} ms, {r['steps']:.0f} steps "
              f"({r['decode_calls']:.0f} decode, {r['prefill_calls']:.0f} "
              f"prefill calls), prefix hits {r['prefix_hits']}, peak "
              f"{r['peak_mem_bytes'] / 2**30:.2f} GiB | teacher forcing vs "
              f"Model.forward (K3): max logit shortfall "
              f"{r['teacher_forced_shortfall']:.4f}, argmax agreement "
              f"{r['argmax_agreement']:.3f}", flush=True)
    res["bfloat16_blocks"] = blocks
    bf, sh, f32 = res["bfloat16"], res[f"bfloat16 first {n} layers"], \
        res["float32"]
    sh_tol = BF16_SHALLOW_TOL * sh["forward"]["plain_max_abs"]
    print(f"  {label} bfloat16 first {n} layers: limit on K3 vs plain logits "
          f"and on the teacher-forced shortfall {BF16_SHALLOW_TOL:g} x "
          f"max|logit| {sh['forward']['plain_max_abs']:.3f} = {sh_tol:.4f}",
          flush=True)
    if blocks["max_rel"] > BF16_BLOCK_TOL:
        raise AssertionError(f"{label} bf16: SSD block on K3 vs plain "
                             f"{blocks['max_rel']} > {BF16_BLOCK_TOL} at "
                             f"layer {blocks['worst_layer']}")
    if max(sh["forward"]["k3_vs_plain"],
           sh["teacher_forced_shortfall"]) > sh_tol:
        raise AssertionError(f"{label} bf16, {n} layers: K3 vs plain logits "
                             f"{sh['forward']['k3_vs_plain']} or teacher-"
                             f"forced shortfall "
                             f"{sh['teacher_forced_shortfall']} > {sh_tol} "
                             f"(two bf16 steps of the largest logit)")
    # full depth, bf16: within twice the plain version's own rounding
    # spread; float32: K3 and the served tokens held as tightly as phases 4
    # and 7 hold bf16
    if bf["forward"]["k3_vs_plain"] > \
            2 * bf["forward"]["plain_vs_plain_chunk64"] + 0.05:
        raise AssertionError(f"{label} bf16: K3 vs plain beyond twice the "
                             f"rounding spread: {bf['forward']}")
    if f32["forward"]["k3_vs_plain"] > 0.02:
        raise AssertionError(f"{label} float32: K3 vs plain logits differ "
                             f"by {f32['forward']['k3_vs_plain']} > 0.02")
    if f32["teacher_forced_shortfall"] > 0.05:
        raise AssertionError(f"{label} float32: teacher-forced shortfall "
                             f"{f32['teacher_forced_shortfall']} > 0.05")
    del m32, p32, shallow, p_sh
    torch.cuda.empty_cache()
    return res, launches


MAMBA2_LAYERS = 24


def phase_mamba2_path(rng, quick: bool) -> dict:
    print("phase 9: main path of the ssm family — mamba2-1.3b served, "
          "SPA-pruned (L1) and OBSPA-pruned (K4), each served again; "
          "teacher forcing through K3", flush=True)
    # cut to MAMBA2_LAYERS of its 48 layers (full width) since phase 12
    # joined the script, to keep it within its time (PERF.md §5)
    cfg = get_config("mamba2-1.3b").replace(
        num_layers=4 if quick else MAMBA2_LAYERS)
    L = cfg.num_layers
    model = build(cfg)
    t0 = time.time()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    print(f"  model: {cfg.name} L={L} d={cfg.d_model} ssm heads "
          f"{cfg.ssm_n_heads} x head_dim {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, conv {cfg.ssm_conv}, chunk {cfg.ssm_chunk}, "
          f"V={cfg.vocab_size}, tied, {cfg.dtype}; {n_params(params)} "
          f"parameters; init {time.time() - t0:.2f}s", flush=True)
    scfg = ServeConfig(max_seqs=16, block_size=16, max_len=640,
                       chunk_size=128)
    n_req, gen = (6, 8) if quick else (16, 32)
    res = {"model": cfg.name, "layers": L, "params": n_params(params),
           "serve_config": dataclasses.asdict(scfg)}
    t_path = time.time()
    k3.reset_launches()                      # counts = this path's only
    k4.reset_launches()
    reset_launches()
    expected = 0
    dense_model, dense_params = model, params
    calib = batches(cfg, "datafree", 4, 4, 512, seed=5)
    for label in ("dense", "pruned", "obspa"):
        if label == "obspa":
            pr, rep = obspa_on_card(dense_model, dense_params, calib)
            pc = pr.cfg
            rep["pruned_cfg"] = {"ssm_heads": pc.ssm_n_heads,
                                 "ssm_head_dim": pc.ssm_head_dim,
                                 "ssm_state": pc.ssm_state,
                                 "params": n_params(pr.params)}
            print_prune("obspa prune", {"ssm_heads": cfg.ssm_n_heads,
                                        "ssm_head_dim": cfg.ssm_head_dim,
                                        "ssm_state": cfg.ssm_state,
                                        "params": res["params"]},
                        rep["pruned_cfg"], rep)
            # the CPU test's reduced pins (8, 16, 16) -> (4, 8, 8), scaled
            if (pc.ssm_n_heads, pc.ssm_head_dim, pc.ssm_state) != (
                    K3_PRUNED["h"], K3_PRUNED["p"], K3_PRUNED["n"]) or \
                    pc.d_model != cfg.d_model:
                raise AssertionError(f"unexpected OBSPA-pruned config {pc}")
            if rep["k4_launches"] != obspa_blocks(cfg):
                raise AssertionError(f"K4 launches {rep['k4_launches']} != "
                                     f"{obspa_blocks(cfg)} column blocks")
            res["obspa_prune"] = rep
            model, params = build(pc), pr.params
            del pr
        if label == "pruned":
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            pr = prune_model(model, params, 0.5, criterion="l1")
            torch.cuda.synchronize()
            prune_s = time.time() - t0
            pc = pr.cfg
            want = dict(h=pc.ssm_n_heads, p=pc.ssm_head_dim, n=pc.ssm_state)
            if want != {k: K3_PRUNED[k] for k in want} or \
                    pc.d_model != cfg.d_model:
                raise AssertionError(f"unexpected pruned config {pc} (phase "
                                     f"8 checked K3 at {K3_PRUNED})")
            res["prune"] = {
                "ratio": 0.5, "criterion": "l1", "wall_s": prune_s,
                "seconds": pr.report["seconds"],
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "pruned_cfg": {"ssm_heads": pc.ssm_n_heads,
                               "ssm_head_dim": pc.ssm_head_dim,
                               "ssm_state": pc.ssm_state,
                               "params": n_params(pr.params)},
                "groups_pruned": pr.report["groups_pruned"]}
            print(f"  pruned config: ssm heads {cfg.ssm_n_heads}->"
                  f"{pc.ssm_n_heads}, head_dim {cfg.ssm_head_dim}->"
                  f"{pc.ssm_head_dim}, state {cfg.ssm_state}->"
                  f"{pc.ssm_state}, d_model {pc.d_model} kept; params "
                  f"{res['params']}->{res['prune']['pruned_cfg']['params']}"
                  f" | prune_model "
                  f"{prune_s:.2f}s: " + " | ".join(
                      f"{k} {v:.3f}s" for k, v in
                      pr.report["seconds"].items())
                  + f" | peak memory "
                  f"{res['prune']['peak_mem_bytes'] / 2**30:.2f} GiB",
                  flush=True)
            model, params = build(pc), pr.params
            del pr
        reqs = make_requests(rng, cfg.vocab_size, n_req, gen, 128, 512, 256)
        res[label], n = check_mamba2(label, model, params, reqs, scfg)
        expected += n
    torch.cuda.synchronize()
    del dense_model, dense_params
    launches = k3.launch_count()
    res["wall_s"] = time.time() - t_path
    res["k3_launches"] = launches
    res["k1_launches"] = launch_counts()["total"]
    res["k4_launches"] = k4.launch_count()
    if res["k4_launches"] != res["obspa_prune"]["k4_launches"]:
        raise AssertionError("K4 launched outside the OBSPA prune")
    if launches != expected or res["k1_launches"]:
        raise AssertionError(f"K3 launches {launches} != {expected} (one per "
                             f"layer of every forward on the card, one per "
                             f"block checked), or K1 launched "
                             f"({res['k1_launches']}) by an attention-free "
                             f"model")
    print(f"  mamba2 path {res['wall_s']:.2f}s wall; K3 launches {launches} "
          f"= one per layer of every forward and per block checked",
          flush=True)
    del model, params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 10: the flash-attention kernel (K2) vs its plain version
# ---------------------------------------------------------------------------

# (B, S, H, KH, D, DV, causal, window, dtype): the reference's six test
# shapes (tests/test_kernels.py::test_flash_attention), the main path's
# (phase 11: TinyLlama at 8 x 512), its OBSPA / SPA-pruned form, a length
# that is not a multiple of the 64-row tile, a window, bidirectional, f32
# at model width, and the widest heads the kernel takes; then the bf16
# shapes of the tensor-core instance: D = DV 128, the widest heads (D 256 /
# DV 200), head dims that are not multiples of 16 (D 48 / DV 20, and D 20,
# whose 40-byte rows take the narrow copy path), a long causal sequence and
# a window at S 1024
K2_MAIN = (8, 512, 32, 4, 64, 64, True, 0, torch.bfloat16)
K2_SHAPES = [
    (2, 128, 4, 2, 32, 32, True, 0, torch.float32),
    (1, 200, 4, 1, 64, 48, True, 0, torch.float32),
    (2, 128, 8, 8, 32, 32, False, 0, torch.float32),
    (1, 256, 4, 2, 32, 32, True, 64, torch.float32),
    (1, 128, 2, 2, 64, 64, True, 0, torch.bfloat16),
    (1, 96, 4, 4, 16, 16, True, 32, torch.bfloat16),
    K2_MAIN,
    (8, 512, 16, 2, 64, 32, True, 0, torch.bfloat16),
    (2, 333, 32, 4, 64, 64, True, 0, torch.bfloat16),
    (2, 512, 32, 4, 64, 64, True, 100, torch.bfloat16),
    (2, 300, 32, 4, 64, 64, False, 0, torch.bfloat16),
    (2, 333, 32, 4, 64, 64, True, 0, torch.float32),
    (1, 130, 2, 1, 256, 200, True, 0, torch.float32),
    (2, 512, 8, 2, 128, 128, True, 0, torch.bfloat16),
    (1, 130, 2, 1, 256, 200, True, 0, torch.bfloat16),
    (2, 200, 4, 2, 48, 20, True, 0, torch.bfloat16),
    (1, 100, 4, 1, 20, 20, False, 0, torch.bfloat16),
    (1, 2048, 32, 4, 64, 64, True, 0, torch.bfloat16),
    (2, 1024, 32, 4, 64, 64, True, 256, torch.bfloat16),
]
# q, k and v as views that start one element into their storage: rows off
# the 16-byte grid, which the narrow copy path reads
K2_OFFSET_SHAPES = [
    (2, 256, 8, 2, 64, 64, True, 0, torch.bfloat16),
    (1, 200, 4, 1, 48, 20, False, 0, torch.bfloat16),
]
# Hymba-1.5B's attention (phase 12): G = 5, one head a block; its window of
# 1024 at S 2048 (key tiles wholly below a row's window are skipped) and
# its global layers; the float32 twin; the heads pruning at 0.5 leaves
K2_HYMBA_SHAPES = [
    (2, 2048, 25, 5, 64, 64, True, 1024, torch.bfloat16),
    (2, 2048, 25, 5, 64, 64, True, 0, torch.bfloat16),
    (2, 2048, 25, 5, 64, 64, True, 1024, torch.float32),
    (2, 2048, 15, 3, 64, 32, True, 1024, torch.bfloat16),
]


# qwen2-moe-a2.7b's attention (phase 13): 16 heads of 128 over 16 KV heads
# (G = 1: one head a block), at phase 13's 2 x 1600 tokens; the float32
# twin; the heads pruning at 0.5 leaves (8 over 8, DV 64)
K2_MOE = (2, 1600, 16, 16, 128, 128, True, 0, torch.bfloat16)
K2_MOE_SHAPES = [
    K2_MOE,
    (2, 1600, 16, 16, 128, 128, True, 0, torch.float32),
    (2, 1600, 8, 8, 128, 64, True, 0, torch.bfloat16),
]


# hubert-xlarge's attention (phase 15): bidirectional, 16 heads of 80 over
# 16 KV heads (G = 1: one head a block; D 80 is five k16 steps, DV 80 takes
# the 128-column accumulator) at B 4 x ~1000 frames (20 s of 50 Hz audio;
# not a multiple of the 64-row tile); the float32 twin; the heads and DV
# that pruning at 0.5 leaves (8 heads, DV 40); and vit-mini's f32 shape
# (8 heads of 32, 196 patches, batch 32) on the CUDA-core instance
K2_HUBERT = (4, 1000, 16, 16, 80, 80, False, 0, torch.bfloat16)
K2_ENCODER_SHAPES = [
    K2_HUBERT,
    (2, 1000, 16, 16, 80, 80, False, 0, torch.float32),
    (4, 1000, 8, 8, 80, 40, False, 0, torch.bfloat16),
    (32, 196, 8, 8, 32, 32, False, 0, torch.float32),
]


def k2_case(seed, B, S, H, KH, D, DV, dtype, offset: int = 0):
    """q, k, v in model layout (B, S, heads, dim) on the card, standard
    normal from a seeded generator, rounded to ``dtype``; with ``offset``
    each is a view that starts ``offset`` elements into its storage."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    out = []
    for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, DV)):
        x = torch.randn(shape, generator=gen, device=DEV).to(dtype)
        if offset:
            buf = torch.zeros(x.numel() + offset, dtype=dtype, device=DEV)
            view = buf[offset:].view(shape)
            view.copy_(x)
            x = view
        out.append(x)
    return out


def k2_label(B, S, H, KH, D, DV, causal, window, dtype) -> str:
    mask = ("causal" if causal else "bidir") + (f" w{window}" if window
                                                 else "")
    return (f"B{B} S{S} H{H} KH{KH} D{D} DV{DV} {mask} "
            f"{str(dtype).replace('torch.', '')}")


def plan_text(pl) -> str:
    if pl.instance == "cuda_core":
        return "CUDA cores"
    return (f"wgmma DV tile {pl.dv_tile}, "
            f"{'cp.async 16 B' if pl.vec16 else 'narrow copy'}, "
            f"{pl.heads} head{'s' if pl.heads > 1 else ''} a block")


def phase_k2_checks() -> float:
    """K2 against its plain version at every shape, each on the instance
    ``plan`` picks (every bf16 shape on tensor cores); returns the largest
    absolute errors at the main path's shape and at hubert-xlarge's."""
    print("phase 10: flash-attention kernel (K2) vs plain PyTorch version",
          flush=True)
    main_err = hubert_err = 0.0
    cases = [(s, 0) for s in K2_SHAPES] + [(s, 1) for s in K2_OFFSET_SHAPES] \
        + [(s, 0) for s in K2_HYMBA_SHAPES] + [(s, 0) for s in K2_MOE_SHAPES] \
        + [(s, 0) for s in K2_ENCODER_SHAPES]
    for i, (shape, offset) in enumerate(cases):
        B, S, H, KH, D, DV, causal, window, dt = shape
        q, k, v = k2_case(300 + i, B, S, H, KH, D, DV, dt, offset)
        pl = k2.plan(q, k, v)
        want = "wgmma" if dt == torch.bfloat16 else "cuda_core"
        if pl.instance != want or (offset and pl.vec16):
            raise AssertionError(f"K2 plan {pl} for {shape}, offset {offset}")
        out = k2.flash_attention_kernel(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        ref = k2.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = (out.float() - ref.float()).abs()
        over = excess_over_tol(err, ref)
        ok = over <= 0 and bool(torch.isfinite(out.float()).all())
        label = k2_label(*shape) + (f" +{offset}" if offset else "")
        print(f"  {label:47s} [{plan_text(pl)}] max_abs_err "
              f"{float(err.max()):.3e} (tol {tol_text(dt)}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"K2 {label}: error exceeds {tol_text(dt)} "
                                 f"by {over} or non-finite output")
        if shape == K2_MAIN and not offset:
            main_err = float(err.max())
        if shape == K2_HUBERT:
            hubert_err = float(err.max())
    return main_err, hubert_err


def ptxas_kernels(log: str) -> list[dict]:
    """Each entry function of a ``ptxas -v`` log: its (demangled) name,
    registers, spill stores and loads, and the ptxas warnings about it."""
    out: list[dict] = []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            out.append({"name": ln.split("'")[1],
                        "mangled": ln.split("'")[1], "registers": None,
                        "spill_bytes": None, "stack_bytes": None,
                        "warnings": []})
        elif not out:
            continue
        elif "spill stores" in ln:
            w = ln.replace(",", " ").split()
            out[-1]["spill_bytes"] = (int(w[w.index("spill") - 2])
                                      + int(w[w.index("loads") - 3]))
            if "stack" in w:
                out[-1]["stack_bytes"] = int(w[w.index("stack") - 2])
        elif "Used " in ln and " registers" in ln:
            out[-1]["registers"] = int(ln.split("Used ")[1].split()[0])
        elif "warning" in ln.lower():
            out[-1]["warnings"].append(ln.strip())
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(k["name"] for k in out),
                               capture_output=True, text=True).stdout
        for k, n in zip(out, names.splitlines()):
            k["name"] = n.replace("(anonymous namespace)::", "")
    return out


def build_report(name: str, label: str) -> dict:
    """A kernel library's instances as ptxas built them (registers, spills,
    stack) and, where ``cuobjdump`` exists, the count of tensor-core
    instructions (HGMMA: wgmma; HMMA: mma.sync) in its SASS, per instance
    and in all."""
    lib = _build.library_path(name)
    log = lib.with_suffix(".log")
    kernels = ptxas_kernels(log.read_text()) if log.exists() else []
    sass, per_fn = {}, {}
    dump = shutil.which("cuobjdump") or (
        str(Path(_build.find_nvcc()).parent / "cuobjdump"))
    if Path(dump).exists():
        text = subprocess.run([dump, "-sass", str(lib)], capture_output=True,
                              text=True).stdout
        sass = {op: len(re.findall(rf"\b{op}\.", text))
                for op in ("HGMMA", "HMMA")}
        # per function: "Function : <mangled name>" opens its code
        parts = re.split(r"Function : (\S+)", text)
        per_fn = {name: {op: len(re.findall(rf"\b{op}\.", body))
                         for op in ("HGMMA", "HMMA")}
                  for name, body in zip(parts[1::2], parts[2::2])}
    for k in kernels:
        k["sass"] = per_fn.get(k["mangled"])
        ops = ("" if k["sass"] is None else
               f", {k['sass']['HGMMA']} HGMMA, {k['sass']['HMMA']} HMMA")
        print(f"  {label} {k['name']}: {k['registers']} registers, "
              f"{k['spill_bytes']} bytes spilled, {k['stack_bytes']} bytes "
              f"of stack{ops}"
              + "".join(f"\n      {w}" for w in k["warnings"]), flush=True)
    if not kernels:
        print(f"  {label} ptxas log: not found (library built by an earlier "
              f"run)", flush=True)
    if sass:
        print(f"  {label} SASS ({Path(dump).name}): {sass['HGMMA']} HGMMA "
              f"(wgmma), {sass['HMMA']} HMMA (mma.sync) instructions",
              flush=True)
    else:
        print("  cuobjdump: not on this machine, SASS not counted",
              flush=True)
    return {"kernels": kernels, "sass": sass}


# the K1 / K2 instances a path picks.  Phase 13's qwen2-moe: bf16 split-KV
# decode and wgmma prefill at DV 128 (dense) and 64 (pruned), K2's wgmma
# instance at the same DV tiles with 16-byte copies.  Phase 15's
# hubert-xlarge: K2's wgmma instance at DV tile 128 for D = DV 80 (48 of
# its 128 accumulator columns padding) and 64 for the pruned DV 40; the
# minis' f32 CUDA-core instance at DV 32
PATH_INSTANCES = {
    "qwen2-moe": {
        "K1": (r"paged_attention_decode_mma_kernel<__nv_bfloat16, (128|64)>",
               r"paged_attention_kernel_wgmma<__nv_bfloat16, (128|64)>"),
        "K2": (r"flash_attention_kernel_wgmma<(128|64), true>",)},
    "hubert-xlarge": {
        "K2": (r"flash_attention_kernel_wgmma<128, true>",
               r"flash_attention_kernel_wgmma<64, true>",
               r"flash_attention_kernel<1>")},
}


def path_instances(report: dict, label: str, path: str = "qwen2-moe"
                   ) -> list[dict]:
    """The instances of ``PATH_INSTANCES[path][label]`` in a library's build
    report, printed with their registers, spills and stack; raises when one
    spills or a pattern matches no instance."""
    ks = report["kernels"]
    if not ks:
        return []
    out = []
    for pat in PATH_INSTANCES[path][label]:
        found = [k for k in ks if re.search(pat, k["name"])]
        if not found:
            raise AssertionError(f"{label}: no instance matches {pat}")
        out += found
    for k in out:
        print(f"  {path} path {label} {k['name'].split('(')[0]}: "
              f"{k['registers']} registers, {k['spill_bytes']} bytes "
              f"spilled, {k['stack_bytes']} bytes of stack", flush=True)
    spilled = [k["name"] for k in out if k["spill_bytes"]]
    if spilled:
        raise AssertionError(f"{label} instances of the {path} path "
                             f"spill registers: {spilled}")
    return [{"name": k["name"].split("(")[0], "registers": k["registers"],
             "spill_bytes": k["spill_bytes"],
             "stack_bytes": k["stack_bytes"]} for k in out]


def build_summary(report: dict) -> dict:
    """A library's build in a few numbers, for the kernels line (the
    instance by instance report goes on a line of its own)."""
    ks = report["kernels"]
    regs = [k["registers"] for k in ks if k["registers"] is not None]
    return {"instances": len(ks),
            "registers": [min(regs), max(regs)] if regs else None,
            "with_spills": [k["name"] for k in ks if k["spill_bytes"]],
            "sass": report["sass"]}


def live_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks let through, per (batch, head)."""
    qi = np.arange(Sq)
    hi = np.minimum(qi, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qi - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def k2_work(B, S, H, KH, D, DV, causal, window, dtype) -> tuple[int, int]:
    """(bytes, flops) of one call: q, k, v read and out written once; 2·D
    flops for q·k and 2·DV for p·v per live pair."""
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = B * S * (H * D + KH * D + KH * DV + H * DV) * esz
    return nbytes, 2 * (D + DV) * B * H * live_pairs(S, S, causal, window)


def gpu_clocks() -> dict:
    """SM clock, its maximum, power draw and temperature now
    (``nvidia-smi``)."""
    keys = ("clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(keys)}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    vals = [float(x) for x in out.splitlines()[0].split(",")]
    return dict(zip(("sm_mhz", "max_sm_mhz", "power_w", "temp_c"), vals))


def spread(xs) -> str:
    return f"median {np.median(xs):.4f} ms (range {min(xs):.4f}-{max(xs):.4f})"


def time_k2(iters: int = 20, rounds: int = 6, shape=None) -> dict:
    """K2, its plain version and one ``scaled_dot_product_attention`` call
    (K/V expanded to every query head outside the timed region: a yardstick
    only; at G = 1 it is the ``enable_gqa`` call) at a path's ``shape``
    (the main path's by default), rotating over four inputs so that each
    call finds the L2 cold, as a layer of the model does.  K2 and SDPA take
    turns over ``rounds`` rounds, the SM clock, power and temperature read
    before and after each; K2's profiler device time beside its event
    time; plain, kernel, kernel, plain; and the f32 (CUDA-core) instance at
    the same shape in f32."""
    shape = shape or K2_MAIN
    B, S, H, KH, D, DV, causal, window, dt = shape
    n_rot = 4
    cases = [k2_case(400 + i, B, S, H, KH, D, DV, dt) for i in range(n_rot)]
    lib = [(q.transpose(1, 2).contiguous(),
            k.transpose(1, 2).repeat_interleave(H // KH, 1).contiguous(),
            v.transpose(1, 2).repeat_interleave(H // KH, 1).contiguous())
           for q, k, v in cases]
    out = k2.flash_attention_kernel(*cases[0], causal=causal)
    ref = k2.flash_attention_ref(*cases[0], causal=causal)
    lib_out = F.scaled_dot_product_attention(*lib[0], is_causal=causal)
    torch.cuda.synchronize()
    max_err = float((out.float() - ref.float()).abs().max())
    lib_err = float((lib_out.transpose(1, 2).float() - ref.float()).abs()
                    .max())
    kern = lambda i: k2.flash_attention_kernel(  # noqa: E731
        *cases[i % n_rot], causal=causal)
    plain = lambda i: k2.flash_attention_ref(  # noqa: E731
        *cases[i % n_rot], causal=causal)
    libf = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        *lib[i % n_rot], is_causal=causal)
    plain_a = time_ms(plain, iters=5, warmup=1)
    rounds_ = []
    for r in range(rounds):
        before = gpu_clocks()
        ka = time_ms(kern, iters=iters)
        la = time_ms(libf, iters=iters)
        rounds_.append({"k2_ms": ka, "library_ms": la, "before": before,
                        "after": gpu_clocks()})
    plain_b = time_ms(plain, iters=5, warmup=1)
    device = kernel_device_ms(kern, "flash_attention_kernel", iters)
    k_ms = [x["k2_ms"] for x in rounds_]
    l_ms = [x["library_ms"] for x in rounds_]
    kern_ms = float(np.median(k_ms))
    nbytes, flops = k2_work(*shape)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dt] * 1e3
    bound = max(t_bytes, t_flops)
    # the unchanged f32 instance at the same shape, in f32
    c32 = [[x.float() for x in c] for c in cases[:2]]
    k32 = lambda i: k2.flash_attention_kernel(  # noqa: E731
        *c32[i % 2], causal=causal)
    f32_ms = time_ms(k32, iters=5, warmup=1)
    f32_device = kernel_device_ms(k32, "flash_attention_kernel", 5)
    del c32
    clocks = [c for x in rounds_ for c in (x["before"], x["after"])]
    entry = {
        "name": "flash_attention", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": 0, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": (plain_a + plain_b) / 2,
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "library_ms": float(np.median(l_ms)),
        "instance": plan_text(k2.plan(*cases[0])),
        "shape": {"B": B, "S": S, "H": H, "KH": KH, "D": D, "DV": DV,
                  "causal": causal, "window": window, "dtype": "bfloat16"},
        "bytes": nbytes, "flops": flops, "device_ms": device,
        "event_over_device": None if device is None else kern_ms / device,
        "share_of_bound": bound / (device or kern_ms),
        "rounds": rounds_, "f32_ms": f32_ms, "f32_device_ms": f32_device,
        "library_max_abs_err_vs_plain": lib_err,
    }
    print(f"  flash_attention B{B} S{S} H{H} KH{KH} D{D} DV{DV} "
          f"{'causal' if causal else 'bidirectional'} bf16 "
          f"[{entry['instance']}], {rounds} alternating rounds of {iters} "
          f"calls:", flush=True)
    for i, x in enumerate(rounds_):
        b_, a_ = x["before"], x["after"]
        print(f"    round {i}: K2 {x['k2_ms']:.4f} ms | SDPA "
              f"{x['library_ms']:.4f} ms | SM clock {b_['sm_mhz']:.0f} -> "
              f"{a_['sm_mhz']:.0f} MHz (max {b_['max_sm_mhz']:.0f}), power "
              f"{b_['power_w']:.0f} -> {a_['power_w']:.0f} W, "
              f"{b_['temp_c']:.0f} -> {a_['temp_c']:.0f} C", flush=True)
    dev_txt = "not measured" if device is None else f"{device:.4f} ms"
    f32_dev_txt = ("not measured" if f32_device is None
                   else f"{f32_device:.4f} ms")
    print(f"  K2 {spread(k_ms)} | SDPA {spread(l_ms)} | K2 device time per "
          f"launch (profiler) {dev_txt}"
          + ("" if device is None else
             f", event / device {kern_ms / device:.3f}")
          + f" | plain {entry['plain_ms']:.4f} ms | bound {bound:.5f} ms "
          f"({entry['bound_by']}: {nbytes / 1e6:.2f} MB at 3.35 TB/s = "
          f"{t_bytes:.5f} ms; {flops / 1e9:.3f} GFLOP at 989 TFLOP/s = "
          f"{t_flops:.5f} ms) -> {100 * entry['share_of_bound']:.1f} % of "
          f"bound | max abs err {max_err:.2e} | f32 instance (CUDA cores, "
          f"same shape in f32) {f32_ms:.4f} ms, device {f32_dev_txt}",
          flush=True)
    del cases, lib
    torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# Phase 11: train, prune any time, fine-tune, at full width
# ---------------------------------------------------------------------------

# Phase 11's knobs: a pool of 8 batches of 8 x 512 tokens of the "id"
# Markov task, cycled by every training run (40 steps, 5 epochs; 20 to
# fine-tune), lr 3e-4.  Forty steps of 4096 fresh tokens cannot learn a
# 32000 x 32000 chain (on an H100, 40 distinct batches at lr 1e-3 moved the
# held-out loss 10.860 -> 10.812), so training is judged on the pool it
# saw; one held-out batch is reported beside it.
ANY_TIME = dict(batch=8, seq=512, pool=8, steps=40, ft_steps=20, lr=3e-4)
# Dense training must lower the loss on seen batches by this many nats
DENSE_MARGIN = 1.0


class Warm:
    """A model whose ``init`` returns given parameters (a warm start for
    ``Trainer``, as the reference's examples build one)."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params

    def init(self, seed, device):
        return self.params


def eval_loss(model, params, evalb, plain: bool = False) -> float:
    """Mean ``Model.loss`` over ``evalb`` under ``torch.no_grad()``: on the
    card that is K2 (one launch per layer per batch), or with ``plain`` the
    model's plain attention."""
    m = build(model.cfg.replace(use_kernels=False)) if plain else model
    with torch.no_grad():
        return float(np.mean([float(m.loss(params, b)[0]) for b in evalb]))


def train(model, batches_, lr: float) -> tuple[dict, dict]:
    """One step of ``repro_torch.train.Trainer`` per batch, on the card from
    ``model.init``; returns (params, record of the run)."""
    steps = len(batches_)
    torch.cuda.reset_peak_memory_stats()
    oc = OptConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                   total_steps=steps)
    res = Trainer(model, oc, TrainerConfig(total_steps=steps, log_every=1)
                  ).train(iter(batches_))
    step_s = [r["step_s"] for r in res.history[1:]]      # the first warms up
    first = batches_[0]
    if "frames" in first:
        unit, n = "frames", first["frames"].shape[0] * first["frames"].shape[1]
    elif "tokens" in first:
        unit, n = "tokens", first["tokens"].numel()
    else:
        unit, n = "images", first["images"].shape[0]
    losses = [r["loss"] for r in res.history]
    quarter = max(len(losses) // 4, 1)
    rec = {"steps": steps, "lr": lr,
           "train_loss_first": losses[0], "train_loss_last": losses[-1],
           "train_loss_first_quarter": float(np.mean(losses[:quarter])),
           "train_loss_last_quarter": float(np.mean(losses[-quarter:])),
           "step_ms_median": 1e3 * float(np.median(step_s)),
           "first_step_ms": 1e3 * res.history[0]["step_s"],
           f"{unit}_per_s": n / float(np.median(step_s)),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "straggler_events": len(res.straggler_events)}
    params = res.params
    del res                             # m, v and the error state go
    torch.cuda.empty_cache()
    return params, rec


def restart_drill(seed: int) -> dict:
    """``run_with_restarts`` with a failure injected at step 13 of 25
    (checkpoints every 10 steps, zlib) against an uninterrupted run, at the
    reduced TinyLlama on the card.  CUDA's embedding backward adds with
    atomics, in no fixed order, so the two runs are held to a tolerance:
    the same final loss within 1e-3 relative, and no parameter further
    apart than 2·lr per step after the restart (AdamW moves a weight by at
    most about lr a step)."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    m = build(cfg)
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=25)

    def factory(start):
        def gen():
            i = start
            while True:
                yield batches(cfg, "id", 1, 8, 32, seed=seed + i)[0]
                i += 1
        return gen()

    with tempfile.TemporaryDirectory() as td:
        tc = TrainerConfig(total_steps=25, ckpt_dir=os.path.join(td, "a"),
                           ckpt_every=10, log_every=5, fail_at_step=13)
        res = run_with_restarts(m, oc, tc, factory)
        tc2 = TrainerConfig(total_steps=25, ckpt_dir=os.path.join(td, "b"),
                            ckpt_every=10, log_every=5)
        res2 = Trainer(m, oc, tc2).train(factory(0))
    d = max(float((a.float() - b.float()).abs().max()) for (_, a), (_, b)
            in zip(tree_paths(res.params), tree_paths(res2.params)))
    l1, l2 = res.history[-1]["loss"], res2.history[-1]["loss"]
    out = {"resumed_from": res.resumed_from, "max_param_diff": d,
           "param_diff_limit": 2 * oc.lr * 15, "final_loss": l1,
           "final_loss_uninterrupted": l2}
    print(f"  restart drill (reduced, 25 steps, failure at 13, checkpoint "
          f"every 10): resumed from {res.resumed_from}, final loss {l1:.6f} "
          f"vs uninterrupted {l2:.6f}, max param diff {d:.2e} (limit "
          f"{out['param_diff_limit']:g})", flush=True)
    if res.resumed_from != 10 or abs(l1 - l2) > 1e-3 * abs(l2) or \
            d > out["param_diff_limit"]:
        raise AssertionError(f"restart drill: {out}")
    return out


def phase_any_time(quick: bool, seed: int) -> dict:
    """The paper's three regimes (``examples/prune_any_time.py``) on
    full-width TinyLlama through the port's trainer and pruners; every
    evaluation is a no-grad ``Model.loss`` on K2, held against the plain
    attention."""
    print("phase 11: train, prune any time, fine-tune — tinyllama-1.1b "
          "through repro_torch.train.Trainer; every evaluation on K2",
          flush=True)
    cfg = get_config("tinyllama-1.1b")
    at = dict(ANY_TIME)
    if quick:
        cfg = cfg.replace(num_layers=4)
        at.update(steps=10, ft_steps=5)
    L = cfg.num_layers
    model = build(cfg)
    res: dict = {"model": cfg.name, "layers": L, "config": at,
                 "dense_margin": DENSE_MARGIN}

    # one Markov task (a 32000 x 32000 float64 transition matrix on the
    # host), every batch drawn from it: the training pool, a held-out batch
    # and SNIP's gradient batch
    t0 = time.time()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    data = batches(cfg, "id", at["pool"] + 2, at["batch"], at["seq"],
                   seed=seed + 77)
    res["data"] = {"seconds": time.time() - t0, "batches": len(data),
                   "host_peak_rss_gib_before": rss0 / 2**20,
                   "host_peak_rss_gib_after": resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss / 2**20}
    pool, heldout, grad_b = data[:at["pool"]], data[-2], data[-1]
    train_b = [pool[i % len(pool)] for i in range(at["steps"])]
    evalb = pool[:2] + [heldout]         # two seen batches, one held out
    print(f"  data: {len(data)} 'id' batches of {at['batch']} x {at['seq']} "
          f"tokens in {res['data']['seconds']:.1f}s (the vocab x vocab task "
          f"matrix on the host; peak RSS "
          f"{res['data']['host_peak_rss_gib_before']:.1f} -> "
          f"{res['data']['host_peak_rss_gib_after']:.1f} GiB)", flush=True)

    k2.reset_launches()                 # counts = this path's only
    k4.reset_launches()
    evals = []                          # every evaluation's losses

    def evaluate(label, m, p) -> dict:
        """Losses on the seen batches and on the held-out one, on K2 and
        on the plain attention."""
        r = {}
        evals.append(r)
        before = k2.launch_count()
        for key, bs in (("", evalb[:2]), ("_heldout", evalb[2:])):
            r["k2" + key] = eval_loss(m, p, bs)
            r["plain" + key] = eval_loss(m, p, bs, plain=True)
        diff = max(abs(r["k2"] - r["plain"]),
                   abs(r["k2_heldout"] - r["plain_heldout"]))
        r["k2_launches"] = k2.launch_count() - before
        print(f"  {label:34s} loss on K2 {r['k2']:.5f} (held out "
              f"{r['k2_heldout']:.5f}) | plain {r['plain']:.5f} "
              f"({r['plain_heldout']:.5f}) | max diff {diff:.2e} | K2 "
              f"launches {r['k2_launches']}", flush=True)
        return r

    def f32_spread(p) -> float:
        """Mean over every evaluated token of |CE on the plain bf16 model -
        CE on its float32 twin|: how far rounding alone moves a token's
        loss.  The kernel only keeps one rounding (p in f32 before PV) that
        the plain bf16 path makes, so the mean loss on K2 stays within this
        of the plain one (|mean Δ| <= mean |Δ|)."""
        m32 = build(cfg.replace(dtype="float32", use_kernels=False))
        mbf = build(cfg.replace(use_kernels=False))
        p32 = f32_tree(p)
        with torch.no_grad():
            return float(np.mean([float((token_nll(mbf, p, b)
                                         - token_nll(m32, p32, b)).abs()
                                        .mean()) for b in evalb]))

    init = model.init(seed=seed)
    res["dense_init"] = evaluate("dense at init", model, init)
    spreads = [f32_spread(init)]

    # prune-train: SPA-SNIP at init on one gradient batch, then train
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    snip = prune_model(model, init, 0.5, criterion="snip", grads_batch=grad_b)
    torch.cuda.synchronize()
    r = {"prune_s": time.time() - t0, "prune_seconds": snip.report["seconds"],
         "prune_peak_mem_bytes": torch.cuda.max_memory_allocated(),
         "pruned_cfg": pruned_dims(snip.cfg)}
    sm = build(snip.cfg)
    r["rf_rp"] = rf_rp(model, init, sm, snip.params, evalb[0])
    r["after_prune"] = evaluate("prune-train: SNIP at init", sm,
                                snip.params)
    p_pt, r["train"] = train(Warm(snip.cfg, snip.params), train_b,
                             at["lr"])
    r["after_train"] = evaluate("prune-train: trained", sm, p_pt)
    res["prune_train"] = r
    del snip, p_pt

    # dense training (shared by the next two regimes)
    dense, res["dense_train"] = train(Warm(cfg, init), train_b, at["lr"])
    res["dense_trained"] = evaluate("dense trained", model, dense)
    spreads.append(f32_spread(dense))

    # train-prune-finetune: SPA-L1 after training, then fine-tune
    t0 = time.time()
    l1 = prune_model(model, dense, 0.5, criterion="l1")
    torch.cuda.synchronize()
    lm = build(l1.cfg)
    r = {"prune_s": time.time() - t0, "pruned_cfg": pruned_dims(l1.cfg),
         "rf_rp": rf_rp(model, dense, lm, l1.params, evalb[0])}
    r["after_prune"] = evaluate("train-prune-finetune: L1", lm, l1.params)
    p_ft, r["finetune"] = train(Warm(l1.cfg, l1.params),
                                train_b[:at["ft_steps"]], at["lr"])
    r["after_finetune"] = evaluate("train-prune-finetune: tuned", lm, p_ft)
    res["train_prune_finetune"] = r
    del l1                              # p_ft drafts in phase 11b

    # train-prune: OBSPA after training, data-free calibration, no tuning
    calib = batches(cfg, "datafree", 4, 4, 512, seed=5)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ob = obspa_prune(model, dense, 0.5, calib, calib_mode="datafree")
    torch.cuda.synchronize()
    om = build(ob.cfg)
    r = {"prune_s": time.time() - t0, "prune_seconds": ob.report["seconds"],
         "prune_peak_mem_bytes": torch.cuda.max_memory_allocated(),
         "pruned_cfg": pruned_dims(ob.cfg),
         "rf_rp": rf_rp(model, dense, om, ob.params, evalb[0])}
    r["after_prune"] = evaluate("train-prune: OBSPA (datafree)", om,
                                ob.params)
    res["train_prune_obspa"] = r

    torch.cuda.synchronize()
    res["k2_launches"] = k2.launch_count()
    res["k4_launches"] = k4.launch_count()
    res["k2_launches_expected"] = L * len(evalb) * len(evals)
    res["tolerance"] = max(spreads)
    res["f32_spreads"] = spreads
    for key in ("prune_train", "train_prune_finetune", "train_prune_obspa"):
        rr = res[key].get("rf_rp")
        if rr:
            print(f"  {key}: RF {rr['RF']:.4f} RP {rr['RP']:.4f} "
                  f"(params {rr['params_before']} -> {rr['params_after']})",
                  flush=True)
    for key in ("prune_train", "dense_train", "train_prune_finetune"):
        t = res[key].get("train") or res[key].get("finetune") or res[key]
        print(f"  {key} training: {t['steps']} steps, median step "
              f"{t['step_ms_median']:.1f} ms ({t['tokens_per_s']:.0f} "
              f"tokens/s; first step {t['first_step_ms']:.0f} ms), train "
              f"loss {t['train_loss_first']:.4f} -> "
              f"{t['train_loss_last']:.4f}, peak "
              f"{t['peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)
    d = res["dense_train"]
    print(f"  dense training with remat={cfg.remat} (every layer recomputed "
          f"in the backward pass): median step {d['step_ms_median']:.1f} ms, "
          f"peak {d['peak_mem_bytes'] / 2**30:.2f} GiB (no remat, the same "
          f"task on an H100 80GB HBM3 at 700 W: 326.6 ms, 63.07 GiB)",
          flush=True)
    res["remat"] = cfg.remat
    print(f"  K2 launches {res['k2_launches']} (expected {L} layers x "
          f"{len(evalb)} batches x {len(evals)} evaluations = "
          f"{res['k2_launches_expected']}) | K4 launches "
          f"{res['k4_launches']} | K2 vs plain tolerance: mean per-token "
          f"|CE plain bf16 - CE f32 twin| = {res['tolerance']:.2e} (dense at "
          f"init, trained: "
          f"{', '.join(f'{x:.2e}' for x in spreads)})", flush=True)

    losses = [r[k] for r in evals for k in ("k2", "plain", "k2_heldout",
                                            "plain_heldout")]
    diffs = [abs(r["k2" + k] - r["plain" + k]) for r in evals
             for k in ("", "_heldout")]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in phase 11: {losses}")
    if max(diffs) > res["tolerance"]:
        raise AssertionError(f"K2 vs plain losses differ by {max(diffs)} > "
                             f"{res['tolerance']}")
    drop = res["dense_init"]["k2"] - res["dense_trained"]["k2"]
    res["dense_drop"] = drop
    if drop < DENSE_MARGIN:
        raise AssertionError(f"dense training lowered the loss on seen "
                             f"batches by {drop:.4f} < {DENSE_MARGIN}")
    if res["k2_launches"] != res["k2_launches_expected"]:
        raise AssertionError(f"K2 launches {res['k2_launches']} != "
                             f"{res['k2_launches_expected']}")
    blocks = L * (math.ceil(cfg.n_heads * cfg.v_head_dim_ / k4.BLOCK)
                  + math.ceil(cfg.d_ff / k4.BLOCK))
    if res["k4_launches"] != blocks:
        raise AssertionError(f"K4 launches {res['k4_launches']} != {blocks}")
    held = res["dense_init"]["k2_heldout"] - \
        res["dense_trained"]["k2_heldout"]
    print(f"  dense training lowered the loss on seen batches by {drop:.4f} "
          f"nats (margin {DENSE_MARGIN}; held out: {held:.4f})", flush=True)
    # phase 11b serves the trained model with its drafts, on the rows no
    # model trained on: the held-out batch and SNIP's gradient batch
    rows = torch.cat([heldout["tokens"], grad_b["tokens"]])
    res["spec_serve"] = phase_spec_serve(
        model, dense, {"L1+FT": (lm, p_ft), "OBSPA": (om, ob.params)}, rows,
        np.random.default_rng([seed, 11, 2]))
    del ob, dense, init, p_ft
    torch.cuda.empty_cache()
    res["restart_drill"] = restart_drill(seed + 5000)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 11b: self-speculative serving of the trained TinyLlama
# ---------------------------------------------------------------------------

# 16 requests, prompts the first 192-320 tokens of the Markov task's rows that
# no model trained on, 64 new tokens each, K 4, greedy
SPEC = dict(requests=16, gen=64, lo=192, hi=320, k=4)


def spec_tolerance(model, params, recs) -> dict:
    """The teacher-forced limit of the speculative runs, fixed before them
    from the dense-only run's requests: the plain bf16 forward's own
    shortfall against its float32 twin (over every emitted position, the
    float32 logit of the bf16 argmax below the float32 maximum: how far
    bf16 rounding alone moves a choice), plus one bf16 step of the largest
    logit (2^-7 · max|logit|)."""
    cfg = model.cfg
    plain = build(cfg.replace(use_kernels=False))
    twin = build(cfg.replace(dtype="float32", use_kernels=False))
    p32 = f32_tree(params)
    short = top = 0.0
    with torch.no_grad():
        for rec in recs:
            seq = torch.tensor([list(rec.prompt) + list(rec.tokens)],
                               dtype=torch.int32, device=DEV)
            P, n = len(rec.prompt), len(rec.tokens)
            lb = plain.forward(params, {"tokens": seq})[0].float()
            lf = twin.forward(p32, {"tokens": seq})[0].float()[P - 1:P - 1 + n]
            pick = lb[P - 1:P - 1 + n].argmax(1)[:, None]
            short = max(short, float((lf.max(1).values
                                      - lf.gather(1, pick)[:, 0]).max()))
            top = max(top, float(lb.abs().max()))
    del p32
    torch.cuda.empty_cache()
    return {"plain_bf16_vs_f32_shortfall": short, "max_abs_logit": top,
            "limit": short + BF16_BLOCK_TOL * top}


def spec_meter(engine) -> dict:
    """Count the drafting slot-cycles (a slot offered candidates) and the
    tokens they emitted, by wrapping ``Engine._fold_spec``."""
    meter = {"slot_cycles": 0, "tokens": 0}
    fold = engine._fold_spec

    def counted(plan, out, n_acc, spec_meta):
        drafted = [(s, len(s.generated)) for s, n, _ in spec_meta if n]
        fold(plan, out, n_acc, spec_meta)
        meter["slot_cycles"] += len(drafted)
        meter["tokens"] += sum(len(s.generated) - n0 for s, n0 in drafted)

    engine._fold_spec = counted
    return meter


def pool_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def spec_run(label, model, params, reqs, scfg, draft=None, telemetry=None
             ) -> tuple[dict, dict]:
    """Serve ``reqs`` through ``Engine`` (speculative with ``draft``); hold
    the host fetches to the sampling steps and K1's launches to the run's
    counters.  Returns ({rid: result}, record)."""
    torch.cuda.reset_peak_memory_stats()
    kw = {} if draft is None else {"draft_model": draft[0],
                                   "draft_params": draft[1]}
    eng = Engine(model, params, scfg, telemetry=telemetry, **kw)
    if eng.spec_active != (draft is not None):
        raise AssertionError(f"11b {label}: spec_active {eng.spec_active}")
    sampling = count_sampling_steps(eng)
    meter = spec_meter(eng)
    reset_launches()                  # counts = this run's only
    out, st = eng.run([dict(r) for r in reqs])
    torch.cuda.synchronize()
    lc = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if len(out) != len(reqs) or any(len(r.tokens) != reqs[0][
            "max_new_tokens"] for r in out.values()):
        raise AssertionError(f"11b {label}: not every request finished")
    if st["host_syncs"] != sampling[0]:
        raise AssertionError(f"11b {label}: {st['host_syncs']:.0f} host "
                             f"fetches over {sampling[0]} sampling steps")
    L = model.cfg.num_layers
    Ld = draft[0].cfg.num_layers if draft is not None else 0
    K = scfg.spec_k if draft is not None else 0
    dec, pre, cyc = (int(st[k]) for k in ("decode_calls", "prefill_calls",
                                          "spec_cycles"))
    want = {"decode": L * dec + Ld * K * cyc,
            "prefill": L * (pre + cyc) + (Ld * pre if draft else 0)}
    formula = (f"decode {L} x {dec} decode calls + {Ld} x {K} x {cyc} "
               f"draft steps = {want['decode']}; prefill {L} x ({pre} "
               f"prefill + {cyc} verify calls) + {Ld} x {pre if draft else 0}"
               f" draft prefill calls = {want['prefill']}")
    if lc["decode"] != want["decode"] or lc["prefill"] != want["prefill"]:
        raise AssertionError(f"11b {label}: K1 launches {lc} != {formula}")
    rec = {"label": label, "steps": st["steps"], "wall_s": st["wall_s"],
           "decode_tok_per_s": st["decode_tok_per_s"],
           "total_tok_per_s": st["total_tok_per_s"],
           "mean_ttft_s": st["mean_ttft_s"], "host_syncs": st["host_syncs"],
           "sampling_steps": sampling[0], "decode_calls": dec,
           "prefill_calls": pre, "spec_cycles": cyc,
           "spec_proposed": st["spec_proposed"],
           "spec_accepted": st["spec_accepted"],
           "spec_acceptance": st["spec_acceptance"],
           "drafting_slot_cycles": meter["slot_cycles"],
           "tokens_per_slot_cycle": meter["tokens"] / meter["slot_cycles"]
           if meter["slot_cycles"] else 0.0,
           "k1_launches": {"decode": lc["decode"], "prefill": lc["prefill"]},
           "k1_launch_formula": formula, "peak_mem_bytes": peak,
           "target_pool_bytes": pool_bytes(eng.cache),
           "draft_pool_bytes": pool_bytes(eng.draft_cache)
           if eng.spec_active else 0}
    print(f"  11b {label:22s} {st['steps']:.0f} steps | decode "
          f"{st['decode_tok_per_s']:.1f} tok/s | TTFT "
          f"{st['mean_ttft_s'] * 1e3:.1f} ms | acceptance "
          f"{st['spec_acceptance']:.3f} ({st['spec_accepted']:.0f}/"
          f"{st['spec_proposed']:.0f}), {rec['tokens_per_slot_cycle']:.3f} "
          f"tokens a drafting slot-cycle over {cyc} cycles | host fetches "
          f"{st['host_syncs']:.0f} = sampling steps | peak "
          f"{peak / 2**30:.2f} GiB | K1 {lc['decode']} decode / "
          f"{lc['prefill']} prefill launches = {formula}", flush=True)
    del eng
    torch.cuda.empty_cache()
    return out, rec


def phase_spec_serve(model, dense, drafts: dict, rows: torch.Tensor,
                     rng) -> dict:
    """Phase 11b: the trained dense TinyLlama served as the target of its own
    pruned drafts (``drafts``: label -> (model, params)), on ``rows`` that
    no model trained on: (a) dense only, (b) the L1 + fine-tuned draft on a
    bf16 draft pool, twice, (c) the same draft on an int8 draft pool, (d)
    the OBSPA draft, (e) run (b) with telemetry on."""
    print("phase 11b: self-speculative serving of the trained tinyllama-1.1b "
          "(a pruned draft proposes, the dense target verifies)", flush=True)
    t0 = time.time()
    n, gen, K = SPEC["requests"], SPEC["gen"], SPEC["k"]
    lens = rng.integers(SPEC["lo"], SPEC["hi"] + 1, size=n)
    reqs = [{"prompt": rows[i % rows.shape[0], :int(lens[i])].tolist(),
             "max_new_tokens": gen} for i in range(n)]
    base = ServeConfig(max_seqs=n, block_size=16,
                       max_len=SPEC["hi"] + gen + K + 16, chunk_size=128)
    scfg = dataclasses.replace(base, spec_k=K)
    res: dict = {"config": dict(SPEC), "prompt_lens": lens.tolist()}
    k2_0 = k2.launch_count()

    out_a, res["a_dense"] = spec_run("(a) dense only", model, dense, reqs,
                                     base)
    tol = spec_tolerance(model, dense, [out_a[r] for r in sorted(out_a)])
    res["tolerance"] = tol
    print(f"  11b teacher-forced limit, set before the speculative runs: "
          f"plain bf16 vs float32 twin shortfall "
          f"{tol['plain_bf16_vs_f32_shortfall']:.4f} + 2^-7 x max|logit| "
          f"{tol['max_abs_logit']:.3f} = {tol['limit']:.4f}", flush=True)
    l1d, obd = drafts["L1+FT"], drafts["OBSPA"]
    runs = {"b": ("(b) L1+FT, bf16 pool", l1d, "", None),
            "b2": ("(b) again", l1d, "", None),
            "c": ("(c) L1+FT, int8 pool", l1d, "int8", None),
            "d": ("(d) OBSPA, bf16 pool", obd, "", None),
            "e": ("(e) = (b), telemetry on", l1d, "",
                  Telemetry(enabled=True))}
    outs = {"a": out_a}
    for key, (label, d, pool, tel) in runs.items():
        outs[key], res[key] = spec_run(
            label, model, dense, reqs,
            dataclasses.replace(scfg, draft_cache_dtype=pool), d, tel)
    tokens = {k: [o[r].tokens for r in sorted(o)] for k, o in outs.items()}

    # (b)-(d) lossless under teacher forcing through Model.forward (K2);
    # beside the acceptance, the share of emitted positions where the
    # draft's own forward over the final sequence picks the target's
    # token (a first candidate's chance of acceptance)
    drafts_of = {"b": l1d, "c": l1d, "d": obd}
    for key in ("a", "b", "c", "d"):
        gaps, agree = [], []
        for rid in sorted(outs[key]):
            rec = outs[key][rid]
            toks = torch.tensor([list(rec.prompt) + list(rec.tokens)],
                                dtype=torch.int32, device=DEV)
            P, m_ = len(rec.prompt), len(rec.tokens)
            with torch.no_grad():
                lt = model.forward(dense, {"tokens": toks})[0].float()
                gaps.append(forced_gap(lt, rec)[0])
                if key in drafts_of:
                    dm_, dp_ = drafts_of[key]
                    ld = dm_.forward(dp_, {"tokens": toks})[0]
                    agree.append(float((lt[P - 1:P - 1 + m_].argmax(1) ==
                                        ld[P - 1:P - 1 + m_].argmax(1))
                                       .float().mean()))
        r = res[key if key != "a" else "a_dense"]
        r["teacher_forced_shortfall"] = max(gaps)
        if agree:
            r["forced_argmax_agreement"] = float(np.mean(agree))
            print(f"  11b {key}: the draft's forward picks the target's "
                  f"token at {100 * r['forced_argmax_agreement']:.1f} % of "
                  f"the emitted positions (acceptance "
                  f"{r['spec_acceptance']:.3f})", flush=True)
        same = [t == ta for t, ta in zip(tokens[key], tokens["a"])]
        r["identical_to_a"] = float(np.mean(same))
        r["first_divergence"] = [
            next(i for i, (x, y) in enumerate(zip(t, ta)) if x != y)
            for t, ta, eq in zip(tokens[key], tokens["a"], same) if not eq]
        print(f"  11b {key}: teacher-forced shortfall {max(gaps):.4f} (limit "
              f"{tol['limit']:.4f}{', recorded only' if key == 'a' else ''})"
              f" | identical to (a) {100 * r['identical_to_a']:.1f} % of "
              f"requests; first divergence at {r['first_divergence']}",
              flush=True)
        if key != "a" and max(gaps) > tol["limit"]:
            raise AssertionError(f"11b ({key}): teacher-forced shortfall "
                                 f"{max(gaps)} > {tol['limit']}")
    res["k2_launches_teacher_forcing"] = k2.launch_count() - k2_0

    # telemetry is host-only: (e) equals (b) token for token, held to the
    # spread between the two telemetry-off runs of (b)
    spread = sum(x != y for x, y in zip(tokens["b"], tokens["b2"]))
    moved = sum(x != y for x, y in zip(tokens["e"], tokens["b"]))
    res["b_runs_differ_in"] = spread
    res["e_differs_from_b_in"] = moved
    print(f"  11b (b) twice: {spread} of {n} requests differ; (e) with "
          f"telemetry vs (b): {moved} differ", flush=True)
    if moved > spread:
        raise AssertionError(f"11b: telemetry moved {moved} requests' tokens "
                             f"(the two (b) runs differ in {spread})")

    tel = runs["e"][3]
    reg = tel.registry
    phases = {}
    for name in ("step", "plan", "prefill_dispatch", "decode_dispatch",
                 "sync", "fold"):
        h = reg.histograms.get("phase/" + name)
        if h is not None:
            phases[name] = h.summary()
    acc = reg.histograms["spec/accepted_per_cycle"]
    res["e_phases"] = phases
    res["e_accepted_per_cycle"] = {"buckets": list(acc.buckets),
                                   "counts": list(acc.counts),
                                   "summary": acc.summary()}
    print("  11b (e) step phases (per-step host wall, ms): " + " | ".join(
        f"{k} p50 {v['p50'] * 1e3:.2f} mean {v['mean'] * 1e3:.2f} n "
        f"{v['count']}" for k, v in phases.items()), flush=True)
    print(f"  11b (e) accepted drafts per slot-cycle, counts at 0..{K}: "
          f"{acc.counts[:K + 1]} (mean {acc.summary()['mean']:.3f})",
          flush=True)
    bf, i8 = res["b"]["draft_pool_bytes"], res["c"]["draft_pool_bytes"]
    print(f"  11b draft pool {bf / 2**20:.1f} MiB in bf16, {i8 / 2**20:.1f} "
          f"MiB in int8 ({i8 / bf:.3f}x); target pool "
          f"{res['b']['target_pool_bytes'] / 2**20:.1f} MiB", flush=True)
    if not i8 < bf:
        raise AssertionError("11b: the int8 draft pool is not smaller")
    res["seconds"] = time.time() - t0
    print(f"  11b took {res['seconds']:.1f}s", flush=True)
    return res


def token_nll(model, params, batch) -> torch.Tensor:
    """Per-token cross-entropy of next-token prediction, f32 (what
    ``Model.loss`` averages)."""
    logits = model.forward(params, batch)[:, :-1].float()
    tgt = batch["tokens"][:, 1:].long()
    return torch.logsumexp(logits, -1) - logits.gather(-1, tgt[..., None]
                                                       )[..., 0]


def pruned_dims(c) -> dict:
    return {"n_heads": c.n_heads, "n_kv_heads": c.n_kv_heads,
            "head_dim": c.head_dim_, "v_head_dim": c.v_head_dim_,
            "d_ff": c.d_ff, "params": c.param_count()}


# ---------------------------------------------------------------------------
# Phase 12: the hybrid family (Hymba) — K1, K2 and K3 in one model, then L1
# and OBSPA (K4) pruning, each model served and checked again
# ---------------------------------------------------------------------------

# SPA at ratio 0.5 on Hymba-1.5B's structure: KV groups 5 -> 3 (each with its
# G = 5 query heads), v_head_dim 64 -> 32, d_ff 5504 -> 2752, SSM heads
# 50 -> 25, SSM head_dim 64 -> 32, state 16 -> 8 (the same widths for L1
# and OBSPA; phases 3, 8 and 10 check the kernels at them)
HYMBA_PRUNED = dict(n_heads=15, n_kv_heads=3, head_dim=64, v_head_dim=32,
                    d_ff=2752, ssm_heads=25, ssm_head_dim=32, ssm_state=8)
HYBRID_SEQ = 1600           # > the window of 1024: the window cuts


def hybrid_dims(c) -> dict:
    return {"n_heads": c.n_heads, "n_kv_heads": c.n_kv_heads,
            "head_dim": c.head_dim_, "v_head_dim": c.v_head_dim_,
            "d_ff": c.d_ff, "ssm_heads": c.ssm_n_heads,
            "ssm_head_dim": c.ssm_head_dim, "ssm_state": c.ssm_state}


def hybrid_requests(rng, vocab, n, gen, n_long) -> list[dict]:
    """``make_requests`` over prompts of 256-1600 tokens (a third behind a
    shared 256-token prefix, which must alias nothing), then ``n_long`` of
    the independent ones redrawn at 1200-1600 tokens, so that the window
    of 1024 cuts in prefill (a chunk from 1152 on no longer sees block 0)
    and in decode."""
    reqs = make_requests(rng, vocab, n, gen, 256, 1600, 256)
    for i in [j for j in range(n) if j % 3][:n_long]:
        length = int(rng.integers(1200, 1601))
        reqs[i]["prompt"] = rng.integers(0, vocab, size=length).tolist()
    return reqs


class VisitRecorder:
    """Within ``with``, every paged-attention call of the model returns its
    kernel's per-(sequence, kv-head) visit counts beside its output (the
    kernel counts them on every launch; only the return changes), which are
    kept with the call's windows, starts and lengths."""

    def __init__(self):
        from repro_torch.models import attention as attn_mod
        self.mod, self.calls = attn_mod, []

    def __enter__(self):
        self.real = (self.mod.paged_attention,
                     self.mod.paged_prefill_attention)
        decode, prefill = self.real

        def spy_decode(q, k, v, tables, kv_lens, **kw):
            out, visits = decode(q, k, v, tables, kv_lens,
                                 return_visits=True, **kw)
            self.calls.append(("decode", kw["window"], kv_lens - 1, kv_lens,
                               tables.shape[1], k.shape[1], visits))
            return out

        def spy_prefill(q, k, v, tables, starts, kv_lens, **kw):
            out, visits = prefill(q, k, v, tables, starts, kv_lens,
                                  return_visits=True, **kw)
            self.calls.append(("prefill", kw["window"], starts, kv_lens,
                               tables.shape[1], k.shape[1], visits))
            return out
        self.mod.paged_attention = spy_decode
        self.mod.paged_prefill_attention = spy_prefill
        return self

    def __exit__(self, *exc):
        self.mod.paged_attention, self.mod.paged_prefill_attention = \
            self.real

    def check(self, window: int) -> dict:
        """Every call's visits equal ``expected_visits`` at its window; on
        the windowed layers, count the rows whose window skipped blocks
        (fewer visits than ``expected_visits`` without a window)."""
        res = {"calls": len(self.calls), "windowed_calls": 0}
        for entry in ("decode", "prefill"):
            res[f"{entry}_rows_cut"] = 0
            res[f"{entry}_blocks_skipped"] = 0
        for entry, win, starts, lens, NB, bs, visits in self.calls:
            if win not in (0, window):
                raise AssertionError(f"a layer ran window {win}")
            want = expected_visits(starts.cpu(), lens.cpu(), NB, bs, win)
            got = visits.cpu()
            if not torch.equal(got, want[:, None].expand_as(got)):
                raise AssertionError(f"{entry} window {win}: K1 visits differ "
                                     f"from expected_visits")
            if win:
                res["windowed_calls"] += 1
                full = expected_visits(starts.cpu(), lens.cpu(), NB, bs, 0)
                if (want > full).any():
                    raise AssertionError("a window added visits")
                res[f"{entry}_rows_cut"] += int((want < full).sum())
                res[f"{entry}_blocks_skipped"] += int((full - want).sum())
        if not (res["decode_rows_cut"] and res["prefill_rows_cut"]):
            raise AssertionError(f"the window skipped no block: {res}")
        return res


def hybrid_blocks_vs_plain(model, params, seq: int = HYBRID_SEQ) -> dict:
    """Every layer's attention half on K2 and SSD half on K3 against their
    plain versions, on the input the plain forward gives that layer (2 x
    ``seq`` tokens): max|Δ| / max|plain| per layer and half.  Launches K2
    and K3 once per layer each."""
    cfg = model.cfg
    plain = cfg.replace(use_kernels=False)
    toks = model.dummy_batch(2, seq, seed=12)["tokens"]
    pos = torch.arange(seq, dtype=torch.int32, device=DEV)[None].expand(
        2, seq)
    errs = {"attention": [], "ssd": []}
    with torch.no_grad():
        h = params["tok_embed"][toks.long()]
        for i, lp in enumerate(tf.unstack_layers(params,
                                                 cfg.num_layers)["layers"]):
            win = tf.layer_window(cfg, i)
            mode = "sliding" if win else "causal"
            hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
            a = attn_block(lp["attn"], cfg, hn, pos, mode, window=win)
            a_p = attn_block(lp["attn"], plain, hn, pos, mode, window=win)
            s = ssm_block(lp["ssm"], cfg, hn)
            s_p = ssm_block(lp["ssm"], plain, hn)
            if not (torch.isfinite(a).all() and torch.isfinite(s).all()):
                raise AssertionError(f"layer {i}: non-finite K2 / K3 output")
            errs["attention"].append(ssd_rel(a, a_p))
            errs["ssd"].append(ssd_rel(s, s_p))
            h = h + a_p + s_p
            h = h + swiglu(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps))
    return {k: {"max_rel": max(v), "worst_layer": int(np.argmax(v)),
                "per_layer": v} for k, v in errs.items()}


def check_hybrid(label, model, params, reqs, scfg, visits: bool = False
                 ) -> tuple[dict, dict]:
    """The checks of ``check_mamba2`` for a hybrid model: in bf16 each
    layer's attention half (K2) and SSD half (K3) against their plain
    versions, and the full-depth forward against the plain version's own
    rounding spread; the model cut to its first SHALLOW_LAYERS layers
    (layer 0 global, layer 1 windowed) served and held to two bf16 steps of
    its largest logit; the float32 twin at full depth, served and held to
    phases 4 and 7's teacher-forcing criterion.  ``visits`` records K1's
    visit counts in the bf16 full-depth serve.  Returns (results, expected
    launches {"k2", "k3"} of these checks)."""
    res = {}
    cfg = model.cfg
    n = SHALLOW_LAYERS
    blocks = hybrid_blocks_vs_plain(model, params)
    print(f"  {label} bfloat16 layer by layer, 2 x {HYBRID_SEQ} tokens: "
          f"attention on K2 vs plain max|Δ|/max|plain| "
          f"{blocks['attention']['max_rel']:.2e} (layer "
          f"{blocks['attention']['worst_layer']}), SSD on K3 vs plain "
          f"{blocks['ssd']['max_rel']:.2e} (layer "
          f"{blocks['ssd']['worst_layer']}); tol {BF16_BLOCK_TOL:.2e}, one "
          f"bf16 step", flush=True)
    launches = cfg.num_layers
    variants = (("bfloat16", model, params),
                (f"bfloat16 first {n} layers",
                 build(cfg.replace(num_layers=n)), first_layers(params, n)),
                ("float32", build(cfg.replace(dtype="float32")),
                 f32_tree(params)))
    for name, m, p in variants:
        fwd = forward_vs_plain(m, p, seq=HYBRID_SEQ,
                               f32_twin=m.cfg.num_layers == n)
        rec = VisitRecorder() if visits and name == "bfloat16" else None
        if rec is not None:
            with rec:
                r = serve_and_force(m, p, reqs, scfg)
            r["k1_visits"] = rec.check(cfg.sliding_window)
        else:
            r = serve_and_force(m, p, reqs, scfg)
        r["forward"], r["layers"] = fwd, m.cfg.num_layers
        res[name] = r
        launches += m.cfg.num_layers * (1 + r["forced_forwards"])
        print(f"  {label} {name}: forward on K2 + K3 vs plain, 2 x "
              f"{HYBRID_SEQ} tokens: max logit diff {fwd['k3_vs_plain']:.4f}"
              f" (plain vs plain at SSM chunk 64: "
              f"{fwd['plain_vs_plain_chunk64']:.4f}), argmax agreement "
              f"{fwd['argmax_agreement_k3_plain']:.3f} "
              f"({fwd['argmax_agreement_plain_chunk64']:.3f}) | served "
              f"{r['requests']} x {r['gen']} tokens in {r['wall_s']:.2f}s, "
              f"decode {r['decode_tok_per_s']:.1f} tok/s, prefill+decode "
              f"{r['total_tok_per_s']:.1f} tok/s, mean TTFT "
              f"{r['mean_ttft_s'] * 1e3:.1f} ms, {r['steps']:.0f} steps "
              f"({r['decode_calls']:.0f} decode, {r['prefill_calls']:.0f} "
              f"prefill calls), prefix hits {r['prefix_hits']}, peak "
              f"{r['peak_mem_bytes'] / 2**30:.2f} GiB | teacher forcing vs "
              f"Model.forward (K2 + K3): max logit shortfall "
              f"{r['teacher_forced_shortfall']:.4f}, argmax agreement "
              f"{r['argmax_agreement']:.3f}", flush=True)
        if rec is not None:
            print(f"  {label} K1 visits over {r['k1_visits']['calls']} calls "
                  f"equal expected_visits at each layer's window; window "
                  f"{cfg.sliding_window} skipped blocks on "
                  f"{r['k1_visits']['decode_rows_cut']} decode rows and "
                  f"{r['k1_visits']['prefill_rows_cut']} prefill rows "
                  f"({r['k1_visits']['decode_blocks_skipped']} / "
                  f"{r['k1_visits']['prefill_blocks_skipped']} (row, block) "
                  f"visits fewer than without a window)", flush=True)
    res["bfloat16_blocks"] = blocks
    bf, sh, f32 = res["bfloat16"], res[f"bfloat16 first {n} layers"], \
        res["float32"]
    # The shallow model's served tokens are held to phase 9's limit.  Its
    # forward is not: the plain attention rounds P to bf16 before P·V and K2
    # keeps it to ~2^-17, so at 2 layers and 1600 tokens kernels and plain
    # differ by more than two bf16 steps (PERF.md §6: K2 alone makes
    # the difference, and the plain version is the one farther from the
    # float32 twin).  The kernels' logits may move from the plain version's
    # by no more than the plain version's own distance from float32.
    sh_tol = BF16_SHALLOW_TOL * sh["forward"]["plain_max_abs"]
    shf = sh["forward"]
    print(f"  {label} bfloat16 first {n} layers: teacher-forced shortfall "
          f"limit {BF16_SHALLOW_TOL:g} x max|logit| "
          f"{shf['plain_max_abs']:.3f} = {sh_tol:.4f}; forward vs the "
          f"float32 twin: kernels max {shf['kernels_vs_f32_max']:.4f} mean "
          f"{shf['kernels_vs_f32_mean']:.6f} | plain max "
          f"{shf['plain_vs_f32_max']:.4f} mean "
          f"{shf['plain_vs_f32_mean']:.6f}", flush=True)
    worst = max(blocks["attention"]["max_rel"], blocks["ssd"]["max_rel"])
    if worst > BF16_BLOCK_TOL:
        raise AssertionError(f"{label} bf16: a layer's half on its kernel "
                             f"vs plain {worst} > {BF16_BLOCK_TOL}")
    if sh["teacher_forced_shortfall"] > sh_tol:
        raise AssertionError(f"{label} bf16, {n} layers: teacher-forced "
                             f"shortfall {sh['teacher_forced_shortfall']} > "
                             f"{sh_tol}")
    if shf["k3_vs_plain"] > shf["plain_vs_f32_max"]:
        raise AssertionError(f"{label} bf16, {n} layers: kernels vs plain "
                             f"logits {shf['k3_vs_plain']} beyond the plain "
                             f"version's own distance from the float32 twin "
                             f"{shf['plain_vs_f32_max']}")
    if bf["forward"]["k3_vs_plain"] > \
            2 * bf["forward"]["plain_vs_plain_chunk64"] + 0.05:
        raise AssertionError(f"{label} bf16: kernels vs plain beyond twice "
                             f"the rounding spread: {bf['forward']}")
    if f32["forward"]["k3_vs_plain"] > 0.02:
        raise AssertionError(f"{label} float32: kernels vs plain logits "
                             f"differ by {f32['forward']['k3_vs_plain']}")
    if f32["teacher_forced_shortfall"] > 0.05:
        raise AssertionError(f"{label} float32: teacher-forced shortfall "
                             f"{f32['teacher_forced_shortfall']} > 0.05")
    del variants
    torch.cuda.empty_cache()
    # K1: every layer of every device call of the three serves
    k1 = sum(res[name]["layers"] * int(res[name]["decode_calls"]
                                       + res[name]["prefill_calls"])
             for name in ("bfloat16", f"bfloat16 first {n} layers",
                          "float32"))
    return res, {"k1": k1, "k2": launches, "k3": launches}


def obspa_blocks(cfg) -> int:
    """K4 launches of an OBSPA prune at ratio 0.5: one per 128-column block
    of every reconstructed consumer — ``attn.wo`` (K = H·DV) and
    ``mlp.w_down`` (K = d_ff) of an attention layer, ``ssm.w_out`` (K =
    SSM heads · head_dim) of an SSD block."""
    per_layer = 0
    if cfg.family != "ssm":
        per_layer += math.ceil(cfg.n_heads * cfg.v_head_dim_ / k4.BLOCK) \
            + math.ceil(cfg.d_ff / k4.BLOCK)
    if cfg.family == "ssm" or cfg.hybrid:
        per_layer += math.ceil(cfg.ssm_n_heads * cfg.ssm_head_dim / k4.BLOCK)
    return cfg.num_layers * per_layer


def obspa_on_card(model, params, calib, calib_mode: str = "datafree"
                  ) -> tuple:
    """``obspa_prune`` at ratio 0.5 timed (wall, by phase) with its peak
    memory and K4 launches, then every reconstructed consumer's layer-output
    error against plain slicing of the same columns (recorded: at about one
    calibration token per column the method does not promise to beat
    slicing).  Returns (PruneResult, report)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = k4.launch_count()
    t0 = time.time()
    pr = obspa_prune(model, params, 0.5, calib, calib_mode=calib_mode)
    torch.cuda.synchronize()
    first = next(calib[0][k] for k in ("frames", "tokens", "images")
                 if k in calib[0])
    rep = {"ratio": 0.5, "criterion": "obspa",
           "calibration": f"{calib_mode} {len(calib)} x "
                          f"{tuple(first.shape)}",
           "wall_s": time.time() - t0, "seconds": pr.report["seconds"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "k4_launches": k4.launch_count() - before,
           "groups_with_obs": pr.report["groups_with_obs"],
           "groups_total": pr.report["groups_total"]}
    errs = layer_output_errors(model, params, pr, calib)
    # a consumer whose input is zero on every calibration row has no error
    # either way (ratio None) and nothing to reconstruct
    rep["layer_errors"] = {k: {"obspa": e_ob, "slicing": e_cut,
                               "ratio": e_ob / e_cut if e_cut else None}
                           for k, (e_ob, e_cut) in errs.items()}
    rep["all_below_slicing"] = all(e_ob < e_cut or e_ob == e_cut == 0
                                   for e_ob, e_cut in errs.values())
    rep["summed_errors"] = {"obspa": sum(e for e, _ in errs.values()),
                            "slicing": sum(e for _, e in errs.values())}
    return pr, rep


def print_prune(label, before: dict, after: dict, rep):
    """One line of a prune's dims, time by phase, peak memory and K4
    launches; one more of its layer-output errors, by consumer."""
    print(f"  {label}: {before} -> {after} | "
          f"{rep['wall_s']:.2f}s: " + " | ".join(
              f"{k} {v:.3f}s" for k, v in rep["seconds"].items())
          + f" | peak memory {rep['peak_mem_bytes'] / 2**30:.2f} GiB"
          + (f" | K4 launches {rep['k4_launches']}, OBS-scored groups "
             f"{rep['groups_with_obs']} of {rep['groups_total']}"
             if "k4_launches" in rep else ""), flush=True)
    if "layer_errors" in rep:
        by_kind: dict[str, list] = {}
        for name, e in rep["layer_errors"].items():
            if e["ratio"] is not None:
                by_kind.setdefault(name.split("@")[0].split(".", 2)[2],
                                   []).append(e["ratio"])
        print(f"  {label} layer output error ‖X(W-W')‖², OBSPA / plain "
              f"slicing of the same columns: " + ", ".join(
                  f"{k} {min(v):.4f}..{max(v):.4f} ({len(v)})"
                  for k, v in sorted(by_kind.items()))
              + f"; every consumer below slicing: "
              f"{rep['all_below_slicing']}", flush=True)


# phase 12 runs Hymba's first 16 of 32 layers since phase 14 joined the
# script, to keep it within its time; global layers 0 and 15 stay
HYMBA_LAYERS = 16


def phase_hybrid_path(rng, quick: bool) -> dict:
    print("phase 12: the hybrid family — hymba-1.5b served, L1- and "
          "OBSPA-pruned and served again (K1, K2, K3 and K4)", flush=True)
    cfg = get_config("hymba-1.5b").replace(
        num_layers=4 if quick else HYMBA_LAYERS)
    L = cfg.num_layers
    model = build(cfg)
    t0 = time.time()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    windows = [tf.layer_window(cfg, i) for i in range(L)]
    print(f"  model: {cfg.name} L={L} d={cfg.d_model} H={cfg.n_heads} "
          f"KH={cfg.n_kv_heads} hd={cfg.head_dim_} ff={cfg.d_ff} ssm heads "
          f"{cfg.ssm_n_heads} x head_dim {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, V={cfg.vocab_size}, "
          f"window {cfg.sliding_window} on {sum(map(bool, windows))} layers"
          f" (global: {[i for i, w in enumerate(windows) if not w]}), "
          f"{cfg.dtype}; {n_params(params)} parameters; init "
          f"{time.time() - t0:.2f}s", flush=True)
    scfg = ServeConfig(max_seqs=16, block_size=16, max_len=2048,
                       chunk_size=128)
    n_req, gen = (6, 8) if quick else (16, 32)
    res = {"model": cfg.name, "layers": L, "params": n_params(params),
           "serve_config": dataclasses.asdict(scfg)}
    t_path = time.time()
    reset_launches()                         # counts = this path's only
    k2.reset_launches()
    k3.reset_launches()
    k4.reset_launches()
    want = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    calib = batches(cfg, "datafree", 4, 4, 512, seed=5)
    dense_model, dense_params = model, params
    for label in ("dense", "l1", "obspa"):
        if label == "l1":
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            pr = prune_model(dense_model, dense_params, 0.5, criterion="l1")
            torch.cuda.synchronize()
            rep = {"ratio": 0.5, "criterion": "l1",
                   "wall_s": time.time() - t0,
                   "seconds": pr.report["seconds"],
                   "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        elif label == "obspa":
            pr, rep = obspa_on_card(dense_model, dense_params, calib)
            want["k4"] += obspa_blocks(cfg)
        if label != "dense":
            pc = pr.cfg
            rep["pruned_cfg"] = dict(hybrid_dims(pc),
                                     params=n_params(pr.params))
            print_prune(f"{label} prune",
                        dict(hybrid_dims(cfg), params=res["params"]),
                        rep["pruned_cfg"], rep)
            if hybrid_dims(pc) != HYMBA_PRUNED or pc.d_model != cfg.d_model:
                raise AssertionError(f"unexpected pruned config {pc}")
            res[f"{label}_prune"] = rep
            model, params = build(pc), pr.params
            del pr
        reqs = hybrid_requests(rng, cfg.vocab_size, n_req, gen,
                               n_long=2 if quick else 4)
        res[label], n = check_hybrid(label, model, params, reqs, scfg,
                                     visits=label == "dense")
        for k in want:
            want[k] += n.get(k, 0)
    torch.cuda.synchronize()
    k1_counts = launch_counts()
    got = {"k1": k1_counts["total"], "k2": k2.launch_count(),
           "k3": k3.launch_count(), "k4": k4.launch_count()}
    res["wall_s"] = time.time() - t_path
    res["launches"] = dict(got, k1_decode=k1_counts["decode"],
                           k1_prefill=k1_counts["prefill"])
    res["expected_launches"] = want
    print(f"  hybrid path {res['wall_s']:.2f}s wall; launches {got} "
          f"(K1 decode {k1_counts['decode']}, prefill "
          f"{k1_counts['prefill']}); expected {want}", flush=True)
    if got != want or min(got.values()) < 1 or not (
            k1_counts["decode"] and k1_counts["prefill"]):
        raise AssertionError(f"hybrid path launches {got} != {want}")
    del model, params, dense_model, dense_params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 13: the moe family (qwen2-moe-a2.7b) — K1 and K2 at head_dim 128 and
# G = 1, then L1 and OBSPA pruning (K4 over the 60 experts at once), each
# model served again
# ---------------------------------------------------------------------------

# SPA at ratio 0.5 on qwen2-moe-a2.7b's structure: heads 16 -> 8 (G = 1:
# each KV head with its one query head), v_head_dim 128 -> 64, experts 60
# -> 30 (router column and expert weights merged by MOE_HINTS), expert width
# 1408 -> 704, shared width 22528 -> 11264 (the same widths for L1 and
# OBSPA; phases 3 and 10 check K1 and K2 at them)
QWEN2_MOE_PRUNED = dict(n_heads=8, n_kv_heads=8, head_dim=128,
                        v_head_dim=64, n_experts=30, top_k=4, moe_d_ff=704,
                        shared_width=11264)
MOE_SEQ = 1600              # the layer checks' 2 x 1600 tokens
# OBSPA's depth: the prune holds every consumer's Hessian at once, 2.03 GB
# a layer for the shared w_down (K 22528) and 0.48 GB for the 60 experts'
# (K 1408): ~60 GB at 24 layers beside 33.6 GB of weights, ~20 GB at 8
MOE_OBSPA_LAYERS = 8
# the no-drop twin held to the oracle token for token: float32 (in bf16 the
# engine's batched steps and the oracle's one-row steps round apart, which
# flips near-tied argmaxes of random weights), cut to its first 2 layers
MOE_TWIN_LAYERS = 2
# a MoE block in bf16 against its float32 twin: the expert and shared paths
# round to bf16 at four places (gate, up, their product, the down
# projection) but each output is one rounding of an f32 sum of them: two
# bf16 steps of the largest output
MOE_BLOCK_TOL = 2.0 ** -6


def moe_dims(c) -> dict:
    return {"n_heads": c.n_heads, "n_kv_heads": c.n_kv_heads,
            "head_dim": c.head_dim_, "v_head_dim": c.v_head_dim_,
            "n_experts": c.n_experts, "top_k": c.top_k,
            "moe_d_ff": c.moe_d_ff,
            "shared_width": c.n_shared_experts * c.shared_d_ff}


def moe_blocks_vs_plain(model, params, seq: int = MOE_SEQ) -> dict:
    """Every layer's attention on K2 against its plain version, and its MoE
    block in bf16 against the same block in float32 (weights and input cast
    up: the router sees the same f32 input, so both route and drop alike),
    on the input the plain forward gives that layer (2 x ``seq`` tokens):
    max|Δ| / max|reference| per layer, and the real tokens' dropped
    assignments of the two, which must be equal.  Launches K2 once per
    layer."""
    cfg = model.cfg
    plain = cfg.replace(use_kernels=False)
    f32 = cfg.replace(dtype="float32")
    toks = model.dummy_batch(2, seq, seed=12)["tokens"]
    pos = torch.arange(seq, dtype=torch.int32, device=DEV)[None].expand(
        2, seq)
    real = torch.ones((2, seq), dtype=torch.bool, device=DEV)
    errs = {"attention": [], "moe": []}
    drops = []
    with torch.no_grad():
        h = params["tok_embed"][toks.long()]
        for i, lp in enumerate(tf.unstack_layers(params,
                                                 cfg.num_layers)["layers"]):
            hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
            a = attn_block(lp["attn"], cfg, hn, pos, "causal")
            a_p = attn_block(lp["attn"], plain, hn, pos, "causal")
            h = h + a_p
            h2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
            moe_mod.reset_dropped()
            m, _ = moe_mod.moe_block(lp["moe"], cfg, h2, real)
            d_bf = moe_mod.dropped_assignments()
            moe_mod.reset_dropped()
            m32, _ = moe_mod.moe_block(f32_tree(lp["moe"]), f32, h2.float(),
                                       real)
            d_32 = moe_mod.dropped_assignments()
            if not (torch.isfinite(a).all() and torch.isfinite(m).all()):
                raise AssertionError(f"layer {i}: non-finite K2 / MoE output")
            if d_bf != d_32:
                raise AssertionError(f"layer {i}: bf16 and float32 MoE blocks "
                                     f"dropped {d_bf} and {d_32} assignments")
            errs["attention"].append(ssd_rel(a, a_p))
            errs["moe"].append(ssd_rel(m, m32))
            drops.append(d_bf)
            h = h + m
    moe_mod.reset_dropped()
    return dict({k: {"max_rel": max(v), "worst_layer": int(np.argmax(v)),
                     "per_layer": v} for k, v in errs.items()},
                dropped_per_layer=drops, dtype=cfg.dtype, seq=seq,
                assignments_per_layer=2 * seq * cfg.top_k)


def serve_moe(model, params, reqs, scfg) -> dict:
    """Serve ``reqs`` through the engine; every request must finish with its
    tokens, finite.  Counts the real tokens' (token, expert) assignments
    that the capacity dropped, over every layer and step of the serve."""
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, params, scfg)
    moe_mod.reset_dropped()
    out, stats = eng.run(reqs)
    torch.cuda.synchronize()
    drops = moe_mod.dropped_assignments()
    moe_mod.reset_dropped()
    peak = torch.cuda.max_memory_allocated()
    gen = reqs[0]["max_new_tokens"]
    if len(out) != len(reqs) or any(len(r.tokens) != gen
                                    for r in out.values()):
        raise AssertionError("not every request finished with its tokens")
    V = model.cfg.vocab_size
    if any(not 0 <= t < V for r in out.values() for t in r.tokens):
        raise AssertionError("a served token lies outside the vocabulary")
    tokens = stats["prefill_tokens"] + stats["decode_tokens"]
    return {"requests": len(out), "gen": gen, "wall_s": stats["wall_s"],
            "steps": stats["steps"], "decode_calls": stats["decode_calls"],
            "prefill_calls": stats["prefill_calls"],
            "decode_tok_per_s": stats["decode_tok_per_s"],
            "total_tok_per_s": stats["total_tok_per_s"],
            "mean_ttft_s": stats["mean_ttft_s"],
            "prefix_hits": eng.cache_host.prefix_hits,
            "peak_mem_bytes": peak, "layers": model.cfg.num_layers,
            "dropped_assignments": drops,
            "real_assignments": int(tokens * model.cfg.top_k
                                    * model.cfg.num_layers),
            "outputs": {rid: out[rid].tokens for rid in sorted(out)}}


def print_moe_serve(label, r):
    print(f"  {label}: served {r['requests']} x {r['gen']} tokens in "
          f"{r['wall_s']:.2f}s, decode {r['decode_tok_per_s']:.1f} tok/s, "
          f"prefill+decode {r['total_tok_per_s']:.1f} tok/s, mean TTFT "
          f"{r['mean_ttft_s'] * 1e3:.1f} ms, {r['steps']:.0f} steps "
          f"({r['decode_calls']:.0f} decode, {r['prefill_calls']:.0f} "
          f"prefill calls), prefix hits {r['prefix_hits']}, peak "
          f"{r['peak_mem_bytes'] / 2**30:.2f} GiB | dropped assignments "
          f"{r['dropped_assignments']} of {r['real_assignments']} "
          f"({100 * r['dropped_assignments'] / r['real_assignments']:.3f} %)",
          flush=True)


def print_moe_blocks(label, blocks):
    print(f"  {label} {blocks['dtype']} layer by layer, 2 x {blocks['seq']} "
          f"tokens: attention "
          f"on K2 vs plain max|Δ|/max|plain| "
          f"{blocks['attention']['max_rel']:.2e} (layer "
          f"{blocks['attention']['worst_layer']}; tol {BF16_BLOCK_TOL:.2e}, "
          f"one bf16 step) | MoE block vs its float32 twin "
          f"{blocks['moe']['max_rel']:.2e} (layer "
          f"{blocks['moe']['worst_layer']}; tol {MOE_BLOCK_TOL:.2e}) | "
          f"dropped assignments per layer "
          f"{min(blocks['dropped_per_layer'])}.."
          f"{max(blocks['dropped_per_layer'])} of "
          f"{blocks['assignments_per_layer']}", flush=True)
    if blocks["attention"]["max_rel"] > BF16_BLOCK_TOL:
        raise AssertionError(f"{label}: attention on K2 vs plain "
                             f"{blocks['attention']['max_rel']}")
    if blocks["moe"]["max_rel"] > MOE_BLOCK_TOL:
        raise AssertionError(f"{label}: MoE block bf16 vs float32 "
                             f"{blocks['moe']['max_rel']}")


def moe_twin_vs_oracle(model, params, reqs, scfg) -> dict:
    """The no-drop twin (capacity factor n_experts / top_k: every expert
    has a slot for every token) served and each request's tokens held to
    the sequential oracle ``generate`` token for token; no assignment may
    be dropped."""
    r = serve_moe(model, params, reqs, scfg)
    if r["dropped_assignments"]:
        raise AssertionError(f"the no-drop twin dropped "
                             f"{r['dropped_assignments']} assignments")
    t0 = time.time()
    mismatched = []
    for rid, req in enumerate(reqs):
        prompt = torch.tensor([req["prompt"]], dtype=torch.int64, device=DEV)
        want = generate(model, params, prompt, req["max_new_tokens"])
        want = want[0, len(req["prompt"]):].tolist()
        if r["outputs"][rid] != want:
            mismatched.append(rid)
    r["oracle_s"] = time.time() - t0
    r["equal_to_oracle"] = not mismatched
    if mismatched:
        raise AssertionError(f"the no-drop twin's engine differs from the "
                             f"oracle on requests {mismatched}")
    return r


def moe_forced(model, params, reqs, scfg) -> dict:
    """Serve ``reqs`` in a configuration where no assignment can drop (none
    may), and feed every served sequence through ``Model.forward`` on K2
    and on the plain attention: the engine's tokens' teacher-forced
    shortfall against the forward on K2, and the largest logit difference
    between the two forwards — how far these logits move under a change of
    attention rounding alone (the plain version rounds P to bf16), router
    near-ties that flip an expert included."""
    r = serve_moe(model, params, reqs, scfg)
    if r["dropped_assignments"]:
        raise AssertionError(f"a no-drop serve dropped "
                             f"{r['dropped_assignments']} assignments")
    plain = build(model.cfg.replace(use_kernels=False))
    gaps, spread, top = [], 0.0, 0.0
    for rid, req in enumerate(reqs):
        rec = types.SimpleNamespace(prompt=req["prompt"],
                                    tokens=r["outputs"][rid])
        seq = torch.tensor([list(rec.prompt) + list(rec.tokens)],
                           dtype=torch.int32, device=DEV)
        with torch.no_grad():
            a = model.forward(params, {"tokens": seq})[0].float()
            b = plain.forward(params, {"tokens": seq})[0].float()
        gaps.append(forced_gap(a, rec))
        spread = max(spread, float((a - b).abs().max()))
        top = max(top, float(b.abs().max()))
    r.update(teacher_forced_shortfall=max(g for g, _ in gaps),
             argmax_agreement=float(np.mean([m for _, m in gaps])),
             forced_forwards=len(gaps), k2_vs_plain_logits=spread,
             plain_max_abs_logit=top)
    return r


def drop_count_cost(cfg, scfg, step_ms: float) -> dict:
    """CUDA-event time of the drop counter's work in one decode step — one
    ``count_dropped`` a layer at the decode step's shapes — beside the
    serve's mean engine step (``step_ms``)."""
    sizes = [torch.zeros(cfg.n_experts, dtype=torch.int64, device=DEV)]
    C = moe_mod._capacity(cfg, scfg.max_seqs)

    def step(_):
        for _ in range(cfg.num_layers):
            moe_mod.count_dropped(sizes, C)

    ms = time_ms(step, iters=50)
    moe_mod.reset_dropped()
    return {"ms_per_decode_step": ms, "mean_engine_step_ms": step_ms,
            "share": ms / step_ms}


def moe_obspa_blocks(cfg) -> int:
    """K4 launches of an OBSPA prune of a moe model at ratio 0.5: one per
    128-column block of ``attn.wo`` (K = H·DV), of the experts' ``w_down``
    (K = moe_d_ff; all experts in one launch) and of the shared
    ``w_down`` (K = shared width), every layer."""
    per_layer = math.ceil(cfg.n_heads * cfg.v_head_dim_ / k4.BLOCK) \
        + math.ceil(cfg.moe_d_ff / k4.BLOCK) \
        + math.ceil(cfg.n_shared_experts * cfg.shared_d_ff / k4.BLOCK)
    return cfg.num_layers * per_layer


def phase_moe_path(seed: int, quick: bool) -> dict:
    print("phase 13: the moe family — qwen2-moe-a2.7b served, L1- and "
          "OBSPA-pruned and served again (K1, K2 and K4)", flush=True)
    rng = np.random.default_rng([seed, 13, 1])
    cfg = get_config("qwen2-moe-a2.7b")
    if quick:
        cfg = cfg.replace(num_layers=4)
    L = cfg.num_layers
    model = build(cfg)
    t0 = time.time()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    res = {"model": cfg.name, "layers": L, "params": n_params(params),
           "init_s": time.time() - t0}
    print(f"  model: {cfg.name} L={L} d={cfg.d_model} H={cfg.n_heads} "
          f"KH={cfg.n_kv_heads} hd={cfg.head_dim_} experts {cfg.n_experts} "
          f"top-{cfg.top_k} x {cfg.moe_d_ff}, shared {cfg.n_shared_experts} "
          f"x {cfg.shared_d_ff}, capacity factor {cfg.capacity_factor}, "
          f"V={cfg.vocab_size}, {cfg.dtype}; {res['params']} parameters "
          f"(param_count {cfg.param_count()}); init {res['init_s']:.2f}s",
          flush=True)
    if res["params"] != cfg.param_count():
        raise AssertionError("param_count differs from the tensors")
    scfg = ServeConfig(max_seqs=16, block_size=16, max_len=512,
                       chunk_size=128)
    n_req, gen = (6, 8) if quick else (16, 32)
    res["serve_config"] = dataclasses.asdict(scfg)
    t_path = time.time()
    reset_launches()                         # counts = this path's only
    k2.reset_launches()
    k4.reset_launches()
    want = {"k1": 0, "k2": 0, "k4": 0}

    # dense: layer checks, the published-capacity serve, the no-drop twin
    t0 = time.time()
    blocks = moe_blocks_vs_plain(model, params)
    print_moe_blocks("dense", blocks)
    want["k2"] += L
    res["dense_blocks"] = dict(blocks, wall_s=time.time() - t0)
    reqs = make_requests(rng, cfg.vocab_size, n_req, gen, 128, 448, 128)
    r = serve_moe(model, params, reqs, scfg)
    print_moe_serve(f"dense, capacity factor {cfg.capacity_factor}", r)
    want["k1"] += L * int(r["decode_calls"] + r["prefill_calls"])
    res["dense"] = r
    n_twin = min(MOE_TWIN_LAYERS, L)
    twin_cfg = cfg.replace(num_layers=n_twin, dtype="float32",
                           capacity_factor=cfg.n_experts / cfg.top_k)
    twin = build(twin_cfg)
    twin_params = f32_tree(first_layers(params, n_twin))
    twin_reqs = make_requests(rng, cfg.vocab_size, 8, 16, 64, 256, 64)
    r = moe_twin_vs_oracle(twin, twin_params, twin_reqs,
                           dataclasses.replace(scfg, max_seqs=8))
    print_moe_serve(f"no-drop twin (float32, first {n_twin} layers, "
                    f"capacity factor {twin_cfg.capacity_factor:g})", r)
    print(f"  no-drop twin: every request's {r['gen']} tokens equal the "
          f"oracle's (generate, {r['oracle_s']:.2f}s)", flush=True)
    want["k1"] += n_twin * int(r["decode_calls"] + r["prefill_calls"])
    res["no_drop_twin"] = r
    del twin, twin_params
    torch.cuda.empty_cache()
    # bf16 through the engine (K1's bf16 instances) held to Model.forward
    # (K2) by teacher forcing, on the twin's requests: routing is discrete,
    # so the published routing is only read (a near-tie flips an expert
    # between the engine's rounding and the forward's); the all-experts
    # twin (every token to all 60 experts once: no choice, no drop) is held
    # at 2 layers to two bf16 steps of the largest logit, as phase 12 holds
    # its shallow model, and at full depth to twice the forwards' own
    # rounding spread plus 0.05, as phase 9 holds its kernels
    n_sh = min(SHALLOW_LAYERS, L)
    forced = (("published routing", n_sh, cfg.top_k,
               twin_cfg.capacity_factor),
              ("all experts", n_sh, cfg.n_experts, 1.0),
              ("all experts", L, cfg.n_experts, 1.0))
    res["forced_bf16"] = []
    for name, n, k, cf in forced:
        m = build(cfg.replace(num_layers=n, top_k=k, capacity_factor=cf))
        r = moe_forced(m, first_layers(params, n), twin_reqs,
                       dataclasses.replace(scfg, max_seqs=8))
        want["k1"] += n * int(r["decode_calls"] + r["prefill_calls"])
        want["k2"] += n * r["forced_forwards"]
        limit = None if k != cfg.n_experts else (
            BF16_SHALLOW_TOL * r["plain_max_abs_logit"] if n == n_sh
            else 2 * r["k2_vs_plain_logits"] + 0.05)
        r.update(name=name, layers=n, top_k=k, capacity_factor=cf,
                 shortfall_limit=limit)
        print(f"  bfloat16 {name} ({n} layers, top-{k}, capacity factor "
              f"{cf:g}): {r['requests']} x {r['gen']} tokens in "
              f"{r['wall_s']:.2f}s, 0 dropped | teacher forcing vs "
              f"Model.forward (K2): max logit shortfall "
              f"{r['teacher_forced_shortfall']:.4f} ("
              + ("read only" if limit is None else f"limit {limit:.4f}")
              + f"), argmax agreement {r['argmax_agreement']:.3f}; forward "
              f"on K2 vs plain {r['k2_vs_plain_logits']:.4f}, max|logit| "
              f"{r['plain_max_abs_logit']:.3f}", flush=True)
        r.pop("outputs")
        res["forced_bf16"].append(r)
        del m
        if limit is not None and r["teacher_forced_shortfall"] > limit:
            raise AssertionError(f"bf16 {name}, {n} layers: teacher-forced "
                                 f"shortfall {r['teacher_forced_shortfall']}"
                                 f" > {limit}")
    torch.cuda.empty_cache()
    d = res["dense"]
    res["drop_counter"] = drop_count_cost(cfg, scfg,
                                          1e3 * d["wall_s"] / d["steps"])
    print(f"  drop counter: {res['drop_counter']['ms_per_decode_step']:.4f}"
          f" ms a decode step ({L} layers, CUDA events), "
          f"{100 * res['drop_counter']['share']:.2f} % of the dense serve's "
          f"mean step {res['drop_counter']['mean_engine_step_ms']:.2f} ms",
          flush=True)

    # L1 at 0.5, all layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pr = prune_model(model, params, 0.5, criterion="l1")
    torch.cuda.synchronize()
    rep = {"ratio": 0.5, "criterion": "l1", "wall_s": time.time() - t0,
           "seconds": pr.report["seconds"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    pc = pr.cfg
    rep["pruned_cfg"] = dict(moe_dims(pc), params=n_params(pr.params))
    print_prune("l1 prune", dict(moe_dims(cfg), params=res["params"]),
                rep["pruned_cfg"], rep)
    if moe_dims(pc) != QWEN2_MOE_PRUNED or pc.d_model != cfg.d_model \
            or rep["pruned_cfg"]["params"] != pc.param_count():
        raise AssertionError(f"unexpected pruned config {pc}")
    res["l1_prune"] = rep
    l1_model, l1_params = build(pc), pr.params
    del pr
    blocks = moe_blocks_vs_plain(l1_model, l1_params)
    print_moe_blocks("l1", blocks)
    want["k2"] += L
    res["l1_blocks"] = blocks
    reqs = make_requests(rng, cfg.vocab_size, n_req, gen, 128, 448, 128)
    r = serve_moe(l1_model, l1_params, reqs, scfg)
    print_moe_serve("l1-pruned", r)
    want["k1"] += L * int(r["decode_calls"] + r["prefill_calls"])
    res["l1"] = r
    del l1_model, l1_params
    torch.cuda.empty_cache()

    # OBSPA at 0.5, the first MOE_OBSPA_LAYERS layers
    n_ob = min(MOE_OBSPA_LAYERS, L)
    ob_cfg = cfg.replace(num_layers=n_ob)
    ob_model, ob_params = build(ob_cfg), first_layers(params, n_ob)
    calib = batches(ob_cfg, "datafree", 4, 4, 512, seed=5)
    pr, rep = obspa_on_card(ob_model, ob_params, calib)
    want["k4"] += moe_obspa_blocks(ob_cfg)
    pc = pr.cfg
    rep["layers"] = n_ob
    rep["pruned_cfg"] = dict(moe_dims(pc), params=n_params(pr.params))
    print_prune(f"obspa prune (first {n_ob} layers)",
                dict(moe_dims(ob_cfg), params=n_params(ob_params)),
                rep["pruned_cfg"], rep)
    if moe_dims(pc) != QWEN2_MOE_PRUNED or pc.d_model != cfg.d_model:
        raise AssertionError(f"unexpected pruned config {pc}")
    if not rep["all_below_slicing"]:
        raise AssertionError("an OBSPA consumer's layer-output error is not "
                             "below plain slicing")
    res["obspa_prune"] = rep
    ob_model, ob_params = build(pc), pr.params
    del pr
    blocks = moe_blocks_vs_plain(ob_model, ob_params)
    print_moe_blocks("obspa", blocks)
    want["k2"] += n_ob
    res["obspa_blocks"] = blocks
    reqs = make_requests(rng, cfg.vocab_size, n_req, gen, 128, 448, 128)
    r = serve_moe(ob_model, ob_params, reqs, scfg)
    print_moe_serve(f"obspa-pruned ({n_ob} layers)", r)
    want["k1"] += n_ob * int(r["decode_calls"] + r["prefill_calls"])
    res["obspa"] = r
    del ob_model, ob_params

    torch.cuda.synchronize()
    k1_counts = launch_counts()
    got = {"k1": k1_counts["total"], "k2": k2.launch_count(),
           "k4": k4.launch_count()}
    res["wall_s"] = time.time() - t_path
    res["launches"] = dict(got, k1_decode=k1_counts["decode"],
                           k1_prefill=k1_counts["prefill"])
    res["expected_launches"] = want
    for name in ("dense", "no_drop_twin", "l1", "obspa"):
        res[name].pop("outputs")
    print(f"  moe path {res['wall_s']:.2f}s wall; launches {got} (K1 decode "
          f"{k1_counts['decode']}, prefill {k1_counts['prefill']}); "
          f"expected {want}", flush=True)
    if got != want or min(got.values()) < 1 or not (
            k1_counts["decode"] and k1_counts["prefill"]):
        raise AssertionError(f"moe path launches {got} != {want}")
    del model, params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 14: the cnn family (resnet50-cifar, vgg19-cifar) trained, pruned at
# the paper's three times, and OBSPA-pruned with BatchNorm recalibration
# (K4 on every conv consumer's (C_out, 9·C_in) view)
# ---------------------------------------------------------------------------

# 100 training steps of 128 images, SNIP on one more batch, L1's
# fine-tuning 50 steps; OBSPA calibrates on 16 x 64 images a regime (16384
# rows at the last stage's 4 x 4 maps for K 4608, 1024 for the classifier's
# K 512); accuracy on 8 x 256 "eval" images
def timed_prune(model, params, criterion: str, **kw) -> tuple:
    """``prune_model`` at ratio 0.5 with its wall time, seconds by phase
    and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pr = prune_model(model, params, 0.5, criterion=criterion, **kw)
    torch.cuda.synchronize()
    return pr, {"criterion": criterion, "mode": pr.report["mode"],
                "wall_s": time.time() - t0, "seconds": pr.report["seconds"],
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}


CNN = dict(batch=128, steps=100, ft_steps=50, calib=(16, 64), evals=(8, 256))
# AdamW's peak lr: the reference benchmarks' 3e-3 for the ResNets; VGG-19,
# whose loss runs BatchNorm as a fixed affine map (eval mode), kills most
# of its ReLUs at 3e-3 and 1e-3 and learns nothing in 100 steps at 3e-4;
# 1e-4 is the largest of the four tried on the card that learns (phase 14
# trains it at the reference's lr too and reports its dead channels)
CNN_REFERENCE_LR = 3e-3
CNN_LR = {"resnet": CNN_REFERENCE_LR, "vgg": 1e-4}
# the float32 forward on the card (cuDNN, TF32 off) against the same forward
# in float64, relative to the largest logit
CNN_F64_TOL = 1e-4


def cnn_accuracy(model, params, evalb) -> float:
    """Top-1 accuracy over ``evalb``; every logit must be finite."""
    hits = total = 0
    with torch.no_grad():
        for b in evalb:
            logits = model.forward(params, b)
            if logits.shape != (b["labels"].shape[0], model.cfg.num_classes) \
                    or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{model.cfg.name}: logits "
                                     f"{tuple(logits.shape)}, not finite or "
                                     f"not (batch, classes)")
            hits += int((logits.argmax(-1) == b["labels"].long()).sum())
            total += b["labels"].shape[0]
    return hits / total


def cnn_f64_gap(model, params, images) -> float:
    """max |logits (f32 on the card) − logits (float64 on the card)| over
    max |logits float64|: the float32 convolutions against a float64
    reference of the same model and weights."""
    p64 = tf._tree_map(lambda t: t.double(), params)
    with torch.no_grad():
        got = model.forward(params, {"images": images}).double()
        ref = model.forward(p64, {"images": images.double()})
    return float((got - ref).abs().max() / ref.abs().max())


def vgg_dead_share(cfg, params, images) -> list[float]:
    """Per conv of a VGG, the share of its channels that no image of
    ``images`` activates (zero after the ReLU everywhere)."""
    from repro_torch.models import cnn
    p, st, h, out = params["params"], params["state"], images, []
    with torch.no_grad():
        for si, (_, convs) in enumerate(cfg.cnn_stages):
            for ci in range(convs):
                name = f"s{si}c{ci}"
                h = cnn._conv(h, p[name]["conv"])
                h = torch.relu(cnn._bn(h, p[name]["bn"], st[name], False)[0])
                out.append(float((h.amax(dim=(0, 1, 2)) <= 0).float().mean()))
            h = cnn._max_pool(h)
    return out


def obspa_f64_check(model, dense, pr, calib, names) -> dict:
    """For the consumers ``names``: the reference's sweep (Eq. 13/14, the
    rows of one Hinv) done again in float64 by the plain version on the
    damped Hessian of the same calibration rows, its layer-output error
    over plain slicing's (the consumer's own pruned output rows cut in
    both), and how many of its pruned input columns are zero on every
    calibration row (dead ReLU channels)."""
    g, ap = trace_model(model, dense, batch=calib[0])
    cons = find_consumers(g, pr.groups)
    H, count = hessian_sums(g, ap, calib, cons)
    dele = delete_positions(pr.groups, pr.pruned_units)
    leaves = dict(tree_paths(ap))
    out = {}
    for (path, _), cs in cons.items():
        for c in cs:
            name = f"{path}@{c.op.uid}"
            if name not in names or name in out:
                continue
            h = H[hkey(c)][0].double()
            K = h.shape[0]
            hm = h / count[hkey(c)]
            lam = OBSPA_DAMPING * max(float(hm.diagonal().sum()) / K, 1e-8)
            hinv = torch.linalg.inv(hm + lam * torch.eye(
                K, dtype=h.dtype, device=h.device))
            w = leaves[path]
            w2d = _dot_w2d(w.double(), c)[0][0]
            mask = torch.zeros(K, dtype=torch.bool, device=h.device)
            rows = torch.ones(w2d.shape[0], dtype=torch.bool, device=h.device)
            for (p, a), pos in dele.items():
                if p == path and a in c.param_contract:
                    mask[torch.as_tensor(_flat_columns(
                        tuple(w.shape), c, a, tuple(sorted(pos))),
                        device=h.device)] = True
                elif p == path:
                    rows[sorted(pos)] = False
            new = k4.sweep_plain(w2d, hinv, mask) * rows[:, None]
            cut = w2d * (~mask)[None, :] * rows[:, None]
            e_ob, e_cut = (float(((w2d - v) @ h * (w2d - v)).sum())
                           for v in (new, cut))
            diag = h.diagonal()
            out[name] = {"f64_ratio": e_ob / e_cut if e_cut else None,
                         "pruned_columns": int(mask.sum()),
                         "dead_pruned_columns": int((diag[mask] == 0).sum())}
    return out


def cnn_swept_blocks(dense, pruned) -> int:
    """K4 launches of an OBSPA prune of a CNN: one per 128-column block of
    every consumer whose input channels lost a unit — a conv's K =
    kh·kw·C_in, the classifier's K = C_in, at the dense widths (the sweep
    runs before the slice)."""
    after = dict(tree_paths(pruned["params"]))
    n = 0
    for path, w in tree_paths(dense["params"]):
        if w.ndim == 4 and after[path].shape[2] < w.shape[2]:
            n += math.ceil(w[..., 0].numel() / k4.BLOCK)
        elif path == "fc" and after[path].shape[0] < w.shape[0]:
            n += math.ceil(w.shape[0] / k4.BLOCK)
    return n


def cnn_model_path(name: str, c: dict, rng, three_times: bool
                   ) -> tuple[dict, int]:
    """One CNN at full width: trained from a seed; with ``three_times``,
    SNIP at init then trained, L1 after training then fine-tuned, OBSPA
    with ID, OOD and DataFree calibration; otherwise L1 and OBSPA ID after
    training.  Returns (record, the K4 launches its OBSPA prunes owe)."""
    cfg = get_config(name)
    model = build(cfg)
    lr = CNN_LR[cfg.cnn_kind]
    seeds = [int(x) for x in rng.integers(0, 2**31, 5)]
    init = model.init(seed=seeds[0])
    n_p = n_params(init["params"])
    t0 = time.time()
    data = batches(cfg, "id", c["steps"] + 1, c["batch"], 0, seed=seeds[1])
    train_b, grad_b = data[:-1], data[-1]
    evalb = batches(cfg, "eval", *c["evals"], 0, seed=seeds[2])
    out = {"model": name, "params": n_p, "stages": list(cfg.cnn_stages),
           "classes": cfg.num_classes, "lr": lr, "data_s": time.time() - t0}
    print(f"  model: {name} {cfg.cnn_kind}, stages {list(cfg.cnn_stages)}, "
          f"{cfg.num_classes} classes, {cfg.image_size} px, float32; {n_p} "
          f"parameters (+ {n_params(init['state'])} BN statistics); data "
          f"{out['data_s']:.1f}s", flush=True)
    want_k4 = 0

    def report(label, m, p, pr=None, rep=None, dense_p=None) -> dict:
        r = {"accuracy": cnn_accuracy(m, p, evalb)}
        txt = f"accuracy {r['accuracy']:.4f}"
        if pr is not None:
            rr = rf_rp(model, dense_p, m, p, evalb[0])
            r.update(rf=rr["RF"], rp=rr["RP"], params_after=rr["params_after"],
                     kept=stage_widths(cfg, p["params"]), **rep)
            txt += (f" | RF {rr['RF']:.3f} RP {rr['RP']:.3f} | "
                    f"{rep['wall_s']:.2f}s: " + " | ".join(
                        f"{k} {v:.3f}s" for k, v in rep["seconds"].items())
                    + f" | peak {rep['peak_mem_bytes'] / 2**30:.2f} GiB")
            if "k4_launches" in rep:
                txt += (f" | K4 launches {rep['k4_launches']} (formula "
                        f"{rep['k4_expected']})")
            txt += f" | kept a stage {r['kept']}"
            if rr["RF"] <= 1.15 or rr["RP"] <= 1.15:
                raise AssertionError(f"{name} {label}: RF {rr['RF']}, RP "
                                     f"{rr['RP']} (<= 1.15)")
        print(f"  {label:32s} {txt}", flush=True)
        return r

    out["dense_init"] = report("dense at init", model, init)
    if three_times:
        # prune-train: SPA-SNIP at init on one gradient batch, then train
        pr, rep = timed_prune(model, init, "snip", grads_batch=grad_b)
        r = {"after_prune": report("prune-train: SNIP at init", build(pr.cfg),
                                   pr.params, pr, rep, init)}
        p_pt, r["train"] = train(Warm(pr.cfg, pr.params), train_b, lr)
        r["after_train"] = report("prune-train: trained", build(pr.cfg), p_pt)
        out["prune_train"] = r
        del pr, p_pt
    if lr != CNN_REFERENCE_LR:
        p_ref, tr = train(Warm(cfg, tf._tree_map(torch.clone, init)),
                          train_b, CNN_REFERENCE_LR)
        out["reference_lr"] = {
            "train": tr, "accuracy": cnn_accuracy(model, p_ref, evalb),
            "dead_share": vgg_dead_share(cfg, p_ref, evalb[0]["images"])}
        r = out["reference_lr"]
        print(f"  trained at the reference lr {CNN_REFERENCE_LR:g}: "
              f"accuracy {r['accuracy']:.4f}, train loss "
              f"{tr['train_loss_first']:.4f} -> {tr['train_loss_last']:.4f}"
              f", channels no eval image activates, a conv: "
              f"{[round(x, 3) for x in r['dead_share']]}", flush=True)
        del p_ref
    dense, out["dense_train"] = train(Warm(cfg, init), train_b, lr)
    out["dense_trained"] = report("dense trained", model, dense)
    d = out["dense_train"]
    out["f64_gap"] = cnn_f64_gap(model, dense, evalb[0]["images"][:32])
    print(f"  dense training: {d['steps']} steps of {c['batch']} images at "
          f"lr {lr:g}, "
          f"median step {d['step_ms_median']:.1f} ms "
          f"({d['images_per_s']:.0f} images/s; first step "
          f"{d['first_step_ms']:.0f} ms), train loss "
          f"{d['train_loss_first']:.4f} -> {d['train_loss_last']:.4f}, peak "
          f"{d['peak_mem_bytes'] / 2**30:.2f} GiB | trained forward vs "
          f"float64 {out['f64_gap']:.2e} of max|logit| (limit "
          f"{CNN_F64_TOL:g})", flush=True)
    if not d["train_loss_last"] < d["train_loss_first"]:
        raise AssertionError(f"{name}: training did not lower the loss: {d}")
    if out["f64_gap"] > CNN_F64_TOL:
        raise AssertionError(f"{name}: float32 forward {out['f64_gap']} "
                             f"from float64")

    # train-prune-finetune: SPA-L1 (global) after training, then fine-tune
    pr, rep = timed_prune(model, dense, "l1")
    r = {"after_prune": report("train-prune: L1", build(pr.cfg), pr.params,
                               pr, rep, dense)}
    if three_times:
        p_ft, r["finetune"] = train(Warm(pr.cfg, pr.params),
                                    train_b[:c["ft_steps"]], lr)
        r["after_finetune"] = report("train-prune-finetune: tuned",
                                     build(pr.cfg), p_ft)
        del p_ft
    out["train_prune_l1"] = r
    del pr

    # train-prune: OBSPA after training, no tuning; BN recalibrated on the
    # calibration images except with DataFree calibration.  The dense model
    # recalibrated alone shows what the refresh does without the prune: the
    # loss ran BN in eval mode, so training fitted the running statistics
    # as parameters (ROADMAP Queue 3)
    for mode in ("id", "ood", "datafree") if three_times else ("id",):
        calib = batches(cfg, mode, *c["calib"], 0, seed=seeds[3])
        if mode == "id":
            out["dense_recalibrated"] = report(
                "dense, BN recalibrated (id)", model,
                recalibrate_bn(cfg, dense, calib))
        pr, rep = obspa_on_card(model, dense, calib, calib_mode=mode)
        rep["k4_expected"] = cnn_swept_blocks(dense, pr.params)
        want_k4 += rep["k4_expected"]
        r = report(f"train-prune: OBSPA ({mode})", build(pr.cfg), pr.params,
                   pr, rep, dense)
        r["f64_gap"] = cnn_f64_gap(build(pr.cfg), pr.params,
                                   evalb[0]["images"][:32])
        ratios = [e["ratio"] for e in rep["layer_errors"].values()
                  if e["ratio"] is not None]
        tot = rep["summed_errors"]
        r["consumers_not_below"] = sum(x >= 1 for x in ratios)
        if mode != "datafree":
            r["not_below_f64"] = obspa_f64_check(
                model, dense, pr, calib,
                {k for k, e in rep["layer_errors"].items()
                 if e["ratio"] is not None and e["ratio"] >= 1})
            for k, v in r["not_below_f64"].items():
                print(f"    not below slicing: {k} ratio "
                      f"{rep['layer_errors'][k]['ratio']:.6f}, float64 "
                      f"plain sweep {v['f64_ratio']:.6f}; "
                      f"{v['dead_pruned_columns']} of its "
                      f"{v['pruned_columns']} pruned columns zero on every "
                      f"calibration row", flush=True)
        print(f"  OBSPA ({mode}) layer output error ‖X(W-W')‖², OBSPA / "
              f"plain slicing, {len(rep['layer_errors'])} conv and fc "
              f"consumers: {min(ratios):.4f}..{max(ratios):.4f}, "
              f"{r['consumers_not_below']} not below; summed "
              f"{tot['obspa']:.6g} / {tot['slicing']:.6g} = "
              f"{tot['obspa'] / tot['slicing']:.6f} | forward vs float64 "
              f"{r['f64_gap']:.2e}", flush=True)
        if rep["k4_launches"] != rep["k4_expected"]:
            raise AssertionError(f"{name} OBSPA ({mode}): K4 launches "
                                 f"{rep['k4_launches']} != "
                                 f"{rep['k4_expected']}")
        # the reference's sweep (Eq. 13/14 with the rows of one fixed
        # Hinv) is no OBS update after the first pruned column, and a
        # consumer whose pruned inputs are mostly dead ReLU channels can
        # come out at or above slicing (a float64 sweep agrees): what the
        # reconstruction must do is lower the error summed over the model
        if three_times and mode != "datafree" and \
                not tot["obspa"] < tot["slicing"]:
            raise AssertionError(f"{name} OBSPA ({mode}): summed layer "
                                 f"output error {tot} not below slicing's")
        if r["f64_gap"] > CNN_F64_TOL:
            raise AssertionError(f"{name} OBSPA ({mode}): float32 forward "
                                 f"{r['f64_gap']} from float64")
        out[f"train_prune_obspa_{mode}"] = r
        del pr, calib
    del dense, init, data, train_b
    torch.cuda.empty_cache()
    return out, want_k4


def phase_cnn_path(seed: int, quick: bool) -> dict:
    print("phase 14: the cnn family — resnet50-cifar and vgg19-cifar "
          "trained, pruned at the paper's three times, OBSPA with BatchNorm "
          "recalibration (K4 on conv consumers)", flush=True)
    c = dict(CNN, steps=10, ft_steps=5) if quick else dict(CNN)
    rng = np.random.default_rng([seed, 14, 1])
    t0 = time.time()
    k4.reset_launches()                 # counts = this path's only
    res: dict = {"config": c, "models": {}}
    want = 0
    for name, three in (("resnet18-cifar" if quick else "resnet50-cifar",
                         True), ("vgg19-cifar", False)):
        res["models"][name], w = cnn_model_path(name, c, rng, three)
        want += w
    torch.cuda.synchronize()
    res["k4_launches"] = k4.launch_count()
    res["k4_launches_expected"] = want
    res["wall_s"] = time.time() - t0
    print(f"  cnn path {res['wall_s']:.2f}s wall; K4 launches "
          f"{res['k4_launches']} (expected {want})", flush=True)
    if res["k4_launches"] != want or want < 1:
        raise AssertionError(f"cnn path K4 launches {res['k4_launches']} "
                             f"!= {want}")
    return res


# ---------------------------------------------------------------------------
# Phase 15: the encoder and VLM families at full width
# ---------------------------------------------------------------------------

# hubert-xlarge: 24 Trainer steps of 8 x 512 frames (10 s of 50 Hz audio a
# sequence) of the "id" FrameTask, lr 3e-4, every layer rematerialised (the
# config's remat; ~1 s a step on an H100); frame accuracy on 8 "eval"
# batches of 8 x 512; OBSPA ID on 4 x 4 x 512 frames; the layer checks on
# 2 x 1000 frames
ENCODER = dict(batch=8, seq=512, steps=24, lr=3e-4, evals=(8, 8),
               calib=(4, 4), check=(2, 1000))
# the prunes' depth: the host's trace, grouping and scoring grow with the
# layers (L1 28.5 s, OBSPA 34.1 s at all 48 on an H100's host), so the
# prunes run on the first 24 to keep phase 15 within its budget
HUBERT_PRUNE_LAYERS = 24
# the paper's encoders at their registered size (6 layers, d 256, f32):
# vit-mini on 196 patches (224 px / 16), distilbert-mini on 128 tokens;
# batches of 32, 100 steps at lr 1e-3 (50 to fine-tune), accuracy on 8 x
# 32 "eval" sequences, OBSPA calibrated on 8 x 32 sequences
MINI_SEQ = {"vit-mini": 196, "distilbert-mini": 128}
MINI = dict(batch=32, steps=100, ft_steps=50, lr=1e-3, evals=(8, 32),
            calib=(8, 32))
# paligemma-3b: 256 image tokens + 64 text tokens a sequence, 6 Trainer
# steps of 2 (DataFree tokens: MarkovLM's 257216² matrix cannot be built),
# OBSPA DataFree on 2 x 2 sequences
PALIGEMMA = dict(batch=2, text=64, steps=6, lr=1e-4, calib=(2, 2))
# paligemma's prefix property: the logits a change of the last text token
# may move elsewhere, relative to the largest logit (the reference's CPU
# test allows 1e-5 absolute)
PREFIX_TOL = 1e-5


def encoder_accuracy(model, params, evalb) -> float:
    """Accuracy of ``Model.forward`` (K2 on the card: one launch a layer a
    batch) on ``evalb``: a sequence's class from its mean logits (the mean
    of the per-frame logits is the classifier on the mean hidden state)
    with at most 16 classes, else every frame's argmax against its
    target.  Every logit must be finite."""
    hits = total = 0
    with torch.no_grad():
        for b in evalb:
            logits = model.forward(params, b).float()
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{model.cfg.name}: non-finite logits")
            if model.cfg.vocab_size <= 16:
                logits = logits.mean(dim=1)
            hits += int((logits.argmax(-1) == b["targets"].long()).sum())
            total += b["targets"].numel()
    return hits / total


def encoder_blocks_vs_plain(model, params, B: int, S: int) -> dict:
    """Every layer's bidirectional attention on K2 against its plain
    version, on the input the plain forward gives that layer (B x S
    frames): max|Δ| / max|plain| per layer.  Launches K2 once a layer."""
    cfg = model.cfg
    plain = cfg.replace(use_kernels=False)
    batch = model.dummy_batch(B, S, seed=15)
    pos = torch.arange(S, dtype=torch.int32, device=DEV)[None].expand(B, S)
    errs = []
    with torch.no_grad():
        h = tf.embed_inputs(params, cfg, batch)
        for i, lp in enumerate(tf.unstack_layers(params,
                                                 cfg.num_layers)["layers"]):
            hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
            a = attn_block(lp["attn"], cfg, hn, pos, "bidir")
            a_p = attn_block(lp["attn"], plain, hn, pos, "bidir")
            if not torch.isfinite(a).all():
                raise AssertionError(f"layer {i}: non-finite K2 output")
            errs.append(ssd_rel(a, a_p))
            h = h + a_p
            h = h + swiglu(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps))
    return {"max_rel": max(errs), "worst_layer": int(np.argmax(errs)),
            "per_layer": errs, "shape": [B, S]}


def encoder_twin(cfg, params, n: int, B: int, S: int) -> dict:
    """The model cut to its first ``n`` layers: its forward on K2, on the
    plain attention and in float32 (plain) on B x S frames; the largest
    logit difference of each pair, and K2's limit: the plain version's own
    distance from float32 plus one bf16 step of the largest logit (the
    logits are bf16, so two paths that agree to the last bit of the f32
    sum can still round a logit to neighbouring bf16 values: at |logit| ~5
    one step is 0.031, more than the plain version's whole distance from
    float32 at 2 layers).  Launches K2 ``n`` times."""
    c = cfg.replace(num_layers=n)
    p = first_layers(params, n)
    m = build(c)
    batch = m.dummy_batch(B, S, seed=11)
    with torch.no_grad():
        a = m.forward(p, batch).float()
        b = build(c.replace(use_kernels=False)).forward(p, batch).float()
        f = build(c.replace(dtype="float32", use_kernels=False)).forward(
            f32_tree(p), batch).float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{cfg.name} first {n} layers: non-finite "
                             f"logits on K2")
    return {"layers": n, "k2_vs_plain": float((a - b).abs().max()),
            "k2_vs_f32": float((a - f).abs().max()),
            "plain_vs_f32": float((b - f).abs().max()),
            "plain_max_abs": float(b.abs().max()),
            "twin_limit": float((b - f).abs().max())
            + BF16_BLOCK_TOL * float(b.abs().max())}


def errors_text(rep) -> str:
    ratios = [e["ratio"] for e in rep["layer_errors"].values()
              if e["ratio"] is not None]
    tot = rep["summed_errors"]
    return (f"layer output error ‖X(W-W')‖², OBSPA / plain slicing, "
            f"{len(ratios)} consumers: {min(ratios):.4f}..{max(ratios):.4f}, "
            f"{sum(x >= 1 for x in ratios)} not below; summed "
            f"{tot['obspa']:.6g} / {tot['slicing']:.6g} = "
            f"{tot['obspa'] / tot['slicing']:.6f}")


def check_obspa_errors(label, rep, mode: str) -> None:
    """What the reconstruction must do: lower the layer-output error summed
    over the model below plain slicing's, for ID and OOD calibration (the
    reference's sweep takes each pruned column's update from the rows of
    one fixed Hinv, so single consumers can end at or above slicing)."""
    tot = rep["summed_errors"]
    if mode != "datafree" and not tot["obspa"] < tot["slicing"]:
        raise AssertionError(f"{label}: summed layer output error {tot} not "
                             f"below slicing's")


def hubert_path(rng, quick: bool, counts: dict) -> dict:
    """hubert-xlarge at full width (48 layers, d 1280, 16 heads of 80, bf16;
    ``quick``: the reduced config in bf16): K2 per layer against plain,
    trained by ``Trainer``, frame accuracy, then L1 and OBSPA ID at 0.5
    (the first ``HUBERT_PRUNE_LAYERS`` layers), each evaluated; the
    OBSPA-pruned model at 2 layers against its float32 twin."""
    cfg = get_config("hubert-xlarge")
    c = dict(ENCODER)
    if quick:
        # at d 64 the bf16 weights' steps are ~1e-3: a step of lr 3e-4
        # rounds away
        cfg = reduced(cfg).replace(dtype=cfg.dtype, remat=cfg.remat)
        c.update(steps=20, lr=3e-3, evals=(2, 4), calib=(2, 4),
                 check=(2, 200))
    model = build(cfg)
    L = cfg.num_layers
    seeds = [int(x) for x in rng.integers(0, 2**31, 5)]
    params = model.init(seed=seeds[0])
    out = {"model": cfg.name, "layers": L, "params": n_params(params),
           "param_count": cfg.param_count(), "config": c}
    t0 = time.time()
    train_b = batches(cfg, "id", c["steps"], c["batch"], c["seq"],
                      seed=seeds[1])
    evalb = batches(cfg, "eval", *c["evals"], c["seq"], seed=seeds[2])
    out["data_s"] = time.time() - t0
    print(f"  model: {cfg.name}, {L} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim_} (bidirectional), d_ff "
          f"{cfg.d_ff}, {cfg.vocab_size} targets, {cfg.dtype}; "
          f"{out['params']} parameters (config's count "
          f"{out['param_count']}); FrameTask data {out['data_s']:.1f}s",
          flush=True)
    if out["params"] != out["param_count"]:
        raise AssertionError(f"{cfg.name}: {out['params']} parameters held, "
                             f"the config counts {out['param_count']}")

    blocks = encoder_blocks_vs_plain(model, params, *c["check"])
    counts["k2"] += L
    out["blocks"] = blocks
    print(f"  attention on K2 vs plain, every layer, {c['check'][0]} x "
          f"{c['check'][1]} frames: max|Δ| / max|plain| "
          f"{blocks['max_rel']:.2e} (layer {blocks['worst_layer']}; tol "
          f"{BF16_BLOCK_TOL:.2e}, one bf16 step)", flush=True)
    if blocks["max_rel"] > BF16_BLOCK_TOL:
        raise AssertionError(f"{cfg.name}: K2 vs plain {blocks['max_rel']} "
                             f"> {BF16_BLOCK_TOL}")
    out["dense_init_accuracy"] = encoder_accuracy(model, params, evalb)
    counts["k2"] += L * len(evalb)

    dense, tr = train(Warm(cfg, params), train_b, c["lr"])
    out["train"] = tr
    out["dense_accuracy"] = encoder_accuracy(model, dense, evalb)
    counts["k2"] += L * len(evalb)
    print(f"  trained {tr['steps']} steps of {c['batch']} x {c['seq']} "
          f"frames at lr {c['lr']:g} (remat {cfg.remat}): median step "
          f"{tr['step_ms_median']:.1f} ms ({tr['frames_per_s']:.0f} "
          f"frames/s; first {tr['first_step_ms']:.0f} ms), loss "
          f"{tr['train_loss_first']:.4f} -> {tr['train_loss_last']:.4f} "
          f"(quarter means {tr['train_loss_first_quarter']:.4f} -> "
          f"{tr['train_loss_last_quarter']:.4f}), "
          f"peak {tr['peak_mem_bytes'] / 2**30:.2f} GiB | frame accuracy "
          f"{out['dense_init_accuracy']:.4f} at init -> "
          f"{out['dense_accuracy']:.4f} ({len(evalb)} x {c['evals'][1]} x "
          f"{c['seq']} frames)", flush=True)
    if not tr["train_loss_last_quarter"] < tr["train_loss_first_quarter"]:
        raise AssertionError(f"{cfg.name}: training did not lower the loss")

    n = min(HUBERT_PRUNE_LAYERS, L)
    pcfg = cfg.replace(num_layers=n)
    pm, pd = build(pcfg), first_layers(dense, n)
    if n < L:
        out["dense_accuracy_cut"] = encoder_accuracy(pm, pd, evalb)
        counts["k2"] += n * len(evalb)
    out["prune_layers"] = n
    calib = batches(cfg, "id", *c["calib"], c["seq"], seed=seeds[3])
    for crit in ("l1", "obspa"):
        if crit == "l1":
            pr, rep = timed_prune(pm, pd, "l1")
        else:
            pr, rep = obspa_on_card(pm, pd, calib, calib_mode="id")
            rep["k4_expected"] = obspa_blocks(pcfg)
            counts["k4"] += rep["k4_expected"]
        m2 = build(pr.cfg)
        rr = rf_rp(pm, pd, m2, pr.params, evalb[0])
        rep.update(rf=rr["RF"], rp=rr["RP"], params_after=rr["params_after"],
                   dims=pruned_dims(pr.cfg),
                   accuracy=encoder_accuracy(m2, pr.params, evalb))
        counts["k2"] += n * len(evalb)
        print_prune(f"{crit} ({n} of {L} layers)", pruned_dims(pcfg),
                    rep["dims"], rep)
        print(f"    RF {rr['RF']:.3f} RP {rr['RP']:.3f} | frame accuracy "
              f"after the prune {rep['accuracy']:.4f}"
              + (f" | K4 launches {rep['k4_launches']} (formula {n} x "
                 f"(⌈{cfg.n_heads * cfg.v_head_dim_}/128⌉ + "
                 f"⌈{cfg.d_ff}/128⌉) = {rep['k4_expected']})"
                 if crit == "obspa" else ""), flush=True)
        if crit == "obspa":
            print(f"    {errors_text(rep)}", flush=True)
            check_obspa_errors(f"{cfg.name} OBSPA (id)", rep, "id")
            if rep["k4_launches"] != rep["k4_expected"]:
                raise AssertionError(f"{cfg.name} OBSPA: K4 launches "
                                     f"{rep['k4_launches']} != "
                                     f"{rep['k4_expected']}")
            twin = encoder_twin(pr.cfg, pr.params, SHALLOW_LAYERS,
                                *c["check"])
            counts["k2"] += SHALLOW_LAYERS
            rep["twin"] = twin
            print(f"    OBSPA-pruned, first {SHALLOW_LAYERS} layers, "
                  f"{c['check'][0]} x {c['check'][1]} frames: max logit "
                  f"diff K2 vs plain {twin['k2_vs_plain']:.4f}, K2 vs "
                  f"float32 twin {twin['k2_vs_f32']:.4f}, plain vs float32 "
                  f"twin {twin['plain_vs_f32']:.4f} (max|logit| "
                  f"{twin['plain_max_abs']:.3f}; K2's limit "
                  f"{twin['twin_limit']:.4f})", flush=True)
            if twin["k2_vs_f32"] > twin["twin_limit"]:
                raise AssertionError(f"{cfg.name} pruned: K2 is farther "
                                     f"from float32 than the plain version "
                                     f"and one bf16 step: {twin}")
        if rr["RF"] <= 1.15 or rr["RP"] <= 1.15:
            raise AssertionError(f"{cfg.name} {crit}: RF {rr['RF']}, RP "
                                 f"{rr['RP']} (<= 1.15)")
        out[crit] = rep
        del pr, m2
    del dense, pd, params, train_b, calib
    torch.cuda.empty_cache()
    return out


def mini_path(name: str, rng, quick: bool, counts: dict) -> dict:
    """One of the paper's encoders at its registered size (float32; K2's
    CUDA-core instance): trained, and pruned at the paper's three times —
    SNIP at init then trained, L1 after training then fine-tuned, OBSPA
    with ID, OOD and DataFree calibration after training."""
    cfg = get_config(name)
    c = dict(MINI)
    if quick:
        cfg = reduced(cfg)
        c.update(steps=60, ft_steps=10, lr=3e-3)
    S = MINI_SEQ[name]
    L = cfg.num_layers
    model = build(cfg)
    seeds = [int(x) for x in rng.integers(0, 2**31, 5)]
    init = model.init(seed=seeds[0])
    data = batches(cfg, "id", c["steps"] + 1, c["batch"], S, seed=seeds[1])
    train_b, grad_b = data[:-1], data[-1]
    evalb = batches(cfg, "eval", *c["evals"], S, seed=seeds[2])
    out = {"model": name, "params": n_params(init), "seq": S, "config": c}
    print(f"  model: {name}, {L} layers, d {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.head_dim_}, {cfg.vocab_size} classes, "
          f"{cfg.dtype}, {S} frames a sequence; {out['params']} parameters",
          flush=True)

    def report(label, m, p, pr=None, rep=None, dense_p=None) -> dict:
        r = {"accuracy": encoder_accuracy(m, p, evalb)}
        counts["k2"] += m.cfg.num_layers * len(evalb)
        txt = f"accuracy {r['accuracy']:.4f}"
        if pr is not None:
            rr = rf_rp(model, dense_p, m, p, evalb[0])
            r.update(rf=rr["RF"], rp=rr["RP"], dims=pruned_dims(pr.cfg),
                     **rep)
            txt += (f" | RF {rr['RF']:.3f} RP {rr['RP']:.3f} | "
                    f"{rep['wall_s']:.2f}s: " + " | ".join(
                        f"{k} {v:.3f}s" for k, v in rep["seconds"].items())
                    + f" | {r['dims']}")
            if "k4_launches" in rep:
                txt += (f" | K4 launches {rep['k4_launches']} (formula "
                        f"{rep['k4_expected']})")
            if rr["RF"] <= 1.15 or rr["RP"] <= 1.15:
                raise AssertionError(f"{name} {label}: RF {rr['RF']}, RP "
                                     f"{rr['RP']} (<= 1.15)")
        print(f"  {label:32s} {txt}", flush=True)
        return r

    out["dense_init"] = report("dense at init", model, init)
    pr, rep = timed_prune(model, init, "snip", grads_batch=grad_b)
    r = {"after_prune": report("prune-train: SNIP at init", build(pr.cfg),
                               pr.params, pr, rep, init)}
    p_pt, r["train"] = train(Warm(pr.cfg, pr.params), train_b, c["lr"])
    r["after_train"] = report("prune-train: trained", build(pr.cfg), p_pt)
    out["prune_train"] = r
    del pr, p_pt
    dense, out["dense_train"] = train(Warm(cfg, init), train_b, c["lr"])
    out["dense_trained"] = report("dense trained", model, dense)
    d = out["dense_train"]
    print(f"  dense training: {d['steps']} steps of {c['batch']} x {S} at lr "
          f"{c['lr']:g}, median step {d['step_ms_median']:.1f} ms "
          f"({d['frames_per_s']:.0f} frames/s), loss "
          f"{d['train_loss_first']:.4f} -> {d['train_loss_last']:.4f} (mean "
          f"of the first and last quarter of the steps "
          f"{d['train_loss_first_quarter']:.4f} -> "
          f"{d['train_loss_last_quarter']:.4f}), peak "
          f"{d['peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)
    # judged on the held-out sequences: on these small tasks a batch's loss
    # moves more from batch to batch than training moves it
    if not out["dense_trained"]["accuracy"] > out["dense_init"]["accuracy"]:
        raise AssertionError(f"{name}: training did not raise the accuracy "
                             f"on the eval sequences")
    pr, rep = timed_prune(model, dense, "l1")
    r = {"after_prune": report("train-prune: L1", build(pr.cfg), pr.params,
                               pr, rep, dense)}
    p_ft, r["finetune"] = train(Warm(pr.cfg, pr.params),
                                train_b[:c["ft_steps"]], c["lr"])
    r["after_finetune"] = report("train-prune-finetune: tuned",
                                 build(pr.cfg), p_ft)
    out["train_prune_l1"] = r
    del pr, p_ft
    for mode in ("id", "ood", "datafree"):
        calib = batches(cfg, mode, *c["calib"], S, seed=seeds[3])
        pr, rep = obspa_on_card(model, dense, calib, calib_mode=mode)
        rep["k4_expected"] = obspa_blocks(cfg)
        counts["k4"] += rep["k4_expected"]
        r = report(f"train-prune: OBSPA ({mode})", build(pr.cfg), pr.params,
                   pr, rep, dense)
        print(f"    {errors_text(rep)}", flush=True)
        check_obspa_errors(f"{name} OBSPA ({mode})", rep, mode)
        if rep["k4_launches"] != rep["k4_expected"]:
            raise AssertionError(f"{name} OBSPA ({mode}): K4 launches "
                                 f"{rep['k4_launches']} != "
                                 f"{rep['k4_expected']}")
        out[f"train_prune_obspa_{mode}"] = r
        del pr, calib
    del dense, init, data, train_b
    torch.cuda.empty_cache()
    return out


def prefix_check(model, params, batch) -> dict:
    """The vlm mask on the card (``tests/test_models.py::
    test_vlm_prefix_mask``): changing the last text token moves no logit
    before it; changing the last image patch moves the first image row's
    (image rows see every image row)."""
    def logits(b):
        with torch.no_grad():
            return model.forward(params, b).float()
    base = logits(batch)
    toks = batch["tokens"].clone()
    toks[:, -1] = (toks[:, -1] + 1) % model.cfg.vocab_size
    moved_text = logits(dict(batch, tokens=toks))
    patches = batch["patches"].clone()
    patches[:, -1] = -patches[:, -1]
    moved_image = logits(dict(batch, patches=patches))
    top = float(base.abs().max())
    return {"max_abs_logit": top,
            "before_last_text_moved": float(
                (moved_text[:, :-1] - base[:, :-1]).abs().max()),
            "last_text_moved": float(
                (moved_text[:, -1] - base[:, -1]).abs().max()),
            "first_image_row_moved": float(
                (moved_image[:, 0] - base[:, 0]).abs().max())}


def paligemma_path(rng, quick: bool, counts: dict) -> dict:
    """paligemma-3b at full width (18 layers, d 2048, 8 query heads over one
    KV head of 256, d_ff 16384, 256 patches of 1152, vocab 257216, tied
    embeddings, bf16): the prefix mask on the plain attention (K2 never),
    its property on the card, a few ``Trainer`` steps, L1 and OBSPA
    DataFree at 0.5, and the engine's refusal."""
    cfg = get_config("paligemma-3b")
    c = dict(PALIGEMMA)
    if quick:
        cfg = reduced(cfg).replace(dtype=cfg.dtype, remat=cfg.remat)
        c.update(text=16)
    model = build(cfg)
    L, nv = cfg.num_layers, cfg.vision_tokens
    seq = nv + c["text"]
    seeds = [int(x) for x in rng.integers(0, 2**31, 5)]
    params = model.init(seed=seeds[0])
    out = {"model": cfg.name, "layers": L, "params": n_params(params),
           "param_count": cfg.param_count(), "config": c}
    print(f"  model: {cfg.name}, {L} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} query heads over {cfg.n_kv_heads} KV head of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, {nv} patches of "
          f"{cfg.vision_embed_dim} + {c['text']} text tokens, vocab "
          f"{cfg.vocab_size} (tied), {cfg.dtype}; {out['params']} "
          f"parameters (config's count {out['param_count']})", flush=True)
    if out["params"] != out["param_count"]:
        raise AssertionError(f"{cfg.name}: {out['params']} parameters held, "
                             f"the config counts {out['param_count']}")
    k2_before = k2.launch_count()
    one = batches(cfg, "datafree", 1, 1, seq, seed=seeds[1])[0]
    pre = prefix_check(model, params, one)
    out["prefix"] = pre
    # the plain attention's share of a no-grad forward: the 18 prefix-masked
    # attentions alone on one layer's input, against the whole forward
    b2 = batches(cfg, "datafree", 1, c["batch"], seq, seed=seeds[2])[0]
    pos = torch.arange(seq, dtype=torch.int32, device=DEV)[None].expand(
        c["batch"], seq)
    layers = tf.unstack_layers(params, L)["layers"]
    with torch.no_grad():
        hn = rms_norm(tf.embed_inputs(params, cfg, b2), layers[0]["ln1"],
                      cfg.norm_eps)
        fwd_ms = time_ms(lambda i: model.forward(params, b2), iters=3,
                         warmup=1)
        attn_ms = time_ms(lambda i: [attn_block(
            lp["attn"], cfg, hn, pos, "prefix", prefix_len=nv)
            for lp in layers], iters=3, warmup=1)
    out["forward_ms"], out["attention_ms"] = fwd_ms, attn_ms
    print(f"  prefix mask on the plain attention: changing the last text "
          f"token moves the logits before it by "
          f"{pre['before_last_text_moved']:.3e} (limit {PREFIX_TOL:g} x "
          f"max|logit| {pre['max_abs_logit']:.3f}) and its own by "
          f"{pre['last_text_moved']:.3f}; flipping the last patch moves "
          f"the first image row by {pre['first_image_row_moved']:.3f} | "
          f"no-grad forward of {c['batch']} x {seq} {fwd_ms:.2f} ms, its "
          f"{L} plain attentions {attn_ms:.2f} ms "
          f"({100 * attn_ms / fwd_ms:.1f} %)", flush=True)
    if pre["before_last_text_moved"] > PREFIX_TOL * pre["max_abs_logit"] \
            or not pre["last_text_moved"] > 0 \
            or not pre["first_image_row_moved"] > 0:
        raise AssertionError(f"{cfg.name}: prefix mask {pre}")

    train_b = batches(cfg, "datafree", c["steps"], c["batch"], seq,
                      seed=seeds[3])
    dense, tr = train(Warm(cfg, params), train_b, c["lr"])
    out["train"] = tr
    print(f"  {tr['steps']} Trainer steps of {c['batch']} x ({nv} patches + "
          f"{c['text']} tokens), loss on the text positions only, lr "
          f"{c['lr']:g} (remat {cfg.remat}): median step "
          f"{tr['step_ms_median']:.1f} ms (first {tr['first_step_ms']:.0f} "
          f"ms), loss {tr['train_loss_first']:.4f} -> "
          f"{tr['train_loss_last']:.4f} (ln vocab "
          f"{math.log(cfg.vocab_size):.4f}), peak "
          f"{tr['peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)
    evalb = [b2]
    out["dense_loss"] = eval_loss(model, dense, evalb)
    calib = batches(cfg, "datafree", *c["calib"], seq, seed=seeds[4])
    for crit in ("l1", "obspa"):
        if crit == "l1":
            pr, rep = timed_prune(model, dense, "l1")
        else:
            pr, rep = obspa_on_card(model, dense, calib,
                                    calib_mode="datafree")
            rep["k4_expected"] = obspa_blocks(cfg)
            counts["k4"] += rep["k4_expected"]
        m2 = build(pr.cfg)
        rr = rf_rp(model, dense, m2, pr.params, b2)
        rep.update(rf=rr["RF"], rp=rr["RP"], dims=pruned_dims(pr.cfg),
                   loss=eval_loss(m2, pr.params, evalb))
        print_prune(f"{crit} (datafree)" if crit == "obspa" else crit,
                    pruned_dims(cfg), rep["dims"], rep)
        print(f"    RF {rr['RF']:.3f} RP {rr['RP']:.3f} | loss on DataFree "
              f"tokens {out['dense_loss']:.4f} -> {rep['loss']:.4f}"
              + (f" | K4 launches {rep['k4_launches']} (formula {L} x "
                 f"(⌈{cfg.n_heads * cfg.v_head_dim_}/128⌉ + "
                 f"⌈{cfg.d_ff}/128⌉) = {rep['k4_expected']})"
                 if crit == "obspa" else ""), flush=True)
        if crit == "obspa":
            print(f"    {errors_text(rep)}", flush=True)
            if rep["k4_launches"] != rep["k4_expected"]:
                raise AssertionError(f"{cfg.name} OBSPA: K4 launches "
                                     f"{rep['k4_launches']} != "
                                     f"{rep['k4_expected']}")
        if not math.isfinite(rep["loss"]) or rr["RP"] <= 1.15:
            raise AssertionError(f"{cfg.name} {crit}: loss {rep['loss']}, "
                                 f"RP {rr['RP']}")
        out[crit] = rep
        del pr, m2
    try:
        Engine(model, dense, ServeConfig())
    except ValueError as e:
        out["engine_refusal"] = str(e)
    else:
        raise AssertionError(f"{cfg.name}: the engine took a vlm model")
    print(f"  Engine refuses it: {out['engine_refusal']!r}", flush=True)
    if out["engine_refusal"] != "vlm serving needs patch prefill (not " \
            "supported)":
        raise AssertionError(f"{cfg.name}: engine refusal "
                             f"{out['engine_refusal']!r}")
    out["k2_launches"] = k2.launch_count() - k2_before
    print(f"  K2 launches on the paligemma path: {out['k2_launches']} "
          f"(prefix attention runs the plain version, as the reference's)",
          flush=True)
    if out["k2_launches"]:
        raise AssertionError(f"{cfg.name}: K2 launched "
                             f"{out['k2_launches']} times on a prefix mask")
    del dense, params, train_b, calib, layers, hn
    torch.cuda.empty_cache()
    return out


def phase_encoder_vlm_path(seed: int, quick: bool) -> dict:
    print("phase 15: the encoder and VLM families — hubert-xlarge, "
          "vit-mini, distilbert-mini and paligemma-3b trained, pruned and "
          "evaluated (K2 bidirectional, K4)", flush=True)
    rng = np.random.default_rng([seed, 15, 1])
    t0 = time.time()
    k2.reset_launches()                 # counts = this path's only
    k4.reset_launches()
    counts = {"k2": 0, "k4": 0}
    res: dict = {"models": {}}
    res["models"]["hubert-xlarge"] = hubert_path(rng, quick, counts)
    res["hubert_s"] = time.time() - t0
    for name in MINI_SEQ:
        res["models"][name] = mini_path(name, rng, quick, counts)
    res["minis_s"] = time.time() - t0 - res["hubert_s"]
    res["models"]["paligemma-3b"] = paligemma_path(rng, quick, counts)
    torch.cuda.synchronize()
    res["launches"] = {"k2": k2.launch_count(), "k2_expected": counts["k2"],
                       "k4": k4.launch_count(), "k4_expected": counts["k4"]}
    res["wall_s"] = time.time() - t0
    la = res["launches"]
    print(f"  encoder / vlm path {res['wall_s']:.2f}s wall (hubert "
          f"{res['hubert_s']:.1f}s, minis {res['minis_s']:.1f}s); K2 "
          f"launches {la['k2']} (one a layer of every encoder forward on "
          f"the card: {la['k2_expected']}), K4 launches {la['k4']} (the "
          f"sum of ⌈K/128⌉ over the swept consumers: {la['k4_expected']})",
          flush=True)
    if la["k2"] != la["k2_expected"] or la["k4"] != la["k4_expected"] \
            or la["k2"] < 1 or la["k4"] < 1:
        raise AssertionError(f"encoder / vlm path launches {la}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="cut phases 4, 7, 9, 11, 12 and 13 to 4 layers and "
                         "a few requests or steps, phase 14 to "
                         "resnet18-cifar and vgg19-cifar at 10 steps, and "
                         "phase 15 to its reduced configs")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one decode and one prefill step with "
                         "torch.profiler: device busy share, top kernels")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    rng = np.random.default_rng(args.seed)

    print("phase 1: environment", flush=True)
    card = nvidia_smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout.strip()
    print(f"  card: {card}")
    release = [ln.strip() for ln in nvcc.splitlines() if "release" in ln]
    print(f"  python {sys.version.split()[0]} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda} | nvcc: {release[0] if release else nvcc}")
    print("  TF32 off: matmul.allow_tf32=False, cudnn.allow_tf32=False",
          flush=True)

    print("phase 2: build (one nvcc per source, all started together)",
          flush=True)
    t0 = time.time()
    sources = {"paged_attention": K1_SOURCE, "obspa_update": K4_SOURCE,
               "ssd_scan": K3_SOURCE, "flash_attention": K2_SOURCE}
    with ThreadPoolExecutor(len(sources)) as ex:
        for f in [ex.submit(_build.build, n) for n in sources]:
            f.result()
    ensure_built()
    k4.ensure_built()
    k3.ensure_built()
    k2.ensure_built()
    print(f"  built {len(sources)} libraries in {time.time() - t0:.1f}s "
          f"(set-up)", flush=True)
    for name, src in sources.items():
        print(f"  {src} -> {_build.library_path(name)} (nvcc "
              f"{_build.build_seconds.get(name, 0.0):.1f}s)", flush=True)
        log = _build.library_path(name).with_suffix(".log")
        ks = ptxas_kernels(log.read_text()) if log.exists() else []
        regs = [k["registers"] for k in ks if k["registers"] is not None]
        if regs:
            print(f"  ptxas: {len(regs)} kernels, registers "
                  f"{min(regs)}-{max(regs)}, "
                  f"{sum(bool(k['spill_bytes']) for k in ks)} with spills",
                  flush=True)
    k1_build = build_report("paged_attention", "K1")
    if k1_build["sass"] and not k1_build["sass"]["HGMMA"]:
        raise AssertionError("K1's SASS holds no HGMMA (wgmma) instruction")
    k2_build = build_report("flash_attention", "K2")
    k3_build = build_report("ssd_scan", "K3")
    if k3_build["sass"] and not k3_build["sass"]["HMMA"]:
        raise AssertionError("K3's SASS holds no HMMA (mma.sync) instruction")
    k4_build = build_report("obspa_update", "K4")
    spilled = [k["name"] for k in k3_build["kernels"] + k4_build["kernels"]
               if k["spill_bytes"]]
    if spilled:
        raise AssertionError(f"K3 / K4 instances spill registers: {spilled}")
    moe_instances = {"K1": path_instances(k1_build, "K1"),
                     "K2": path_instances(k2_build, "K2")}
    hubert_instances = path_instances(k2_build, "K2", "hubert-xlarge")

    phase_s: dict[str, float] = {}
    t_lap = [t_start]

    def lap(name: str) -> None:
        """Seconds since the previous lap, kept under ``name``."""
        now = time.time()
        phase_s[name] = now - t_lap[0]
        t_lap[0] = now
        print(f"  [{name}: {phase_s[name]:.1f}s; {now - t_start:.1f}s since "
              f"the start]", flush=True)

    lap("phases 1-2")
    worst = phase_kernel_checks(rng, args.seed)
    lap("phase 3")
    print("phase 3b: kernel times at the main path's shapes (bf16)",
          flush=True)
    kernels = [
        time_kernel("paged_attention.decode", rng, C=1, NB=80, prefill=False,
                    iters=40),
        time_kernel("paged_attention.prefill", rng, C=128, NB=80,
                    prefill=True, iters=12),
    ]
    # qwen2-moe-a2.7b's shapes (phase 13), from a generator of their own
    moe_rng = np.random.default_rng([args.seed, 13, 2])
    k1_moe = [time_kernel(f"{k['name']} qwen2-moe", moe_rng, C=c, NB=32,
                          prefill=c > 1, iters=it, shape=K1_TIMED_MOE)
              for k, c, it in ((kernels[0], 1, 40), (kernels[1], 128, 12))]
    # the speculative verify's shape (phase 11b), from a generator of its own
    k1_verify = time_kernel("paged_attention.verify C=4", np.random.default_rng(
        [args.seed, 3, 3]), C=SPEC["k"], NB=32, prefill=True, iters=40,
        shape=K1_TIMED_VERIFY)
    lap("phase 3b")
    k4_rel = phase_k4_checks()
    print("phase 6b: K4 time at the main path's tiles (f32)", flush=True)
    k4_entry, k4_sweep = time_k4()
    lap("phases 6-6b")
    main_res = phase_main_path(rng, args.quick, args.profile, args.seed)
    lap("phase 4")
    front = main_res["front_door"]
    phase_s["phase 4b (within phase 4)"] = front["seconds"]
    kernels[0]["launches"] = main_res["k1_launches"]["decode"]
    kernels[1]["launches"] = main_res["k1_launches"]["prefill"]
    for k, entry in (("decode", kernels[0]), ("prefill", kernels[1])):
        entry["launches_front_door_async"] = \
            front["async_vs_lockstep"]["async"][0]["k1_launches"][k]
    kernels[0]["build"] = kernels[1]["build"] = build_summary(k1_build)
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], worst)
    dev_res = phase_device_code(rng)
    prune_res = phase_prune_path(rng, args.quick)
    lap("phases 5, 7")
    k4_entry["launches"] = prune_res["k4_launches"]
    k4_entry["max_rel_err_vs_oracle"] = k4_rel
    k4_entry["build"] = build_summary(k4_build)
    kernels.append(k4_entry)
    k3_rel = phase_k3_checks()
    print("phase 8b: K3 time at the full-width and two pruned forwards' "
          "shapes", flush=True)
    k3_entry = time_k3()
    lap("phases 8-8b")
    mamba_res = phase_mamba2_path(rng, args.quick)
    lap("phase 9")
    k3_entry["launches"] = mamba_res["k3_launches"]
    k3_entry["max_rel_err"] = k3_rel
    k3_entry["build"] = build_summary(k3_build)
    kernels.append(k3_entry)
    k2_err, k2_hubert_err = phase_k2_checks()
    print("phase 10b: K2 time at the main path's shape", flush=True)
    k2_entry = time_k2()
    k2_entry["build"] = build_summary(k2_build)
    k2_moe = time_k2(shape=K2_MOE)
    k2_hubert = time_k2(shape=K2_HUBERT)
    k2_hubert["max_abs_err"] = max(k2_hubert["max_abs_err"], k2_hubert_err)
    lap("phases 10-10b")
    any_res = phase_any_time(args.quick, args.seed)
    lap("phase 11")
    phase_s["phase 11b (within phase 11)"] = any_res["spec_serve"]["seconds"]
    spec_runs = [v for v in any_res["spec_serve"].values()
                 if isinstance(v, dict) and "k1_launches" in v]
    for k, entry in (("decode", kernels[0]), ("prefill", kernels[1])):
        entry["launches_spec"] = sum(r["k1_launches"][k] for r in spec_runs)
    k2_entry["launches"] = any_res["k2_launches"]
    k2_entry["launches_teacher_forcing"] = {
        "phase_4": main_res["k2_launches_teacher_forcing"],
        "phase_7": prune_res["k2_launches"]}
    k2_entry["max_abs_err"] = max(k2_entry["max_abs_err"], k2_err)
    kernels.append(k2_entry)
    # phase 12 draws its prompts from a generator of its own, so that its
    # launch counts do not depend on what the earlier phases drew
    hybrid_res = phase_hybrid_path(np.random.default_rng([args.seed, 12, 1]),
                                   args.quick)
    lap("phase 12")
    hl = hybrid_res["launches"]
    kernels[0]["launches_hybrid"] = hl["k1_decode"]
    kernels[1]["launches_hybrid"] = hl["k1_prefill"]
    k4_entry["launches_hybrid"] = hl["k4"]
    k4_entry["launches_mamba2"] = mamba_res["k4_launches"]
    k3_entry["launches_hybrid"] = hl["k3"]
    k2_entry["launches_hybrid"] = hl["k2"]
    moe_res = phase_moe_path(args.seed, args.quick)
    lap("phase 13")
    ml = moe_res["launches"]
    kernels[0]["launches_moe"] = ml["k1_decode"]
    kernels[1]["launches_moe"] = ml["k1_prefill"]
    k2_entry["launches_moe"] = ml["k2"]
    k4_entry["launches_moe"] = ml["k4"]
    # phase 14 draws its data from a generator of its own
    cnn_res = phase_cnn_path(args.seed, args.quick)
    lap("phase 14")
    k4_entry["launches_cnn"] = cnn_res["k4_launches"]
    # phase 15 draws its data from a generator of its own
    enc_res = phase_encoder_vlm_path(args.seed, args.quick)
    lap("phase 15")
    k2_entry["launches_encoder_vlm"] = enc_res["launches"]["k2"]
    k4_entry["launches_encoder_vlm"] = enc_res["launches"]["k4"]
    timed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "library_gqa_ms", "device_ms", "share_of_bound",
                  "max_abs_err", "instance", "shape", "bytes", "flops")
    for entry, timed in ((kernels[0], k1_moe[0]), (kernels[1], k1_moe[1]),
                         (k2_entry, k2_moe)):
        entry["qwen2_moe"] = {key: timed.get(key) for key in timed_keys}
    kernels[1]["verify"] = {key: k1_verify.get(key) for key in timed_keys}
    k2_entry["hubert_xlarge"] = {key: k2_hubert.get(key)
                                 for key in timed_keys}
    for label, ks in moe_instances.items():
        entry = kernels[0] if label == "K1" else k2_entry
        entry["qwen2_moe_instances"] = ks
    k2_entry["hubert_xlarge_instances"] = hubert_instances
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was never launched by its "
                                 f"path")

    print(json.dumps({"builds": {"paged_attention": k1_build,
                                 "flash_attention": k2_build,
                                 "ssd_scan": k3_build,
                                 "obspa_update": k4_build}}))
    print(json.dumps({"main_path": main_res}))
    print(json.dumps({"device_code_ms": dev_res}))
    print(json.dumps({"prune_path": prune_res, "k4_sweep": k4_sweep}))
    print(json.dumps({"mamba2_path": mamba_res}))
    print(json.dumps({"any_time_path": any_res}))
    print(json.dumps({"hybrid_path": hybrid_res}))
    print(json.dumps({"moe_path": moe_res}))
    print(json.dumps({"cnn_path": cnn_res}))
    print(json.dumps({"encoder_vlm_path": enc_res}))
    print(json.dumps({"phase_seconds": phase_s}))
    print(f"total {time.time() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
