"""Pruning orchestration: analyze → group → score → select → physically slice.

The output of ``prune_model`` is a *new* (params, config) pair with smaller
dims — structured pruning as a real shape change (paper Step 4): the pruned
model runs smaller products and a smaller KV cache through the same kernels.

Two selection modes, as in the reference:
  per_group — prune the lowest-scoring fraction within every prunable group
              (keeps layers uniform, which the stacked layer layout needs)
  global    — the paper's globally-normalized ranking (Eq. 1's Norm makes
              groups comparable): units go in order of score until their
              parameters reach ``ratio`` of the prunable total; the default
              for the cnn family, whose layers need not stay uniform
``align_units`` keeps its reference meaning and default (1: no rounding).

Every family of the reference is ported.  A CNN's
``{"params", "state"}`` tree is traced as it is (no layer stack), so the
BatchNorm running statistics are parameters of the trace and are sliced
with their channels.  For the moe family the groups found by propagation
are merged by the reference's ``MOE_HINTS``: router column ``e`` and expert
``e``'s weights are coupled through the top-k indices, which no shape rule
can see.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph import (CompGraph, trace_graph, tree_map_paths,
                                    tree_paths)
from repro_torch.core.groups import (MOE_HINTS, Group, build_groups,
                                     merge_by_hints)
from repro_torch.core.importance import (GRADIENT_CRITERIA,
                                         hessian_grad_product, leaf_scores,
                                         unit_scores)
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class PruneResult:
    params: Any                 # pruned params, original (stacked) structure
    cfg: ArchConfig
    report: dict
    groups: list[Group]
    pruned_units: dict[str, list[int]]


class PhaseClock:
    """Seconds per phase, the device synchronised at each lap."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}
        self._t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        now = self._now()
        self.seconds[name] = now - self._t
        self._t = now


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

def analysis_seq(cfg: ArchConfig) -> int:
    """Tokens of the analysis trace: 8, or more to fill one SSM chunk, to
    leave 8 text tokens after a vlm's image prefix, or to reach a sliding
    window."""
    s = 8
    if cfg.ssm_state:
        s = max(s, cfg.ssm_chunk)
    if cfg.family == "vlm":
        s = max(s, cfg.vision_tokens + 8)
    if cfg.sliding_window:
        s = max(s, min(cfg.sliding_window, 32))
    return s


def to_analysis(cfg: ArchConfig, params):
    """The analysis form of a parameter tree: layers as a list (a CNN's
    tree as it is)."""
    if cfg.family == "cnn":
        return params
    return tf.unstack_layers(params, cfg.num_layers)


def trace_model(model, params, batch=None) -> tuple[CompGraph, Any]:
    """Trace the model's unrolled forward over its layers as a list.
    Returns (graph, analysis-form params).

    The trace runs the plain versions (``use_kernels=False``), as the
    reference traces with ``use_pallas=False``: it runs on fake tensors,
    which a kernel launched through ``ctypes`` cannot take."""
    cfg = model.cfg
    tf.require_ported(cfg)
    if batch is None:
        dev = tree_paths(params)[0][1].device
        batch = model.dummy_batch(1, analysis_seq(cfg), device=dev)
    plain = type(model)(cfg.replace(use_kernels=False))
    ap = to_analysis(cfg, params)
    g = trace_graph(lambda p, b: plain.forward(p, b), ap, batch)
    return g, ap


def group_graph(cfg: ArchConfig, g: CompGraph) -> list[Group]:
    """The graph's groups, merged by ``MOE_HINTS`` when the config has
    experts (as the reference's ``analyze`` merges them)."""
    groups = build_groups(g)
    if cfg.n_experts:
        groups = merge_by_hints(groups, MOE_HINTS)
    return groups


def analyze(model, params, clock: PhaseClock | None = None
            ) -> tuple[CompGraph, list[Group], Any]:
    """Trace + group.  Returns (graph, groups, analysis-form params); a
    ``clock`` gets a lap for each of the two."""
    g, ap = trace_model(model, params)
    if clock is not None:
        clock.lap("trace")
    groups = group_graph(model.cfg, g)
    if clock is not None:
        clock.lap("group")
    return g, groups, ap


def prunable(groups: list[Group]) -> list[Group]:
    return [gr for gr in groups if not gr.protected]


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------

def _unit_param_count(gr: Group, shapes: dict[str, tuple]) -> int:
    """Parameters one unit of ``gr`` holds (its slices' share of each
    leaf)."""
    n = 0
    for sl in gr.units[0].slices:
        shp = shapes[sl.path]
        n += len(sl.positions) * int(np.prod(shp)) // shp[sl.axis]
    return n


def _aligned_keep(n_units: int, n_prune: int, align: int, min_keep: int) -> int:
    keep = n_units - n_prune
    keep = max(keep, min_keep, 1)
    if align > 1:
        keep = max((keep // align) * align, min(align, n_units))
    return keep


def _group_align(gr: Group, align_units: int, mesh_divisor: int) -> int:
    """Units-alignment so pruned axis sizes stay mesh-divisible: if a
    coupled axis is divisible by the mesh before pruning, keep it divisible
    after (pruning qwen3's KV groups 8 -> 4 left 8 query heads, which no
    longer divided a 16-way model axis)."""
    a = align_units
    if mesh_divisor > 1:
        # every coupled axis that is mesh-divisible now must stay so
        # (e.g. the q-head axis reached from a KV-group seed)
        for sl in gr.units[0].slices:
            u = len(sl.positions)
            total = u * gr.n_units
            if total % mesh_divisor == 0:
                need = mesh_divisor // math.gcd(u, mesh_divisor)
                a = a * need // math.gcd(a, need)
    return a


def select_units(groups: list[Group], scores: dict[str, np.ndarray],
                 ratio: float, mode: str = "per_group", align_units: int = 1,
                 min_keep: int = 1, shapes: dict | None = None,
                 mesh_divisor: int = 0) -> dict[str, list[int]]:
    """``per_group``: per group, the lowest-scoring ``round(n * ratio)``
    units (aligned).  ``global``: all units in one ranking by score (ties in
    group, then unit order), taken while the parameters they remove are
    below ``ratio`` of all units' parameters and the unit's group keeps
    ``max(min_keep, align_units)``; ``shapes`` (path -> shape) weighs each
    unit by the parameters of its slices (a conv weight counts in the group
    of its input channels and in that of its output channels, as in the
    reference)."""
    pruned: dict[str, list[int]] = {}
    if mode == "per_group":
        for gr in groups:
            s = scores[gr.key]
            n = gr.n_units
            a = _group_align(gr, align_units, mesh_divisor)
            keep = _aligned_keep(n, int(round(n * ratio)), a, min_keep)
            order = np.argsort(s, kind="stable")
            pruned[gr.key] = sorted(int(i) for i in order[: n - keep])
    elif mode == "global":
        if shapes is None:
            raise ValueError("global selection needs the leaves' shapes")
        weights = {gr.key: _unit_param_count(gr, shapes) for gr in groups}
        total = sum(weights[gr.key] * gr.n_units for gr in groups)
        entries = [(float(s), gr.key, u, weights[gr.key])
                   for gr in groups for u, s in enumerate(scores[gr.key])]
        entries.sort(key=lambda e: e[0])
        kept = {gr.key: gr.n_units for gr in groups}
        budget = ratio * total
        removed = 0.0
        sel: dict[str, list[int]] = {gr.key: [] for gr in groups}
        for _, key, u, w in entries:
            if removed >= budget:
                break
            if kept[key] - 1 < max(min_keep, align_units):
                continue
            sel[key].append(u)
            kept[key] -= 1
            removed += w
        # enforce alignment by un-pruning the best of the over-pruned
        for gr in groups:
            keep = _aligned_keep(gr.n_units, len(sel[gr.key]), align_units,
                                 min_keep)
            order = sorted(sel[gr.key],
                           key=lambda u: float(scores[gr.key][u]))
            pruned[gr.key] = sorted(order[:gr.n_units - keep])
    else:
        raise ValueError(f"unknown selection mode {mode!r}")
    return pruned


def default_mode(cfg: ArchConfig) -> str:
    """The reference's default: ``global`` for the cnn family, else
    ``per_group``."""
    return "global" if cfg.family == "cnn" else "per_group"


def leaf_shapes(ap) -> dict[str, tuple]:
    return {path: tuple(x.shape) for path, x in tree_paths(ap)}


# ---------------------------------------------------------------------------
# Execution: physical slicing
# ---------------------------------------------------------------------------

def delete_positions(groups: list[Group], pruned: dict[str, list[int]],
                     ) -> dict[tuple[str, int], set[int]]:
    dele: dict[tuple[str, int], set[int]] = {}
    for gr in groups:
        for u in pruned.get(gr.key, ()):
            for sl in gr.units[u].slices:
                dele.setdefault((sl.path, sl.axis), set()).update(sl.positions)
    return dele


def apply_pruning(analysis_params, dele: dict[tuple[str, int], set[int]]):
    """New tensors without the deleted positions (``index_select`` on the
    device each leaf lives on); untouched leaves are kept as they are."""
    by_path: dict[str, list[tuple[int, set[int]]]] = {}
    for (path, axis), pos in dele.items():
        by_path.setdefault(path, []).append((axis, pos))

    def slice_leaf(path, leaf):
        for axis, pos in by_path.get(path, ()):  # slice each pruned axis
            keep = [i for i in range(leaf.shape[axis]) if i not in pos]
            leaf = leaf.index_select(
                axis, torch.tensor(keep, dtype=torch.long, device=leaf.device))
        return leaf

    return tree_map_paths(slice_leaf, analysis_params)


def infer_config(cfg: ArchConfig, analysis_params) -> ArchConfig:
    """Read the pruned dims back into a new ArchConfig.  A CNN keeps its
    config: its forward reads the widths off the tensors."""
    tf.require_ported(cfg)
    if cfg.family == "cnn":
        return cfg
    layer0 = analysis_params["layers"][0]
    kw: dict[str, Any] = {"name": cfg.name + "-pruned"}
    if "attn" in layer0:
        kw["n_heads"] = int(layer0["attn"]["wq"].shape[1])
        kw["n_kv_heads"] = int(layer0["attn"]["wk"].shape[1])
        kw["head_dim"] = int(layer0["attn"]["wq"].shape[2])
        kw["v_head_dim"] = int(layer0["attn"]["wv"].shape[2])
    if "mlp" in layer0:
        kw["d_ff"] = int(layer0["mlp"]["w_down"].shape[0])
    if "moe" in layer0:
        kw["n_experts"] = int(layer0["moe"]["router"].shape[1])
        kw["moe_d_ff"] = int(layer0["moe"]["w_down"].shape[1])
        kw["top_k"] = min(cfg.top_k, kw["n_experts"])
        if cfg.n_shared_experts:
            total = int(layer0["moe"]["shared"]["w_down"].shape[0])
            kw["shared_d_ff"] = max(total // cfg.n_shared_experts, 1)
    if "ssm" in layer0:
        kw["ssm_heads_override"] = int(layer0["ssm"]["w_x"].shape[1])
        kw["ssm_head_dim"] = int(layer0["ssm"]["w_x"].shape[2])
        kw["ssm_state"] = int(layer0["ssm"]["w_B"].shape[1])
    return cfg.replace(**kw)


def restack(cfg: ArchConfig, analysis_params):
    tf.require_ported(cfg)
    if cfg.family == "cnn":
        return analysis_params
    return tf.stack_layers(analysis_params)


# ---------------------------------------------------------------------------
# Top-level
# ---------------------------------------------------------------------------

def prune_model(model, params, ratio: float, criterion: str = "l1",
                mode: str | None = None, align_units: int = 1,
                grads_batch=None, seed: int = 0,
                mesh_divisor: int = 0) -> PruneResult:
    """End-to-end SPA pruning (paper §3.2 four steps); ``mode`` None is
    ``default_mode(cfg)``.

    ``align_units`` rounds kept unit counts to a multiple (1: none);
    ``mesh_divisor`` keeps previously divisible axes divisible by a
    tensor-parallel degree.  The gradient criteria (snip, grasp, crop)
    differentiate the loss on ``grads_batch`` through the model's plain
    attention (``use_kernels=False``: the flash-attention kernel is forward
    only) with ``torch.func``, without remat.  ``report["seconds"]`` holds
    the time of each phase (trace, group, score, slice)."""
    cfg = model.cfg
    clock = PhaseClock(tree_paths(params)[0][1].device)
    _, groups, ap = analyze(model, params, clock)
    targets = prunable(groups)
    grads = hg = None
    if criterion in GRADIENT_CRITERIA:
        if grads_batch is None:
            raise ValueError(f"criterion {criterion!r} needs a grads batch")
        # torch.func differentiates: no remat (torch.utils.checkpoint
        # raises under its transforms)
        plain = type(model)(cfg.replace(use_kernels=False, remat=False))
        loss = lambda p: plain.loss(p, grads_batch)[0]  # noqa: E731
        if criterion == "snip":
            grads = torch.func.grad(loss)(ap)
        else:
            grads, hg = hessian_grad_product(loss, ap)
    scores_tree = leaf_scores(ap, criterion, grads=grads, hg=hg, seed=seed)
    scores = unit_scores(targets, scores_tree)
    mode = mode or default_mode(cfg)
    pruned = select_units(targets, scores, ratio, mode=mode,
                          align_units=align_units, shapes=leaf_shapes(ap),
                          mesh_divisor=mesh_divisor)
    clock.lap("score")
    dele = delete_positions(targets, pruned)
    new_ap = apply_pruning(ap, dele)
    new_cfg = infer_config(cfg, new_ap)
    new_params = restack(new_cfg, new_ap)
    clock.lap("slice")

    report = {
        "criterion": criterion, "ratio": ratio, "mode": mode,
        "groups_total": len(groups), "groups_pruned": len(targets),
        "units_pruned": {k: len(v) for k, v in pruned.items() if v},
        "seconds": clock.seconds,
    }
    return PruneResult(new_params, new_cfg, report, targets, pruned)
