"""Optimal Brain SPA (paper §3.3) — structured train-prune, no fine-tuning.

Per prunable group, the *consumer* weights (products whose contracted input
channels the group removes) get:
  1. a layer Hessian  H = X Xᵀ (+ λ·mean(diag)·I)  accumulated from
     calibration activations captured by re-executing the computational
     graph (no hooks — the graph IS the interpreter);
  2. layer-OBS unit scores  Σ_cols W[:,j]² / [H⁻¹]ⱼⱼ  aggregated per
     coupled-channel unit (Eq. 1), normalized within the group;
  3. the SparseGPT-style column-sweep reconstruction (Eq. 13/14) over the
     pruned columns — the ``obspa_update`` sweep, whose in-block chain is
     the CUDA kernel K4 on the card.

Producer weights (whose *output* channels die) are simply sliced; a group
with no product consumer falls back to magnitude scoring with no
reconstruction, as in the reference.  The consumers are found on the ATen
graph of every family: ``attn.wo`` and ``mlp.w_down`` (dense, hybrid,
and the audio and vlm families, calibrated on frames or on patches and
tokens), the SSD block's ``ssm.w_out`` over its heads and head_dim (ssm
and hybrid), and for the moe family the experts' ``moe.w_down`` ``(E, f,
d)`` (the expert axis a batch axis of its product: one Hessian per expert
from the rows dispatched to it, capacity padding included, as the
reference counts them; all experts sweep in one K4 launch, on its grid's
y) and the shared experts' ``moe.shared.w_down``.  Whole experts (router
column + expert weights, merged by ``MOE_HINTS``) have no consumer: an
expert is a batch axis, not a contraction, so magnitude scores them.  The
SSM state group has none (``B`` meets ``C`` inside the scan, a product of
two activations), so magnitude scores it.  For the cnn family every
``conv2d`` that reads a pruned group on its input channels (groups 1) is a
consumer, as in the reference: its HWIO weight viewed ``(1, C_out, C_in ·
kh · kw)`` and its input unfolded (``F.unfold``, the consumer's own
stride and padding) into rows of the same column order, one Hessian a
(feature map, convolution) pair, so that a 3x3 convolution and a 1x1
projection reading one map keep theirs apart; the classifier ``fc`` is a
product consumer.  After the sweep, the BatchNorm running statistics are
re-estimated from the calibration batches (paper App. B.3;
``recalibrate_bn``), except with DataFree calibration.

Everything runs on the device the parameters live on: activations are
captured there, ``H`` accumulates there in f32 and is inverted there in
float64 (the reference does both on the host in numpy, outside any Pallas
kernel).  Scoring and sweeps run in f32; weights are cast back to their
dtype.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import (CompGraph, OpNode, tree_map_paths,
                                    tree_paths)
from repro_torch.core.groups import Group
from repro_torch.core.importance import leaf_scores, unit_scores
from repro_torch.core.pruner import (PhaseClock, PruneResult,
                                     apply_pruning, default_mode,
                                     delete_positions, group_graph,
                                     infer_config, leaf_shapes, prunable,
                                     restack, select_units, to_analysis,
                                     trace_model)
from repro_torch.kernels.obspa_update import obspa_sweep, obspa_sweep_batched
from repro_torch.kernels.obspa_update.ops import full_f32_matmul
from repro_torch.models.cnn import cnn_forward

DAMPING = 0.01      # λ of H + λ·mean(diag H)·I, the reference's default
_PRODUCTS = ("einsum", "matmul", "mm", "bmm")
_CASTS = ("to", "_to_copy", "clone", "contiguous", "alias", "detach")


# ---------------------------------------------------------------------------
# Consumer discovery
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Consumer:
    param_path: str
    op: OpNode
    x_uid: int
    param_contract: tuple[int, ...]
    param_batch: tuple[int, ...]
    x_contract: tuple[int, ...]   # aligned pairwise with param_contract
    x_batch: tuple[int, ...]      # aligned pairwise with param_batch
    kind: str = "dot"             # "dot" | "conv" (x unfolded into patches)


def _real_consumers(node):
    """Consumers, following through dtype casts."""
    out = []
    stack = [node]
    while stack:
        n = stack.pop()
        for op in n.consumers:
            if op.prim in _CASTS:
                stack.append(op.outvars[0])
            else:
                out.append((op, n))
    return out


def _conv_consumers(perm_op: OpNode, path: str, axis: int) -> list[Consumer]:
    """The ``conv2d`` ops that take ``permute(param)`` as their weight (a
    CNN's HWIO leaf viewed OIHW) with ``axis`` on their input channels and
    groups 1.  The contracted axes are the leaf's (C_in, kh, kw), in the
    order of ``F.unfold``'s columns; the output channel is the free one."""
    perm = [d % 4 for d in perm_op.params["args"][1]]
    found = []
    for op, used in _real_consumers(perm_op.outvars[0]):
        if op.prim != "conv2d" or op.invars[1] is not used \
                or _conv_geometry(op)["groups"] != 1 or perm[1] != axis:
            continue
        xv = op.invars[0]
        if not (xv.is_param or xv.is_const):
            found.append(Consumer(path, op, xv.uid, tuple(perm[1:]), (),
                                  (), (), kind="conv"))
    return found


def _conv_geometry(op: OpNode) -> dict:
    """stride, padding, dilation and groups of a traced ``conv2d``
    (arguments 3-6, where the trace kept them)."""
    args, kw = op.params["args"], op.params["kwargs"]
    return {name: args[i] if len(args) > i else kw.get(name, default)
            for i, (name, default) in enumerate(
                (("stride", 1), ("padding", 0), ("dilation", 1),
                 ("groups", 1)), start=3)}


def find_consumers(g: CompGraph, groups: list[Group]
                   ) -> dict[tuple[str, int], list[Consumer]]:
    """(param_path, axis) -> product and convolution consumers contracting
    that axis."""
    out: dict[tuple[str, int], list[Consumer]] = {}
    for gr in groups:
        for sl in gr.units[0].slices:
            key = (sl.path, sl.axis)
            if key in out:
                continue
            found = []
            for op, used in _real_consumers(g.params[sl.path]):
                if op.prim == "permute" and len(used.shape) == 4:
                    found += _conv_consumers(op, sl.path, sl.axis)
                    continue
                if op.prim not in _PRODUCTS or len(op.invars) != 2:
                    continue
                ins, out_spec = op.params["spec"]
                for side in (0, 1):
                    if op.invars[side] is not used:
                        continue
                    xv = op.invars[1 - side]
                    if xv.is_param or xv.is_const:
                        continue
                    ps, xs = ins[side], ins[1 - side]
                    contract = [c for c in ps if c in xs and c not in out_spec]
                    batch = [c for c in ps if c in xs and c in out_spec]
                    if ps[sl.axis] in contract:
                        found.append(Consumer(
                            sl.path, op, xv.uid,
                            tuple(ps.index(c) for c in contract),
                            tuple(ps.index(c) for c in batch),
                            tuple(xs.index(c) for c in contract),
                            tuple(xs.index(c) for c in batch)))
            out[key] = found
    return out


# ---------------------------------------------------------------------------
# 2-D views (weight columns aligned with activation features)
# ---------------------------------------------------------------------------

def _dot_w2d(w: torch.Tensor, c: Consumer) -> tuple[torch.Tensor, tuple]:
    """-> (B, R, K) with contract dims flattened last; returns inverse info.
    A conv consumer's HWIO weight comes out ``(1, C_out, C_in·kh·kw)``, the
    reference's ``_conv_w2d``."""
    nd = w.ndim
    free = [d for d in range(nd) if d not in c.param_contract
            and d not in c.param_batch]
    perm = list(c.param_batch) + free + list(c.param_contract)
    wt = w.permute(perm)
    B = int(np.prod([w.shape[d] for d in c.param_batch])) or 1
    R = int(np.prod([w.shape[d] for d in free])) or 1
    K = int(np.prod([w.shape[d] for d in c.param_contract]))
    return wt.reshape(B, R, K), (perm, tuple(wt.shape))


def _dot_w2d_inverse(w2d: torch.Tensor, inv: tuple) -> torch.Tensor:
    perm, tshape = inv
    return w2d.reshape(tshape).permute(list(np.argsort(perm))).contiguous()


def _flat_columns(w_shape: tuple, c: Consumer, axis: int,
                  positions: tuple[int, ...]) -> np.ndarray:
    """Positions on one contract axis -> flat K-column indices."""
    sizes = [w_shape[d] for d in c.param_contract]
    ci = list(c.param_contract).index(axis)
    m = np.zeros(sizes, bool)
    sel = [slice(None)] * len(sizes)
    sel[ci] = np.asarray(sorted(positions))
    m[tuple(sel)] = True
    return np.nonzero(m.reshape(-1))[0]


def _x2d(x: torch.Tensor, c: Consumer) -> torch.Tensor:
    """Activation -> (B, N, K) aligned with _dot_w2d columns.  A conv
    consumer's NCHW input becomes its patches (N·positions, C_in·kh·kw),
    unfolded at the consumer's own stride, padding and dilation."""
    if c.kind == "conv":
        geo = _conv_geometry(c.op)
        cols = F.unfold(x, tuple(c.op.invars[1].shape[2:]),
                        dilation=geo["dilation"], padding=geo["padding"],
                        stride=geo["stride"])
        return cols.transpose(1, 2).reshape(1, -1, cols.shape[1])
    nd = x.ndim
    free = [d for d in range(nd) if d not in c.x_contract
            and d not in c.x_batch]
    perm = list(c.x_batch) + free + list(c.x_contract)
    B = int(np.prod([x.shape[d] for d in c.x_batch])) or 1
    N = int(np.prod([x.shape[d] for d in free])) or 1
    K = int(np.prod([x.shape[d] for d in c.x_contract]))
    return x.permute(perm).reshape(B, N, K)


# ---------------------------------------------------------------------------
# Hessian accumulation via graph re-execution
# ---------------------------------------------------------------------------

def hkey(c: Consumer) -> tuple[int, int]:
    """Hessian key: activation node x consumer op (two ops may read one
    map through other windows — a 3x3 conv and a 1x1 projection)."""
    return (c.x_uid, c.op.uid)


def hessian_sums(g: CompGraph, ap, calib_batches: list, consumers: dict
                 ) -> tuple[dict, dict]:
    """hkey -> (Σ XᵀX (B, K, K) f32 on the device, token count)."""
    pvals = dict(tree_paths(ap))
    every = {hkey(c): c for cs in consumers.values() for c in cs}
    cap_uids = {c.x_uid for c in every.values()}
    H: dict[tuple[int, int], torch.Tensor] = {}
    count: dict[tuple[int, int], int] = {}
    with full_f32_matmul():
        for batch in calib_batches:
            inputs = [t for _, t in tree_paths(batch)]
            _, captured = g.evaluate(pvals, inputs, capture=cap_uids)
            for k, c in every.items():
                x2 = _x2d(captured[c.x_uid].float(), c)
                h = torch.matmul(x2.transpose(1, 2), x2)
                H[k] = H[k] + h if k in H else h
                count[k] = count.get(k, 0) + x2.shape[1]
            del captured
    return H, count


def invert_hessians(H: dict, count: dict) -> dict:
    """hkey -> inverse of the damped mean Hessian (B, K, K) f32; the float64
    inverse, as the reference takes it.  Empties ``H`` as it goes."""
    Hinv: dict[tuple[int, int], torch.Tensor] = {}
    for k in list(H):
        h = H.pop(k) / max(count[k], 1)
        K = h.shape[-1]
        lam = DAMPING * torch.clamp(
            torch.diagonal(h, dim1=-2, dim2=-1).sum(-1) / K, min=1e-8)
        h = h + lam[:, None, None] * torch.eye(K, dtype=h.dtype,
                                               device=h.device)[None]
        Hinv[k] = torch.linalg.inv(h.double()).float().contiguous()
    return Hinv


# ---------------------------------------------------------------------------
# Scoring (layer-OBS, Eq. 12, grouped via Eq. 1)
# ---------------------------------------------------------------------------

def obs_unit_scores(groups: list[Group], consumers: dict, ap, Hinv: dict
                    ) -> tuple[dict[str, np.ndarray], dict[str, bool]]:
    """Per group: unit scores normalised by their mean, and whether a
    consumer with a Hessian scored them (else L2 magnitude did)."""
    by_path = dict(tree_paths(ap))
    mag_scores = None
    out: dict[str, np.ndarray] = {}
    has_obs: dict[str, bool] = {}
    for gr in groups:
        vals = np.zeros(gr.n_units, np.float64)
        found = False
        # per-(path,axis) precomputed per-flat-column scores for each consumer
        col_scores: dict[tuple[str, int], list] = {}
        for sl in gr.units[0].slices:
            key = (sl.path, sl.axis)
            entries = []
            for c in consumers.get(key, ()):
                if hkey(c) not in Hinv:
                    continue
                w = by_path[sl.path]
                w2d = _dot_w2d(w.float(), c)[0]
                diag = torch.diagonal(Hinv[hkey(c)], dim1=-2, dim2=-1)
                sc = (w2d.square().sum(dim=1) / diag.clamp(min=1e-12)
                      ).sum(dim=0)                                # (K,)
                entries.append((c, sc.cpu().numpy(), tuple(w.shape)))
            col_scores[key] = entries
        for u, cc in enumerate(gr.units):
            for sl in cc.slices:
                for c, sc, wshape in col_scores[(sl.path, sl.axis)]:
                    cols = _flat_columns(wshape, c, sl.axis, sl.positions)
                    vals[u] += float(sc[cols].sum())
                    found = True
        if not found:
            if mag_scores is None:
                mag_scores = leaf_scores(ap, "l2")
            vals = unit_scores([gr], mag_scores, agg="sum", norm="none")[gr.key]
        v = np.asarray(vals, np.float64)
        out[gr.key] = v / max(v.mean(), 1e-12)
        has_obs[gr.key] = found
    return out, has_obs


# ---------------------------------------------------------------------------
# Reconstruction
# ---------------------------------------------------------------------------

def reconstruct(ap, groups: list[Group], pruned: dict[str, list[int]],
                consumers: dict, Hinv: dict):
    """Apply the Eq. 13/14 sweep to every consumer, then return new params
    (full width: the pruned positions are sliced afterwards)."""
    leaves = dict(tree_paths(ap))

    # consumer -> flat prune mask over K columns (union across groups/axes)
    masks: dict[tuple[str, int], dict] = {}
    for gr in groups:
        for u in pruned.get(gr.key, ()):
            for sl in gr.units[u].slices:
                key = (sl.path, sl.axis)
                for c in consumers.get(key, ()):
                    if hkey(c) not in Hinv:
                        continue
                    ck = (sl.path, c.op.uid)
                    ent = masks.setdefault(ck, {"c": c, "cols": set()})
                    cols = _flat_columns(tuple(leaves[sl.path].shape), c,
                                         sl.axis, sl.positions)
                    ent["cols"].update(int(v) for v in cols)

    for (path, _), ent in masks.items():
        c: Consumer = ent["c"]
        w = leaves[path]
        w2d, inv = _dot_w2d(w.float(), c)
        B, R, K = w2d.shape
        mask = torch.zeros(K, dtype=torch.bool, device=w.device)
        mask[torch.tensor(sorted(ent["cols"]), dtype=torch.long,
                          device=w.device)] = True
        hin = Hinv[hkey(c)]
        if hin.shape[0] == 1 and B == 1:
            new = obspa_sweep(w2d[0], hin[0], mask)[None]
        else:
            hb = hin if hin.shape[0] == B else hin.expand(B, K, K)
            new = obspa_sweep_batched(w2d, hb, mask)
        leaves[path] = _dot_w2d_inverse(new, inv).to(w.dtype)

    return tree_map_paths(lambda p, _: leaves[p], ap)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def obspa_prune(model, params, ratio: float, calib_batches: list,
                calib_mode: str = "id", mode: str | None = None,
                recalibrate: bool = True) -> PruneResult:
    """OBSPA pruning of a model on the device its parameters live on, with
    the reference's defaults (damping ``DAMPING``, scores normalised by
    their mean, no unit alignment; ``mode`` None is ``default_mode(cfg)``:
    global for a CNN, per group otherwise).  A CNN's BatchNorm statistics
    are then re-estimated from ``calib_batches`` (``recalibrate_bn``)
    unless ``calib_mode`` is ``datafree`` or ``recalibrate`` is False.
    ``report["seconds"]`` holds the time of each phase (trace, group,
    hessians, inverse, score, sweep, slice, and recalibrate for a CNN)."""
    cfg = model.cfg
    mode = mode or default_mode(cfg)
    clock = PhaseClock(tree_paths(params)[0][1].device)
    # trace at the calibration batch's shapes: the graph interpreter replays
    # the trace on the calibration data, and the trace is shape-specialized
    graph, ap = trace_model(model, params, batch=calib_batches[0])
    clock.lap("trace")
    targets = prunable(group_graph(cfg, graph))
    consumers = find_consumers(graph, targets)
    clock.lap("group")
    H, count = hessian_sums(graph, ap, calib_batches, consumers)
    clock.lap("hessians")
    Hinv = invert_hessians(H, count)
    clock.lap("inverse")
    scores, has_obs = obs_unit_scores(targets, consumers, ap, Hinv)
    pruned = select_units(targets, scores, ratio, mode=mode,
                          shapes=leaf_shapes(ap))
    clock.lap("score")
    ap = reconstruct(ap, targets, pruned, consumers, Hinv)
    del Hinv
    clock.lap("sweep")
    dele = delete_positions(targets, pruned)
    new_ap = apply_pruning(ap, dele)
    new_cfg = infer_config(cfg, new_ap)
    new_params = restack(new_cfg, new_ap)
    clock.lap("slice")
    if recalibrate and cfg.family == "cnn" and calib_mode != "datafree":
        new_params = recalibrate_bn(new_cfg, new_params, calib_batches)
        clock.lap("recalibrate")

    report = {
        "criterion": "obspa", "ratio": ratio, "mode": mode,
        "calib_mode": calib_mode,
        "groups_with_obs": sum(has_obs.values()),
        "groups_total": len(targets),
        "units_pruned": {k: len(v) for k, v in pruned.items() if v},
        "seconds": clock.seconds,
    }
    return PruneResult(new_params, new_cfg, report, targets, pruned)


@torch.no_grad()
def recalibrate_bn(cfg, params, calib_batches: list, passes: int = 2):
    """Paper App. B.3: forward the calibration images through train-mode
    BatchNorm ``passes`` times and keep the running statistics it leaves."""
    state = params["state"]
    for _ in range(passes):
        for b in calib_batches:
            _, state = cnn_forward(cfg, params["params"], state,
                                   b["images"], train=True)
    return {"params": params["params"], "state": state}


# ---------------------------------------------------------------------------
# Check: layer-output error of every reconstructed consumer
# ---------------------------------------------------------------------------

def _embed(leaf: torch.Tensor, shape: tuple, dele: dict, path: str
           ) -> torch.Tensor:
    """A pruned leaf put back at full width, zeros at deleted positions."""
    for (p, axis), pos in sorted(dele.items()):
        if p != path:
            continue
        keep = torch.tensor([i for i in range(shape[axis]) if i not in pos],
                            dtype=torch.long, device=leaf.device)
        full_shape = list(leaf.shape)
        full_shape[axis] = shape[axis]
        full = leaf.new_zeros(full_shape)
        full.index_copy_(axis, keep, leaf)
        leaf = full
    return leaf


def layer_output_errors(model, params, result: PruneResult,
                        calib_batches: list) -> dict[str, tuple[float, float]]:
    """For every consumer whose input columns were pruned: the summed
    squared layer-output error over the calibration tokens, ``‖X(W − W')‖²``,
    for W' = the pruned model's weight (reconstructed, zeros at every
    deleted position) and for W' = W with the same positions simply cut.
    Both zero a deleted batch entry whole (a pruned expert of ``moe.w_down``),
    so the two differ only where OBSPA reconstructed.  X are the dense
    model's activations, which is what OBSPA's Hessian sees.
    Returns {"path@op": (obspa error, plain-slicing error)}."""
    graph, ap = trace_model(model, params, batch=calib_batches[0])
    consumers = find_consumers(graph, result.groups)
    H, count = hessian_sums(graph, ap, calib_batches, consumers)
    dele = delete_positions(result.groups, result.pruned_units)
    dense = dict(tree_paths(ap))
    pruned = dict(tree_paths(to_analysis(result.cfg, result.params)))
    out: dict[str, tuple[float, float]] = {}
    with full_f32_matmul():
        for (path, _), cs in consumers.items():
            for c in cs:
                name = f"{path}@{c.op.uid}"
                shape = tuple(dense[path].shape)
                cols = [_flat_columns(shape, c, a, tuple(sorted(pos)))
                        for (p, a), pos in dele.items()
                        if p == path and a in c.param_contract]
                if name in out or not cols:
                    continue
                w = dense[path].float()
                w2d = _dot_w2d(w, c)[0]
                p2d = _dot_w2d(_embed(pruned[path].float(), shape, dele,
                                      path), c)[0]
                sliced = apply_pruning({path: w}, dele)[path]
                c2d = _dot_w2d(_embed(sliced, shape, dele, path), c)[0]
                h = H[hkey(c)]
                errs = []
                for d in (w2d - p2d, w2d - c2d):
                    errs.append(float((torch.matmul(d, h) * d).sum()))
                out[name] = (errs[0], errs[1])
    return out
