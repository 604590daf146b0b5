"""Grouping coupled channels (paper Alg. 2) + group classification.

For each not-yet-covered (param, axis) we propagate ONE seed channel to
closure (paper's O(|E|) optimization: all units in a group follow the same
pattern).  The closure determines the *unit size* on every touched (param,
axis); per-unit masks are generated by translation and validated against a
second propagation of the last unit — if the translation assumption fails
we fall back to exact per-unit propagation.

A group is *protected* when its closure reaches structurally untouchable
axes (vocab rows, the residual stream / final norm, RoPE'd head_dim
scales, classifier columns).  Protected groups are still discovered and
reported — the paper's residual-trunk groups exist, policy just refuses to
prune them by default.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import CompGraph, DataNode
from repro_torch.core.propagate import propagate


@dataclasses.dataclass
class ParamSlice:
    path: str
    axis: int
    positions: tuple[int, ...]


@dataclasses.dataclass
class CoupledChannels:
    """One prunable unit: channels across params that die together."""
    slices: list[ParamSlice]


@dataclasses.dataclass
class Group:
    key: str                       # "<seed param path>:<axis>"
    kind: str                      # mlp | heads | expert | expert_mlp | ...
    units: list[CoupledChannels]
    protected: bool
    reason: str = ""
    # closure over activations too (node uids) — used by OBSPA capture
    closure: dict = dataclasses.field(default_factory=dict)

    @property
    def n_units(self) -> int:
        return len(self.units)


# params whose listed axis must never be pruned (policy, paper-consistent)
def default_protected_axes(g: CompGraph) -> set[tuple[str, int]]:
    prot: set[tuple[str, int]] = set()
    for path, node in g.params.items():
        leaf = path.rsplit(".", 1)[-1]
        if leaf in ("tok_embed",):
            prot.add((path, 0))       # vocab rows
            prot.add((path, 1))       # residual stream
        if leaf in ("head", "fc"):
            prot.add((path, len(node.shape) - 1))   # class / vocab columns
        if leaf in ("final_norm",):
            prot.add((path, 0))
        if leaf in ("q_norm", "k_norm"):
            prot.add((path, 0))       # RoPE'd head_dim
        if leaf in ("frame_proj", "vision_proj"):
            prot.add((path, 1))       # residual stream
        if leaf == "conv_w":
            prot.add((path, 0))       # SSM conv tap (temporal) axis
        if (leaf.startswith("conv") or leaf == "proj" or leaf == "stem_conv") \
                and len(node.shape) == 4:
            prot.add((path, 0))       # conv kernel spatial axes (HWIO)
            prot.add((path, 1))
    return prot


def classify(seed_path: str, axis: int, node: DataNode) -> str:
    p = seed_path
    leaf = p.rsplit(".", 1)[-1]
    if ".mlp." in p or leaf in ("w_gate", "w_up", "w_down") and ".moe." not in p:
        return "mlp"
    if ".moe." in p:
        if leaf == "router" or axis == 0:
            return "expert"
        return "expert_mlp"
    if ".attn." in p:
        return "heads" if axis in (1,) or leaf == "wo" else "attn_in"
    if ".ssm." in p:
        return "ssm_heads" if leaf in ("w_x", "w_z", "w_dt", "w_out",
                                       "A_log", "D", "dt_bias") else "ssm_state"
    if leaf.startswith("conv") or ".conv" in p or leaf in ("stem_conv",):
        return "conv"
    return "other"


def _param_masks(g: CompGraph, closure: dict) -> dict[tuple[str, int], frozenset]:
    """Restrict a propagation closure to parameter nodes."""
    uid_to_param = {n.uid: p for p, n in g.params.items()}
    out = {}
    for (uid, axis), pos in closure.items():
        if uid in uid_to_param:
            out[(uid_to_param[uid], axis)] = pos
    return out


def _unit_of(pos: frozenset) -> tuple[int, int]:
    """(start, contiguous length) if positions form one block else (-1, len)."""
    s = sorted(pos)
    if s[-1] - s[0] + 1 == len(s):
        return s[0], len(s)
    return -1, len(s)


def build_groups(g: CompGraph) -> list[Group]:
    protected_axes = default_protected_axes(g)
    covered: set[tuple[str, int]] = set()
    groups: list[Group] = []

    for path in sorted(g.params):
        node = g.params[path]
        for axis in range(len(node.shape)):
            if node.shape[axis] <= 1 or (path, axis) in covered:
                continue
            closure0 = propagate(g, [(node, axis, frozenset({0}))])
            pmask0 = _param_masks(g, closure0)
            if (path, axis) not in pmask0:
                covered.add((path, axis))
                continue

            # unit size on the seed axis after closure (e.g. GQA group of G)
            seed_pos = pmask0[(path, axis)]
            start, ulen = _unit_of(seed_pos)
            size = node.shape[axis]
            if start != 0 or size % ulen != 0:
                # irregular: treat the whole axis as a single unit
                ulen = size
            n_units = size // ulen

            # per-(param,axis) pattern: positions for unit 0 + stride
            pattern: dict[tuple[str, int], tuple[np.ndarray, int]] = {}
            consistent = True
            for (pp, aa), pos in pmask0.items():
                arr = np.fromiter(sorted(pos), dtype=np.int64)
                pnode = g.params[pp]
                psize = pnode.shape[aa]
                if len(arr) * n_units == psize:
                    stride = len(arr)
                elif len(arr) == psize:
                    stride = 0             # fully covered by every unit
                else:
                    consistent = False
                    stride = 0
                pattern[(pp, aa)] = (arr, stride)

            if consistent and n_units > 1:
                last = n_units - 1
                seed_last = frozenset(range(last * ulen, (last + 1) * ulen))
                closure_last = propagate(g, [(node, axis, seed_last)])
                pmask_last = _param_masks(g, closure_last)
                if set(pmask_last) != set(pmask0):
                    consistent = False
                else:
                    for (pp, aa), (arr, stride) in pattern.items():
                        want = set(arr + stride * last) if stride else set(arr)
                        if set(pmask_last[(pp, aa)]) != want:
                            consistent = False
                            break

            units: list[CoupledChannels] = []
            if consistent:
                for u in range(n_units):
                    slices = [
                        ParamSlice(pp, aa, tuple(int(v) for v in
                                                 (arr + stride * u)))
                        for (pp, aa), (arr, stride) in sorted(pattern.items())
                    ]
                    units.append(CoupledChannels(slices))
            else:
                # exact fallback: propagate every unit
                seen_pos: set[int] = set()
                u = 0
                while u * ulen < size:
                    seed_u = frozenset(range(u * ulen, (u + 1) * ulen)) - seen_pos
                    if not seed_u:
                        u += 1
                        continue
                    cl = propagate(g, [(node, axis, seed_u)])
                    pm = _param_masks(g, cl)
                    slices = [ParamSlice(pp, aa, tuple(sorted(pos)))
                              for (pp, aa), pos in sorted(pm.items())]
                    units.append(CoupledChannels(slices))
                    seen_pos |= set(pm.get((path, axis), seed_u))
                    u += 1

            prot = False
            reason = ""
            for (pp, aa) in pmask0:
                if (pp, aa) in protected_axes:
                    prot, reason = True, f"touches protected {pp}:{aa}"
                    break
            if not prot:
                # groups coupled to graph inputs/outputs or baked-in
                # constants cannot be pruned: the I/O contract is fixed
                # (RGB channels, stub frontend embeddings, logits classes,
                # RoPE frequency tables, ...)
                leaf_uids = {n.uid for n in g.inputs}
                leaf_uids |= {n.uid for n in g.outputs}
                leaf_uids |= {n.uid for n in g.data.values()
                              if n.is_const and len(n.shape) > 0}
                for (uid, _aa) in closure0:
                    if uid in leaf_uids:
                        prot, reason = True, "coupled to graph input/output/const"
                        break
            if not prot and n_units <= 1:
                prot, reason = True, "single unit (whole-axis) group"

            groups.append(Group(
                key=f"{path}:{axis}",
                kind=classify(path, axis, node),
                units=units,
                protected=prot,
                reason=reason,
                closure=closure0,
            ))
            for (pp, aa) in pmask0:
                covered.add((pp, aa))

    return groups


def merge_by_hints(groups: list[Group],
                   hints: list[list[tuple[str, int]]]) -> list[Group]:
    """Fuse groups whose seeds are semantically coupled through *data values*
    (index arithmetic invisible to shape propagation).

    The canonical case is MoE: router column ``e`` and expert ``e``'s weights
    are coupled through top-k indices, which neither ONNX nor jaxpr shape
    analysis can see.  A hint is a list of ``(param_path_suffix, axis)``; all
    groups whose seed matches one entry of the same hint (within the same
    layer prefix) are merged unit-by-unit.  This is SPA's "define rules for
    novel operators" escape hatch (paper App. A.3) made first-class.
    """
    out: list[Group] = []
    used: set[int] = set()
    for hint in hints:
        # bucket matching groups by their path prefix (layer)
        buckets: dict[str, list[tuple[int, Group]]] = {}
        for gi, gr in enumerate(groups):
            seed_path, seed_axis = gr.key.rsplit(":", 1)
            for suf, ax in hint:
                if seed_path.endswith(suf) and int(seed_axis) == ax:
                    prefix = seed_path[: -len(suf)]
                    buckets.setdefault(prefix, []).append((gi, gr))
        for prefix, members in buckets.items():
            if len(members) < 2:
                continue
            n_units = {m.n_units for _, m in members}
            if len(n_units) != 1:
                continue
            base_i, base = members[0]
            merged_units = []
            for u in range(base.n_units):
                slices = []
                for _, m in members:
                    slices.extend(m.units[u].slices)
                merged_units.append(CoupledChannels(slices))
            closure = dict(base.closure)
            for _, m in members[1:]:
                closure.update(m.closure)
            out.append(Group(
                key=base.key + "+hint",
                kind=base.kind,
                units=merged_units,
                protected=any(m.protected for _, m in members),
                reason=base.reason,
                closure=closure,
            ))
            used.update(gi for gi, _ in members)
    for gi, gr in enumerate(groups):
        if gi not in used:
            out.append(gr)
    return out


MOE_HINTS = [[("moe.router", 1), ("moe.w_gate", 0), ("moe.w_up", 0),
              ("moe.w_down", 0)]]
