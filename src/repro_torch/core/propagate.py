"""Coupled-channel discovery via mask propagation (paper Alg. 1, App. A.3).

A *mask* is ``(data_node, axis, position-set)``.  Starting from a seed mask
on one parameter axis, masks are pushed through operator nodes using
per-operator rules until fixpoint; the closure is the set of coupled
channels that must be pruned together.

The rules are the ATen counterparts of the reference's per-JAX-primitive
rules (``repro/core/propagate.py``), each equivalent to the primitives the
reference's trace holds for the same model code: ``einsum`` / ``matmul`` take
the ``dot_general`` rule with the equation's letters naming the batch,
contract and free axes; elementwise ops broadcast from the right as
``broadcast_in_dim`` + the elementwise rule do; ``softmax`` is elementwise on
every axis (the reference sees max, sub, exp, sum, div); ``reshape`` uses the
same segment map with the conservative outer-factor cover (the GQA "prune
the whole KV group" closure); ``chunk``/``cat`` carry offsets; ``index`` is
the embedding gather.  For the SSM block: ``pad`` shifts positions by the
low padding of its axis, ``cumsum`` keeps them (the reference's scan rule),
and ``conv1d`` couples channels as ``conv_general_dilated`` does, in
PyTorch's layout (input ``(N, C_in, T)``, weight ``(C_out, C_in/groups,
K)``, output ``(N, C_out, T)``; the depthwise conv of the SSM block has
``groups = C_in``).  ``conv2d`` (the CNNs) takes the same rule with two
spatial axes, and ``max_pool2d`` the reference's ``reduce_window_max``
rule.  For the MoE dispatch: ``sort`` / ``argsort`` / ``topk`` follow the
reference's sort and top_k rules, ``index_put`` its scatter rule and
``stack`` the concatenate rule with a new axis.
"""
from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np

from repro_torch.core.graph import CompGraph, DataNode, GraphError, OpNode

Mask = tuple[DataNode, int, frozenset]
RULES: dict[str, Callable] = {}


def rule(*names):
    def deco(fn):
        for n in names:
            RULES[n] = fn
        return fn
    return deco


def _others(op: OpNode, role: str, idx: int):
    """All (node, role, idx) slots adjacent to op except the given one."""
    out = []
    for i, v in enumerate(op.invars):
        if not (role == "in" and i == idx):
            out.append((v, "in", i))
    for i, v in enumerate(op.outvars):
        if not (role == "out" and i == idx):
            out.append((v, "out", i))
    return out


def _src(op: OpNode, role: str, idx: int) -> DataNode:
    return op.invars[idx] if role == "in" else op.outvars[idx]


def _arg(op: OpNode, i: int, name: str, default=None):
    a = op.params["args"]
    if len(a) > i:
        return a[i]
    return op.params["kwargs"].get(name, default)


def _dim(d: int, nd: int) -> int:
    return d + nd if d < 0 else d


# ---------------------------------------------------------------------------
# Elementwise (with right-aligned broadcasting)
# ---------------------------------------------------------------------------

_ELEMENTWISE = (
    "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum",
    "remainder", "atan2", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "lt", "le", "gt", "ge", "eq", "ne", "neg", "exp", "exp2", "expm1", "log",
    "log1p", "sigmoid", "tanh", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "rsqrt", "sqrt", "square", "abs", "sign", "floor",
    "ceil", "round", "isfinite", "erf", "erfc", "erfinv", "reciprocal",
    "silu", "gelu", "relu", "where", "clamp", "clamp_min", "clamp_max",
    "masked_fill", "to", "_to_copy", "type_as", "clone", "contiguous",
    "alias", "detach", "lift_fresh_copy", "softmax", "_softmax",
    "log_softmax", "_log_softmax", "softplus",
)


@rule(*_ELEMENTWISE)
def _ew(op, role, idx, axis, pos):
    src = _src(op, role, idx)
    size = src.shape[axis]
    out = []
    for node, _, _ in _others(op, role, idx):
        a = axis + len(node.shape) - len(src.shape)
        if 0 <= a < len(node.shape) and node.shape[a] == size:
            out.append((node, a, pos))
    return out


# ---------------------------------------------------------------------------
# Structural ops
# ---------------------------------------------------------------------------

@rule("expand")
def _expand(op, role, idx, axis, pos):
    x, y = op.invars[0], op.outvars[0]
    lead = len(y.shape) - len(x.shape)
    if role == "in":
        if x.shape[axis] == y.shape[axis + lead]:
            return [(y, axis + lead, pos)]
        return []
    a = axis - lead
    if a >= 0 and x.shape[a] == y.shape[axis]:
        return [(x, a, pos)]
    return []


@rule("permute", "transpose", "t")
def _permute(op, role, idx, axis, pos):
    x, y = op.invars[0], op.outvars[0]
    nd = len(x.shape)
    if op.prim == "permute":
        perm = [_dim(d, nd) for d in _arg(op, 1, "dims")]
    elif nd < 2:
        perm = list(range(nd))
    else:
        d0, d1 = (0, 1) if op.prim == "t" else (
            _dim(_arg(op, 1, "dim0"), nd), _dim(_arg(op, 2, "dim1"), nd))
        perm = list(range(nd))
        perm[d0], perm[d1] = perm[d1], perm[d0]
    if role == "in":
        return [(y, perm.index(axis), pos)]
    return [(x, perm[axis], pos)]


def _removed_dims(op) -> list[int]:
    """Axes of the input that ``squeeze`` drops (read off the shapes)."""
    x, y = op.invars[0], op.outvars[0]
    nd = len(x.shape)
    dims = _arg(op, 1, "dim")
    if dims is None:
        dims = [d for d in range(nd) if x.shape[d] == 1]
    elif isinstance(dims, int):
        dims = [dims]
    dims = [_dim(d, nd) for d in dims]
    return [d for d in dims if x.shape[d] == 1] \
        if len(y.shape) < nd else []


@rule("squeeze")
def _squeeze(op, role, idx, axis, pos):
    dims = _removed_dims(op)
    x, y = op.invars[0], op.outvars[0]
    if role == "in":
        if axis in dims:
            return []
        return [(y, axis - sum(1 for d in dims if d < axis), pos)]
    a = axis
    for d in sorted(dims):
        if d <= a:
            a += 1
    return [(x, a, pos)]


@rule("unsqueeze")
def _unsqueeze(op, role, idx, axis, pos):
    x, y = op.invars[0], op.outvars[0]
    d = _dim(_arg(op, 1, "dim"), len(y.shape))
    if role == "in":
        return [(y, axis + (1 if axis >= d else 0), pos)]
    if axis == d:
        return []
    return [(x, axis - (1 if axis > d else 0), pos)]


def _segments(ish: tuple, osh: tuple):
    """Greedy factorization of a reshape into (in_axes, out_axes) segments."""
    segs = []
    i = j = 0
    while i < len(ish) or j < len(osh):
        ia, oa = [i], [j]
        pi = ish[i] if i < len(ish) else 1
        pj = osh[j] if j < len(osh) else 1
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                pi *= ish[i]; ia.append(i); i += 1
            else:
                pj *= osh[j]; oa.append(j); j += 1
        # absorb trailing 1s that belong to this segment
        while i < len(ish) and ish[i] == 1 and (j >= len(osh) or pi == pj):
            if j < len(osh) and osh[j] == 1:
                break
            ia.append(i); i += 1
        segs.append((ia, oa, pi))
    return segs


_MAX_ENUM = 50_000_000


def _reshape_map(ish, osh, axis, pos):
    """Map mask (axis, pos) on in-shape to [(out_axis, posset)] (cover)."""
    for ia, oa, total in _segments(ish, osh):
        if axis in ia:
            if total > _MAX_ENUM:
                raise GraphError(f"reshape segment too large to analyze: {total}")
            in_sizes = [ish[a] for a in ia]
            li = ia.index(axis)
            m = np.zeros(in_sizes, bool)
            sel = [slice(None)] * len(in_sizes)
            sel[li] = np.fromiter(sorted(pos), dtype=np.int64)
            m[tuple(sel)] = True
            flat = np.nonzero(m.reshape(-1))[0]
            out_sizes = [osh[a] for a in oa]
            emits = []
            stride = int(np.prod(out_sizes))
            for lo, mo in zip(oa, out_sizes):
                stride //= mo
                q = np.unique((flat // stride) % mo)
                if len(q) < mo:
                    emits.append((lo, frozenset(int(v) for v in q)))
            if emits:
                return [emits[0]]        # outermost non-full factor (cover)
            # mask covered the whole segment: whole-tensor coupling
            return [(oa[0], frozenset(range(out_sizes[0])))] if out_sizes else []
    return []


@rule("reshape", "view", "_unsafe_view")
def _reshape(op, role, idx, axis, pos):
    x, y = op.invars[0], op.outvars[0]
    if role == "in":
        mapped = _reshape_map(x.shape, y.shape, axis, pos)
        return [(y, a, p) for a, p in mapped]
    mapped = _reshape_map(y.shape, x.shape, axis, pos)
    return [(x, a, p) for a, p in mapped]


@rule("cat")
def _cat(op, role, idx, axis, pos):
    y = op.outvars[0]
    xs = op.invars
    dim = _dim(_arg(op, 1, "dim", 0), len(y.shape))
    offs = np.cumsum([0] + [v.shape[dim] for v in xs])
    out = []
    if role == "in":
        if axis == dim:
            out.append((y, dim, frozenset(p + int(offs[idx]) for p in pos)))
        else:
            out.append((y, axis, pos))
            for i, v in enumerate(xs):
                if i != idx and v.shape[axis] == xs[idx].shape[axis]:
                    out.append((v, axis, pos))
    else:
        if axis == dim:
            for i, v in enumerate(xs):
                lo, hi = int(offs[i]), int(offs[i + 1])
                sub = frozenset(p - lo for p in pos if lo <= p < hi)
                if sub:
                    out.append((v, dim, sub))
        else:
            for v in xs:
                if v.shape[axis] == y.shape[axis]:
                    out.append((v, axis, pos))
    return out


@rule("chunk", "split", "split_with_sizes")
def _split(op, role, idx, axis, pos):
    x = op.invars[0]
    dim = _dim(_arg(op, 2, "dim", 0), len(x.shape))
    offs = np.cumsum([0] + [y.shape[dim] for y in op.outvars])
    out = []
    if role == "in":
        if axis == dim:
            for i, y in enumerate(op.outvars):
                lo, hi = int(offs[i]), int(offs[i + 1])
                sub = frozenset(p - lo for p in pos if lo <= p < hi)
                if sub:
                    out.append((y, dim, sub))
        else:
            for y in op.outvars:
                out.append((y, axis, pos))
    else:
        if axis == dim:
            lo = int(offs[idx])
            out.append((x, dim, frozenset(p + lo for p in pos)))
        else:
            out.append((x, axis, pos))
            for i, y in enumerate(op.outvars):
                if i != idx:
                    out.append((y, axis, pos))
    return out


@rule("slice")
def _slice(op, role, idx, axis, pos):
    x, y = op.invars[0], op.outvars[0]
    dim = _dim(_arg(op, 1, "dim", 0), len(x.shape))
    if axis != dim:
        return [(y if role == "in" else x, axis, pos)]
    n = x.shape[dim]
    start = _arg(op, 2, "start", 0) or 0
    start = min(max(start + n, 0) if start < 0 else start, n)
    step = _arg(op, 4, "step", 1) or 1
    if role == "in":
        sub = set()
        for p in pos:
            q, r = divmod(p - start, step)
            if r == 0 and 0 <= q < y.shape[axis]:
                sub.add(q)
        return [(y, axis, frozenset(sub))] if sub else []
    return [(x, axis, frozenset(p * step + start for p in pos))]


@rule("select")
def _select(op, role, idx, axis, pos):
    x, y = op.invars[0], op.outvars[0]
    dim = _dim(_arg(op, 1, "dim"), len(x.shape))
    if role == "in":
        if axis == dim:
            return []
        return [(y, axis - (1 if axis > dim else 0), pos)]
    return [(x, axis + (1 if axis >= dim else 0), pos)]


@rule("pad", "constant_pad_nd")
def _pad(op, role, idx, axis, pos):
    """``pad(x, pad)``: ``pad`` holds (low, high) pairs from the last axis
    backwards; a position moves by its axis's low padding and drops out
    where the padding cut it off."""
    x, y = op.invars[0], op.outvars[0]
    widths = _arg(op, 1, "pad")
    k = len(x.shape) - 1 - axis
    lo = widths[2 * k] if 2 * k < len(widths) else 0
    hi = widths[2 * k + 1] if 2 * k + 1 < len(widths) else 0
    if (lo or hi) and _arg(op, 2, "mode", "constant") != "constant":
        raise GraphError(f"{op.prim} mode {_arg(op, 2, 'mode')!r} on a "
                         f"padded axis is not supported")
    node, shift = (y, lo) if role == "in" else (x, -lo)
    sub = frozenset(p + shift for p in pos
                    if 0 <= p + shift < node.shape[axis])
    return [(node, axis, sub)] if sub else []


@rule("cumsum")
def _cumulative(op, role, idx, axis, pos):
    """Positions map to themselves on every axis (the reference's rule for
    its scan primitives)."""
    x, y = op.invars[0], op.outvars[0]
    return [(y if role == "in" else x, axis, pos)]


@rule("conv1d", "conv2d")
def _conv(op, role, idx, axis, pos):
    """``conv_general_dilated``'s rule in PyTorch's layout: batch axes
    couple input and output; with ``groups == 1`` input channels couple the
    weight's input axis and output channels the weight's output axis; with
    ``groups > 1`` a channel carries its whole group along.  The spatial
    (time) axes mix positions and couple nothing."""
    if len(op.invars) > 2:
        raise GraphError(f"{op.prim} with a bias is not supported")
    fgc = _arg(op, 6, "groups", 1)
    lhs, rhs, y = op.invars[0], op.invars[1], op.outvars[0]
    icg, ocg = lhs.shape[1] // fgc, rhs.shape[0] // fgc

    def from_out(pos):                 # output channels -> the rest
        out = [(rhs, 0, pos), (y, 1, pos)]
        if fgc > 1:
            groups = {p // ocg for p in pos}
            out.append((lhs, 1, frozenset(
                q for g in groups for q in range(g * icg, (g + 1) * icg))))
        return out

    if role == "in" and idx == 0:
        if axis == 0:
            return [(y, 0, pos)]
        if axis != 1:
            return []
        if fgc == 1:
            return [(rhs, 1, pos)]
        groups = {p // icg for p in pos}
        out = from_out(frozenset(
            q for g in groups for q in range(g * ocg, (g + 1) * ocg)))
        if icg > 1:
            out.append((rhs, 1, frozenset(p % icg for p in pos)))
        return out
    if role == "in":
        if axis == 0:
            return from_out(pos)
        return [(lhs, 1, pos)] if axis == 1 and fgc == 1 else []
    if axis == 0:
        return [(lhs, 0, pos)]
    return from_out(pos) if axis == 1 else []


@rule("max_pool2d", "max_pool2d_with_indices")
def _pool(op, role, idx, axis, pos):
    """The reference's ``reduce_window_max`` rule in PyTorch's layout: the
    pooled (last two) axes mix positions; the batch and channel axes map
    onto every other operand."""
    if axis >= len(op.invars[0].shape) - 2:
        return []
    return [(node, axis, pos) for node, _, _ in _others(op, role, idx)]


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

@rule("mean", "sum", "amax", "amin", "argmax", "argmin", "prod", "any",
      "all", "logsumexp")
def _reduce(op, role, idx, axis, pos):
    x, y = op.invars[0], op.outvars[0]
    nd = len(x.shape)
    dims = _arg(op, 1, "dim")
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return []                          # reduce over everything
    if isinstance(dims, int):
        dims = [dims]
    dims = sorted(_dim(d, nd) for d in dims)
    keep = len(y.shape) == nd
    if role == "in":
        if axis in dims:
            return []
        return [(y, axis if keep else axis - sum(1 for d in dims if d < axis),
                 pos)]
    if keep:
        return [] if axis in dims else [(x, axis, pos)]
    a = axis
    for d in dims:
        if d <= a:
            a += 1
    return [(x, a, pos)]


# ---------------------------------------------------------------------------
# Contractions
# ---------------------------------------------------------------------------

@rule("einsum", "matmul", "mm", "bmm")
def _contract(op, role, idx, axis, pos):
    """The ``dot_general`` rule over einsum letters: a batch letter couples
    both operands and the output, a contracted letter the two operands, a
    free letter its operand and the output."""
    ins, out_spec = op.params["spec"]
    letter = (ins[idx] if role == "in" else out_spec)[axis]
    out = []
    for i, (v, spec) in enumerate(zip(op.invars, ins)):
        if not (role == "in" and i == idx) and letter in spec:
            out.append((v, spec.index(letter), pos))
    if role == "in" and letter in out_spec:
        out.append((op.outvars[0], out_spec.index(letter), pos))
    return out


# ---------------------------------------------------------------------------
# Gather
# ---------------------------------------------------------------------------

@rule("index")
def _index(op, role, idx, axis, pos):
    """``x[idx]`` with one index tensor at axis k (``None`` before it): the
    other axes of x map onto the output; the gathered axis and the index
    tensor couple to nothing (the reference's gather rule)."""
    indices = op.params["args"][1]
    tensors = [i for i, t in enumerate(indices) if t is not None]
    if len(tensors) != 1:
        raise GraphError("index with several index tensors is not supported")
    k = tensors[0]
    operand, y = op.invars[0], op.outvars[0]
    ni = len(indices[k].shape)
    if role == "in" and idx == 0:
        if axis == k:
            return []
        return [(y, axis if axis < k else axis - 1 + ni, pos)]
    if role == "in":
        return []
    if axis < k:
        return [(operand, axis, pos)]
    if axis < k + ni:
        return []
    return [(operand, axis - ni + 1, pos)]


@rule("index_put")
def _index_put(op, role, idx, axis, pos):
    """``x.index_put(idx, values)`` with one index tensor at axis k (the
    reference's scatter rule): x and the output couple on every axis, and
    with the values on the axes the index leaves whole; the indexed axis
    and the index tensor couple to nothing."""
    indices = op.params["args"][1]
    tensors = [i for i, t in enumerate(indices) if t is not None]
    if len(tensors) != 1:
        raise GraphError("index_put with several index tensors is not "
                         "supported")
    k = tensors[0]
    operand, values, y = op.invars[0], op.invars[-1], op.outvars[0]
    ni = len(indices[k].shape)
    full = len(values.shape) == len(operand.shape) - 1 + ni

    def values_axis(a):
        if not full or a == k:
            return None
        u = a if a < k else a - 1 + ni
        return u if values.shape[u] == operand.shape[a] else None

    if role == "in" and idx == len(op.invars) - 1:
        if not full or k <= axis < k + ni:
            return []
        a = axis if axis < k else axis - ni + 1
        if values.shape[axis] != operand.shape[a]:
            return []
        return [(operand, a, pos), (y, a, pos)]
    if role == "in" and idx != 0:
        return []
    out = [(y if role == "in" else operand, axis, pos)]
    u = values_axis(axis)
    if u is not None:
        out.append((values, u, pos))
    return out


@rule("stack")
def _stack(op, role, idx, axis, pos):
    """``stack(xs, dim)``: an input axis maps to the output axis past the
    new one, and couples the same axis of the other inputs; the new axis
    couples to nothing."""
    y = op.outvars[0]
    dim = _dim(_arg(op, 1, "dim", 0), len(y.shape))
    if role == "in":
        out = [(y, axis + (1 if axis >= dim else 0), pos)]
        out += [(v, axis, pos) for i, v in enumerate(op.invars) if i != idx]
        return out
    if axis == dim:
        return []
    return [(v, axis - (1 if axis > dim else 0), pos) for v in op.invars]


# ---------------------------------------------------------------------------
# Sorting (the MoE dispatch): positions along the sorted axis mix
# ---------------------------------------------------------------------------

@rule("sort", "argsort")
def _sort(op, role, idx, axis, pos):
    src = _src(op, role, idx)
    dim = _dim(_arg(op, 1, "dim", -1), len(src.shape))
    if axis == dim:
        return []
    return [(node, axis, pos) for node, _, _ in _others(op, role, idx)
            if axis < len(node.shape)]


@rule("topk")
def _topk(op, role, idx, axis, pos):
    """The reference's ``top_k`` rule: every axis but the selected one maps
    the input onto the values."""
    x = op.invars[0]
    dim = _dim(_arg(op, 2, "dim", -1), len(x.shape))
    if axis == dim:
        return []
    if role == "in":
        return [(op.outvars[0], axis, pos)]
    return [(x, axis, pos)]


_NO_PROP = ("arange", "full_like", "zeros_like", "ones_like", "empty_like",
            "full", "zeros", "ones", "empty", "scalar_tensor", "rand",
            "randn", "randint", "rand_like", "randn_like")
for _n in _NO_PROP:
    RULES[_n] = lambda op, role, idx, axis, pos: []


# ---------------------------------------------------------------------------
# Worklist fixpoint (Alg. 1)
# ---------------------------------------------------------------------------

def propagate(g: CompGraph, seeds: list[Mask]
              ) -> dict[tuple[int, int], frozenset]:
    """Push seed masks to fixpoint.  Returns {(node_uid, axis): positions}."""
    acc: dict[tuple[int, int], set] = {}
    work: deque = deque()
    for node, axis, pos in seeds:
        work.append((node, axis, frozenset(pos)))

    while work:
        node, axis, pos = work.popleft()
        if len(node.shape) <= axis or node.shape[axis] <= 1:
            continue
        key = (node.uid, axis)
        have = acc.setdefault(key, set())
        delta = frozenset(p for p in pos if p not in have)
        if not delta:
            continue
        have.update(delta)

        sites = []
        if node.producer is not None:
            for i, ov in enumerate(node.producer.outvars):
                if ov is node:
                    sites.append((node.producer, "out", i))
        for op in node.consumers:
            for i, iv in enumerate(op.invars):
                if iv is node:
                    sites.append((op, "in", i))

        for op, role, i in sites:
            fn = RULES.get(op.prim)
            if fn is None:
                raise GraphError(
                    f"no propagation rule for operator {op.prim!r}")
            for tgt, a, p in fn(op, role, i, axis, delta):
                if p:
                    work.append((tgt, a, frozenset(p)))

    return {k: frozenset(v) for k, v in acc.items()}
