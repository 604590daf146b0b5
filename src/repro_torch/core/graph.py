"""Computational graph built from an ATen trace — the port's counterpart of
the reference's jaxpr graph (``repro/core/graph.py``).

The reference traces a jaxpr and keeps one node per JAX primitive.  Here the
model function is traced with ``make_fx(..., pre_dispatch=True)``, which
keeps ``aten.einsum`` with its equation string and ``aten.matmul`` whole
(plain ``make_fx`` would break them into view/permute/bmm chains and lose the
contraction structure).  Parameters become placeholders keyed by the same
dotted paths as the reference's pytree paths (``layers.0.attn.wq``), so
group keys come out letter for letter the same.  Shapes and dtypes are read
from each node's ``meta["val"]``.

Control flow that the trace keeps as a higher-order operator (``cond``,
``while_loop``, ``scan``, ``map``) is rejected with ``GraphError``: SPA
analysis traces models unrolled, as the reference does.

The graph doubles as an interpreter (``evaluate``) so OBSPA can capture
intermediate activations (layer inputs for Hessian accumulation) without
framework hooks; it runs on the device the trace was made on.
"""
from __future__ import annotations

import dataclasses
import operator
from collections import Counter
from typing import Any, Callable, Sequence

import torch
import torch.fx
from torch.fx.experimental.proxy_tensor import make_fx


@dataclasses.dataclass(eq=False)
class DataNode:
    uid: int
    shape: tuple[int, ...]
    dtype: Any
    param_path: str | None = None       # set for parameter leaves
    producer: "OpNode | None" = None
    consumers: list["OpNode"] = dataclasses.field(default_factory=list)
    is_const: bool = False
    fx_ref: tuple[str, int | None] = ("", None)   # (fx node name, list index)

    @property
    def is_param(self) -> bool:
        return self.param_path is not None

    def __repr__(self):
        tag = self.param_path or ("const" if self.is_const else "data")
        return f"DataNode({self.uid}, {tag}, {self.shape})"


@dataclasses.dataclass(eq=False)
class OpNode:
    uid: int
    prim: str                            # ATen op name: "einsum", "add", ...
    params: dict                         # "args"/"kwargs" with DataNodes in
    invars: list[DataNode]               # tensor operands, in argument order
    outvars: list[DataNode]

    def __repr__(self):
        return f"OpNode({self.uid}, {self.prim})"


class GraphError(Exception):
    pass


REJECT_OPS = {"cond", "while_loop", "scan", "map_impl", "map"}


def keystr(path: Sequence) -> str:
    """Dotted path ("layers.0.attn.wq") of a sequence of keys."""
    return ".".join(str(k) for k in path)


def tree_paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(dotted path, leaf) of a nested dict / list, dict keys sorted — the
    order and the paths of the reference's ``tree_flatten_with_path``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in
                tree_paths(v, prefix + (i,))]
    return [(keystr(prefix), tree)]


def tree_map_paths(fn: Callable[[str, Any], Any], tree, prefix: tuple = ()):
    """The same nesting with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_paths(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_paths(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(keystr(prefix), tree)


class _Capture(torch.fx.Interpreter):
    """Runs the traced module and keeps the values of named nodes."""

    def __init__(self, gm, names: set[str]):
        super().__init__(gm)
        self.names = names
        self.values: dict[str, Any] = {}

    def run_node(self, n):
        out = super().run_node(n)
        if n.name in self.names:
            self.values[n.name] = out
        return out


class CompGraph:
    """Flat computational graph over a traced model function."""

    def __init__(self):
        self.ops: list[OpNode] = []
        self.data: dict[int, DataNode] = {}
        self.params: dict[str, DataNode] = {}   # param_path -> node
        self.inputs: list[DataNode] = []        # non-param placeholders
        self.outputs: list[DataNode] = []
        self.module: torch.fx.GraphModule | None = None
        self._uid = 0

    # ----- construction helpers -----
    def _new_data(self, val, fx_ref, **kw) -> DataNode:
        n = DataNode(self._uid, tuple(int(s) for s in val.shape), val.dtype,
                     fx_ref=fx_ref, **kw)
        self._uid += 1
        self.data[n.uid] = n
        return n

    def _new_op(self, prim, params, invars, outvars) -> OpNode:
        op = OpNode(self._uid, prim, params, invars, outvars)
        self._uid += 1
        self.ops.append(op)
        for v in invars:
            v.consumers.append(op)
        for v in outvars:
            v.producer = op
        return op

    # ----- evaluation (used by OBSPA activation capture) -----
    @torch.no_grad()
    def evaluate(self, param_values: dict[str, torch.Tensor],
                 input_values: Sequence[torch.Tensor],
                 capture: set[int] | None = None,
                 ) -> tuple[list[torch.Tensor], dict[int, torch.Tensor]]:
        """Execute the graph; optionally capture given data-node uids.
        ``input_values`` are the flat non-parameter inputs, in the order of
        ``tree_paths`` over the traced arguments."""
        capture = capture or set()
        names = {self.data[u].fx_ref[0] for u in capture}
        interp = _Capture(self.module, names)
        flat = [param_values[p] for p in self.params] + list(input_values)
        outs = interp.run(*flat)
        captured = {}
        for u in capture:
            name, index = self.data[u].fx_ref
            val = interp.values[name]
            captured[u] = val if index is None else val[index]
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        return list(outs), captured


def trace_graph(fn: Callable, params, *args) -> CompGraph:
    """Trace ``fn(params, *args)`` and build the computational graph.

    ``params`` is the nested dict/list whose tensor leaves become parameter
    nodes (keyed by dotted path); the tensors in ``args`` become plain input
    nodes.  The trace runs ``fn`` on fake tensors of the given shapes,
    dtypes and devices; constants made inside ``fn`` are kept as tensors of
    the graph module."""
    pflat = tree_paths(params)
    aflat = tree_paths(args)
    n_p = len(pflat)
    ppaths = [p for p, _ in pflat]
    apaths = [p for p, _ in aflat]

    def flat_fn(*xs):
        pv = dict(zip(ppaths, xs[:n_p]))
        av = dict(zip(apaths, xs[n_p:]))
        p = tree_map_paths(lambda path, _: pv[path], params)
        a = tree_map_paths(lambda path, _: av[path], args)
        return fn(p, *a)

    # fake tensors: the trace needs shapes, not values (a real-mode trace
    # also computes the forward and snapshots every output, ~3x slower)
    with torch.no_grad():
        gm = make_fx(flat_fn, pre_dispatch=True, tracing_mode="fake")(
            *[t for _, t in pflat], *[t for _, t in aflat])
    g = CompGraph()
    g.module = gm
    var: dict[str, Any] = {}       # fx node name -> DataNode or [DataNode]
    n_ph = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            val = node.meta["val"]
            if n_ph < n_p:
                dn = g._new_data(val, (node.name, None),
                                 param_path=ppaths[n_ph])
                g.params[ppaths[n_ph]] = dn
            else:
                dn = g._new_data(val, (node.name, None))
                g.inputs.append(dn)
            var[node.name] = dn
            n_ph += 1
        elif node.op == "get_attr":
            val = getattr(gm, node.target)
            var[node.name] = g._new_data(val, (node.name, None),
                                         is_const=True) \
                if isinstance(val, torch.Tensor) else val   # sub-graphs
        elif node.op == "call_function":
            _add_call(g, node, var)
        elif node.op == "output":
            for leaf in _flat_nodes(node.args[0]):
                dn = var.get(leaf.name)
                if isinstance(dn, DataNode):
                    g.outputs.append(dn)
        else:
            raise GraphError(f"unsupported fx node {node.op} {node.target}")
    return g


def _flat_nodes(a) -> list[torch.fx.Node]:
    if isinstance(a, torch.fx.Node):
        return [a]
    if isinstance(a, (list, tuple)):
        return [n for x in a for n in _flat_nodes(x)]
    if isinstance(a, dict):
        return [n for x in a.values() for n in _flat_nodes(x)]
    return []


def _sub(a, var):
    """Arguments with fx nodes replaced by their DataNodes."""
    if isinstance(a, torch.fx.Node):
        return var[a.name]
    if isinstance(a, (list, tuple)):
        return type(a)(_sub(x, var) for x in a)
    if isinstance(a, dict):
        return {k: _sub(v, var) for k, v in a.items()}
    return a


def _add_call(g: CompGraph, node: torch.fx.Node, var: dict) -> None:
    tgt = node.target
    if tgt is operator.getitem:
        src = var[node.args[0].name]
        if not isinstance(src, list):
            raise GraphError(f"getitem on a single tensor: {node}")
        var[node.name] = src[node.args[1]]
        return
    if isinstance(tgt, torch._ops.HigherOrderOperator):
        name = getattr(tgt, "__name__", str(tgt))
        if name in REJECT_OPS:
            raise GraphError(
                f"control-flow operator {name!r} in analysis trace — SPA "
                f"analysis requires unrolled model tracing")
        raise GraphError(f"higher-order operator {name!r} is not supported")
    if not isinstance(tgt, torch._ops.OpOverload):
        raise GraphError(f"unsupported call {tgt!r} in analysis trace")
    prim = tgt.overloadpacket.__name__
    args = _sub(node.args, var)
    kwargs = _sub(node.kwargs, var)
    invars = [d for d in _flat_data(args) + _flat_data(kwargs)]
    val = node.meta["val"]
    if isinstance(val, (list, tuple)):
        outvars = [g._new_data(v, (node.name, i)) for i, v in enumerate(val)]
        var[node.name] = outvars
    else:
        outvars = [g._new_data(val, (node.name, None))]
        var[node.name] = outvars[0]
    params = {"args": args, "kwargs": kwargs}
    if prim in _CONTRACTIONS:
        params["spec"] = _contraction_spec(prim, args, invars)
    g._new_op(prim, params, invars, outvars)


def _flat_data(a) -> list[DataNode]:
    if isinstance(a, DataNode):
        return [a]
    if isinstance(a, (list, tuple)):
        return [n for x in a for n in _flat_data(x)]
    if isinstance(a, dict):
        return [n for x in a.values() for n in _flat_data(x)]
    return []


# ---------------------------------------------------------------------------
# Contractions: every product as einsum letters (operand specs, output spec)
# ---------------------------------------------------------------------------

_CONTRACTIONS = {"einsum", "matmul", "mm", "bmm"}
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"      # batch axes of a matmul


def _contraction_spec(prim: str, args, invars) -> tuple[list[str], str]:
    if prim == "einsum":
        eq = args[0].replace(" ", "")
        if "..." in eq or "->" not in eq:
            raise GraphError(f"einsum {eq!r}: explicit output and no "
                             f"ellipsis required")
        ins, out = eq.split("->")
        specs = ins.split(",")
        for s in specs:
            if len(set(s)) != len(s):
                raise GraphError(f"einsum {eq!r}: repeated index in operand")
        return specs, out
    a, b = invars
    ra, rb = len(a.shape), len(b.shape)
    if ra == 0 or rb == 0:
        raise GraphError("matmul of a scalar")
    if ra == 1 and rb == 1:
        return ["k", "k"], ""
    if rb == 1:
        batch = _LETTERS[:ra - 2]
        return [batch + "nk", "k"], batch + "n"
    if ra == 1:
        batch = _LETTERS[:rb - 2]
        return ["k", batch + "km"], batch + "m"
    if rb == 2:
        batch = _LETTERS[:ra - 2]
        return [batch + "nk", "km"], batch + "nm"
    if ra != rb or a.shape[:-2] != b.shape[:-2]:
        raise GraphError(f"broadcast batched matmul {a.shape} @ {b.shape} "
                         f"is not supported")
    batch = _LETTERS[:ra - 2]
    return [batch + "nk", batch + "km"], batch + "nm"


# ---------------------------------------------------------------------------
# Small utilities used across the engine
# ---------------------------------------------------------------------------

def graph_stats(g: CompGraph) -> dict:
    return {
        "n_ops": len(g.ops),
        "n_data": len(g.data),
        "n_params": len(g.params),
        "prims": dict(Counter(op.prim for op in g.ops)),
    }
