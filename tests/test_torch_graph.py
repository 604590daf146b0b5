"""The port's computational graph + mask propagation rules (the cases of
``tests/test_graph.py`` that need no CNN or scan, written with torch ops),
and the ATen trace of the port's dense model.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, reduced
from repro_torch.core.graph import (GraphError, graph_stats, trace_graph,
                                    tree_paths)
from repro_torch.core.propagate import _reshape_map, _segments, propagate
from repro_torch.models import build
from repro_torch.models import transformer as tf


def closure_of(fn, params, x, path, axis, pos={0}):
    g = trace_graph(fn, params, x)
    node = g.params[path]
    cl = propagate(g, [(node, axis, frozenset(pos))])
    uid2p = {n.uid: p for p, n in g.params.items()}
    return {(uid2p[u], a): sorted(p) for (u, a), p in cl.items() if u in uid2p}


def test_mlp_hidden_coupling():
    params = {"w1": torch.ones(8, 16), "w2": torch.ones(16, 4)}
    fn = lambda p, x: F.relu(x @ p["w1"]) @ p["w2"]
    cl = closure_of(fn, params, torch.ones(2, 8), "w1", 1, {3})
    assert cl == {("w1", 1): [3], ("w2", 0): [3]}


def test_residual_coupling():
    params = {"w1": torch.ones(8, 8), "w2": torch.ones(8, 8)}
    fn = lambda p, x: x + (x @ p["w1"]) @ p["w2"]
    cl = closure_of(fn, params, torch.ones(2, 8), "w2", 1, {5})
    # residual add couples w2's output column with w1's input row (via x)
    assert ("w1", 0) in cl and cl[("w2", 1)] == [5]


def test_concat_split_offsets():
    params = {"wa": torch.ones(4, 6), "wb": torch.ones(4, 10),
              "wc": torch.ones(16, 3)}

    def fn(p, x):
        h = torch.cat([x @ p["wa"], x @ p["wb"]], dim=-1)
        return h @ p["wc"]

    cl = closure_of(fn, params, torch.ones(2, 4), "wb", 1, {2})
    assert cl[("wc", 0)] == [8]          # offset by wa's 6 columns
    cl2 = closure_of(fn, params, torch.ones(2, 4), "wc", 0, {3})
    assert cl2[("wa", 1)] == [3] and ("wb", 1) not in cl2


def test_chunk_offsets():
    params = {"w": torch.ones(4, 10), "wa": torch.ones(5, 3),
              "wb": torch.ones(5, 3)}

    def fn(p, x):
        a, b = (x @ p["w"]).chunk(2, dim=-1)
        return a @ p["wa"] + b @ p["wb"]

    cl = closure_of(fn, params, torch.ones(2, 4), "w", 1, {7})
    assert cl[("wb", 0)] == [2] and ("wa", 0) not in cl


def test_gqa_reshape_cover():
    """Splitting heads H -> (KH, G) must close over the whole KV group."""
    B, S, d, KH, G, hd = 1, 4, 16, 2, 3, 4
    H = KH * G
    params = {"wq": torch.ones(d, H, hd), "wk": torch.ones(d, KH, hd)}

    def fn(p, x):
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        qg = q.reshape(B, S, KH, G, hd)
        return torch.einsum("bsigk,btik->bsigt", qg, k)

    cl = closure_of(fn, params, torch.ones(B, S, d), "wq", 1, {0})
    assert cl[("wq", 1)] == [0, 1, 2]      # whole group of G q-heads
    assert cl[("wk", 1)] == [0]


def test_broadcast_mul_couples_scale():
    """A (d,) scale broadcast against (B, S, d) couples on d, as the
    reference's broadcast_in_dim + mul do."""
    params = {"s": torch.ones(6), "w": torch.ones(6, 5)}
    fn = lambda p, x: (x * p["s"]) @ p["w"]
    cl = closure_of(fn, params, torch.ones(2, 3, 6), "w", 0, {4})
    assert cl[("s", 0)] == [4]


STRUCTURAL = {
    # name: (fn, params shapes, seed (path, axis, pos), expected closure)
    "transpose-permute": (
        lambda p, x: (x @ p["w1"]).transpose(0, 1).permute(1, 0) @ p["w2"],
        {"w1": (4, 6), "w2": (6, 5)}, ("w1", 1, {3}),
        {("w1", 1): [3], ("w2", 0): [3]}),
    "unsqueeze-squeeze": (
        lambda p, x: (x @ p["w1"]).unsqueeze(1).squeeze(1) @ p["w2"],
        {"w1": (4, 6), "w2": (6, 5)}, ("w1", 1, {2}),
        {("w1", 1): [2], ("w2", 0): [2]}),
    "slice": (
        lambda p, x: (x @ p["w1"])[:, 2:] @ p["w2"],
        {"w1": (4, 8), "w2": (6, 5)}, ("w1", 1, {3}),
        {("w1", 1): [3], ("w2", 0): [1]}),
    "slice-dropped": (
        lambda p, x: (x @ p["w1"])[:, 2:] @ p["w2"],
        {"w1": (4, 8), "w2": (6, 5)}, ("w1", 1, {1}),
        {("w1", 1): [1]}),
    "split": (
        lambda p, x: sum(h @ w for h, w in zip(
            (x @ p["w1"]).split([3, 5], dim=-1), (p["wa"], p["wb"]))),
        {"w1": (4, 8), "wa": (3, 2), "wb": (5, 2)}, ("w1", 1, {4}),
        {("w1", 1): [4], ("wb", 0): [1]}),
    "sum-keepdim-mean": (
        lambda p, x: ((x @ p["w1"]).sum(dim=0) * p["s"]
                      + (x @ p["w1"]).mean(dim=0, keepdim=True)[0]),
        {"w1": (4, 6), "s": (6,)}, ("s", 0, {2}),
        {("w1", 1): [2], ("s", 0): [2]}),
    "select": (
        lambda p, x: (x @ p["w1"])[1] * p["s"],
        {"w1": (4, 6), "s": (6,)}, ("s", 0, {5}),
        {("w1", 1): [5], ("s", 0): [5]}),
    # the SSM block's ops: pad shifts by the low padding, cumsum keeps
    # positions, softplus is elementwise, a depthwise conv1d couples a
    # channel with its filter, a dense one the input channel with the
    # weight's input axis only
    "pad-shift": (
        lambda p, x: F.pad(x @ p["w1"], (2, 0)) @ p["w2"],
        {"w1": (4, 6), "w2": (8, 5)}, ("w1", 1, {3}),
        {("w1", 1): [3], ("w2", 0): [5]}),
    "cumsum-softplus": (
        lambda p, x: F.softplus((x @ p["w1"]).cumsum(dim=-1)) @ p["w2"],
        {"w1": (4, 6), "w2": (6, 5)}, ("w1", 1, {2}),
        {("w1", 1): [2], ("w2", 0): [2]}),
    "conv1d-depthwise": (
        lambda p, x: F.conv1d((x @ p["w1"]).t()[None], p["cw"],
                              groups=6).sum(dim=2) @ p["w2"],
        {"w1": (4, 6), "cw": (6, 1, 2), "w2": (6, 5)}, ("w1", 1, {4}),
        {("w1", 1): [4], ("cw", 0): [4], ("w2", 0): [4]}),
    "conv1d-dense": (
        lambda p, x: F.conv1d((x @ p["w1"]).t()[None], p["cw"]
                              ).sum(dim=2) @ p["w2"],
        {"w1": (4, 6), "cw": (5, 6, 2), "w2": (5, 3)}, ("w1", 1, {4}),
        {("w1", 1): [4], ("cw", 1): [4]}),
}


@pytest.mark.parametrize("name", sorted(STRUCTURAL))
def test_structural_rules(name):
    fn, shapes, (path, axis, pos), want = STRUCTURAL[name]
    params = {k: torch.ones(v) for k, v in shapes.items()}
    assert closure_of(fn, params, torch.ones(3, 4), path, axis, pos) == want


def test_reshape_segments():
    assert _segments((4, 6), (24,))[0] == ([0, 1], [0], 24)
    assert _segments((2, 3, 4), (6, 4))[0] == ([0, 1], [0], 6)
    m = _reshape_map((12,), (3, 4), 0, frozenset({5}))
    assert m == [(0, frozenset({1}))]       # conservative outer cover
    m2 = _reshape_map((3, 4), (12,), 0, frozenset({1}))
    assert m2 == [(0, frozenset({4, 5, 6, 7}))]


def test_control_flow_rejected():
    params = {"w": torch.ones(4, 4)}

    def fn(p, x):
        return torch.cond(x.sum() > 0, lambda y: y @ p["w"],
                          lambda y: y - 1.0, (x,))

    with pytest.raises(GraphError):
        trace_graph(fn, params, torch.ones(2, 4))


def test_graph_evaluate_matches_fn():
    gen = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(8, 16, generator=gen),
              "w2": torch.randn(16, 4, generator=gen)}
    x = torch.randn(3, 8, generator=gen)
    fn = lambda p, xx: F.silu(xx @ p["w1"]) @ p["w2"]
    g = trace_graph(fn, params, x)
    x2 = torch.randn(3, 8, generator=gen)
    hid = [op for op in g.ops if op.prim == "silu"][0].outvars[0]
    outs, cap = g.evaluate(params, [x2], capture={hid.uid})
    torch.testing.assert_close(outs[0], fn(params, x2), rtol=1e-6, atol=0)
    torch.testing.assert_close(cap[hid.uid], F.silu(x2 @ params["w1"]),
                               rtol=1e-6, atol=0)


def test_model_trace_keeps_contractions():
    """The dense forward traces to einsum / matmul nodes with their
    equations (no view/bmm chains), params keyed by dotted paths."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    m = build(cfg)
    p = m.init(0, device="cpu")
    ap = tf.unstack_layers(p, cfg.num_layers)
    g = trace_graph(lambda pp, b: m.forward(pp, b), ap,
                    m.dummy_batch(1, 8, device="cpu"))
    assert set(g.params) == {path for path, _ in tree_paths(ap)}
    assert "layers.1.attn.wq" in g.params
    prims = graph_stats(g)["prims"]
    L = cfg.num_layers
    assert prims["einsum"] == 6 * L + 1       # q k v, qk, pv, o; + logits
    assert prims["matmul"] == 3 * L           # SwiGLU
    assert "bmm" not in prims and "view" not in prims
    eqs = sorted({op.params["args"][0] for op in g.ops
                  if op.prim == "einsum"})
    assert "bshk,hkd->bsd" in eqs
    assert len(g.inputs) == 1 and len(g.outputs) == 1
    assert any(n.is_const for n in g.data.values())   # RoPE frequencies
    outs, _ = g.evaluate(dict(tree_paths(ap)),
                         [m.dummy_batch(1, 8, seed=1, device="cpu")["tokens"]])
    ref = m.forward(p, m.dummy_batch(1, 8, seed=1, device="cpu"))
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), atol=1e-6)
