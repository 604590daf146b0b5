"""The port's sharding rules, serving meshes and collectives against the
reference's (``repro.distributed.sharding``, ``repro.launch.mesh``): the
rule tables, ``spec`` / ``_fit``, ``serve_rules`` of every config on meshes
1x1 .. 4x4, the logical-axes trees of every config, ``parse_mesh``'s
errors, and the bytes the collectives count.

The reference's ``ShardingRules`` needs no devices when given
``axis_sizes``, and its ``serve_rules`` / ``for_mesh`` read only
``axis_names``, ``devices.shape`` and ``shape`` — so a duck-typed stand-in
mesh runs them on one CPU device.
"""
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_config as j_get_config
from repro.distributed import sharding as j_sharding
from repro.launch.mesh import serve_rules as j_serve_rules
from repro.models import build as j_build
from repro_torch.configs import get_config as t_get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as t_sharding
from repro_torch.launch.mesh import (
    Mesh, make_serve_mesh, make_test_mesh, parse_mesh, serve_rules)
from repro_torch.models import build as t_build

CPU = torch.device("cpu")


class StandInMesh:
    """What the reference's rules read of a mesh, without devices."""

    def __init__(self, data: int, model: int):
        self.axis_names = ("data", "model")
        self.devices = np.empty((data, model), dtype=object)
        self.shape = {"data": data, "model": model}


def as_spec(pspec) -> tuple:
    """A JAX PartitionSpec as the port's spec: one tuple per dimension."""
    return tuple(() if p is None else (p,) if isinstance(p, str)
                 else tuple(p) for p in pspec)


def test_rule_tables_equal_the_reference():
    assert t_sharding.SINGLE_POD_RULES == j_sharding.SINGLE_POD_RULES
    assert t_sharding.MULTI_POD_RULES == j_sharding.MULTI_POD_RULES


def test_reference_cases():
    """The reference's own cases (tests/test_sharding.py): a non-dividing
    dim replicates, a mesh axis is used once per spec."""
    rules = t_sharding.ShardingRules.for_mesh(StandInMesh(4, 2))
    assert rules.spec(("batch", "heads"), shape=(16, 7))[1] == ()
    assert rules.spec(("batch", "heads"), shape=(16, 8)) == \
        (("data",), ("model",))
    spec = rules.spec(("heads", "mlp"), shape=(8, 8))
    assert [s for s in spec if s == ("model",)] == [("model",)]


def test_spec_and_fit_equal_the_reference():
    """Generated logical axes, shapes, mesh sizes and rule tables (multi-
    pod too): the port's spec equals the reference's, with and without
    shapes; ``_fit`` likewise."""
    rng = np.random.default_rng(0)
    names = sorted(t_sharding.MULTI_POD_RULES) + [None, "unknown"]
    for case in range(400):
        pod = case % 4 == 0
        axes = ("pod", "data", "model") if pod else ("data", "model")
        sizes = {a: int(rng.choice([1, 2, 3, 4, 8])) for a in axes}
        table = dict(t_sharding.MULTI_POD_RULES if pod
                     else t_sharding.SINGLE_POD_RULES)
        if case % 3 == 0:        # an override, as serve_rules makes
            table[str(rng.choice(names[:-2]))] = tuple(
                rng.permutation(axes)[:int(rng.integers(0, 3))])
        n = int(rng.integers(1, 6))
        logical = tuple(names[int(rng.integers(len(names)))]
                        for _ in range(n))
        shape = tuple(int(rng.choice([1, 2, 3, 6, 7, 8, 12, 16, 40]))
                      for _ in range(n))
        mine = t_sharding.ShardingRules(table, sizes)
        ref = j_sharding.ShardingRules(table, sizes)
        assert mine.spec(logical, shape=shape) == \
            as_spec(ref.spec(logical, shape=shape)), (logical, shape, sizes)
        assert mine.spec(logical) == as_spec(ref.spec(logical))
        for dim in shape:
            got = tuple(rng.permutation(axes)[:int(rng.integers(0, 4))])
            assert mine._fit(got, dim) == ref._fit(got, dim)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_serve_rules_equal_the_reference(arch):
    for data in range(1, 5):
        for model in range(1, 5):
            mine = serve_rules(t_get_config(arch), StandInMesh(data, model))
            ref = j_serve_rules(j_get_config(arch), StandInMesh(data, model))
            assert dict(mine.rules) == dict(ref.rules), (data, model)
            assert dict(mine.axis_sizes) == dict(ref.axis_sizes)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_axes_trees_equal_the_reference(arch):
    jm, tm = j_build(j_get_config(arch)), t_build(t_get_config(arch))
    assert tm.param_axes() == jm.param_axes()
    assert tm.cache_axes() == jm.cache_axes()
    for quantized in (False, True):
        assert tm.paged_cache_axes(quantized) == \
            jm.paged_cache_axes(quantized)


def test_cnn_has_no_axes():
    with pytest.raises(ValueError, match="no sharding axes"):
        t_build(t_get_config("resnet18-cifar")).param_axes()


def test_meshes_and_their_errors():
    mesh = make_serve_mesh(2, 2, devices=[CPU] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.devices.shape == (2, 2)
    assert parse_mesh("auto", devices=[CPU] * 3).shape == \
        {"data": 3, "model": 1}
    assert parse_mesh("1X2", devices=[CPU] * 2).shape == \
        {"data": 1, "model": 2}
    assert make_test_mesh(devices=[CPU] * 2).shape == \
        {"data": 2, "model": 1}
    with pytest.raises(ValueError, match=r"mesh 2x1 needs 2 devices, "
                                         r"have 1"):
        parse_mesh("2x1", devices=[CPU])
    with pytest.raises(ValueError, match="model axis 3 does not divide 4 "
                                         "devices"):
        make_serve_mesh(1, 3, devices=[CPU] * 4)
    for bad in ("2", "x", "2x1x1", "axb"):
        with pytest.raises(ValueError, match="--mesh wants 'DxM' or "
                                             "'auto'"):
            parse_mesh(bad, devices=[CPU])


def test_place_gather_and_reshard():
    """Placement cuts each shard's piece (contiguous copies; a whole
    replicated piece shares storage unless copied), ``gather`` puts it back,
    and ``reshard`` all-gathers or slices as the new spec says."""
    mesh = Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2))
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    s = t_sharding.place(x, mesh, (("data",), ("model",)))
    assert [tuple(t.shape) for t in s.shards] == [(4, 3)] * 4
    assert torch.equal(s.local(1, 0), x[4:, :3])
    assert torch.equal(t_sharding.gather(s), x)
    rep = t_sharding.place(x, mesh, ((), ()))
    assert all(t.data_ptr() == x.data_ptr() for t in rep.shards)
    own = t_sharding.place(x, mesh, ((), ()), copy=True)
    assert len({t.data_ptr() for t in own.shards} | {x.data_ptr()}) == 5
    coll.reset_collectives()
    cols = coll.reshard(s, (("data",), ()))
    assert [tuple(t.shape) for t in cols.shards] == [(4, 6)] * 4
    assert torch.equal(cols.local(1, 1), x[4:])
    # two all-gathers (one per data row), each of a (4, 6) f32 result
    assert coll.collective_bytes() == {
        "total_bytes": 2 * 4 * 6 * 4, "per_kind": {"all-gather": 192},
        "counts": {"all-gather": 2}}
    back = coll.reshard(cols, (("data",), ("model",)))
    assert torch.equal(t_sharding.gather(back), x)
    assert coll.collective_bytes()["counts"] == {"all-gather": 2}  # sliced


def test_collectives_count_their_bytes():
    coll.reset_collectives()
    a = [torch.full((2, 3), float(i), dtype=torch.bfloat16)
         for i in range(4)]
    red = coll.all_reduce(a)
    assert all(torch.equal(t, torch.full((2, 3), 6.0, dtype=torch.bfloat16))
               for t in red)
    gat = coll.all_gather(a[:2], dim=1)
    assert gat[0].shape == (2, 6)
    rows = coll.broadcast_rows(a[:2])
    assert rows[1].shape == (4, 3)
    got = coll.gather_to(a[:3], CPU)
    assert got.shape == (6, 3)
    src = torch.arange(2 * 5 * 3, dtype=torch.int8).reshape(2, 5, 3)
    dst = torch.zeros_like(src)
    idx = torch.tensor([1, 3])
    coll.permute(src, dst, idx, idx)
    assert torch.equal(dst[:, [1, 3]], src[:, [1, 3]])
    assert dst[:, [0, 2, 4]].abs().sum() == 0
    # one participant moves nothing
    coll.all_reduce(a[:1])
    coll.all_gather(a[:1], 0)
    assert coll.collective_bytes() == {
        "total_bytes": 12 + 24 + 24 + 36 + 12,
        "per_kind": {"all-reduce": 12, "all-gather": 24,
                     "row-broadcast": 24, "gather": 36,
                     "collective-permute": 12},
        "counts": {"all-reduce": 1, "all-gather": 1, "row-broadcast": 1,
                   "gather": 1, "collective-permute": 1}}
