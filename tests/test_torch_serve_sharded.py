"""Sharded serving of the port: the engine with ``mesh=`` against its own
one-device engine, on logical CPU meshes (1,1), (2,1), (1,2), (4,1),
(2,2), (1,4) and the (3,1) fallback — the counterparts of the reference's
``tests/test_serve_sharded.py``, which forces 4 host devices in a
subprocess for the same cases.

f32, reduced TinyLlama with H 4 / KH 2 (the reference's cases), weights
made by the JAX package and converted.  The sharded port engine must equal
the one-device port engine token for token; the one-device run's top-2
logit gap (teacher forcing through ``Model.forward``) is asserted above
``GAP`` at every emitted position first, so the comparison is not at the
mercy of a near-tie between two summation orders.  The dense and pruned
decodes are also held to the JAX one-device engine, its own top-2 gaps
asserted first.
"""
import dataclasses
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.pruner import prune_model
from repro.models import build as j_build
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import use_rules
from repro_torch.kernels.paged_attention import (
    paged_attention, paged_prefill_attention)
from repro_torch.launch.mesh import make_serve_mesh, serve_rules
from repro_torch.models import build
from repro_torch.serve import (
    Engine, ServeConfig, load_snapshot, restore_engine, save_snapshot)
from repro_torch.serve.kv_cache import PagedCache
from repro_torch.serve.scheduler import FCFSScheduler, Request

MESHES = [(1, 1), (2, 1), (1, 2), (4, 1), (2, 2), (1, 4)]
GAP = 1e-4
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(d: int, m: int):
    return make_serve_mesh(d, m, devices=["cpu"] * (d * m))


def models(pruned: bool = False):
    """(JAX model, JAX params, port model, port params) of the reference's
    sharded-serving config; ``pruned``: 50 % L1 by the JAX pruner."""
    if pruned not in _MODELS:
        jm = j_build(j_reduced(j_get_config("tinyllama-1.1b")).replace(
            n_kv_heads=2, n_heads=4))
        jp = jm.init(jax.random.PRNGKey(0))
        if pruned:
            pr = prune_model(jm, jp, 0.5, criterion="l1")
            jm, jp = j_build(pr.cfg), pr.params
        tm = build(convert.convert_config(dataclasses.asdict(jm.cfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS[pruned] = (jm, jp, tm, tp)
    return _MODELS[pruned]


def prompts(V, n=6, base=5, seed=3):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, base + i % 3)]
            for i in range(n)]


def serve(tm, tp, rows, gen=8, mesh=None, draft=None, **cfg):
    eng = Engine(tm, tp, ServeConfig(**cfg), device="cpu", mesh=mesh,
                 draft_model=draft and draft[0],
                 draft_params=draft and draft[1])
    for p in rows:
        eng.add_request(p, max_new_tokens=gen)
    out, stats = eng.run()
    return {r: out[r].tokens for r in out}, eng, stats


def assert_gaps(tm, tp, rows, out):
    """Every emitted position's top-2 logit gap, by teacher forcing the
    one-device run's sequence through ``Model.forward``, exceeds GAP."""
    for rid, p in enumerate(rows):
        seq = torch.tensor([p + out[rid]], dtype=torch.int32)
        with torch.no_grad():
            logits = tm.forward(tp, {"tokens": seq})[0]
        at = logits[len(p) - 1:len(p) - 1 + len(out[rid])]
        top2 = at.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > GAP, rid
        assert at.argmax(-1).tolist() == out[rid]


def check_meshes(tm, tp, rows, gen=8, meshes=MESHES, draft=None,
                 check=None, **cfg):
    """One-device reference, its gaps, then every mesh: equal tokens and
    the replica audit; ``check(eng, stats)`` runs after each mesh."""
    ref, ref_eng, ref_stats = serve(tm, tp, rows, gen, draft=draft, **cfg)
    assert_gaps(tm, tp, rows, ref)
    for dm in meshes:
        out, eng, stats = serve(tm, tp, rows, gen, mesh=mesh(*dm),
                                draft=draft, **cfg)
        assert out == ref, (dm, eng.shard_mode)
        eng.replica_audit()
        if check is not None:
            check(dm, eng, stats)
    return ref, ref_eng, ref_stats


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned50"])
def test_sharded_decode_matches_one_device(pruned):
    jm, jp, tm, tp = models(pruned)
    rows = prompts(tm.cfg.vocab_size)
    cfg = dict(max_seqs=4, block_size=4, max_len=32)
    modes = {}
    ref, _, _ = check_meshes(
        tm, tp, rows, check=lambda dm, e, s: modes.setdefault(
            dm, e.shard_mode), **cfg)
    assert modes == {(1, 1): "gspmd", (2, 1): "dp", (1, 2): "gspmd",
                     (4, 1): "dp", (2, 2): "gspmd", (1, 4): "gspmd"}
    # held to the JAX one-device engine: its own top-2 gaps first
    jeng = JEngine(jm, jp, JServeConfig(**cfg))
    for p in rows:
        jeng.add_request(p, max_new_tokens=8)
    jout, _ = jeng.run()
    for rid, p in enumerate(rows):
        seq = np.asarray([p + jout[rid].tokens], np.int32)
        logits = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(seq)}))[0]
        at = np.sort(logits[len(p) - 1:len(p) - 1 + 8], axis=-1)
        assert (at[:, -1] - at[:, -2]).min() > GAP, rid
        assert ref[rid] == jout[rid].tokens, rid


def test_sharded_chunked_prefill_matches_one_device():
    _, _, tm, tp = models()
    rng = np.random.default_rng(9)
    rows = [[int(t) for t in rng.integers(0, tm.cfg.vocab_size, 21 - i)]
            for i in range(4)]

    def chunked(dm, eng, stats):
        assert stats["prefill_chunks"] > 4          # chunking engaged

    check_meshes(tm, tp, rows, check=chunked, max_seqs=4, block_size=4,
                 max_len=40, chunk_size=8, prefill_budget=16)


def test_sharded_prefix_cow_and_allocator_invariants():
    """Shared-prefix batches: the reference's (all four admitted at once),
    then a second wave that hits the cached prefix — two prompts are
    exactly the prefix, so they alias every block and copy the last on
    write.  Tokens equal the one-device engine's, the allocator's
    conservation oracle holds after every step, and (one data shard) the
    global prefix index saves blocks."""
    _, _, tm, tp = models()
    rng = np.random.default_rng(11)
    common = [int(t) for t in rng.integers(0, tm.cfg.vocab_size, 12)]
    rows = [common + [int(t) for t in rng.integers(0, 100, 2 + i)]
            for i in range(4)]
    waves = [rows, rows[:2] + [common, common]]
    cfg = ServeConfig(max_seqs=4, block_size=4, max_len=40, chunk_size=8)

    def run(mesh_):
        eng = Engine(tm, tp, cfg, device="cpu", mesh=mesh_)
        for wave in waves:
            for p in wave:
                eng.add_request(p, max_new_tokens=8)
            while eng.scheduler.has_work:
                eng.step()
                eng.cache_host.check()
        return {s.req.rid: list(s.generated)
                for s in eng.scheduler.finished}, eng

    ref, ref_eng = run(None)
    assert_gaps(tm, tp, rows + waves[1], [ref[r] for r in range(8)])
    assert ref_eng.cache_host.prefix_hits > 0
    assert ref_eng._c["cow_copies"].value > 0
    for dm in MESHES:
        out, eng = run(mesh(*dm))
        assert out == ref, dm
        assert eng._c["cow_copies"].value > 0
        eng.replica_audit()
        if eng.scheduler.data_shards == 1:
            assert eng.cache_host.allocator.total_allocated <= \
                ref_eng.cache_host.allocator.total_allocated


def test_sharded_preemption_matches_one_device():
    _, _, tm, tp = models()
    rows = prompts(tm.cfg.vocab_size, n=4, base=8)

    def preempted(dm, eng, stats):
        assert sum(s.preemptions for s in eng.scheduler.finished) > 0, dm

    check_meshes(tm, tp, rows, gen=12, check=preempted, max_seqs=4,
                 block_size=4, max_len=64, num_blocks=13)


def test_sharded_spec_decode_matches_one_device():
    """The draft's pool and parameters are placed (and moved) as the
    target's; every mesh equals the one-device speculative engine."""
    jm, jp, tm, tp = models()
    _, _, dm_model, dp = models(pruned=True)

    def cycled(dm, eng, stats):
        assert eng.spec_active and stats["spec_cycles"] > 0
        assert len(eng.draft_cache["k"].shards) == dm[0] * dm[1]

    check_meshes(tm, tp, prompts(tm.cfg.vocab_size), draft=(dm_model, dp),
                 check=cycled, max_seqs=4, block_size=4, max_len=48,
                 spec_k=4, chunk_size=4)


def test_sharded_quantized_cache_matches_one_device():
    """int8 pools: the scale pools shard exactly like their KV pools, so an
    int8 engine on any mesh equals the one-device int8 engine."""
    _, _, tm, tp = models()
    rng = np.random.default_rng(23)
    common = [int(t) for t in rng.integers(0, tm.cfg.vocab_size, 8)]
    rows = [common + [int(t) for t in rng.integers(0, 100, 2 + i % 3)]
            for i in range(4)]

    def quantized(dm, eng, stats):
        assert eng.cache["k"].dtype == torch.int8
        assert "k_scale" in eng.cache
        assert eng.cache["k_scale"].spec == eng.cache["k"].spec[:4]
        eng.cache_host.check()

    ref, _, _ = serve(tm, tp, rows, max_seqs=4, block_size=4, max_len=40,
                      chunk_size=8, cache_dtype="int8")
    out, eng, _ = serve(tm, tp, rows, mesh=mesh(1, 2), max_seqs=4,
                        block_size=4, max_len=40, chunk_size=8,
                        cache_dtype="int8")
    assert out == ref
    check_meshes(tm, tp, rows, check=quantized, max_seqs=4, block_size=4,
                 max_len=40, chunk_size=8, cache_dtype="int8")


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_kernel_shard_wrap_matches_unsharded(quantized):
    """The ops-level shard wrap: paged attention under an active serve mesh
    vs the unsharded call, decode and prefill entries, bit for bit, on
    every mesh (the plain version runs per shard on the CPU)."""
    from repro_torch.kernels.paged_attention import quantize
    rng = np.random.default_rng(0)
    B, H, KH, D, bs, NB = 4, 4, 2, 8, 4, 3
    P = B * NB + 1
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    kp, vp = (T(rng.normal(size=(P, bs, KH, D))) for _ in range(2))
    scales = {}
    if quantized:
        (kp, scales["k_scale"]), (vp, scales["v_scale"]) = \
            quantize(kp, torch.int8), quantize(vp, torch.int8)
    tables = torch.from_numpy(
        1 + np.arange(B * NB, dtype=np.int32).reshape(B, NB))
    lens = torch.tensor([5, 9, 12, 7], dtype=torch.int32)
    q = T(rng.normal(size=(B, H, D)))
    C = 4
    qc = T(rng.normal(size=(B, C, H, D)))
    starts = torch.tensor([2, 4, 0, 3], dtype=torch.int32)
    ref = paged_attention(q, kp, vp, tables, lens, **scales)
    refc = paged_prefill_attention(qc, kp, vp, tables, starts, starts + C,
                                   **scales)
    cfg = get_config("tinyllama-1.1b").replace(n_kv_heads=KH, n_heads=H)
    for dm in MESHES + [(3, 1)]:
        mm = mesh(*dm)
        with use_rules(serve_rules(cfg, mm), mesh=mm):
            out = paged_attention(q, kp, vp, tables, lens, **scales)
            outc = paged_prefill_attention(qc, kp, vp, tables, starts,
                                           starts + C, **scales)
        assert torch.equal(out, ref), dm
        assert torch.equal(outc, refc), dm


def test_scheduler_balances_slots_across_shards():
    cache = PagedCache(max_seqs=8, num_blocks=64, block_size=4,
                       max_blocks_per_seq=8, data_shards=4)
    sched = FCFSScheduler(cache)
    for i in range(4):
        sched.add(Request(rid=i, prompt=(1, 2, 3), max_new_tokens=4))
    sched.admit()
    assert sorted(sched.shard_of(s.slot) for s in sched.running) == \
        [0, 1, 2, 3]
    for i in range(4, 8):
        sched.add(Request(rid=i, prompt=(1, 2, 3), max_new_tokens=4))
    sched.admit()
    loads = np.bincount([sched.shard_of(s.slot) for s in sched.running])
    assert loads.tolist() == [2, 2, 2, 2]


def test_shard_local_prefix_index():
    cache = PagedCache(max_seqs=4, num_blocks=32, block_size=4,
                       max_blocks_per_seq=4, prefix_caching=True,
                       data_shards=2)
    toks = tuple(range(8))
    cache.ensure(0, 8)                    # slot 0 -> shard 0
    cache.commit(0, toks)
    assert cache.assign_prefix(1, toks) == 8
    assert cache.assign_prefix(2, toks) == 0
    cache.check()


def staged(tm, tp, mesh_, n_fillers: int, seed: int, migrate=True):
    """The reference's staged cross-shard scenario: A registers a prefix on
    shard 0, fillers then occupy the other shards' first slots, and B (same
    prefix) lands on the last shard.  Returns (A's, B's tokens, engine)."""
    rng = np.random.default_rng(seed)
    V = tm.cfg.vocab_size
    common = [int(t) for t in rng.integers(0, V, 12)]
    pa, pb = common + [1, 2], common + [3, 4]
    fillers = [[int(t) for t in rng.integers(0, V, 6)]
               for _ in range(n_fillers)]
    eng = Engine(tm, tp, ServeConfig(
        max_seqs=n_fillers + 1, block_size=4, max_len=48, chunk_size=8,
        migrate_on_alias=migrate), device="cpu", mesh=mesh_)
    ra = eng.add_request(pa, max_new_tokens=6)
    while eng.scheduler.has_work:
        eng.step()
    for f in fillers:
        eng.add_request(f, max_new_tokens=16)
    eng.step()
    rb = eng.add_request(pb, max_new_tokens=6)
    while eng.scheduler.has_work:
        eng.step()
        eng.cache_host.check()
    done = {s.req.rid: list(s.generated) for s in eng.scheduler.finished}
    return done[ra], done[rb], eng


@pytest.mark.parametrize("shards,seed", [(2, 17), (4, 23)],
                         ids=["2x1", "4x1"])
def test_dp_cross_shard_prefix_hit_migrates(shards, seed):
    """A cross-shard prefix hit re-homes A's blocks by an intra-mesh copy;
    tokens equal the one-device engine's, ``shard_moves`` counts the copy,
    nothing is refused, and the copy's bytes are counted."""
    _, _, tm, tp = models()
    ref_a, ref_b, ref_eng = staged(tm, tp, None, shards - 1, seed)
    coll.reset_collectives()
    out_a, out_b, eng = staged(tm, tp, mesh(shards, 1), shards - 1, seed)
    assert eng.shard_mode == "dp" and eng.scheduler.data_shards == shards
    assert (out_a, out_b) == (ref_a, ref_b)
    assert eng._c["shard_moves"].value > 0
    assert eng.cache_host.alias_refusals == 0
    assert coll.collective_bytes()["counts"]["collective-permute"] > 0
    # the migrated path re-prefills less than the refusing one
    _, _, refusing = staged(tm, tp, mesh(shards, 1), shards - 1, seed,
                            migrate=False)
    assert eng._c["prefill_tokens"].value < \
        refusing._c["prefill_tokens"].value


def test_dp_cross_shard_refusal_counter_without_migration():
    _, _, tm, tp = models()
    ref_a, ref_b, _ = staged(tm, tp, None, 1, 17)
    out_a, out_b, eng = staged(tm, tp, mesh(2, 1), 1, 17, migrate=False)
    assert eng.shard_mode == "dp"
    assert (out_a, out_b) == (ref_a, ref_b)
    assert eng._c["shard_moves"].value == 0
    assert eng.cache_host.alias_refusals > 0
    assert eng._c["alias_refusals"].value == eng.cache_host.alias_refusals


def test_non_dividing_slot_count_falls_back():
    """4 slots on a (3, 1) mesh: gspmd with every data replica running
    every row, replicas byte-equal."""
    _, _, tm, tp = models()
    rows = prompts(tm.cfg.vocab_size, n=4)

    def fallback(dm, eng, stats):
        assert eng.shard_mode == "gspmd" and eng.scheduler.data_shards == 1
        assert eng.replica_audit()["replica_pairs"] > 0

    check_meshes(tm, tp, rows, meshes=[(3, 1)], check=fallback,
                 max_seqs=4, block_size=4, max_len=32)


def test_pool_shards_own_their_storage_and_replicas_agree():
    """Pools are one tensor per shard (distinct storage even on one device);
    a gspmd engine's data replicas stay byte-equal through the run; a dp
    engine's replicas differ (each holds its own slots' blocks)."""
    _, _, tm, tp = models()
    rows = prompts(tm.cfg.vocab_size)
    for dm, pairs in (((2, 2), 4), ((2, 1), 0)):
        _, eng, _ = serve(tm, tp, rows, mesh=mesh(*dm), max_seqs=4,
                          block_size=4, max_len=32)
        audit = eng.replica_audit()
        assert audit == {"shards": 2 * dm[0] * dm[1],
                         "replica_pairs": pairs}
        ks = eng.cache["k"].shards
        assert len({t.data_ptr() for t in ks}) == len(ks)
    assert not torch.equal(ks[0], ks[1])
    # a corrupted replica is caught
    _, eng, _ = serve(tm, tp, rows, mesh=mesh(2, 1), max_seqs=3,
                      block_size=4, max_len=32)
    assert eng.shard_mode == "gspmd"
    eng.cache["v"].shards[1][0, 1, 0, 0, 0] += 1.0      # layer 0, block 1
    with pytest.raises(AssertionError, match="data replica 1 of pool v"):
        eng.replica_audit()


def test_one_host_fetch_per_step_and_async_on_a_dp_mesh(monkeypatch):
    """A 2x1 mesh still fetches once a step (the shards' samples join on
    the first device), and ``step_async`` there equals lockstep."""
    _, _, tm, tp = models()
    rows = prompts(tm.cfg.vocab_size, n=5)
    cfg = dict(max_seqs=4, block_size=4, max_len=32, chunk_size=4)
    eng = Engine(tm, tp, ServeConfig(**cfg), device="cpu", mesh=mesh(2, 1))
    for p in rows:
        eng.add_request(p, max_new_tokens=6)
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (
        calls.append(1), real(self, *a, **k))[1])
    while eng.scheduler.has_work:
        before = len(calls)
        eng.step()
        assert len(calls) - before <= 1
    monkeypatch.setattr(torch.Tensor, "cpu", real)
    assert len(calls) == eng._c["host_syncs"].value > 0
    lock = {s.req.rid: list(s.generated) for s in eng.scheduler.finished}
    out, aeng, _ = serve(tm, tp, rows, gen=6, mesh=mesh(2, 1),
                         async_step=True, **cfg)
    assert aeng.shard_mode == "dp" and out == lock


def test_dp_sampling_uses_a_generator_per_shard():
    """Temperature > 0 on a dp mesh: one generator per data shard, seeded
    from the seed and the shard index — reproducible run to run."""
    _, _, tm, tp = models()
    rows = prompts(tm.cfg.vocab_size)
    runs = []
    for _ in range(2):
        eng = Engine(tm, tp, ServeConfig(max_seqs=4, block_size=4,
                                         max_len=32, seed=3),
                     device="cpu", mesh=mesh(2, 1))
        for p in rows:
            eng.add_request(p, max_new_tokens=8, temperature=0.8)
        out, _ = eng.run()
        runs.append({r: out[r].tokens for r in out})
        states = [p.gen.get_state() for p in eng._progs]
    assert runs[0] == runs[1]
    assert len(states) == 2 and not torch.equal(states[0], states[1])


def test_snapshot_on_a_dp_mesh_restores_onto_one(tmp_path):
    """A snapshot taken mid-run on a 2x1 mesh (every replica's pools, every
    shard's generator) restores onto a 2x1 mesh and finishes with the
    uninterrupted run's tokens; the header carries ``migrate_on_alias``."""
    _, _, tm, tp = models()
    rows = prompts(tm.cfg.vocab_size)
    cfg = ServeConfig(max_seqs=4, block_size=4, max_len=32,
                      migrate_on_alias=False)
    ref, _, _ = serve(tm, tp, rows, mesh=mesh(2, 1),
                      **dataclasses.asdict(cfg))
    eng = Engine(tm, tp, cfg, device="cpu", mesh=mesh(2, 1))
    for p in rows:
        eng.add_request(p, max_new_tokens=8)
    for _ in range(4):
        eng.step()
    path = str(tmp_path / "dp.rsrv")
    header = save_snapshot(eng, path)
    assert header["serve_config"]["migrate_on_alias"] is False
    snap = load_snapshot(path)
    assert isinstance(snap["pools"], list) and len(snap["pools"]) == 2
    back = restore_engine(snap, tm, tp, device="cpu", mesh=mesh(2, 1))
    while back.scheduler.has_work:
        back.step()
    out = {s.req.rid: list(s.generated) for s in back.scheduler.finished}
    assert out == ref
    with pytest.raises(ValueError, match="another mesh"):
        restore_engine(snap, tm, tp, device="cpu")


def test_recurrent_and_moe_meshes_wait():
    """The ssm, hybrid and moe families no longer wait for their mesh
    slice: each builds on a 2x1 mesh in the reference's mode (gspmd for
    the recurrent families, dp for moe); reduced Mamba-2 on a 1x1 mesh
    equals its no-mesh tokens.  (Every mesh of these families:
    ``test_torch_serve_sharded_families.py``.)"""
    for arch, mode in (("mamba2-1.3b", "gspmd"), ("qwen2-moe-a2.7b", "dp"),
                       ("hymba-1.5b", "gspmd")):
        cfg = reduced(get_config(arch))
        m = build(cfg)
        p = m.init(0, device="cpu")
        eng = Engine(m, p, ServeConfig(max_seqs=2, block_size=4, max_len=16),
                     device="cpu", mesh=mesh(2, 1))
        assert eng.shard_mode == mode, arch
        if arch != "mamba2-1.3b":
            continue
        rows = prompts(cfg.vocab_size, n=3)
        ref, _, _ = serve(m, p, rows, max_seqs=2, block_size=4, max_len=24,
                          chunk_size=4)
        assert_gaps(m, p, rows, ref)
        out, eng, _ = serve(m, p, rows, mesh=mesh(1, 1), max_seqs=2,
                            block_size=4, max_len=24, chunk_size=4)
        assert out == ref and eng.shard_mode == "gspmd"


def test_cli_mesh_on_the_cpu(capsys):
    from repro_torch.launch import serve as cli
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--requests", "3",
            "--prompt-len", "8", "--gen", "4", "--max-seqs", "2",
            "--block-size", "4", "--device", "cpu"]
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    cli.main(argv + ["--mesh", "1x1"])
    out = capsys.readouterr().out
    assert "serving mesh: {'data': 1, 'model': 1} | slots per data " \
           "shard: 2" in out
    assert "served 3 requests / 12 new tokens" in out
    # on the CPU a mesh is logical: 2x1 is two shards of the one device
    cli.main(argv + ["--mesh", "2x1"])
    out = capsys.readouterr().out
    assert "serving mesh: {'data': 2, 'model': 1} | slots per data " \
           "shard: 1" in out
    assert "served 3 requests / 12 new tokens" in out
    with pytest.raises(ValueError, match="wants 'DxM' or 'auto'"):
        cli.main(argv + ["--mesh", "2"])
    assert {s: signal.getsignal(s) for s in prev} == prev
