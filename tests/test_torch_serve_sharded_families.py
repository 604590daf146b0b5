"""Mesh serving of the ssm, hybrid and moe families on the port alone:
reduced mamba2-1.3b, hymba-1.5b, qwen2-moe-a2.7b and a Hymba with 5 query
heads, 5 KV heads and vocab 257, f32, on logical CPU meshes.

1x1 is bit-equal to the engine without a mesh (tokens and pools); 2x1, 1x2,
2x2 and 1x3 (8 SSM heads do not divide 3: the SSD block replicates) are
token-equal to it, after every fed row's top-2 logit gap is asserted.  The
tensor-parallel blocks — the SSD decode step and prefill chunk over
``ssm_heads``, the split gated norm, the expert-parallel MoE block — are
held to the unsharded blocks on 2 and 4 shards; the collectives' bytes to
their formula; a dropped MoE assignment is counted once; idle slots keep
their state; a 2x2 Hymba snapshot round-trips; the CLI serves on a 2x2 CPU
mesh.  The reference's engine on the same meshes is the JAX file's
(``test_torch_serve_sharded_families_jax.py``).
"""
import signal

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (
    gather, place_tree, tree_specs, use_rules)
from repro_torch.launch.mesh import serve_rules
from repro_torch.models import build
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import rms_norm
from repro_torch.serve import (
    Engine, ServeConfig, load_snapshot, restore_engine, save_snapshot)

from test_torch_serve_sharded import GAP, mesh

CONFIGS = {"mamba2": ("mamba2-1.3b", {}), "hymba": ("hymba-1.5b", {}),
           "moe": ("qwen2-moe-a2.7b", {}),
           "hymba55": ("hymba-1.5b", dict(n_heads=5, n_kv_heads=5,
                                          vocab_size=257))}
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 3)]
SERVE = dict(max_seqs=4, block_size=4, max_len=40, chunk_size=8)
BLOCK_TOL = 1e-5
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(name: str, **kw):
    key = (name, tuple(sorted(kw.items())))
    if key not in _MODELS:
        arch, rep = CONFIGS[name]
        m = build(reduced(get_config(arch)).replace(**rep, **kw))
        _MODELS[key] = (m, m.init(0, device="cpu"))
    return _MODELS[key]


def prompts(V, n=5, seed=7):
    """Prompts of 5-19 tokens: several prefill chunks of 8, and more
    requests than slots."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, 5 + (7 * i) % 15)]
            for i in range(n)]


def record_gaps(eng) -> list:
    """Wrap the engine's steps: the smallest top-2 logit gap of the rows
    each step feeds (active decode rows, prefill rows with tokens)."""
    gaps, real = [], eng._step_fn

    def step_fn(prog, which, draft=False):
        fn = real(prog, which, draft)

        def run(params, cache, *args):
            logits, cache = fn(params, cache, *args)
            rows = args[3] if which == "paged_decode_step" else args[-1] > 0
            top = logits.float().topk(2, dim=-1).values
            gaps.append(float((top[:, 0] - top[:, 1])[rows].min()))
            return logits, cache
        return run
    eng._step_fn = step_fn
    return gaps


def serve(model, params, rows, mesh_=None, gen=6, gaps=False, **cfg):
    eng = Engine(model, params, ServeConfig(**{**SERVE, **cfg}),
                 device="cpu", mesh=mesh_)
    rec = record_gaps(eng) if gaps else None
    for p in rows:
        eng.add_request(p, max_new_tokens=gen)
    out, _ = eng.run()
    toks = {r: out[r].tokens for r in out}
    return (toks, eng, rec) if gaps else (toks, eng)


def pools_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(
        a[n].view(torch.uint8), b[n].view(torch.uint8)) for n in a)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_family_serves_on_every_mesh(name):
    model, params = models(name)
    rows = prompts(model.cfg.vocab_size)
    moe_mod.reset_dropped()
    ref, ref_eng, gaps = serve(model, params, rows, gaps=True)
    assert min(gaps) > GAP, min(gaps)
    ref_drops = moe_mod.dropped_assignments()
    for dm in MESHES:
        moe_mod.reset_dropped()
        out, eng = serve(model, params, rows, mesh(*dm))
        want = "dp" if model.cfg.n_experts and dm == (2, 1) else "gspmd"
        assert eng.shard_mode == want, dm
        if want == "dp" and moe_mod.dropped_assignments() + ref_drops:
            # each dp shard's capacity comes from its own tokens (the
            # reference's rule, held to the JAX engine in the JAX file):
            # tokens equal one device's only where nothing drops
            cf = model.cfg.n_experts / model.cfg.top_k
            twin, tparams = models(name, capacity_factor=cf)
            assert serve(twin, tparams, rows, mesh(*dm))[0] == \
                serve(twin, tparams, rows)[0]
        else:
            assert out == ref, (name, dm, eng.shard_mode)
        audit = eng.replica_audit()
        if dm == (1, 1):
            assert pools_equal({n: t.shards[0] for n, t in eng.cache.items()},
                               ref_eng.cache)
        elif dm[1] > 1 and "conv" in eng.cache:
            # the conv window's model replicas were held byte-equal
            assert audit["replica_pairs"] >= dm[1] - 1
            eng.cache["conv"].shards[1][0, 0, 0, 0] += 1.0
            with pytest.raises(AssertionError,
                               match="model replica 1 of pool conv"):
                eng.replica_audit()


def test_idle_slots_keep_their_state_on_a_mesh():
    """One request on a 4-slot hybrid engine over 2x2 and 1x2: the idle
    slots' conv and state rows hold their bytes through prefill and decode
    (the ``active`` mask and ``valid == 0`` on every shard)."""
    model, params = models("hymba")
    for dm in ((2, 2), (1, 2)):
        eng = Engine(model, params, ServeConfig(**SERVE), device="cpu",
                     mesh=mesh(*dm))
        for n in ("conv", "state"):
            for t in eng.cache[n].shards:
                t.fill_(0.5)
        eng.add_request(prompts(model.cfg.vocab_size, 1)[0],
                        max_new_tokens=4)
        used = set()
        while eng.scheduler.has_work:
            eng.step()
            used |= {s.slot for s in eng.scheduler.running}
        (slot,) = used
        for n in ("conv", "state"):
            pool = gather(eng.cache[n])
            idle = [s for s in range(4) if s != slot]
            assert bool((pool[:, idle] == 0.5).all()), (dm, n)
            assert not bool((pool[:, slot] == 0.5).all()), (dm, n)


def expected_decode_bytes(cfg, B: int, d: int, m: int) -> dict:
    """The bytes by kind of one decode step over a (d, m) mesh whose data
    axis divides the B slots: every collective's result as one participant
    holds it, once per call (``collectives``' convention)."""
    f, D, L = 4, cfg.d_model, cfg.num_layers          # f32 reduced models
    Bl = B // d
    out: dict = {}

    def add(kind, calls, numel, size=f):
        if calls:
            out[kind] = out.get(kind, 0) + calls * numel * size
    V, H, KH, hd = cfg.vocab_size, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim_
    vsplit = V % m == 0 and m > 1
    add("all-reduce", d if vsplit else 0, Bl * D)           # the embedding
    add("all-gather", d if vsplit else 0, Bl * V)           # the logits
    add("gather", 1 if d > 1 else 0, B * V)
    for _ in range(L):
        if cfg.family == "ssm" or cfg.hybrid:
            nh, hp = cfg.ssm_n_heads, cfg.ssm_head_dim
            if nh % m == 0 and m > 1:
                add("ssm-conv-all-gather", d, Bl * nh * hp)
                add("ssm-norm-all-reduce", d, Bl)
                add("all-reduce", d, Bl * D)
        if cfg.family == "ssm":
            continue
        hs, ks = H % m == 0 and m > 1, KH % m == 0 and m > 1
        if d > 1:
            add("row-broadcast", 2 * m, B * (KH // m if ks else KH) * hd)
        if hs and not ks:                 # the wrap all-gathers q's heads
            add("all-gather", d, Bl * H * hd)
        if hs:
            add("all-reduce", d, Bl * D)
        if cfg.n_experts:
            E = cfg.n_experts
            ep = E % m == 0 and m > 1
            T = B if d > 1 else Bl
            if d > 1:
                add("moe-row-gather", m, B * D)
            C = moe_mod._capacity(cfg, T)
            add("moe-router-all-gather", d if ep else 0, T * E)
            add("moe-expert-all-gather", d if ep else 0, E * C * D)
            sw = cfg.n_shared_experts * cfg.shared_d_ff
            add("all-reduce", d if sw % m == 0 and m > 1 else 0, T * D)
        elif cfg.d_ff and cfg.d_ff % m == 0 and m > 1:
            add("all-reduce", d, Bl * D)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_collective_bytes_match_their_formula(name):
    model, params = models(name)
    cfg = model.cfg
    B = SERVE["max_seqs"]
    for dm in ((2, 2), (1, 2)):
        eng = Engine(model, params, ServeConfig(**SERVE), device="cpu",
                     mesh=mesh(*dm))
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, B)
                                .astype(np.int32))
        pos = torch.tensor([3, 0, 5, 2], dtype=torch.int32)
        tables = torch.zeros((B, eng.cache_host.tables.shape[1]),
                             dtype=torch.int32)
        coll.reset_collectives()
        with use_rules(eng.rules, mesh=eng.mesh):
            tp.paged_decode_step(eng.params, cfg, eng.cache, toks, pos,
                                 tables, torch.ones(B, dtype=torch.bool))
        got = coll.collective_bytes()
        assert got["per_kind"] == expected_decode_bytes(cfg, B, *dm), dm
        assert got["total_bytes"] == sum(got["per_kind"].values())


def test_dropped_assignment_counted_once():
    """Published capacity cut to a quarter: a prefill chunk of 4 x 16
    tokens drops assignments; every gspmd mesh (one dispatch over the
    step's tokens, on every shard) counts exactly the one-device count."""
    model, params = models("moe", capacity_factor=0.25)
    rows = [[int(t) for t in np.random.default_rng(i).integers(
        0, model.cfg.vocab_size, 16)] for i in range(4)]
    cfg = dict(chunk_size=16, max_len=24)
    moe_mod.reset_dropped()
    ref, _ = serve(model, params, rows, gen=2, **cfg)
    want = moe_mod.dropped_assignments()
    assert want > 0
    for dm in ((1, 1), (1, 2), (2, 2), (1, 4)):
        moe_mod.reset_dropped()
        out, eng = serve(model, params, rows, mesh(*dm), gen=2, **cfg)
        assert eng.shard_mode == "gspmd"
        assert moe_mod.dropped_assignments() == want, dm
        assert out == ref, dm


def placed(model, params, m: int):
    """Parameters and pools (B 4) over a 1 x m mesh, the step's mesh and
    rules; the pools' unsharded copies."""
    mm = mesh(1, m)
    rules = serve_rules(model.cfg, mm)
    pools = model.init_paged_cache(num_blocks=9, block_size=4, max_seqs=4,
                                   device="cpu")
    gen = torch.Generator().manual_seed(5)
    for t in pools.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    sp = place_tree(params, mm, tree_specs(rules, model.param_axes(),
                                           params))
    sc = place_tree(pools, mm, tree_specs(rules, model.paged_cache_axes(),
                                          pools), copy=True)
    return mm, rules, sp, sc, pools


def close(a, b) -> bool:
    return float((a - b).abs().max()) <= BLOCK_TOL * max(
        1.0, float(b.abs().max()))


@pytest.mark.parametrize("m", [2, 4])
def test_tensor_parallel_blocks_match_unsharded(m):
    """The SSD decode step and prefill chunk over ``ssm_heads``, the split
    gated norm and the expert-parallel MoE block on m shards against the
    unsharded blocks, outputs and state, within 1e-5."""
    model, params = models("mamba2")
    cfg = model.cfg
    mm, rules, sp, sc, pools = placed(model, params, m)
    gen = torch.Generator().manual_seed(9)
    layer = tf._layer(params["layers"], 1)["ssm"]
    lc = {n: pools[n][1].clone() for n in ("conv", "state")}
    active = torch.tensor([True, False, True, True])
    pos = torch.tensor([[0], [4], [7], [2]], dtype=torch.int32)
    x = torch.randn((4, 1, cfg.d_model), generator=gen)
    with use_rules(rules, mesh=mm):
        st = tp._Step(sp, 4)
        rec = tp._Recurrent(st, cfg, sc, pos, None, active, None)
        out = rec(1, st.local(x))
    want = tf.ssm_decode_rows(layer, cfg, x, lc, pos[:, 0] == 0, active)
    assert all(close(o, want) for o in out)
    assert close(gather(sc["state"])[1], lc["state"])
    assert all(torch.equal(t[1], lc["conv"]) for t in sc["conv"].shards)
    # a prefill chunk of 8 on state rows [2, 0, 3, 1]
    C = 8
    valid = torch.tensor([8, 0, 3, 5], dtype=torch.int32)
    slots = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    posc = torch.tensor([0, 4, 6, 0])[:, None] + torch.arange(C)[None]
    xc = torch.randn((4, C, cfg.d_model), generator=gen)
    with use_rules(rules, mesh=mm):
        st = tp._Step(sp, 4)
        rec = tp._Recurrent(st, cfg, sc, posc, valid, None, slots)
        out = rec(1, st.local(xc))
    want = tf.ssm_chunk_rows(layer, cfg, xc, lc, slots.long(),
                             posc[:, 0] == 0, valid > 0, valid)
    real = torch.arange(C)[None, :] < valid[:, None]
    assert all(close(o[real], want[real]) for o in out)
    assert close(gather(sc["state"])[1], lc["state"])
    assert all(torch.equal(t[1], lc["conv"]) for t in sc["conv"].shards)
    # the gated norm over channels split m ways
    g = torch.randn((4, 3, 128), generator=gen)
    scale = torch.randn((128,), generator=gen)
    with use_rules(rules, mesh=mm):
        st = tp._Step(sp, 4)
        parts = tp.split_rms_norm(st, list(g.chunk(m, -1)), [scale] * m,
                                  cfg.norm_eps)
    assert close(torch.cat(parts, -1), rms_norm(g, scale, cfg.norm_eps))
    # the MoE block: 8 experts and the 128-wide shared experts over m
    model, params = models("moe")
    cfg = model.cfg
    mm, rules, sp, _, _ = placed(model, params, m)
    assert sp["layers"]["moe"]["w_gate"].spec[1] == ("model",)
    xm = torch.randn((4, C, cfg.d_model), generator=gen)
    mask = torch.arange(C)[None, :] < valid[:, None]
    moe_mod.reset_dropped()
    want, _ = moe_mod.moe_block(tf._layer(params["layers"], 0)["moe"], cfg,
                                xm, token_mask=mask)
    drops = moe_mod.dropped_assignments()
    moe_mod.reset_dropped()
    with use_rules(rules, mesh=mm):
        st = tp._Step(sp, 4)
        mp = sp["layers"]["moe"]
        ex = tp._MoeExchange(st, cfg, mp)
        assert ex.ep and ex.split_shared
        xt = xm.reshape(-1, cfg.d_model)
        out, _, _ = moe_mod.moe_shards([tp._at(mp, k, 0) for k in range(m)],
                                       cfg, [xt] * m, [mask] * m, ex)
    assert all(close(o.to(xm.dtype).reshape(xm.shape), want) for o in out)
    assert moe_mod.dropped_assignments() == drops


def test_snapshot_round_trip_on_a_2x2_hybrid_mesh(tmp_path):
    """A snapshot taken mid-run on a 2x2 Hymba mesh (every shard's KV,
    conv and state pools) restores onto a 2x2 mesh and finishes with the
    uninterrupted run's tokens."""
    model, params = models("hymba")
    rows = prompts(model.cfg.vocab_size)
    ref, _ = serve(model, params, rows, mesh(2, 2))
    eng = Engine(model, params, ServeConfig(**SERVE), device="cpu",
                 mesh=mesh(2, 2))
    for p in rows:
        eng.add_request(p, max_new_tokens=6)
    for _ in range(5):
        eng.step()
    path = str(tmp_path / "hymba.rsrv")
    save_snapshot(eng, path)
    snap = load_snapshot(path)
    assert len(snap["pools"]) == 4 and "state" in snap["pools"][3]
    back = restore_engine(snap, model, params, device="cpu", mesh=mesh(2, 2))
    for n in ("conv", "state", "k"):
        assert all(torch.equal(a, b) for a, b in zip(
            back.cache[n].shards, eng.cache[n].shards)), n
    while back.scheduler.has_work:
        back.step()
    out = {s.req.rid: list(s.generated) for s in back.scheduler.finished}
    assert out == ref
    back.replica_audit()


def test_cli_serves_hymba_on_a_2x2_cpu_mesh(capsys):
    from repro_torch.launch import serve as cli
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    cli.main(["--arch", "hymba-1.5b", "--reduced", "--mesh", "2x2",
              "--device", "cpu", "--requests", "4", "--prompt-len", "12",
              "--gen", "4", "--max-seqs", "4", "--block-size", "4"])
    out = capsys.readouterr().out
    assert "serving mesh: {'data': 2, 'model': 2} | slots per data " \
           "shard: 2" in out
    assert "served 4 requests / 16 new tokens" in out
    assert {s: signal.getsignal(s) for s in prev} == prev


def test_moe_decode_step_receives_the_active_mask():
    """The moe family's decode calls carry ``active``, as the reference's
    engine passes it, on one device and on a mesh: an idle slot's token
    routes to the virtual expert and takes no expert capacity."""
    model, params = models("moe")
    rows = prompts(model.cfg.vocab_size, n=2)
    for dm in (None, (1, 2)):
        eng = Engine(model, params, ServeConfig(**SERVE), device="cpu",
                     mesh=dm and mesh(*dm))
        seen, real = [], eng._step_fn

        def step_fn(prog, which, draft=False, real=real, seen=seen):
            fn = real(prog, which, draft)
            if which != "paged_decode_step":
                return fn

            def run(params, cache, tokens, positions, tables, active=None):
                seen.append(active)
                return fn(params, cache, tokens, positions, tables, active)
            return run
        eng._step_fn = step_fn
        for p in rows:
            eng.add_request(p, max_new_tokens=4)
        eng.run()
        assert seen and all(a is not None and a.dtype == torch.bool
                            for a in seen), dm
        assert any(not bool(a.all()) for a in seen)   # idle slots rode along
