"""The port's disaggregated prefill/decode serving, mirroring
``tests/test_serve_disagg.py``, and the serving CLI's replicated mode.

The contract under test: a cluster split into prefill-role and decode-role
replicas serves every request with the tokens of a single mixed engine.  A
prefill replica plans prefill chunks only; once a sequence's final chunk
completes it parks at decode phase and the cluster migrates its KV blocks
and prefix chain to the least-loaded decode-capable replica over the
``export_slot`` / ``import_slot`` transport.  When the decode pool has
headroom the hand-off is zero-recompute; when it does not, the adopter
falls back to waiting-with-recompute — either way the tokens cannot change.
Recurrent families (reduced Mamba-2 here) cannot move their state as
blocks, so every hand-off of theirs takes the recompute path.

The CLI's ``--replicas`` / ``--prefill-replicas`` run in this process, and a
SIGHUP (through the handler the CLI installs, recorded instead of
installed) rolls every replica mid-run.  Reduced TinyLlama, f32, the port's
own weights, on the CPU; the engine and the cluster read a patched clock.

Across frameworks, one prefill and two decode replicas run on the JAX
package's Cluster and the port's with converted weights (plainly, through a
prefill replica's restart, and through a decode replica's death): the
hand-offs, adopters, counts and steps per replica must be equal, the
gathered pool bytes within 1e-5, and the tokens by the cluster tests' gap
rule.
"""
import dataclasses
import signal

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import build as j_build
from repro.serve import (Cluster as JCluster, Engine as JEngine,
                         Fault as JFault, FaultInjector as JFaultInjector,
                         ServeConfig as JServeConfig)
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import build
from repro_torch.obs import Telemetry
from repro_torch.serve import (Cluster, ClusterConfig, Engine, Fault,
                               FaultInjector, ServeConfig)
from repro_torch.serve import cluster as cluster_mod
from repro_torch.serve import engine as engine_mod
from test_torch_serve_async import FakeClock
from test_torch_serve_cluster import _JCFG, _hold_tokens, _record_exports

_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    """The port's engine and cluster read a deterministic clock."""
    fc = FakeClock()
    monkeypatch.setattr(engine_mod, "time", fc)
    monkeypatch.setattr(cluster_mod, "time", fc)
    return fc


def _model(arch: str = "tinyllama-1.1b"):
    if arch not in _MODELS:
        m = build(reduced(get_config(arch)))
        _MODELS[arch] = (m, m.init(0, device="cpu"))
    return _MODELS[arch]


def _prompts(V, n=6, base=10, seed=41):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, base - (i % 4))]
            for i in range(n)]


def _cfg(**kw):
    kw.setdefault("max_seqs", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("max_len", 48)
    kw.setdefault("chunk_size", 8)
    kw.setdefault("audit_level", "full")
    return ServeConfig(**kw)


def _engine(arch: str = "tinyllama-1.1b", **kw):
    m, params = _model(arch)
    return Engine(m, params, _cfg(**kw), device="cpu")


def _reference(prompts, gen=8, arch="tinyllama-1.1b", **cfg_kw):
    """Single mixed-engine oracle: {submission index: tokens}."""
    eng = _engine(arch, **cfg_kw)
    for p in prompts:
        eng.add_request(p, max_new_tokens=gen)
    out, _ = eng.run()
    return {i: tuple(out[i].tokens) for i in sorted(out)}


def _drive(cluster, rids, max_ticks=500):
    res, stats = cluster.run(max_ticks=max_ticks)
    assert not cluster.has_work, "cluster deadlocked"
    cluster.check()
    for r in cluster.replicas:
        if r.state == "alive":
            a = r.engine.cache_host.allocator
            assert a.num_live == 0, f"{r.name}: leaked live blocks"
            assert a.num_held == 0, f"{r.name}: leaked held blocks"
    return {rids.index(rid): (tuple(rec.tokens), rec.finish_reason)
            for rid, rec in res.items()}, stats


def _tokens(got):
    return {i: v for i, (v, _) in got.items()}


def _disagg(decode_cfg=None, prefill_cfg=None, arch="tinyllama-1.1b",
            **cluster_kw):
    """1 prefill + 1 decode replica; returns (cluster, e_pre, e_dec)."""
    m, params = _model(arch)
    e_pre = Engine(m, params, prefill_cfg or _cfg(role="prefill"),
                   device="cpu")
    e_dec = Engine(m, params, decode_cfg or _cfg(role="decode"),
                   device="cpu")
    return Cluster([e_pre, e_dec], **cluster_kw), e_pre, e_dec


# ---------------------------------------------------------------------------
# Disaggregated == single engine
# ---------------------------------------------------------------------------

def test_disagg_byte_identical_to_single_engine():
    """1 prefill + 1 decode replica over a mixed-length request set: every
    request completes with the single engine's tokens, every sequence
    migrated exactly once, and the routing maps retire with the
    requests."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size)
    ref = _reference(prompts)
    cl, e_pre, e_dec = _disagg()
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    # role-aware routing: new prompts all land on the prefill replica
    assert len(e_pre.scheduler.waiting) == len(prompts)
    assert not e_dec.scheduler.waiting
    got, stats = _drive(cl, rids)
    assert _tokens(got) == ref
    assert all(reason == "length" for _, reason in got.values())
    assert stats["disagg_migrations"] == len(prompts)
    assert stats["failovers"] == 0
    # prefill replica did prefill only: at most the sampled-prefill token
    # per request, never a steady-state decode stream
    assert e_pre._c["prefill_tokens"].value > 0
    assert e_pre._c["decode_tokens"].value <= len(prompts)
    assert e_pre._c["decode_calls"].value == 0
    assert e_dec._c["decode_tokens"].value > 0
    assert not cl._alias and not cl._retries


def test_disagg_zero_recompute_with_headroom():
    """When the decode pool has slots for every migrated sequence, the
    block hand-off is exact and zero-recompute: the decode replica never
    prefills a single token, and it holds the blocks the prefill replica
    wrote."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=3, base=12)
    ref = _reference(prompts, gen=10)
    cl, e_pre, e_dec = _disagg()
    rids = [cl.submit(p, max_new_tokens=10) for p in prompts]
    got, stats = _drive(cl, rids)
    assert _tokens(got) == ref
    assert stats["disagg_migrations"] == len(prompts)
    # each request hands over the blocks of its prompt (every token but
    # the last sampled one is cached)
    assert stats["migrated_blocks"] == sum(
        e_dec.cache_host.blocks_for(len(p)) for p in prompts)
    assert e_dec._c["prefill_tokens"].value == 0, \
        "headroom present: migration must not recompute"


def test_disagg_headroom_fallback_recomputes():
    """More in-flight sequences than the decode pool holds: the overflow
    falls back to waiting-with-recompute on the decode replica and outputs
    still cannot change."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=6, base=11)
    ref = _reference(prompts)
    cl, e_pre, e_dec = _disagg(
        decode_cfg=_cfg(role="decode", max_seqs=2, num_blocks=24))
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    got, stats = _drive(cl, rids)
    assert _tokens(got) == ref
    assert stats["disagg_migrations"] == len(prompts)
    assert e_dec._c["prefill_tokens"].value > 0, \
        "expected the recompute fallback to engage"
    assert all(reason == "length" for _, reason in got.values())


def test_disagg_migration_latency_observed():
    """The migration-latency histogram records one hand-off per sequence,
    and the per-role trace tracks carry the role suffix."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=3)
    tel = Telemetry(enabled=True)
    cl, _, _ = _disagg(telemetry=tel)
    rids = [cl.submit(p, max_new_tokens=6) for p in prompts]
    _drive(cl, rids)
    hist = tel.registry.histograms["migrate/handoff_s"]
    assert hist.count == len(prompts)
    names = set(tel.trace._track_names.values())
    assert any(":prefill" in n for n in names)
    assert any(":decode" in n for n in names)


# ---------------------------------------------------------------------------
# Role constraints and routing
# ---------------------------------------------------------------------------

def test_prefill_only_cluster_rejected():
    """A cluster whose every replica is prefill-role can never finish a
    request — constructing one is a config error."""
    with pytest.raises(ValueError, match="decode-capable"):
        Cluster([_engine(role="prefill")])


def test_bad_role_rejected():
    with pytest.raises(ValueError, match="role"):
        _engine(role="verifier")


def test_decode_replica_takes_prompts_when_alone():
    """Availability beats the role split: with every prefill-capable
    replica dead, new prompts route to the decode replica, whose engine
    plans normally."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=3)
    ref = _reference(prompts)
    cl, e_pre, e_dec = _disagg()
    cl.kill(0)                            # prefill replica down
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    assert len(e_dec.scheduler.waiting) == len(prompts)
    got, stats = _drive(cl, rids)
    assert _tokens(got) == ref
    assert stats["disagg_migrations"] == 0


# ---------------------------------------------------------------------------
# Failure domains per role
# ---------------------------------------------------------------------------

def test_prefill_replica_death_rehomes_to_decode():
    """The prefill replica dies mid-prefill: its half-prefilled running set
    and backlog re-home onto the decode replica through ordinary failover,
    identically."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size)
    ref = _reference(prompts)
    fi = FaultInjector([Fault("replica_kill", step=2, rid=0)])
    cl, _, e_dec = _disagg(faults=fi)
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    got, stats = _drive(cl, rids)
    assert fi.fired["replica_kill"] == 1
    assert stats["failovers"] == 1 and stats["alive"] == 1
    assert _tokens(got) == ref
    assert all(reason == "length" for _, reason in got.values())


def test_decode_replica_death_fails_parked_requests_cleanly():
    """The decode replica dies and only the prefill replica survives:
    parked sequences have no decode-capable target, so they fail with
    finish_reason "error" instead of wedging the cluster; nothing leaks,
    and the retry map retires with them."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=3)
    fi = FaultInjector([Fault("replica_kill", step=4, rid=1)])
    cl, e_pre, _ = _disagg(faults=fi)
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    got, _ = _drive(cl, rids)
    assert fi.fired["replica_kill"] == 1
    assert len(got) == len(prompts), "every request must get a result"
    assert all(reason == "error" for _, reason in got.values())
    assert not cl._alias and not cl._retries


def test_prefill_replica_restart_live_migrates():
    """restart() on a prefill replica cannot drain (parked sequences never
    finish there): it live-migrates running + backlog instead, with zero
    failed requests and identical outputs."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size)
    ref = _reference(prompts)
    cl, e_pre, _ = _disagg(cfg=ClusterConfig(drain_timeout_s=30.0))
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    for _ in range(2):
        cl.step()
    cl.restart(0)
    assert cl.replicas[0].state == "alive"
    got, stats = _drive(cl, rids)
    assert stats["failovers"] == 0
    assert _tokens(got) == ref
    assert all(reason == "length" for _, reason in got.values())


def test_rolling_restart_role_cluster():
    """rolling_restart across a prefill + decode + mixed cluster: zero
    failed requests, identical tokens."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size)
    ref = _reference(prompts)
    cl = Cluster([_engine(role="prefill"), _engine(role="decode"),
                  _engine()])
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    for _ in range(3):
        cl.step()
    cl.rolling_restart()
    assert all(r.state == "alive" for r in cl.replicas)
    got, stats = _drive(cl, rids)
    assert stats["failovers"] == 0
    assert _tokens(got) == ref
    assert all(reason in ("length", "stop") for _, reason in got.values())


# ---------------------------------------------------------------------------
# Prefill-role engine semantics
# ---------------------------------------------------------------------------

def test_prefill_role_engine_plans_no_decode():
    """Standalone prefill-role engine: sequences park at decode phase
    (never finish) and the scheduler plans zero steady-state decode rows —
    run() would deadlock, so step until quiescent."""
    m, _ = _model()
    eng = _engine(role="prefill")
    prompts = _prompts(m.cfg.vocab_size, n=2)
    for p in prompts:
        eng.add_request(p, max_new_tokens=8)
    for _ in range(30):
        if not eng.scheduler.has_work:
            break
        before = eng._steps
        eng.step()
        if eng._steps == before:        # planned nothing: parked
            break
    parked = [s for s in eng.scheduler.running if s.phase == "decode"]
    assert len(parked) == len(prompts), "sequences must park, not finish"
    assert not eng.scheduler.finished
    assert eng.decode_ready() == [s.req.rid for s in parked]
    # each sequence emitted at most its sampled-prefill first token
    assert all(len(s.generated) <= 1 for s in parked)
    assert eng._c["decode_calls"].value == 0
    eng.cache_host.check()


# ---------------------------------------------------------------------------
# Recurrent families: every hand-off recomputes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["disagg", "failover"])
def test_ssm_handoffs_take_the_recompute_path(scenario):
    """Reduced Mamba-2 (SSM/conv state per slot, not per block):
    ``can_handoff_blocks`` is False, so neither a disaggregation hand-off
    nor a failover carries block bytes; every adopted request re-prefills
    its known tokens and the tokens equal a single engine's."""
    arch = "mamba2-1.3b"
    m, _ = _model(arch)
    prompts = _prompts(m.cfg.vocab_size, n=3)
    ref = _reference(prompts, arch=arch)
    if scenario == "disagg":
        cl, _, e_to = _disagg(arch=arch)
        rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    else:
        engines = [_engine(arch), _engine(arch)]
        e_to = engines[1]
        cl = Cluster(engines, faults=FaultInjector(
            [Fault("replica_kill", step=4, rid=0)]))
        rids = [engines[0].add_request(p, max_new_tokens=8)
                for p in prompts]
    assert not e_to.can_handoff_blocks
    exported = []
    for r in cl.replicas:
        inner = r.engine.export_request

        def export(rid, remove=False, _inner=inner):
            h = _inner(rid, remove=remove)
            exported.append(h)
            return h
        r.engine.export_request = export
    got, stats = _drive(cl, rids)
    assert _tokens(got) == ref
    assert exported and all(h.pools is None for h in exported)
    assert stats["migrated_blocks"] == 0
    assert e_to._c["prefill_tokens"].value > 0
    if scenario == "disagg":
        assert stats["disagg_migrations"] == len(prompts)
    else:
        assert stats["failovers"] == 1


# ---------------------------------------------------------------------------
# The CLI's replicated mode
# ---------------------------------------------------------------------------

_ARGV = ["--arch", "tinyllama-1.1b", "--reduced", "--requests", "6",
         "--prompt-len", "12", "--gen", "8", "--max-seqs", "2",
         "--block-size", "4", "--device", "cpu"]


def _cli(argv, hup_after=None):
    """Run the serving CLI in this process with its signal handlers
    recorded instead of installed; with ``hup_after``, deliver a SIGHUP to
    the recorded handler once that many engine steps ran.  Returns the
    recorded handlers after the run."""
    from repro_torch.launch import serve as cli
    installed: dict = {}

    def fake_signal(sig, handler):
        old = installed.get(sig, signal.SIG_DFL)
        installed[sig] = handler
        return old

    steps = [0]
    real_step = engine_mod.Engine.step

    def step(self):
        steps[0] += 1
        if steps[0] == hup_after:
            installed[signal.SIGHUP](signal.SIGHUP, None)
        return real_step(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli.signal, "signal", fake_signal)
        mp.setattr(engine_mod.Engine, "step", step)
        cli.main(argv)
    return installed


def _served(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("served "))
    return line.split(" in ")[0]


def test_cli_replicas_and_prefill_replicas(capsys):
    """``--replicas 2`` and ``--prefill-replicas 1 --replicas 2`` serve the
    same requests to the same tokens as one engine; the disaggregated run
    migrates every request; SIGTERM / SIGINT / SIGHUP handlers are
    installed and the previous ones restored."""
    _cli(_ARGV)
    single = capsys.readouterr().out
    installed = _cli(_ARGV + ["--replicas", "2"])
    rep = capsys.readouterr().out
    assert set(installed) == {signal.SIGTERM, signal.SIGINT, signal.SIGHUP}
    assert all(h == signal.SIG_DFL for h in installed.values())
    assert "cluster ready (2 replicas)" in rep
    assert "2/2 alive | failovers 0" in rep
    _cli(_ARGV + ["--replicas", "2", "--prefill-replicas", "1"])
    dis = capsys.readouterr().out
    assert "cluster ready (1 prefill + 2 decode replicas)" in dis
    assert "disagg migrations 6" in dis
    assert _served(single) == _served(rep) == _served(dis) == \
        "served 6 requests / 48 new tokens"
    sample = [ln for ln in single.splitlines() if ln.startswith("sample")]
    assert sample and sample[0] in rep.splitlines() and \
        sample[0] in dis.splitlines()


def test_cli_sighup_rolling_restart(capsys):
    """A SIGHUP mid-run rolls every replica (drain, re-home, snapshot
    round-trip) and the run still serves every request, none failed."""
    _cli(_ARGV + ["--replicas", "2"])
    ref = capsys.readouterr().out
    _cli(_ARGV + ["--replicas", "2", "--drain-timeout", "60"], hup_after=3)
    out = capsys.readouterr().out
    assert "SIGHUP: rolling restart" in out
    assert _served(out) == _served(ref) == \
        "served 6 requests / 48 new tokens"
    assert "2/2 alive | failovers 0" in out


# ---------------------------------------------------------------------------
# Across frameworks: the port's role cluster against the JAX package's
# ---------------------------------------------------------------------------

_ROLES = ("prefill", "decode", "decode")


def _jax_role_engines():
    """One prefill and two decode engines per framework (``_JCFG`` of the
    cluster tests, with roles) on reduced TinyLlama from PRNGKey(0), the
    port's weights converted; built once and reset by every user."""
    if "jax_roles" not in _MODELS:
        jm = j_build(j_reduced(j_get_config("tinyllama-1.1b")))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build(convert.convert_config(dataclasses.asdict(jm.cfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        je = [JEngine(jm, jp, JServeConfig(**_JCFG, role=r)) for r in _ROLES]
        te = [Engine(tm, tp, ServeConfig(**_JCFG, role=r), device="cpu")
              for r in _ROLES]
        _MODELS["jax_roles"] = (jm, jp, je, te)
    jm, jp, je, te = _MODELS["jax_roles"]
    for e in je + te:
        e.reset()
        e.faults = None
    return jm, jp, je, te


def _record_adopts(engines, log):
    """Log every adoption: (adopter index, exported rid, adopted rid)."""
    for i, e in enumerate(engines):
        inner = e.adopt

        def adopt(h, _inner=inner, _i=i):
            new = _inner(h)
            log.append((_i, h.state.req.rid, new))
            return new
        e.adopt = adopt


@pytest.mark.parametrize("scenario", ["headroom", "prefill_restart",
                                      "decode_kill"])
def test_role_cluster_vs_jax_cluster(scenario):
    """One prefill and two decode replicas on the reference's Cluster and
    the port's, the same converted weights and requests: identical
    hand-offs (exported rid, chain, cursor), adopters and adopted rids,
    disaggregation migrations, migrated blocks, failovers, ticks, steps
    per replica and finish reasons; the gathered pool bytes within 1e-5;
    tokens by the cluster tests' gap rule.  ``headroom`` migrates every
    request at its last prefill chunk; ``prefill_restart`` restarts the
    prefill replica after two ticks, which live-migrates its running set
    and backlog; ``decode_kill`` kills a decode replica mid-decode, whose
    decode-phase requests may re-home only onto the other decode
    replica."""
    jm, jp, je, te = _jax_role_engines()
    rng = np.random.default_rng(47)
    prompts = [[int(t) for t in rng.integers(0, jm.cfg.vocab_size, n)]
               for n in (10, 9, 8, 10, 9, 8)]
    gen = 8

    def serve(cluster_cls, fault, injector, engines):
        exports: list = []
        adopts: list = []
        _record_exports(engines, exports)
        _record_adopts(engines, adopts)
        fi = injector([fault("replica_kill", step=6, rid=1)]) \
            if scenario == "decode_kill" else None
        cl = cluster_cls(engines, faults=fi)
        rids = [cl.submit(p, max_new_tokens=gen) for p in prompts]
        if scenario == "prefill_restart":
            for _ in range(2):
                cl.step()
            cl.restart(0)
        res, stats = cl.run(max_ticks=500)
        for e in engines:
            del e.export_request
            del e.adopt
        assert not cl.has_work
        cl.check()
        for r in cl.replicas:
            if r.state == "alive":
                assert r.engine.cache_host.allocator.num_live == 0
        return (rids, res, stats, [r.state for r in cl.replicas],
                [r.engine._steps for r in cl.replicas], exports, adopts)

    jr, jres, jst, jalive, jsteps, jexp, jad = serve(
        JCluster, JFault, JFaultInjector, je)
    tr, tres, tst, talive, tsteps, texp, tad = serve(
        Cluster, Fault, FaultInjector, te)
    stride = ClusterConfig().rid_stride
    assert tr == jr and all(r // stride == 0 for r in tr)
    assert talive == jalive and tsteps == jsteps
    for k in ("disagg_migrations", "migrated_blocks", "failovers", "ticks",
              "steps", "completed"):
        assert tst[k] == jst[k], k
    assert tad == jad
    assert {r: x.finish_reason for r, x in tres.items()} == \
        {r: x.finish_reason for r, x in jres.items()}
    assert all(x.finish_reason == "length" for x in tres.values())
    assert len(texp) == len(jexp)
    for (a, ca, na, pa), (b, cb, nb, pb) in zip(texp, jexp):
        assert (a, ca, na) == (b, cb, nb)
        assert (pa is None) == (pb is None)
        if pa is not None:
            assert set(pa) == set(pb)
            for k in pa:
                assert pa[k].shape == pb[k].shape
                np.testing.assert_allclose(pa[k], pb[k], rtol=0, atol=1e-5)
    # the scenario happened: hand-offs carried blocks, and the adopters
    # were the decode replicas (a restarted or dead replica adopts none)
    assert any(p is not None for *_, p in texp)
    assert {i for i, *_ in tad} <= {1, 2}
    if scenario == "headroom":
        assert tst["disagg_migrations"] == len(prompts)
        assert tst["failovers"] == 0
    elif scenario == "prefill_restart":
        assert tst["failovers"] == 0 and talive == ["alive"] * 3
        assert tst["disagg_migrations"] < len(prompts)
    else:
        assert tst["failovers"] == 1 and talive == ["alive", "dead", "alive"]
        assert any(a // stride == 1 and p is not None
                   for a, _, _, p in texp), "no decode-phase failover"
        assert {i for i, *_ in tad if i != 1}
    idx = {r: i for i, r in enumerate(tr)}
    _hold_tokens(jm, jp, {idx[r]: prompts[idx[r]] for r in tr},
                 {idx[r]: jres[r].tokens for r in jr},
                 {idx[r]: tres[r].tokens for r in tr})
