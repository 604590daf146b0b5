"""The port's speculative decoding, mirroring ``tests/test_serve_spec.py``
and ``tests/test_serve_quant.py::test_spec_draft_pool_int8_lossless_greedy``.

The speculative engine's contract is distribution identity: whatever the
draft proposes and however often it is rejected, the emitted tokens keep the
dense-only engine's law.  Greedy, that is token-for-token equality with the
port's dense-only engine and its sequential oracle (``generate``), for a bad
draft (random-init 50 %-pruned: near-zero acceptance, rejection and rollback
every cycle) and a perfect one (the target itself: full acceptance,
multi-token appends), under preemption, a stop token inside an accepted
window, prefix caching with copy-on-write on both pools, and narrowed draft
pools (bfloat16, int8).  At temperature the rejection sampler's emitted law
is the target's softmax whatever the proposal (the Leviathan et al.
identity), checked empirically under a seeded ``torch.Generator``.  The
ssm / hybrid families are gated back to dense decode.

Reduced configs, f32, on the CPU (``device="cpu"`` asked for explicitly),
random weights from the port's own ``init``: every case here compares the
port with itself.  The cases held against the JAX package are in
``test_torch_spec_jax.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.pruner import prune_model
from repro_torch.launch.serve import generate
from repro_torch.models import build
from repro_torch.models import moe as t_moe
from repro_torch.serve import Engine, ServeConfig
from test_torch_engine import count_sampling_steps

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(name, pruned_ratio=0.0):
    """(model, params) of reduced ``name`` from seed 0; with
    ``pruned_ratio``, L1-pruned by the port's pruner."""
    k = (name, pruned_ratio)
    if k not in _MODELS:
        m = build(reduced(get_config(name)))
        params = m.init(0, device="cpu")
        if pruned_ratio:
            pr = prune_model(m, params, pruned_ratio, criterion="l1")
            m, params = build(pr.cfg), pr.params
        _MODELS[k] = (m, params)
    return _MODELS[k]


def _prompts(V, B, P, seed):
    return np.random.default_rng(seed).integers(0, V, size=(B, P))


def _oracle(m, params, prompt, gen):
    with torch.no_grad():
        return generate(m, params, torch.from_numpy(np.asarray(prompt)),
                        gen).numpy()


def _engine(m, params, draft=None, **cfg):
    kw = {} if draft is None else dict(draft_model=draft[0],
                                       draft_params=draft[1])
    return Engine(m, params, ServeConfig(**cfg), device="cpu", **kw)


class _DraftDropsApart:
    """A draft whose MoE capacity drops are kept out of ``moe.dropped``:
    they change only what it proposes, never the emitted tokens, so the
    count left is the target's."""

    def __init__(self, model):
        self._m = model
        self.cfg = model.cfg

    def init_paged_cache(self, *a, **kw):
        return self._m.init_paged_cache(*a, **kw)

    def _apart(self, fn, *a):
        saved = {d: t.clone() for d, t in t_moe.dropped.items()}
        out = fn(*a)
        t_moe.dropped.clear()
        t_moe.dropped.update(saved)
        return out

    def paged_decode_step(self, *a):
        return self._apart(self._m.paged_decode_step, *a)

    def paged_prefill_step(self, *a):
        return self._apart(self._m.paged_prefill_step, *a)


def _serve(eng, prompts, gen, temperature=0.0):
    rids = [eng.add_request([int(t) for t in p], max_new_tokens=gen,
                            temperature=temperature) for p in prompts]
    out, stats = eng.run()
    return [out[r] for r in rids], stats


# ---------------------------------------------------------------------------
# 1. greedy byte parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("draft", ["pruned", "self"])
def test_spec_byte_identical_greedy(name, draft):
    """Spec engine == sequential oracle == dense-only engine at temperature
    0, whether the draft is nearly always rejected or always accepted.
    MoE: the engine's multi-row steps could pass an expert's capacity where
    the one-row oracle cannot, so no dropped assignment of the target's is
    a stated precondition of equal tokens (the draft's may drop)."""
    m, params = _build(name)
    d = _build(name, 0.5) if draft == "pruned" else (m, params)
    d = (_DraftDropsApart(d[0]), d[1])
    B, P, GEN = 3, 11, 8
    prompt = _prompts(m.cfg.vocab_size, B, P, seed=41)
    ref = _oracle(m, params, prompt, GEN)

    t_moe.reset_dropped()
    sc = dict(max_seqs=3, block_size=4, max_len=32, chunk_size=4)
    dense, dstats = _serve(_engine(m, params, **sc), prompt, GEN)
    eng = _engine(m, params, d, spec_k=3, **sc)
    assert eng.spec_active
    res, stats = _serve(eng, prompt, GEN)
    assert t_moe.dropped_assignments() == 0
    eng.cache_host.check()
    assert stats["spec_cycles"] > 0 and dstats["spec_cycles"] == 0
    for b, (r, dr) in enumerate(zip(res, dense)):
        assert r.tokens == list(ref[b, P:]) == dr.tokens, (name, draft, b)
        assert r.spec_proposed >= r.spec_accepted >= 0
    assert sum(r.spec_proposed for r in res) == stats["spec_proposed"]
    if draft == "self":
        assert stats["spec_acceptance"] == 1.0
        # accepted drafts actually shortened the schedule
        assert stats["steps"] < B * GEN
        assert stats["steps"] < dstats["steps"]


def test_spec_survives_preemption():
    """Recompute preemption of a speculating request (pool sized below the
    working set) must not break parity or allocator invariants."""
    m, params = _build("tinyllama-1.1b")
    P, GEN = 12, 10
    prompts = [_prompts(m.cfg.vocab_size, 1, P, seed=43 + b)[0]
               for b in range(3)]
    refs = [_oracle(m, params, p[None], GEN)[0] for p in prompts]
    eng = _engine(m, params, (m, params), max_seqs=3, block_size=4,
                  max_len=32, chunk_size=4, num_blocks=13, spec_k=3)
    res, _ = _serve(eng, prompts, GEN)
    eng.cache_host.check()
    assert sum(r.preemptions for r in res) > 0   # pressure was real
    for r, p, ref in zip(res, prompts, refs):
        assert r.tokens == list(ref[len(p):])


def test_spec_stop_token_mid_accepted_window():
    """A stop token inside an accepted draft window ends the request there:
    tokens after the stop in the same window are discarded, matching the
    oracle cut at the first stop; the rolled-back slot serves again."""
    m, params = _build("tinyllama-1.1b")
    P, GEN = 11, 8
    prompt = _prompts(m.cfg.vocab_size, 1, P, seed=53)[0]
    ref = _oracle(m, params, prompt[None], GEN)[0]
    # self draft -> full acceptance: the first cycle appends several
    # tokens in one fold, so stopping on the SECOND generated token
    # exercises the mid-window truncation
    stop = int(ref[P + 1])
    eng = _engine(m, params, (m, params), max_seqs=2, block_size=4,
                  max_len=32, chunk_size=4, spec_k=4)
    rid = eng.add_request([int(t) for t in prompt], max_new_tokens=GEN,
                          stop_tokens=(stop,))
    out, stats = eng.run()
    eng.cache_host.check()
    assert stats["spec_cycles"] >= 1
    assert stats["spec_accepted"] >= 2           # the window covered it
    assert out[rid].tokens == list(ref[P:P + 2])  # cut at the first stop
    assert out[rid].tokens[-1] == stop
    assert out[rid].finish_reason == "stop"
    r2 = eng.add_request([int(t) for t in prompt], max_new_tokens=GEN)
    out2, _ = eng.run()
    eng.cache_host.check()
    assert out2[r2].tokens == list(ref[P:])


def test_spec_with_prefix_caching_and_cow():
    """A full-cover prefix hit (COW on the boundary block) composes with
    speculative append / rollback: parity holds, and the self draft keeps
    accepting everything, which it can only do if its own pool's copy of
    the boundary block was made too."""
    m, params = _build("tinyllama-1.1b")
    P, GEN = 16, 8                    # 4 full blocks of 4
    prompt = _prompts(m.cfg.vocab_size, 1, P, seed=47)[0]
    ref = _oracle(m, params, prompt[None], GEN)[0]
    eng = _engine(m, params, (m, params), max_seqs=4, block_size=4,
                  max_len=32, chunk_size=8, spec_k=3)
    copies = []
    cow = eng._cow_impl

    def recording(cache, src, dst):
        copies.append((cache is eng.draft_cache, src, dst))
        return cow(cache, src, dst)

    eng._cow_impl = recording
    r1 = eng.add_request([int(t) for t in prompt], max_new_tokens=GEN)
    for _ in range(3):                # r1 prefills and starts speculating
        eng.step()
    r2 = eng.add_request([int(t) for t in prompt], max_new_tokens=GEN)
    out, stats = eng.run()
    eng.cache_host.check()
    assert stats["cow_copies"] >= 1
    assert out[r1].tokens == list(ref[P:])
    assert out[r2].tokens == list(ref[P:])
    assert stats["spec_acceptance"] == 1.0
    # every copy ran on both pools
    target = sorted((s, d) for is_draft, s, d in copies if not is_draft)
    assert target and target == sorted((s, d) for is_draft, s, d in copies
                                       if is_draft)


# ---------------------------------------------------------------------------
# 2. temperature > 0: the rejection sampler keeps the target's law
# ---------------------------------------------------------------------------

def test_rejection_sampler_matches_target_distribution():
    """Empirical law of the emitted token == the target's softmax, for an
    adversarial proposal (all mass on the second-likeliest token) and for
    q = p, under a seeded generator.  Candidates are drawn from q each
    trial (the theorem's premise), then accepted or replaced by the verify
    pass.  (Temperature is low so the target law is concentrated: the TV of
    600 samples of a near-flat 256-token law would be sampling noise.)"""
    m, params = _build("tinyllama-1.1b")
    V = m.cfg.vocab_size
    TEMP = 0.25
    eng = _engine(m, params, (m, params), max_seqs=2, block_size=4,
                  max_len=16, chunk_size=4, spec_k=3)
    eng.add_request([1, 2, 3, 4, 5], max_new_tokens=8, temperature=TEMP)
    eng.step()
    s = eng.scheduler.running[0]
    assert s.phase == "decode"

    B, K = 2, eng.cfg.spec_k
    base = np.zeros((B,), np.int32)
    base[s.slot] = s.next_token
    positions = np.zeros((B,), np.int32)
    positions[s.slot] = s.num_cached
    temps = np.full((B,), TEMP, np.float32)
    valid = np.zeros((B,), np.int32)
    valid[s.slot] = 1                 # focus on row 0: one candidate
    ncand = np.zeros((B,), np.int32)
    ncand[s.slot] = 1
    tables = np.where(np.arange(B)[:, None] == s.slot,
                      eng.cache_host.tables, 0)

    seq = torch.tensor([list(s.seq)], dtype=torch.int32)
    with torch.no_grad():
        logits = m.forward(params, {"tokens": seq})[0, s.num_cached]
    p_exact = torch.softmax(logits.float() / TEMP, -1).numpy()

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def empirical(q_row, n=600):
        q = np.zeros((B, K, V), np.float32)
        q[s.slot, 0] = q_row
        counts = np.zeros(V)
        rng = np.random.default_rng(11)
        eng._gen.manual_seed(7)
        for _ in range(n):
            cand = np.zeros((B, K), np.int32)
            cand[s.slot, 0] = rng.choice(V, p=q_row / q_row.sum())
            with torch.no_grad():
                out, _ = eng._verify_impl(
                    T(base), T(cand), T(q), T(positions),
                    torch.arange(B, dtype=torch.int32), T(tables),
                    T(valid), T(ncand), temps, T(temps))
            counts[int(out[s.slot, 0])] += 1
        return counts / n

    other = int(np.argsort(p_exact)[-2])
    q_adv = np.full((V,), 1e-9, np.float32)
    q_adv[other] = 1.0
    for q_row in (q_adv, p_exact.astype(np.float32)):
        emp = empirical(q_row)
        tv = 0.5 * np.abs(emp - p_exact).sum()
        assert tv < 0.12, tv


# ---------------------------------------------------------------------------
# 3. capability gate: recurrent families fall back to dense decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2-1.3b", "hymba-1.5b"])
def test_spec_gated_for_recurrent_families(name):
    """Rolling back rejected KV positions is a cursor move; recurrent
    SSM/conv state cannot be rewound that way.  The engine refuses to
    speculate for ssm / hybrid and still matches the oracle."""
    m, params = _build(name)
    d = _build(name, 0.5)
    P, GEN = 8, 5
    prompt = _prompts(m.cfg.vocab_size, 1, P, seed=53)[0]
    ref = _oracle(m, params, prompt[None], GEN)[0]
    eng = _engine(m, params, d, max_seqs=1, block_size=4, max_len=32,
                  chunk_size=4, spec_k=3)
    assert not eng.spec_active
    assert not hasattr(eng, "draft_cache")
    res, stats = _serve(eng, [prompt], GEN)
    assert stats["spec_cycles"] == 0
    assert res[0].tokens == list(ref[P:]), name


def test_draft_with_another_vocabulary_is_refused():
    m, params = _build("tinyllama-1.1b")
    other = build(reduced(get_config("tinyllama-1.1b")).replace(
        vocab_size=128))
    with pytest.raises(ValueError, match="vocabularies differ"):
        Engine(m, params, ServeConfig(spec_k=2), draft_model=other,
               draft_params=other.init(0, device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# 4. plumbing: verify-step logits and the one-fetch-per-step contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
def test_paged_verify_logits_match_prefill_rows(name):
    """The multi-token scoring step returns, at every position j, the logits
    the chunked-prefill path gives for the same chunk cut at j+1 valid
    tokens (MoE capacity couples tokens across the chunk, so the prefill
    machinery at the same chunk shape is the oracle); the dense case also
    against the teacher-forced ``forward``."""
    m, params = _build(name)
    V = m.cfg.vocab_size
    bs, NB, C, P = 4, 4, 3, 7
    toks = _prompts(V, 1, P + C, seed=59).astype(np.int32)
    T = torch.from_numpy
    with torch.no_grad():
        cache = m.init_paged_cache(num_blocks=NB * 2 + 1, block_size=bs,
                                   max_seqs=2, device="cpu")
        tables = np.zeros((2, NB), np.int32)
        tables[0] = np.arange(1, NB + 1)
        slots = torch.tensor([0, 1], dtype=torch.int32)
        pre = np.zeros((2, P), np.int32)
        pre[0] = toks[0, :P]
        pos = np.tile(np.arange(P, dtype=np.int32)[None], (2, 1))
        _, cache = m.paged_prefill_step(
            params, cache, T(pre), T(pos), slots, T(tables),
            torch.tensor([P, 0], dtype=torch.int32))
        ver = np.zeros((2, C), np.int32)
        ver[0] = toks[0, P:]
        vpos = P + np.tile(np.arange(C, dtype=np.int32)[None], (2, 1))
        logits, _ = m.paged_verify_step(
            params, cache, T(ver), T(vpos), slots, T(tables),
            torch.tensor([C, 0], dtype=torch.int32))
        for j in range(C):
            row_ref, _ = m.paged_prefill_step(
                params, cache, T(ver), T(vpos), slots, T(tables),
                torch.tensor([j + 1, 0], dtype=torch.int32))
            np.testing.assert_allclose(
                logits[0, j].numpy(), row_ref[0].numpy(), rtol=2e-4,
                atol=2e-4, err_msg=f"{name} row {j}")
        if name == "tinyllama-1.1b":  # dense: vs the teacher-forced forward
            full = m.forward(params, {"tokens": T(toks)}).numpy()
            np.testing.assert_allclose(logits[0].numpy(), full[0, P:P + C],
                                       rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("spec", [False, True], ids=["dense", "spec"])
def test_one_host_fetch_per_step(spec, monkeypatch):
    """Every engine step makes at most one device->host copy, counted by
    the engine and by intercepting ``Tensor.cpu`` itself: one for every
    step that samples and none besides, with the draft loop, the verify
    and the acceptance all on the device."""
    m, params = _build("tinyllama-1.1b")
    sc = dict(max_seqs=3, block_size=4, max_len=32, chunk_size=4)
    eng = _engine(m, params, (m, params) if spec else None,
                  spec_k=3 if spec else 0, **sc)
    sampling = count_sampling_steps(eng)
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: (calls.append(1),
                                               real(self, *a, **k))[1])
    prompts = [_prompts(m.cfg.vocab_size, 1, 9, seed=61 + b)[0]
               for b in range(3)]
    _, stats = _serve(eng, prompts, 6)
    assert stats["host_syncs"] == len(calls) == sampling[0]
    assert 0 < len(calls) <= stats["steps"]
    assert (stats["spec_cycles"] > 0) == spec


# ---------------------------------------------------------------------------
# 5. dynamic speculative K + draft-pool dtype narrowing
# ---------------------------------------------------------------------------

def test_dynamic_k_decays_under_bad_draft():
    """spec_ema > 0: a draft that keeps missing decays each slot's planned K
    to the floor of 1 (the EMA of its ~0 acceptance rate), while outputs
    stay byte-identical to the oracle."""
    m, params = _build("tinyllama-1.1b")
    dm, _ = _build("tinyllama-1.1b", 0.5)
    bad_dp = dm.init(99, device="cpu")           # a random draft
    prompts = [_prompts(m.cfg.vocab_size, 1, 7, seed=71 + b)[0]
               for b in range(3)]
    refs = [_oracle(m, params, p[None], 16)[0] for p in prompts]
    eng = _engine(m, params, (dm, bad_dp), max_seqs=3, block_size=4,
                  max_len=40, chunk_size=4, spec_k=4, spec_ema=0.5)
    res, stats = _serve(eng, prompts, 16)
    for r, p, ref in zip(res, prompts, refs):
        assert r.tokens == list(ref[len(p):])
    assert stats["spec_acceptance"] < 0.3
    finals = [s.spec_k_plan for s in eng.scheduler.finished]
    assert all(k == 1 for k in finals), finals
    assert all(s.spec_ema < 0.5 for s in eng.scheduler.finished)


def test_dynamic_k_stays_high_for_good_draft():
    """The target as its own draft (100 % acceptance): the EMA stays at 1
    and every cycle keeps the full K."""
    m, params = _build("tinyllama-1.1b")
    prompts = [_prompts(m.cfg.vocab_size, 1, 7, seed=81 + b)[0]
               for b in range(2)]
    eng = _engine(m, params, (m, params), max_seqs=2, block_size=4,
                  max_len=40, chunk_size=4, spec_k=4, spec_ema=0.5)
    _, stats = _serve(eng, prompts, 16)
    assert stats["spec_acceptance"] == 1.0
    assert all(s.spec_k_plan == 4 for s in eng.scheduler.finished)
    assert all(s.spec_ema == 1.0 for s in eng.scheduler.finished)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_draft_cache_dtype_narrowing_is_lossless(dtype):
    """A bfloat16 or int8 draft pool may change which drafts are proposed,
    but greedy verify keeps the emitted tokens byte-identical to the oracle
    (rejections cost speed, never correctness); the target pool keeps its
    dtype and an int8 draft pool carries its scale pools."""
    m, params = _build("tinyllama-1.1b")
    d = _build("tinyllama-1.1b", 0.5)
    B, P, GEN = 3, 11, 10
    prompt = _prompts(m.cfg.vocab_size, B, P, seed=91)
    ref = _oracle(m, params, prompt, GEN)
    eng = _engine(m, params, d, max_seqs=3, block_size=4, max_len=32,
                  chunk_size=4, spec_k=3, draft_cache_dtype=dtype)
    want = {"bfloat16": torch.bfloat16, "int8": torch.int8}[dtype]
    assert eng.draft_cache["k"].dtype == want
    assert eng.draft_cache["v"].dtype == want
    assert ("k_scale" in eng.draft_cache) == (dtype == "int8")
    assert eng.cache["k"].dtype == torch.float32  # target pool untouched
    assert "k_scale" not in eng.cache
    res, stats = _serve(eng, prompt, GEN)
    assert stats["spec_cycles"] > 0
    for b, r in enumerate(res):
        assert r.tokens == list(ref[b, P:]), b
    with pytest.raises(ValueError, match="draft_cache_dtype"):
        _engine(m, params, d, spec_k=3, draft_cache_dtype="int4")
