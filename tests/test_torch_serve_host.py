"""The port's copies of the host-side serving core (``kv_cache.py``,
``scheduler.py``, ``faults.py``) against the originals: the first two are
driven by one seeded sequence of operations and must agree **exactly** —
allocator state, block tables, prefix index, raised errors and
``StepPlan``s.
"""
import inspect

import numpy as np
import pytest

from repro.serve import (faults as j_faults, kv_cache as j_kv,
                         scheduler as j_sched)
from repro_torch.serve import (faults as t_faults, kv_cache as t_kv,
                               scheduler as t_sched)

_COPIES = {"kv_cache": (t_kv, j_kv), "scheduler": (t_sched, j_sched),
           "faults": (t_faults, j_faults)}


@pytest.mark.parametrize("name", sorted(_COPIES))
def test_copies_are_verbatim(name):
    """kv_cache and faults: whole file; scheduler: everything but its one
    import."""
    port, ref = _COPIES[name]
    want = inspect.getsource(ref).replace("from repro.serve.kv_cache",
                                          "from repro_torch.serve.kv_cache")
    assert inspect.getsource(port) == want


def cache_state(c):
    a = c.allocator
    return {
        "tables": c.tables.copy().tolist(),
        "owned": [c.owned(s) for s in range(c.max_seqs)],
        "free": list(a._free), "ref": dict(a._ref),
        "cached": list(a._cached), "held": sorted(a._held),
        "counts": (a.num_free, a.num_live, a.num_cached, a.num_available,
                   a.total_allocated, a.total_evictions, a.peak_live),
        "block_of": dict(c._block_of), "hash_of": dict(c._hash_of),
        "chain": [list(x) for x in c._chain],
        "prefix": (c.prefix_lookups, c.prefix_hits),
    }


def drive_cache(mod, seed, prefix_caching, n_ops=400):
    """Random admit / grow / commit / COW / truncate / release ops on a
    small pool; returns the trace of (op, result-or-error, state)."""
    rng = np.random.default_rng(seed)
    bs, S = 4, 4
    c = mod.PagedCache(max_seqs=S, num_blocks=14, block_size=bs,
                       max_blocks_per_seq=6, prefix_caching=prefix_caching)
    seqs: list = [None] * S                 # tokens written per slot
    prompts = [tuple(int(t) for t in rng.integers(0, 5, size=24))
               for _ in range(3)]
    trace = []
    for _ in range(n_ops):
        slot = int(rng.integers(0, S))
        op = rng.choice(["admit", "grow", "commit", "cow", "truncate",
                         "release", "hold"])
        res = None
        try:
            if op == "admit" and seqs[slot] is None:
                p = prompts[int(rng.integers(0, 3))]
                toks = p[:int(rng.integers(1, 20))]
                matched = c.assign_prefix(slot, toks)
                try:
                    c.ensure(slot, len(toks) + 1)
                except mod.OutOfBlocks:
                    c.release(slot)
                    raise
                seqs[slot] = toks
                res = matched
            elif op == "grow" and seqs[slot] is not None:
                n = len(seqs[slot]) + int(rng.integers(1, 4))
                c.ensure(slot, n)
                extra = tuple(int(t) for t in rng.integers(
                    0, 5, size=n - len(seqs[slot])))
                seqs[slot] = seqs[slot] + extra
            elif op == "commit" and seqs[slot] is not None:
                c.commit(slot, seqs[slot])
            elif op == "cow" and seqs[slot] is not None:
                n = len(seqs[slot])
                res = c.prepare_write(slot, max(n - 2, 0), n)
            elif op == "truncate" and seqs[slot] is not None:
                n = int(rng.integers(1, len(seqs[slot]) + 1))
                c.truncate(slot, n)
                seqs[slot] = seqs[slot][:n]
            elif op == "release" and seqs[slot] is not None:
                c.release(slot)
                seqs[slot] = None
            elif op == "hold":
                held = c.allocator.hold(int(rng.integers(0, 3)))
                c.allocator.unhold(held)
                res = held
            c.check()
        except (mod.OutOfBlocks, ValueError) as e:
            res = type(e).__name__
        trace.append((str(op), slot, res, cache_state(c)))
    return trace


@pytest.mark.parametrize("prefix_caching", [False, True],
                         ids=["no-prefix", "prefix"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_cache_traces_equal(seed, prefix_caching):
    a = drive_cache(j_kv, seed, prefix_caching)
    b = drive_cache(t_kv, seed, prefix_caching)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"op {i}: {x[:3]} vs {y[:3]}"
    assert any(s[3]["counts"][5] > 0 for s in a) or not prefix_caching


def plan_view(plan):
    return {
        "decode": [s.req.rid for s in plan.decode],
        "prefill": [(s.req.rid, n) for s, n in plan.prefill],
        "copies": [tuple(int(x) for x in c) for c in plan.copies],
        "spec": [s.req.rid for s in plan.spec],
        "admitted": [s.req.rid for s in plan.admitted],
        "preempted": [s.req.rid for s in plan.preempted],
    }


def drive_scheduler(kv, sched, seed, *, chunk_size, prefill_budget,
                    num_blocks, spec_k=0, prefill_only=False, max_steps=400):
    """A stand-in engine: fold each plan as the engine would, with the
    'sampled' token a pure function of (rid, position)."""
    rng = np.random.default_rng(seed)
    cache = kv.PagedCache(max_seqs=3, num_blocks=num_blocks, block_size=4,
                          max_blocks_per_seq=8, prefix_caching=True)
    sc = sched.FCFSScheduler(cache)
    shared = tuple(int(t) for t in rng.integers(0, 50, size=12))
    trace = []
    for rid in range(9):
        tail = tuple(int(t) for t in rng.integers(
            0, 50, size=int(rng.integers(0, 8))))
        prompt = (shared + tail) if rid % 2 == 0 else \
            tuple(int(t) for t in rng.integers(0, 50, size=int(
                rng.integers(3, 18))))
        sc.add(sched.Request(rid=rid, prompt=prompt,
                             max_new_tokens=int(rng.integers(1, 13)),
                             stop_tokens=(7,)))
    for bad in (dict(prompt=(), max_new_tokens=3),
                dict(prompt=(1,), max_new_tokens=0),
                dict(prompt=(1,) * 30, max_new_tokens=8)):
        with pytest.raises(ValueError):
            sc.add(sched.Request(rid=99, **bad))
    for _ in range(max_steps):
        if not sc.has_work:
            break
        plan = sc.plan_step(chunk_size, prefill_budget, spec_k,
                            prefill_only=prefill_only)
        trace.append((plan_view(plan), cache_state(cache),
                      [(s.req.rid, s.slot, s.num_cached) for s in sc.running],
                      [s.req.rid for s in sc.waiting]))
        if prefill_only and not plan.prefill and not plan.decode:
            break                      # decode-phase slots stay parked

        def sample(s):
            tok = (s.req.rid * 31 + s.seq_len * 7) % 50 + 8 * (s.seq_len % 3)
            s.generated.append(tok)
            if tok in s.req.stop_tokens:
                s.stopped = True
        for s, n in plan.prefill:
            covered = s.num_cached + n == s.seq_len
            s.num_cached += n
            if covered:
                sample(s)
        for s in plan.decode:
            emit = s.num_cached == s.seq_len - 1
            s.num_cached += 1
            if emit:
                sample(s)
            if s in plan.spec:         # nothing accepted: roll back
                cache.truncate(s.slot, s.num_cached)
        sc.commit_progress()
        cache.check()
    trace.append(sorted((s.req.rid, tuple(s.generated), s.preemptions)
                        for s in sc.finished))
    return trace


SCHED_CASES = {
    "chunked": dict(chunk_size=4, prefill_budget=0, num_blocks=25),
    "budget": dict(chunk_size=4, prefill_budget=5, num_blocks=25),
    "token-by-token": dict(chunk_size=0, prefill_budget=0, num_blocks=25),
    "preemption": dict(chunk_size=4, prefill_budget=0, num_blocks=10),
    "spec-k": dict(chunk_size=4, prefill_budget=0, num_blocks=25, spec_k=2),
    "prefill-only": dict(chunk_size=4, prefill_budget=0, num_blocks=25,
                         prefill_only=True),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_scheduler_plans_equal(case, seed):
    a = drive_scheduler(j_kv, j_sched, seed, **SCHED_CASES[case])
    b = drive_scheduler(t_kv, t_sched, seed, **SCHED_CASES[case])
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"step {i}"
    if case == "preemption":
        assert any(step[0]["preempted"] for step in a[:-1])
    if case in ("chunked", "budget"):
        assert any(step[0]["prefill"] for step in a[:-1])
        assert any(step[1]["prefix"][1] > 0 for step in a[:-1])
    if case == "spec-k":
        assert any(step[0]["spec"] for step in a[:-1])
