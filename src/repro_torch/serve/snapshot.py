"""Engine snapshot/restore: crash recovery for the port's serving engine.

A snapshot captures everything a fresh, config-identical :class:`Engine`
needs to resume *byte-identically*:

  - the scheduler queues (waiting / running / finished ``RequestState``
    objects, the free-slot stack, queued COW copies);
  - the allocator (free-list ORDER, refcounts, cached-LRU order, held set,
    stats) and the paged-cache bookkeeping (per-slot ownership, block
    tables, the full prefix index + per-slot commit chains) — order matters:
    the free list is a LIFO stack and the cached dict is the LRU eviction
    order, so restoring sets, not sequences, would change which physical
    blocks future allocations pick;
  - the engine's per-rid bookkeeping (wall clocks, admit/finish steps,
    deadlines) and its ``torch.Generator`` state (``get_state`` /
    ``set_state``, where the reference keeps a JAX key) — with it restored,
    even temperature > 0 serving resumes identically, because everything
    else about scheduling is deterministic host state;
  - the device pools — the target's and, in spec mode, the draft's — as raw
    bytes with their dtype and shape, so bf16, int8 and fp8 pools and their
    scale pools round-trip bit for bit (numpy has no bf16 or fp8).  On a
    serving mesh the pools are a list, one entry per shard in mesh order
    (a dp replica holds its own slots' blocks only, so every replica is
    kept), and every data shard's generator state is kept beside the first.

NOT captured: ``on_token`` callbacks (arbitrary closures are not
serializable; a restored engine streams nothing for pre-crash requests).

``capture_requests`` / ``adopt_requests`` move single requests instead of a
whole engine (failover hand-off): each request's state, clocks and — for a
running request of an attention family — its hash chain and the bytes of
its KV(+scale) blocks, copied to the host in the pool format above, under a
header with the exporter's ``handoff_key``.

File format, the reference's: an 8-byte magic, a little-endian u32 header
length, a JSON header (version, the full ServeConfig, model identity) for
cheap validation without unpickling, then one pickle with the host state and
the pool bytes.  The header is versioned so a future layout bump fails
loudly instead of deserializing garbage.  The pickle names the port's
classes (``repro_torch.serve.scheduler.RequestState``) and its pools are
torch bytes, so a port snapshot does not load into the JAX package's engine,
nor a JAX snapshot into the port, though both share magic, version and
header.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import pickle
import struct
from collections import OrderedDict, deque

import numpy as np
import torch

MAGIC = b"RSRVSNAP"
VERSION = 1

# engine per-rid bookkeeping dicts captured verbatim (mirrors reset())
_RID_DICTS = ("_admit_step", "_finish_step", "_submit_wall",
              "_first_tok_wall", "_last_tok_wall", "_queue_wait",
              "_preempt_wall", "_preempt_stall", "_deadline")


def _pool_bytes(pools: dict) -> dict:
    """Each pool tensor as (dtype name, shape, uint8 bytes), copied to the
    host (a copy on the CPU too: the pools are written in place)."""
    return {name: (str(t.dtype).removeprefix("torch."), tuple(t.shape),
                   t.detach().contiguous().view(torch.uint8).reshape(-1)
                   .to("cpu", copy=True).numpy())
            for name, t in pools.items()}


def _shard_pools(engine, draft: bool = False) -> list[dict]:
    """The engine's pool tensors, one dict per shard (one without a mesh)."""
    return engine._pool_shards(engine.draft_cache if draft else engine.cache)


def _capture_pools(engine, draft: bool = False):
    """A dict of pool bytes without a mesh; a list of them, one per shard,
    on one."""
    shards = [_pool_bytes(p) for p in _shard_pools(engine, draft)]
    return shards if engine.mesh is not None else shards[0]


def _check_shards(engine, saved, what: str, draft: bool = False) -> None:
    """Refuse saved pools whose layout (one dict, or one per shard) or
    contents differ from the engine's."""
    mine = _shard_pools(engine, draft)
    if isinstance(saved, dict) != (engine.mesh is None) or \
            (engine.mesh is not None and len(saved) != len(mine)):
        raise ValueError(f"{what} pools were saved for another mesh")
    for pools, got in zip(mine, [saved] if isinstance(saved, dict)
                          else saved):
        _check_pools(pools, got, what)


def _load_shards(engine, saved, draft: bool = False) -> None:
    for pools, got in zip(_shard_pools(engine, draft),
                          [saved] if isinstance(saved, dict) else saved):
        _load_pools(pools, got)


def _check_pools(engine_pools: dict, saved: dict, what: str) -> None:
    """Refuse pools whose names, dtypes or shapes differ from the engine's
    (before anything is written)."""
    if set(saved) != set(engine_pools):
        raise ValueError(f"{what} pools {sorted(saved)} != the engine's "
                         f"{sorted(engine_pools)}")
    for name, (dtype, shape, raw) in saved.items():
        t = engine_pools[name]
        want = (str(t.dtype).removeprefix("torch."), tuple(t.shape))
        if (dtype, tuple(shape)) != want or \
                raw.size != t.numel() * t.element_size():
            raise ValueError(f"{what} pool {name}: snapshot holds "
                             f"{dtype} {tuple(shape)}, the engine {want}")


def _load_pools(engine_pools: dict, saved: dict) -> None:
    """Copy the saved bytes into the engine's pool tensors in place."""
    for name, (dtype, shape, raw) in saved.items():
        t = engine_pools[name]
        if t.numel() == 0:
            continue
        src = torch.from_numpy(np.ascontiguousarray(raw)).view(
            getattr(torch, dtype)).reshape(shape)
        t.copy_(src)


def capture(engine) -> dict:
    """Snapshot a quiescent engine (no pending async step — use
    ``Engine.snapshot()``, which reconciles first)."""
    assert engine._pending is None, "snapshot with a step in flight"
    cache, a = engine.cache_host, engine.cache_host.allocator
    sched = engine.scheduler
    header = {
        "format": "repro-serve-snapshot",
        "version": VERSION,
        "model": engine.model.cfg.name,
        "vocab_size": engine.model.cfg.vocab_size,
        "spec_active": bool(engine.spec_active),
        "serve_config": dataclasses.asdict(engine.cfg),
    }
    host = {
        "rid": engine._rid,
        "generator": engine._gen.get_state().numpy().copy(),
        "generators": [p.gen.get_state().numpy().copy()
                       for p in engine._progs],
        "counters": {k: c.value for k, c in engine._c.items()},
        "tick": engine._tick,
        "drained": engine._drained,
        "degraded": (engine._degraded, engine._pressure_run,
                     engine._calm_run),
        "chunked": sorted(engine._chunked),
        "rid_dicts": {name: dict(getattr(engine, name))
                      for name in _RID_DICTS},
        "scheduler": {
            "waiting": list(sched.waiting),
            "running": list(sched.running),
            "finished": list(sched.finished),
            "free_slots": list(sched._free_slots),
            "copies": list(sched._copies),
        },
        "allocator": {
            "free": list(a._free),
            "ref": dict(a._ref),
            "cached": list(a._cached),
            "held": sorted(a._held),
            "stats": (a.total_allocated, a.total_evictions, a.peak_live),
        },
        "cache": {
            "owned": [list(lst) for lst in cache._owned],
            "tables": np.array(cache.tables),
            "block_of": dict(cache._block_of),
            "hash_of": dict(cache._hash_of),
            "home_of": dict(cache._home_of),
            "chain": [list(c) for c in cache._chain],
            "prefix_lookups": cache.prefix_lookups,
            "prefix_hits": cache.prefix_hits,
            "alias_refusals": cache.alias_refusals,
            "pending_moves": list(cache._pending_moves),
            "admission_paused": cache.admission_paused,
        },
    }
    pools = _capture_pools(engine)
    draft_pools = _capture_pools(engine, draft=True) \
        if engine.spec_active else None
    # deep-copy the host tree: an in-memory snapshot must stay frozen while
    # the source engine keeps mutating its RequestStates (the pool bytes
    # are already fresh host copies)
    return {"header": header, "host": copy.deepcopy(host),
            "pools": pools, "draft_pools": draft_pools}


def save(path: str, snap: dict) -> None:
    header = json.dumps(snap["header"], sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        pickle.dump({k: snap[k] for k in ("host", "pools", "draft_pools")},
                    f, protocol=4)


def load(path: str) -> dict:
    """Read + validate a snapshot file.  Every malformed-file mode — wrong
    magic, truncated length/header/body, corrupt JSON, version skew — raises
    ValueError *before* any engine state is touched, so a failed restore
    leaves the target engine exactly as it was.  The body is a pickle: load
    only snapshots this program wrote."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a serve snapshot "
                             f"(magic {magic!r})")
        raw = f.read(4)
        if len(raw) != 4:
            raise ValueError(f"{path}: truncated snapshot (no header "
                             f"length)")
        (hlen,) = struct.unpack("<I", raw)
        hraw = f.read(hlen)
        if len(hraw) != hlen:
            raise ValueError(f"{path}: truncated snapshot header "
                             f"({len(hraw)}/{hlen} bytes)")
        try:
            header = json.loads(hraw)
        except ValueError as e:
            raise ValueError(f"{path}: corrupt snapshot header: {e}") \
                from e
        if not isinstance(header, dict):
            raise ValueError(f"{path}: corrupt snapshot header "
                             f"(not an object)")
        if header.get("version") != VERSION:
            raise ValueError(f"{path}: snapshot version "
                             f"{header.get('version')} != {VERSION}")
        try:
            body = pickle.load(f)
        except (pickle.UnpicklingError, EOFError, AttributeError,
                MemoryError) as e:
            raise ValueError(f"{path}: truncated/corrupt snapshot body: "
                             f"{e}") from e
    return {"header": header, **body}


def save_snapshot(engine, path: str) -> dict:
    """``Engine.snapshot()`` + ``save``; returns the header."""
    snap = engine.snapshot()
    save(path, snap)
    return snap["header"]


def restore_into(engine, snap: dict) -> None:
    """Overwrite a fresh (or reset) engine's state from a snapshot.

    The engine must be built with the identical ServeConfig and model —
    validated against the header (and the pools against the engine's)
    before anything is touched, because byte-identical resumption depends
    on every scheduling knob matching.  The pool bytes are copied into the
    engine's pool tensors in place."""
    h = snap["header"]
    if h.get("format") != "repro-serve-snapshot":
        raise ValueError("not a serve snapshot")
    if h["model"] != engine.model.cfg.name or \
            h["vocab_size"] != engine.model.cfg.vocab_size:
        raise ValueError(
            f"snapshot is for model {h['model']} (vocab "
            f"{h['vocab_size']}), engine runs {engine.model.cfg.name}")
    if bool(h["spec_active"]) != bool(engine.spec_active):
        raise ValueError("snapshot/engine disagree on speculative decode")
    mine = dataclasses.asdict(engine.cfg)
    diffs = {k: (v, mine.get(k)) for k, v in h["serve_config"].items()
             if mine.get(k) != v}
    if diffs:
        raise ValueError(f"ServeConfig mismatch (snapshot, engine): "
                         f"{diffs}")
    _check_shards(engine, snap["pools"], "target")
    if engine.spec_active:
        _check_shards(engine, snap["draft_pools"], "draft", draft=True)

    engine.reset()
    # copy on the way in as well: the same snapshot object can restore
    # several engines without them sharing mutable RequestStates
    host = copy.deepcopy(snap["host"])
    cache, a = engine.cache_host, engine.cache_host.allocator
    sched = engine.scheduler

    sc = host["scheduler"]
    sched.waiting = deque(sc["waiting"])
    sched.running = list(sc["running"])
    sched.finished = list(sc["finished"])
    sched._free_slots = list(sc["free_slots"])
    sched._copies = list(sc["copies"])

    al = host["allocator"]
    a._free = list(al["free"])
    a._ref = dict(al["ref"])
    a._cached = OrderedDict((b, None) for b in al["cached"])
    a._held = set(al["held"])
    a.total_allocated, a.total_evictions, a.peak_live = al["stats"]

    ca = host["cache"]
    cache._owned = [list(lst) for lst in ca["owned"]]
    cache.tables[:] = ca["tables"]
    cache._block_of = dict(ca["block_of"])
    cache._hash_of = dict(ca["hash_of"])
    cache._home_of = dict(ca["home_of"])
    cache._chain = [list(c) for c in ca["chain"]]
    cache.prefix_lookups = ca["prefix_lookups"]
    cache.prefix_hits = ca["prefix_hits"]
    cache.alias_refusals = ca.get("alias_refusals", 0)
    cache._pending_moves = [tuple(m) for m in ca.get("pending_moves", [])]
    cache.admission_paused = ca["admission_paused"]

    engine._rid = host["rid"]
    for prog, state in zip(engine._progs, host.get(
            "generators", [host["generator"]])):
        prog.gen.set_state(torch.from_numpy(state))
    for k, v in host["counters"].items():
        if k in engine._c:
            engine._c[k].value = v
    engine._tick = host["tick"]
    engine._drained = host["drained"]
    engine._degraded, engine._pressure_run, engine._calm_run = \
        host["degraded"]
    engine._chunked = set(host["chunked"])
    for name in _RID_DICTS:
        getattr(engine, name).update(host["rid_dicts"][name])

    _load_shards(engine, snap["pools"])
    if engine.spec_active:
        _load_shards(engine, snap["draft_pools"], draft=True)
    cache.check()                       # restored state must audit clean


# ----- partial (per-request) capture: failover hand-off -----

HANDOFF_FORMAT = "repro-serve-handoff"


def _tensors(saved: dict | None) -> dict | None:
    """Host tensors from ``_pool_bytes`` entries (a hand-off's blocks)."""
    if saved is None:
        return None
    return {name: torch.from_numpy(np.ascontiguousarray(raw)).view(
        getattr(torch, dtype)).reshape(shape)
        for name, (dtype, shape, raw) in saved.items()}


def _check_blocks(engine_pools: dict, saved: dict, what: str) -> None:
    """Refuse block bytes whose names, dtypes or per-block shapes differ
    from the engine's pools (the block count is the hand-off's own)."""
    for name, (dtype, shape, raw) in saved.items():
        t = engine_pools.get(name)
        if t is None:
            raise ValueError(f"{what} block bytes for pool {name}, which "
                             f"the engine does not have")
        want = str(t.dtype).removeprefix("torch.")
        shape = tuple(shape)
        if dtype != want or len(shape) != t.dim() or \
                shape[:1] + shape[2:] != t.shape[:1] + t.shape[2:] or \
                raw.size != int(np.prod(shape)) * t.element_size():
            raise ValueError(f"{what} block bytes {name}: {dtype} {shape}, "
                             f"the engine's pool {want} "
                             f"{tuple(t.shape)}")


def capture_requests(engine, rids=None) -> dict:
    """Capture a serializable hand-off bundle for a subset of requests.

    Unlike :func:`capture` this does not freeze the whole engine — it
    exports individual unfinished requests (running ones with their block
    bytes when the engine supports block hand-off, copied to the host) so
    a cluster, or a cold process, can re-home exactly those sequences onto
    another engine via :func:`adopt_requests`.  ``rids=None`` means every
    unfinished request.  The source engine is left untouched (pass the
    rids through ``Engine.export_request(remove=True)`` yourself when you
    want them gone).  ``on_token`` callbacks are not serializable and are
    dropped."""
    sched = engine.scheduler
    if rids is None:
        rids = [s.req.rid for s in list(sched.running) +
                list(sched.waiting) if not s.done]
    reqs = []
    for rid in rids:
        h = engine.export_request(rid)
        reqs.append({
            "state": h.state,
            "clocks": dict(h.clocks),
            "deadline": h.deadline,
            "num_cached": h.num_cached,
            "draft_cached": h.draft_cached,
            "chain": list(h.chain),
            "pools": None if h.pools is None else _pool_bytes(h.pools),
            "draft_pools": None if h.draft_pools is None
            else _pool_bytes(h.draft_pools),
        })
    header = {
        "format": HANDOFF_FORMAT,
        "version": VERSION,
        "model": engine.model.cfg.name,
        "vocab_size": engine.model.cfg.vocab_size,
        "handoff_key": list(engine.handoff_key()),
    }
    # the host tree is deep-copied (the exported states are already
    # copies, the block bytes fresh host arrays)
    return {"header": header, "requests": copy.deepcopy(reqs)}


def adopt_requests(engine, snap: dict) -> list[int]:
    """Adopt every request of a :func:`capture_requests` bundle; returns the
    new rids in bundle order.

    The bundle is validated before anything is adopted: format and version,
    and — when its ``handoff_key`` matches the engine's, so the bytes would
    be scattered — each request's block bytes against the engine's pools
    (ValueError).  With another key each request falls back to
    waiting-with-recompute (still byte-identical at temperature 0)."""
    from repro_torch.serve.engine import SequenceHandoff
    h = snap["header"]
    if h.get("format") != HANDOFF_FORMAT:
        raise ValueError("not a serve handoff bundle")
    if h.get("version") != VERSION:
        raise ValueError(f"handoff version {h.get('version')} != "
                         f"{VERSION}")
    key = tuple(h["handoff_key"])
    if key == engine.handoff_key() and engine.can_handoff_blocks:
        for r in snap["requests"]:
            if r["pools"] is not None:
                _check_blocks(engine.cache, r["pools"], "target")
            if r["draft_pools"] is not None and engine.spec_active:
                _check_blocks(engine.draft_cache, r["draft_pools"],
                              "draft")
    out = []
    # deep-copy so the bundle stays reusable after the engine starts
    # mutating the adopted RequestStates
    for r in snap["requests"]:
        out.append(engine.adopt(SequenceHandoff(
            state=copy.deepcopy(r["state"]), clocks=dict(r["clocks"]),
            key=key, num_cached=r["num_cached"],
            draft_cached=r["draft_cached"], chain=list(r["chain"]),
            pools=_tensors(r["pools"]),
            draft_pools=_tensors(r["draft_pools"]),
            deadline=r["deadline"])))
    return out


def restore_engine(snap: dict, model, params, draft_model=None,
                   draft_params=None, telemetry=None, device=None,
                   mesh=None):
    """Build a fresh Engine from the snapshot's own ServeConfig (on
    ``mesh`` when given) and restore into it (the launch CLI's
    ``--restore`` path)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = ServeConfig(**snap["header"]["serve_config"])
    eng = Engine(model, params, cfg, draft_model=draft_model,
                 draft_params=draft_params, telemetry=telemetry,
                 device=device, mesh=mesh)
    restore_into(eng, snap)
    return eng
