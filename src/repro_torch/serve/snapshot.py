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
    scale pools round-trip bit for bit (numpy has no bf16 or fp8).

NOT captured: ``on_token`` callbacks (arbitrary closures are not
serializable; a restored engine streams nothing for pre-crash requests).

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
    pools = _pool_bytes(engine.cache)
    draft_pools = _pool_bytes(engine.draft_cache) \
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
    _check_pools(engine.cache, snap["pools"], "target")
    if engine.spec_active:
        _check_pools(engine.draft_cache, snap["draft_pools"], "draft")

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
    engine._gen.set_state(torch.from_numpy(host["generator"]))
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

    _load_pools(engine.cache, snap["pools"])
    if engine.spec_active:
        _load_pools(engine.draft_cache, snap["draft_pools"])
    cache.check()                       # restored state must audit clean


def restore_engine(snap: dict, model, params, draft_model=None,
                   draft_params=None, telemetry=None, device=None):
    """Build a fresh Engine from the snapshot's own ServeConfig and restore
    into it (the launch CLI's ``--restore`` path)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = ServeConfig(**snap["header"]["serve_config"])
    eng = Engine(model, params, cfg, draft_model=draft_model,
                 draft_params=draft_params, telemetry=telemetry,
                 device=device)
    restore_into(eng, snap)
    return eng
