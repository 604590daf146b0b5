"""Block-pool KV/SSM cache management for continuous batching.

The device side (the pools themselves) is built by
``Model.init_paged_cache``; this module owns the *host* side: a refcounted
free-list allocator over pool blocks, the per-slot block tables the engine
feeds to each jitted step, and a hash-keyed prefix index that lets requests
sharing a prompt prefix alias *full* blocks instead of re-filling them.

Block lifecycle (enforced by ``check()``; tested in
tests/test_serve_properties.py):

  free ──alloc──▶ live (ref >= 1) ──release/decref──▶ free
                    │  ▲                        │
               incref│  │incref (prefix hit)    │ registered in the prefix
                    ▼  │                        ▼ index at release time
                  live (ref > 1, shared)      cached (ref == 0, evictable)

Invariants:
  - block 0 is the reserved null block (idle slots write there) and is
    never allocated;
  - ``free + live + cached + held`` partitions blocks ``1..N-1`` (pool
    conservation — nothing leaks, nothing is double-owned; *held* is
    the fault-injection/reservation state, see ``hold``);
  - a live block's refcount equals the number of slot block tables that
    reference it (shared blocks come only from prefix hits);
  - cached blocks are exactly the ref==0 blocks still in the prefix
    index; ``alloc`` evicts them LRU-first when the free list runs dry;
  - freeing/decrefing a block a slot does not hold raises (double free).

Copy-on-write: full blocks are immutable while shared.  The only write
into a matched block is the re-fed last known token when a prefix hit
covers the entire sequence (the model must still *see* that token to
produce logits); ``prepare_write`` detects ref>1 blocks in the write
range and hands the engine (src, dst) pool copies to run on device.

Quantized pools (DESIGN.md §11): the host tracks *blocks*, never scale
values — the per-(token, kv-head) scale pools share the KV pools' block
addressing, so every transition this module performs (alias/incref on a
prefix hit, the COW (src, dst) pairs ``prepare_write`` hands the engine,
``truncate`` rollback, release, eviction) moves a block's scales in
lockstep with its bytes by construction.  The one device-side obligation
is the engine's: its COW copy must cover the scale pools alongside k/v
(``Engine._cow_impl``; shadow-asserted in test_serve_properties.py).

Speculative append/rollback (DESIGN.md §9): a speculative decode cycle
grows a slot by K+1 tokens up front (``ensure``), writes drafted K/V into
the reserved range, and after verification rolls the rejected suffix back
with ``truncate`` — surplus blocks return through the same
decref/retain path as ``release``, and a prefix-index entry whose block
is about to be partially rewritten (ref == 1, content now past the new
length) is dropped so the index never describes overwritten KV.  A
*shared* boundary block keeps its entry: the donors still hold that
content, and the slot's next write COWs via ``prepare_write``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, OrderedDict

import numpy as np


class OutOfBlocks(Exception):
    """Raised when the pool cannot satisfy an allocation (caller preempts)."""


class BlockAllocator:
    """Refcounted LIFO free-list over ``num_blocks`` blocks; block 0 reserved.

    Three disjoint states: ``_free`` (stack), ``_ref`` (live, refcount >= 1)
    and ``_cached`` (refcount 0 but retained for prefix reuse; LRU-evicted
    by ``alloc`` when the free list is short).  ``on_evict(block)`` is
    called when a cached block is reclaimed so the owner can drop its
    prefix-index entry.
    """

    def __init__(self, num_blocks: int, on_evict=None):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the null block)")
        self.num_blocks = num_blocks
        self.on_evict = on_evict
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        # fourth disjoint state: blocks sequestered by fault injection /
        # capacity reservations — unavailable to alloc() but still
        # accounted for, so the conservation oracle stays meaningful
        # while the pool is under simulated pressure (DESIGN.md §14)
        self._held: set[int] = set()
        # stats (benchmarks/serving.py, repro.obs pool gauges): fresh
        # allocations vs prefix reuse, and LRU evictions of cached blocks
        self.total_allocated = 0
        self.total_evictions = 0
        self.peak_live = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._ref)

    # old name, kept for callers that predate the cached state
    num_used = num_live

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def num_available(self) -> int:
        """Blocks an alloc() can obtain: free plus evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def num_held(self) -> int:
        return len(self._held)

    def ref(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int = 1) -> list[int]:
        if n > self.num_available:
            raise OutOfBlocks(f"need {n} blocks, have {self.num_available}")
        while len(self._free) < n:            # reclaim cached, LRU first
            b, _ = self._cached.popitem(last=False)
            if self.on_evict is not None:
                self.on_evict(b)
            self._free.append(b)
            self.total_evictions += 1
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.total_allocated += n
        self.peak_live = max(self.peak_live, len(self._ref))
        return out

    def incref(self, block: int) -> None:
        """Share a live block, or revive a cached one (prefix hit)."""
        if block in self._ref:
            self._ref[block] += 1
        elif block in self._cached:
            del self._cached[block]
            self._ref[block] = 1
            self.peak_live = max(self.peak_live, len(self._ref))
        else:
            raise ValueError(f"incref of free/foreign block {block}")

    def decref(self, block: int, retain: bool = False) -> bool:
        """Drop one reference; on 0 the block is cached (``retain``) or
        freed.  Returns True when the last reference was dropped."""
        if block not in self._ref:
            raise ValueError(f"double free / foreign block {block}")
        self._ref[block] -= 1
        if self._ref[block]:
            return False
        del self._ref[block]
        if retain:
            self._cached[block] = None        # newest at the LRU tail
        else:
            self._free.append(block)
        return True

    def free(self, blocks: list[int]) -> None:
        """Hard-free unshared blocks (legacy API; shared blocks raise)."""
        for b in blocks:
            if self._ref.get(b, 0) > 1:
                raise ValueError(f"freeing shared block {b} (ref>1)")
            self.decref(b)

    def hold(self, n: int) -> list[int]:
        """Sequester up to ``n`` available blocks (evicting cached ones
        LRU-first like ``alloc``) into the held state: invisible to
        ``alloc`` but still conserved.  The fault injector uses this to
        simulate pool exhaustion without faking allocator state; returns
        the blocks actually taken (pass them back to ``unhold``)."""
        n = min(n, self.num_available)
        while len(self._free) < n:            # reclaim cached, LRU first
            b, _ = self._cached.popitem(last=False)
            if self.on_evict is not None:
                self.on_evict(b)
            self._free.append(b)
            self.total_evictions += 1
        out = [self._free.pop() for _ in range(n)]
        self._held.update(out)
        return out

    def unhold(self, blocks: list[int]) -> None:
        """Return held blocks to the free list."""
        for b in blocks:
            if b not in self._held:
                raise ValueError(f"unhold of non-held block {b}")
            self._held.discard(b)
            self._free.append(b)

    def check(self) -> None:
        """Invariant: free + live + cached + held partition 1..N-1,
        block 0 untouched."""
        free, live, cached = set(self._free), set(self._ref), set(self._cached)
        held = self._held
        assert 0 not in free and 0 not in live and 0 not in cached \
            and 0 not in held
        assert len(free) == len(self._free)               # no dup in stack
        assert not (free & live) and not (free & cached) and not (live & cached)
        assert not held & (free | live | cached)
        assert len(free) + len(live) + len(cached) + len(held) \
            == self.num_blocks - 1
        assert all(r >= 1 for r in self._ref.values())


def _chain_hash(parent: int, tokens: tuple[int, ...]) -> int:
    """Position-aware content hash for one full block, chained from the
    previous block's hash so equal content at different depths differs."""
    return hash((parent, tokens))


@dataclasses.dataclass
class PagedCache:
    """Host-side paged-cache bookkeeping for ``max_seqs`` decode slots.

    ``data_shards > 1`` (sharded-DP serving, DESIGN.md §10): slots are
    chunked over the mesh's data axis and each device holds its own pool
    *replica*, authoritative only for blocks its slots wrote.  The prefix
    index therefore records each registered block's home shard and only
    hands a block to slots on that shard — an alias across shards would
    read another replica's garbage.  ``data_shards == 1`` (single device,
    or GSPMD-consistent pools) keeps the global index.

    ``migrate_on_alias`` (intra-mesh block migration, DESIGN.md §16):
    instead of refusing a cross-shard match, schedule a home-shard →
    requesting-shard replica copy for the engine to run before the next
    device step, re-home the block, and alias it as usual.  Off by
    default so raw-cache users keep the conservative refusal.
    """

    max_seqs: int
    num_blocks: int
    block_size: int
    max_blocks_per_seq: int
    prefix_caching: bool = False
    data_shards: int = 1
    migrate_on_alias: bool = False

    def __post_init__(self):
        # non-dividing shard counts fall back to the global (1-shard) view
        if self.data_shards < 1 or self.max_seqs % self.data_shards:
            self.data_shards = 1
        self.allocator = BlockAllocator(self.num_blocks,
                                        on_evict=self._forget_block)
        # null block 0 everywhere: idle slots harmlessly write into it
        self.tables = np.zeros((self.max_seqs, self.max_blocks_per_seq),
                               np.int32)
        self._owned: list[list[int]] = [[] for _ in range(self.max_seqs)]
        # prefix index: chained content hash <-> pool block (full blocks only)
        self._block_of: dict[int, int] = {}          # hash  -> block
        self._hash_of: dict[int, int] = {}           # block -> hash
        self._home_of: dict[int, int] = {}           # block -> home shard
        # per-slot committed chain: hash of each full block registered so
        # far (a list, not just the tip, so speculative rollback can rewind
        # the commit cursor block by block)
        self._chain: list[list[int]] = [[] for _ in range(self.max_seqs)]
        # prefix-index effectiveness (repro.obs pool gauges): full-block
        # index probes at admission vs probes that aliased a block, plus
        # cross-shard matches the DP home-shard rule turned away
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.alias_refusals = 0
        # cross-shard replica copies scheduled by assign_prefix under
        # migrate_on_alias: (block, src_shard, dst_shard), drained by the
        # engine before the step that first reads the alias
        self._pending_moves: list[tuple[int, int, int]] = []
        # degradation ladder (DESIGN.md §14): while paused, commit() stops
        # registering new blocks in the prefix index, so released blocks
        # return straight to the free list instead of lingering cached
        self.admission_paused = False

    def shard_of(self, slot: int) -> int:
        return slot // (self.max_seqs // self.data_shards)

    @property
    def max_len(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    # ----- allocation / growth -----
    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow slot's table to cover ``n_tokens``; raises OutOfBlocks."""
        if n_tokens > self.max_len:
            raise OutOfBlocks(
                f"{n_tokens} tokens > per-seq capacity {self.max_len}")
        need = self.blocks_for(n_tokens) - len(self._owned[slot])
        if need <= 0:
            return
        new = self.allocator.alloc(need)
        start = len(self._owned[slot])
        self._owned[slot].extend(new)
        self.tables[slot, start:start + len(new)] = new

    def release(self, slot: int) -> None:
        """Refcount-aware release: registered full blocks stay cached for
        prefix reuse; everything else returns to the free list."""
        for b in self._owned[slot]:
            self.allocator.decref(b, retain=b in self._hash_of)
        self._owned[slot] = []
        self.tables[slot] = 0
        self._chain[slot] = []

    def truncate(self, slot: int, n_tokens: int) -> None:
        """Speculative rollback: shrink the slot to cover ``n_tokens``
        (rejected drafted positions are simply abandoned — the pool KV
        there is garbage that the next write overwrites).  Surplus blocks
        release exactly like ``release`` (retained when prefix-indexed);
        a kept block that was registered but whose content now extends
        past ``n_tokens`` is unregistered if this slot is its only owner
        (its KV is about to be rewritten); if it is shared, the entry
        survives — donors keep the content and our next write COWs."""
        keep = self.blocks_for(n_tokens)
        full = n_tokens // self.block_size
        for b in self._owned[slot][keep:]:
            self.allocator.decref(b, retain=b in self._hash_of)
        self._owned[slot] = self._owned[slot][:keep]
        self.tables[slot, keep:] = 0
        for bi in range(full, keep):
            b = self._owned[slot][bi]
            if b in self._hash_of and self.allocator.ref(b) == 1:
                self._forget_block(b)
        self._chain[slot] = self._chain[slot][:full]

    def owned(self, slot: int) -> list[int]:
        return list(self._owned[slot])

    def blocks_needed(self, slot: int, n_tokens: int) -> int:
        """Blocks ``ensure(slot, n_tokens)`` would have to allocate —
        the speculative-reservation probe the async engine's overlap gate
        sums over running slots to prove the *predicted* next plan cannot
        hit OutOfBlocks (and therefore cannot preempt); see DESIGN.md
        §13.  Pure query, no allocation."""
        return max(0, self.blocks_for(n_tokens) - len(self._owned[slot]))

    # ----- block migration (DESIGN.md §15) -----
    def export_slot(self, slot: int, n_tokens: int
                    ) -> tuple[list[int], list[int]]:
        """Export a slot's block addressing for migration to another
        cache: the block ids covering its first ``n_tokens`` tokens (in
        table order — the engine gathers their pool bytes at these ids)
        and the committed hash chain over the exported *full* blocks, so
        the importer can re-register the content in its own prefix index
        (the prefix becomes aliasable on the destination even though it
        was written on another replica/shard — the migration transport
        that makes cross-shard prefix aliases legal).  Read-only."""
        n = self.blocks_for(n_tokens)
        blocks = self._owned[slot][:n]
        assert len(blocks) == n, \
            f"slot {slot} owns {len(blocks)} blocks < {n} exported"
        return blocks, self._chain[slot][:n]

    def import_slot(self, slot: int, n_blocks: int, chain: list[int],
                    n_tokens: int = 0) -> list[int]:
        """Migration import: allocate fresh blocks for an *empty* slot to
        receive ``n_blocks`` exported blocks (plus growth headroom to
        cover ``n_tokens``, so a post-import ``ensure`` cannot fail
        halfway), wire up its table, and adopt the exported hash chain —
        re-registering each full block in this cache's prefix index under
        the destination slot's home shard (skipping hashes already
        present: dedup keeps the first registration, exactly like
        ``commit``).  Atomic: the single ``alloc`` either satisfies the
        whole request or raises OutOfBlocks having mutated nothing.
        Returns the destination block ids for ``n_blocks`` (the engine
        scatters the migrated pool bytes there)."""
        assert not self._owned[slot], "import_slot on a non-empty slot"
        total = max(n_blocks, self.blocks_for(n_tokens))
        if total > self.max_blocks_per_seq:
            raise OutOfBlocks(
                f"{total} blocks > per-seq capacity {self.max_blocks_per_seq}")
        new = self.allocator.alloc(total)
        self._owned[slot] = new
        self.tables[slot, :total] = new
        chain = list(chain[:n_blocks])
        if self.prefix_caching:
            self._chain[slot] = chain
            if not self.admission_paused:
                home = self.shard_of(slot)
                for h, b in zip(chain, new):
                    if h not in self._block_of and b not in self._hash_of:
                        self._block_of[h] = b
                        self._hash_of[b] = h
                        self._home_of[b] = home
        return new[:n_blocks]

    def drain_moves(self) -> list[tuple[int, int, int]]:
        """Return-and-clear the cross-shard replica copies scheduled by
        ``assign_prefix`` since the last drain, as (block, src_shard,
        dst_shard) in schedule order (order matters: a block re-homed
        twice in one plan chains its copies).  The engine must run these
        *before* the step's device writes — the copy sources a block's
        current home-replica bytes, and nothing is allowed to overwrite
        them in between.  A move whose alias was rolled back (admission
        ran out of blocks after the match) may survive here; draining it
        copies bytes nothing reads, which is wasteful but harmless."""
        moves, self._pending_moves = self._pending_moves, []
        return moves

    # ----- prefix caching -----
    def _forget_block(self, block: int) -> None:
        h = self._hash_of.pop(block)
        del self._block_of[h]
        self._home_of.pop(block, None)

    def assign_prefix(self, slot: int, tokens: tuple[int, ...]) -> int:
        """Alias the longest chain of cached full blocks matching ``tokens``
        into an empty slot's table (incref each).  Returns matched tokens
        (a multiple of block_size; the scheduler caps ``num_cached`` at
        len(tokens)-1 and COWs via ``prepare_write`` when needed)."""
        assert not self._owned[slot], "assign_prefix on a non-empty slot"
        if not self.prefix_caching:
            return 0
        bs = self.block_size
        h = 0
        matched: list[int] = []
        hashes: list[int] = []
        while (len(matched) + 1) * bs <= len(tokens):
            i = len(matched)
            h2 = _chain_hash(h, tuple(tokens[i * bs:(i + 1) * bs]))
            self.prefix_lookups += 1
            b = self._block_of.get(h2)
            if b is None:
                break
            home = self._home_of.get(b)
            if self.data_shards > 1 and home != self.shard_of(slot):
                # per-replica pools: the block's KV only exists on its
                # home shard — an alias from another shard would read
                # that shard's (garbage) replica.  With migration on,
                # schedule a replica copy home -> our shard and re-home;
                # the engine runs the copy before this step's dispatch,
                # so by the time the alias is read the bytes are local.
                if not self.migrate_on_alias:
                    self.alias_refusals += 1
                    break
                self._pending_moves.append((b, home, self.shard_of(slot)))
                self._home_of[b] = self.shard_of(slot)
            self.allocator.incref(b)
            self.prefix_hits += 1
            matched.append(b)
            hashes.append(h2)
            h = h2
        if matched:
            self._owned[slot] = matched
            self.tables[slot, :len(matched)] = matched
            self._chain[slot] = hashes
        return len(matched) * bs

    def commit(self, slot: int, tokens: tuple[int, ...]) -> None:
        """Register slot blocks that became full (``tokens`` = the written
        prefix so far) in the prefix index.  Duplicate content keeps the
        first registration (dedup happens at match time)."""
        if not self.prefix_caching or self.admission_paused:
            return
        bs = self.block_size
        chain = self._chain[slot]
        h = chain[-1] if chain else 0
        full = len(tokens) // bs
        for i in range(len(chain), full):
            h = _chain_hash(h, tuple(tokens[i * bs:(i + 1) * bs]))
            b = self._owned[slot][i]
            if h not in self._block_of and b not in self._hash_of:
                self._block_of[h] = b
                self._hash_of[b] = h
                self._home_of[b] = self.shard_of(slot)
            chain.append(h)

    def prepare_write(self, slot: int, start: int, end: int
                      ) -> list[tuple[int, int]]:
        """Copy-on-write guard: the slot is about to write token positions
        [start, end).  Any shared (ref>1) block in that range is replaced
        by a fresh block; returns (src, dst) pool copies for the engine to
        run on device.  May raise OutOfBlocks."""
        shared = [bi for bi in range(start // self.block_size,
                                     (end - 1) // self.block_size + 1)
                  if bi < len(self._owned[slot])
                  and self.allocator.ref(self._owned[slot][bi]) > 1]
        if not shared:
            return []
        fresh = self.allocator.alloc(len(shared))  # all-or-nothing: a raise
        copies: list[tuple[int, int]] = []         # here mutates no state
        for bi, new in zip(shared, fresh):
            b = self._owned[slot][bi]
            self.allocator.decref(b, retain=b in self._hash_of)
            self._owned[slot][bi] = new
            self.tables[slot, bi] = new
            copies.append((b, new))
        return copies

    # ----- recovery (DESIGN.md §14) -----
    def rebuild(self) -> None:
        """Recovery path for the runtime auditor: reconstruct every
        derived structure from the authoritative per-slot ownership
        lists (``_owned``), discarding whatever was corrupted.

        Ownership is authoritative because it is what the engine's
        dispatch actually reads (via ``tables``) and what ``release``
        walks — if it is wrong the KV itself is unrecoverable and the
        request must be failed (the engine checks per-slot capacity
        after the rebuild).  Everything else is derived: refcounts are
        the multiplicity of a block across slots, the free list is the
        complement, and the prefix index is an optimization that is
        *dropped wholesale* — a corrupt index would silently serve the
        wrong KV, and an empty one merely costs future prefix hits.
        Held blocks (fault injection) stay held."""
        a = self.allocator
        for slot, lst in enumerate(self._owned):
            self._owned[slot] = [b for b in lst
                                 if 0 < b < self.num_blocks]
        owned_ct = Counter(b for lst in self._owned for b in lst)
        a._ref = dict(owned_ct)
        a._held -= set(owned_ct)             # ownership wins over holds
        a._cached = OrderedDict()
        a._free = [b for b in range(self.num_blocks - 1, 0, -1)
                   if b not in owned_ct and b not in a._held]
        self.tables[:] = 0
        for slot, lst in enumerate(self._owned):
            self.tables[slot, :len(lst)] = lst
        self._block_of.clear()
        self._hash_of.clear()
        self._home_of.clear()
        self._pending_moves.clear()
        for slot in range(self.max_seqs):
            self._chain[slot] = []
        self.check()                         # recovery must converge

    # ----- invariant oracle (property tests) -----
    def check(self) -> None:
        self.allocator.check()
        # refcounts == multiplicity across live block tables
        owned_ct = Counter(b for lst in self._owned for b in lst)
        assert dict(owned_ct) == self.allocator._ref, \
            (dict(owned_ct), self.allocator._ref)
        # table rows mirror ownership, zero past the owned prefix
        for slot, lst in enumerate(self._owned):
            assert list(self.tables[slot, :len(lst)]) == lst
            assert not self.tables[slot, len(lst):].any()
        # prefix index: bijective, every entry points at a live or cached
        # block with a recorded home shard; every cached block is indexed
        assert len(self._block_of) == len(self._hash_of)
        assert set(self._home_of) == set(self._hash_of)
        for h, b in self._block_of.items():
            assert self._hash_of[b] == h
            assert b in self.allocator._ref or b in self.allocator._cached
            assert 0 <= self._home_of[b] < self.data_shards
        for b, src, dst in self._pending_moves:
            assert 0 <= src < self.data_shards and \
                0 <= dst < self.data_shards and src != dst, (b, src, dst)
        for b in self.allocator._cached:
            assert b in self._hash_of
        # committed chains never outrun ownership, and a block this slot
        # both owns and registered carries the chain's hash for its index
        for slot, chain in enumerate(self._chain):
            assert len(chain) <= len(self._owned[slot])
            for i, h in enumerate(chain):
                b = self._owned[slot][i]
                if b in self._hash_of:
                    assert self._hash_of[b] == h, (slot, i, b)
