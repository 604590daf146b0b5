"""FCFS continuous-batching scheduler with chunked prefill.

Requests wait in arrival order; each engine step the scheduler (a) retires
finished requests and frees their blocks, (b) grows the block tables of
running requests that crossed a block boundary — preempting the *youngest*
running request back to the waiting queue when the pool is exhausted
(vLLM-style recompute preemption: its blocks are freed and its
prompt+generated prefix is re-prefilled on re-admission), (c) admits
waiting requests into free slots while the pool can hold their prefix
(aliasing cached prefix blocks via ``PagedCache.assign_prefix`` when
prefix caching is on), and (d) plans this step's work as a ``StepPlan``:
which slots take a batched decode token and which take a prefill chunk,
under a per-step prefill token budget.

With ``chunk_size <= 1`` prefill degrades to the original token-by-token
path: every running slot rides the batched decode step and the plan's
``prefill`` list is empty.  With chunking, a slot in prefill phase
advances up to ``chunk_size`` known tokens per step through the model's
``paged_prefill_step`` — O(P/chunk) engine steps instead of O(P).

Token-feed invariant (engine + scheduler contract): a request's sequence
so far is ``seq = prompt + generated``; each step feeds
``seq[num_cached : num_cached + n]`` at positions ``num_cached + i``
(n == 1 on the decode path); after the step ``num_cached += n`` and the
sampled token is appended iff the model just saw the last known token
(``num_cached == len(seq)``).  This one rule covers fresh prefill,
steady-state decode, re-prefill after preemption, and prefix-hit
admission (which simply starts ``num_cached`` at the matched length,
capped at ``len(seq) - 1`` so the last known token is always re-fed —
the copy-on-write case in kv_cache.py).
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter, deque
from typing import Sequence

from repro_torch.serve.kv_cache import OutOfBlocks, PagedCache


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 -> greedy
    stop_tokens: tuple[int, ...] = ()


@dataclasses.dataclass
class RequestState:
    req: Request
    slot: int = -1                    # -1 -> not admitted
    num_cached: int = 0               # tokens written to the KV pool
    generated: list[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    stopped: bool = False
    # async double-buffered stepping (engine step_async; DESIGN.md §13):
    # tokens sampled on device but not yet fetched to the host.  The
    # device has written their KV (so ``num_cached`` counts them) and the
    # next step feeds them device-to-device; the host learns their values
    # at the overlapped reconcile.  Always 0 in lockstep/sync mode.
    pending: int = 0
    finish_reason: str = ""           # ""=in flight; stop/length/
                                      # cancelled/deadline once finished
    # speculative decoding (engine spec mode; DESIGN.md §9)
    draft_cached: int = 0             # tokens written to the *draft* pool
    spec_proposed: int = 0            # draft tokens offered to verification
    spec_accepted: int = 0            # draft tokens the target accepted
    # dynamic K (ServeConfig.spec_ema > 0): EMA of the measured acceptance
    # rate, folded by the engine after every verify; the scheduler plans
    # ceil(ema * spec_k) candidates, clamped to [1, spec_k], so a slot
    # whose draft keeps missing stops paying for rejected drafts
    spec_ema: float = 1.0
    spec_k_plan: int = 0              # candidates planned this cycle

    @property
    def seq(self) -> tuple[int, ...]:
        return self.req.prompt + tuple(self.generated)

    @property
    def seq_len(self) -> int:
        """Sequence length *including* in-flight pending tokens: the
        length the KV pool must back and the planner schedules against.
        ``seq``/``next_token`` deliberately exclude pending — the host
        does not know those token values yet."""
        return len(self.req.prompt) + len(self.generated) + self.pending

    @property
    def next_token(self) -> int:
        """Token to feed at position ``num_cached`` this step."""
        i = self.num_cached
        P = len(self.req.prompt)
        return self.req.prompt[i] if i < P else self.generated[i - P]

    @property
    def phase(self) -> str:
        return "prefill" if self.num_cached < self.seq_len - 1 else "decode"

    @property
    def done(self) -> bool:
        # pending tokens count toward the budget: a predicted plan must
        # not schedule work past max_new_tokens (the in-flight sample is
        # the final token; reconcile appends it after retirement)
        return self.stopped or \
            len(self.generated) + self.pending >= self.req.max_new_tokens

    def reset_for_preemption(self) -> None:
        self.slot = -1
        self.num_cached = 0
        self.draft_cached = 0
        self.preemptions += 1


@dataclasses.dataclass
class StepPlan:
    """One engine step's work: a batched decode set, per-slot prefill
    chunks (state, n_tokens), device pool copies (COW) to run first, and
    the decode subset taking a K-token speculative draft/verify cycle
    this step (``spec`` is always a subset of ``decode``; pool room for
    the K+1 speculative positions is pre-reserved).  ``admitted`` and
    ``preempted`` report this round's queue transitions so the engine
    can record request-lifecycle spans and queue-wait / preemption-stall
    wall time (repro.obs; DESIGN.md §12) without re-deriving them."""
    decode: list[RequestState]
    prefill: list[tuple[RequestState, int]]
    copies: list[tuple[int, int]]
    spec: list[RequestState] = dataclasses.field(default_factory=list)
    admitted: list[RequestState] = dataclasses.field(default_factory=list)
    preempted: list[RequestState] = dataclasses.field(default_factory=list)


class FCFSScheduler:
    def __init__(self, cache: PagedCache):
        self.cache = cache
        self.waiting: deque[RequestState] = deque()
        self.running: list[RequestState] = []
        self.finished: list[RequestState] = []
        self._free_slots = list(range(cache.max_seqs - 1, -1, -1))
        self._copies: list[tuple[int, int]] = []

    # Sharded serving: slots are chunked over the mesh's data axis (slot
    # s lives on shard s // (max_seqs / data_shards) — jax's row-chunked
    # array layout).  The shard count lives on the PagedCache — one
    # source of truth for both slot placement here and the home-shard
    # prefix-alias guard there.  data_shards == 1 reproduces the legacy
    # placement byte-for-byte.
    @property
    def data_shards(self) -> int:
        return self.cache.data_shards

    def shard_of(self, slot: int) -> int:
        return self.cache.shard_of(slot)

    def _pick_slot(self) -> int:
        """Free slot to admit into: least-loaded data shard first (ties:
        lowest shard, then lowest slot); single-shard keeps the legacy
        LIFO free-list order byte-for-byte."""
        if self.data_shards == 1:
            return self._free_slots[-1]
        load = Counter(self.shard_of(s.slot) for s in self.running)
        return min(self._free_slots,
                   key=lambda sl: (load[self.shard_of(sl)],
                                   self.shard_of(sl), sl))

    # ----- queue -----
    def add(self, req: Request) -> RequestState:
        if req.max_new_tokens <= 0:
            # previously admitted and still generated one token (done
            # only fires after a sample lands); reject up front instead
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1, "
                f"got {req.max_new_tokens}")
        if len(req.prompt) + req.max_new_tokens > self.cache.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new "
                f"{len(req.prompt) + req.max_new_tokens} exceeds per-seq "
                f"capacity {self.cache.max_len}")
        # worst-case block need must fit the pool even running alone,
        # otherwise admit() can never succeed and the queue stalls forever
        worst = self.cache.blocks_for(len(req.prompt) + req.max_new_tokens)
        usable = self.cache.allocator.num_blocks - 1
        if worst > usable:
            raise ValueError(
                f"request {req.rid}: needs up to {worst} blocks but the "
                f"pool has {usable} usable")
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        st = RequestState(req)
        self.waiting.append(st)
        return st

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ----- backlog adoption (cluster failover; DESIGN.md §15) -----
    def adopt_waiting(self, st: RequestState, front: bool = False) -> None:
        """Splice a re-homed request into the waiting queue.  ``front``
        preserves a preemption-like priority (the request already waited
        its turn on the dead replica); the default appends in arrival
        order, matching how the cluster replays a salvaged backlog."""
        assert st.slot == -1 and not st.done
        if front:
            self.waiting.appendleft(st)
        else:
            self.waiting.append(st)

    def adopt_running(self, st: RequestState,
                      slot: int | None = None) -> int:
        """Seat a migrated request directly into a free slot (its blocks
        were just imported by ``PagedCache.import_slot``) and return the
        slot.  The engine pre-picks the slot (``_pick_slot``) so it can
        import the pool bytes first; this only performs the queue
        transition ``admit`` would have."""
        if slot is None:
            slot = self._pick_slot()
        assert slot in self._free_slots, f"slot {slot} is not free"
        self._free_slots.remove(slot)
        st.slot = slot
        self.running.append(st)
        return slot

    def drop_waiting(self, st: RequestState) -> None:
        """Retire a not-yet-admitted request (cancellation / deadline
        expiry before admission): straight to finished, no slot or
        blocks were ever held."""
        self.waiting.remove(st)
        self.finished.append(st)

    # ----- per-step transitions -----
    def retire_finished(self) -> list[RequestState]:
        done = [s for s in self.running if s.done]
        for s in done:
            self._release(s)
            self.finished.append(s)
        return done

    def _release(self, s: RequestState) -> None:
        self.running.remove(s)
        self.cache.release(s.slot)
        self._free_slots.append(s.slot)
        s.slot = -1

    def grow_or_preempt(self) -> list[RequestState]:
        """Reserve room for each running seq's next token; preempt on OOM."""
        preempted: list[RequestState] = []
        # oldest first, so the youngest is the victim under pressure
        for s in sorted(self.running, key=lambda r: r.req.rid):
            if s not in self.running:          # preempted earlier this round
                continue
            while True:
                try:
                    self.cache.ensure(s.slot, s.num_cached + 1)
                    break
                except OutOfBlocks:
                    victim = max(self.running, key=lambda r: r.req.rid)
                    if victim is s and len(self.running) == 1:
                        raise   # a lone request outgrew the pool: fatal
                    self._preempt(victim)
                    preempted.append(victim)
                    if victim is s:     # s itself was youngest: stop growing
                        break
        return preempted

    def _preempt(self, victim: RequestState) -> None:
        self._release(victim)
        victim.reset_for_preemption()
        self.waiting.appendleft(victim)       # FCFS: retry before newer work

    def admit(self) -> list[RequestState]:
        """Admit waiting requests while a slot + prefix-sized pool room
        exist.  With prefix caching, cached full blocks matching the
        request's sequence are aliased in and ``num_cached`` jumps past
        them (capped at seq_len-1; a full-cover hit triggers COW on the
        re-fed last block)."""
        admitted = []
        while self.waiting and self._free_slots:
            cand = self.waiting[0]
            if cand.done:       # cancelled/expired while waiting: never
                self.waiting.popleft()        # serve it, finish cleanly
                self.finished.append(cand)
                continue
            slot = self._pick_slot()
            seq = cand.seq
            copies: list[tuple[int, int]] = []
            try:
                matched = self.cache.assign_prefix(slot, seq)
                nc = min(matched, len(seq) - 1)
                if nc < matched:
                    # write cursor landed inside a shared block: COW now
                    copies = self.cache.prepare_write(slot, nc, nc + 1)
                self.cache.ensure(slot, len(seq) + 1)
            except OutOfBlocks:
                self.cache.release(slot)      # roll back partial admission
                break
            self.waiting.popleft()
            self._free_slots.remove(slot)
            cand.slot = slot
            cand.num_cached = nc
            self._copies.extend(copies)
            self.running.append(cand)
            admitted.append(cand)
        return admitted

    def plan_step(self, chunk_size: int = 0, prefill_budget: int = 0,
                  spec_k: int = 0, spec_ema: float = 0.0,
                  allow_admission: bool = True,
                  prefill_only: bool = False) -> StepPlan:
        """One scheduling round.  Returns the step plan; ``chunk_size <= 1``
        reproduces the legacy all-through-decode behavior exactly.

        ``spec_k > 0`` plans speculative draft/verify cycles: decode-phase
        slots are offered a K-token draft if (a) the request still wants
        more than one token, (b) the shared token budget — prefill chunks
        are planned first, so prompt streaming keeps its TTFT priority —
        has K tokens left, and (c) the pool can reserve the K+1
        speculative positions (shared blocks in the write range are COWed
        now).  A slot that fails any gate simply rides the step as a
        plain one-token decode; speculation is an opportunistic upgrade,
        never a correctness dependency.

        ``spec_ema > 0`` turns on dynamic K: each slot is planned
        ``ceil(ema * spec_k)`` candidates (clamped to [1, spec_k]) from
        its acceptance-rate EMA, so a consistently-rejected draft decays
        to a single candidate while a well-matched one keeps the full K.
        The device shapes stay (B, spec_k) — dynamic K narrows ``ncand``
        and the pool reservation, never the compiled step.

        ``prefill_only`` (disaggregated serving, DESIGN.md §16): plan no
        decode work — decode-phase slots are parked for the cluster to
        migrate to a decode replica, and speculation is skipped.  The
        sampled prefill of a prompt's final chunk still happens (it is
        part of the prefill dispatch), so the first token is produced
        here; with ``chunk_size <= 1`` prefill advances token-by-token
        through the decode path, so that path plans prefill-phase slots
        only."""
        self.retire_finished()
        preempted = self.grow_or_preempt()
        # drain mode (DESIGN.md §14): finish what's running, leave the
        # waiting queue intact for a post-drain snapshot
        admitted = self.admit() if allow_admission else []
        copies, self._copies = self._copies, []
        if chunk_size <= 1 and spec_k <= 0:
            rows = [s for s in self.running if s.phase == "prefill"] \
                if prefill_only else list(self.running)
            return StepPlan(decode=rows, prefill=[],
                            copies=copies, admitted=admitted,
                            preempted=preempted)
        # with chunking off, prefill-phase slots still advance through the
        # decode path token by token (the legacy contract)
        if prefill_only:
            decode = [] if chunk_size > 1 else \
                [s for s in self.running if s.phase == "prefill"]
        else:
            decode = list(self.running) if chunk_size <= 1 else \
                [s for s in self.running if s.phase == "decode"]
        prefill: list[tuple[RequestState, int]] = []
        budget = prefill_budget if prefill_budget > 0 else float("inf")
        if chunk_size > 1:
            for s in sorted(self.running, key=lambda r: r.req.rid):
                if s.phase != "prefill" or budget <= 0:
                    continue
                n = int(min(chunk_size, s.seq_len - s.num_cached, budget))
                # admission pre-reserved blocks through seq_len+1, so the
                # chunk's write range is already backed; assert, don't alloc
                assert self.cache.blocks_for(s.num_cached + n) <= \
                    len(self.cache.owned(s.slot))
                prefill.append((s, n))
                budget -= n
        spec: list[RequestState] = []
        if spec_k > 0 and not prefill_only:
            for s in sorted(decode, key=lambda r: r.req.rid):
                want = s.req.max_new_tokens - len(s.generated)
                k_s = spec_k if spec_ema <= 0 else \
                    max(1, min(spec_k, math.ceil(s.spec_ema * spec_k)))
                if s.phase != "decode" or want <= 1 or budget < k_s:
                    continue
                try:
                    self.cache.ensure(s.slot, s.num_cached + 1 + k_s)
                    copies.extend(self.cache.prepare_write(
                        s.slot, s.num_cached, s.num_cached + 1 + k_s))
                except OutOfBlocks:
                    # plain decode; +1 is already backed.  If ensure
                    # succeeded but the COW alloc failed, hand the
                    # speculative surplus back rather than idling it
                    # while grow_or_preempt evicts someone else
                    self.cache.truncate(s.slot, s.num_cached + 1)
                    continue
                s.spec_k_plan = k_s
                spec.append(s)
                budget -= k_s
        return StepPlan(decode=decode, prefill=prefill, copies=copies,
                        spec=spec, admitted=admitted, preempted=preempted)

    def commit_progress(self) -> None:
        """Register newly-filled full blocks in the prefix index (no-op
        when prefix caching is off; under sharded-DP serving the cache
        itself records each block's home shard and refuses cross-shard
        aliases — see kv_cache.PagedCache)."""
        if not self.cache.prefix_caching:
            return
        for s in self.running:
            self.cache.commit(s.slot, s.seq[:s.num_cached])

    def schedule(self) -> Sequence[RequestState]:
        """Legacy single-token scheduling round; returns the running set.
        Pending COW copies are re-queued, not dropped — a caller that later
        switches to ``plan_step`` (the engine) still receives them."""
        plan = self.plan_step(chunk_size=0)
        self._copies = plan.copies + self._copies
        return plan.decode
