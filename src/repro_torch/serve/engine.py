"""Continuous-batching inference engine over the paged KV cache — the
port of the reference's ``serve/engine.py`` (single device).

Two fixed-shape device steps serve every in-flight request:

  - a batched *decode* step of shape (max_seqs,): slots in decode feed their
    last sample; slots that are idle or mid-prefill ride along inactive
    (zeroed table row -> null-block writes);
  - a *prefill* step of shape (max_seqs, chunk_size): every slot with a
    planned chunk pushes its known tokens through the model in ONE device
    call per step, scattering K/V straight into its pool blocks (idle rows
    write the null block) — O(P/chunk) engine steps per P-token prompt.

One engine step may mix both (continuous batching): the scheduler plans
prefill chunks under a per-step token budget so decode latency stays bounded
while prompts stream in.  ``chunk_size=0`` is token-by-token prefill through
the decode step.

Prefix caching (``prefix_caching``) aliases cached full blocks into new
requests' tables; the scheduler hands back copy-on-write (src, dst) pool
copies which the engine runs on the device before the step.

Quantized KV pools (``cache_dtype="int8"``/``"fp8_e4m3"``): the pools store
1-byte elements plus per-(token, kv-head) f32 scale pools that share the KV
pools' block addressing — ``_scatter_kv`` quantizes on write, the
paged-attention kernel dequantizes while it loads, and the engine's only
added duty is COWing the scale pools alongside k/v.  Host bookkeeping is
unchanged, so scheduler behaviour is identical across cache dtypes.

Host<->device traffic is one upload per device call and ONE fetch per step:
every sampled token the host needs is stacked into a single tensor and
brought over once (``stats["host_syncs"]``).  A step that samples nothing
(prefill chunks that all end before their prompts, no decode row) fetches
nothing.  The fetch has two halves: its *start*, at dispatch, copies the
stacked tensor with ``non_blocking=True`` into a pinned host buffer and
records a CUDA event; its *wait*, at reconcile, synchronizes on that event
and reads the buffer.  Uploads are staged through pinned buffers too, so the
host half of a step (plan, uploads, dispatch) never waits for the device.
Each in-flight record keeps its pinned buffers until its reconcile has
waited.  On ``device="cpu"`` the same code runs without pinning or events.

Async double-buffered stepping (``step_async``; ``async_step`` makes
``run`` / ``stream`` / ``drain`` use it): while step N's device work is in
flight, the host predicts its fold (decode growth is deterministic; only
sampled *values* are unknown), plans and dispatches step N+1 from that
predicted state — feeding tokens still on the device with ``torch.where``,
so they never pass through the host — and only then waits for step N.
Speculative decoding and any round that could preempt fall back to
lockstep (``_can_overlap``).  A token that finishes its request while the
next step flies cancels that request's row in the newer record and hands
back the blocks the predicted plan reserved (``_cancel_inflight``).  Every
pool read and write stays on the engine's one stream, so an in-flight write
into a block freed that way lands before the block's next owner writes it.

The front door: ``add_request(..., on_token=, deadline_s=)`` streams tokens
to a callback (hardened: a callback that raises fails only its own request)
and deadlines a request from submission; ``cancel``; ``stream`` (an
iterator); ``max_waiting`` backpressure (``EngineOverloaded``);
``pop_finished``; ``drain`` (stop admitting, finish what runs, optionally
force-preempt stragglers back to the waiting queue at a deadline).

Crash safety (``Engine(..., faults=)``, ``repro_torch.serve.faults``):
seeded fault injection at fixed seams (step start, the fetch's wait, the
streaming emit; ``faults=None`` keeps every hook behind one ``is None``
check); runtime invariant audits before dispatch (``audit_level``) that
quarantine into a rebuild of derived host state (``_recover``); a fetch
that fails past its retries aborts the step (``_abort_step``, split on
whether the async pipeline already predicted it); the degradation ladder
under sustained pool pressure (``degrade``: shed aged waiting requests,
clamp the planned speculative K to 1, pause prefix-cache admission); and
``snapshot`` / ``restore`` (``repro_torch.serve.snapshot``).

Speculative decoding (``spec_k > 0`` plus a draft model): a *draft* loop of
K pruned-model decode steps and a *verify* step of shape (max_seqs, K) that
scores every drafted position with the dense target in one multi-token pass
(``paged_verify_step``), accepting drafts by exact match (greedy) or
rejection sampling (temperature), so outputs keep the dense-only engine's
law.  Self-speculative decoding is the pruning loop closed: the SPA/OBSPA-
pruned model shares the dense model's vocabulary, so it is a free draft.
Draft and target each own a device block pool (the draft's may be narrower,
``draft_cache_dtype``, int8 / fp8 with their scale pools) but share one
host allocator and one set of block tables, so admission, growth, COW and
preemption stay single-sourced; rejected drafts roll back by cursor
(``PagedCache.truncate``).  The draft loop is K eager decode steps (the
reference fuses them into one jitted call).

Telemetry (``Engine(..., telemetry=...)``, ``repro_torch.obs``): the run
counters live in the handle's registry and ``run()``'s stats are a diff of
two snapshots; an enabled handle also records per-step phase timers (plan /
prefill dispatch / decode-or-spec dispatch / the fetch's wait / fold, the
async ``overlap`` around the predicted plan and dispatch, the audit),
request lifecycle spans, TTFT and inter-token histograms, pool gauges and
the speculative acceptance histograms.  All of it is host clocks around
calls the engine makes anyway: no device synchronization is added, nothing
touches a tensor or the generator, so outputs are byte-identical with it on
or off, and the disabled default reads no clock.

Device placement: the engine runs on the CUDA device unless the caller asks
for ``device="cpu"``; without CUDA and without that request it raises.  The
pools are updated in place by the model steps (where the reference donates
buffers to its jitted steps).

Recurrent families (ssm): every paged step carries the ``active`` mask, so
slots that are idle or mid-prefill keep their SSM/conv state, and a slot
whose position is 0 starts from zero state (slot reuse).  Prefix caching is
gated off for them: recurrent state is per slot and cannot be rebuilt from
aliased KV blocks; speculative decoding is gated off for them (no rewind
of recurrent state), and ``can_handoff_blocks`` is False.

Not in this module yet (later slices of the port): cluster hand-off
(``export_request`` / ``adopt``), disaggregated roles and meshes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import CACHE_DTYPES
from repro_torch.obs import DEFAULT_TIME_BUCKETS, NULL_CTX, Telemetry
from repro_torch.serve.faults import CrashError, FaultError, FaultInjector
from repro_torch.serve.kv_cache import OutOfBlocks, PagedCache
from repro_torch.serve.scheduler import FCFSScheduler, Request, RequestState

# engine run counters, registry-backed (repro_torch.obs): the keys double as
# the delta-stat names run() reports, so stats are a diff of two snapshots
_RUN_COUNTERS = ("steps", "decode_tokens", "prefill_tokens",
                 "prefill_chunks", "cow_copies", "host_syncs",
                 "spec_cycles", "spec_proposed", "spec_accepted",
                 # target device calls made (each runs every layer once);
                 # a spec cycle adds K draft decode calls and one verify,
                 # and in spec mode every prefill call one draft prefill
                 "decode_calls", "prefill_calls",
                 # fault tolerance: injected faults, recoveries (retried
                 # fetches, aborted steps, rebuilds, unjams), shed
                 # requests, failed audits, raising stream callbacks
                 "faults_injected", "recoveries", "requests_shed",
                 "audit_violations", "callback_errors")

# pool entries a copy-on-write block copy moves: KV plus the per-(token,
# head) scale pools sharing block addressing
_POOL_KEYS = ("k", "v", "k_scale", "v_scale")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The reference's ``ServeConfig`` on one device.  ``donate_pools`` has
    no counterpart (the port's pools are updated in place, never donated);
    ``role`` and ``migrate_on_alias`` belong to the cluster and mesh
    slices of the port."""
    max_seqs: int = 8                 # decode slots = max batch per step
    block_size: int = 16              # tokens per KV block
    max_len: int = 512                # per-sequence token capacity
    num_blocks: int = 0               # 0 -> pool sized for worst case
    seed: int = 0
    chunk_size: int = 32              # prefill chunk; 0/1 -> token-by-token
    prefill_budget: int = 0           # max prefill tokens/step (0 = no cap)
    prefix_caching: bool = True       # share full blocks across prefixes
    spec_k: int = 0                   # draft tokens per speculative cycle
    spec_ema: float = 0.0             # >0: dynamic K, EMA coefficient of
                                      # the per-slot acceptance rate
    draft_cache_dtype: str = ""       # "" = draft pool in the draft's
                                      # dtype; e.g. "bfloat16" or "int8"
                                      # narrows it (lossless under verify)
    cache_dtype: str = ""             # KV pool dtype: "" = model dtype;
                                      # "float32"/"bfloat16" cast;
                                      # "int8"/"fp8_e4m3" quantize with
                                      # per-write scale pools and fused
                                      # kernel dequant
    async_step: bool = False          # run()/stream()/drain() drive
                                      # step_async(): double-buffered
                                      # submit/reconcile pipeline; outputs
                                      # stay byte-identical at temp 0
    max_waiting: int = 0              # backpressure: add_request raises
                                      # EngineOverloaded once this many
                                      # requests wait (0 = unbounded)
    audit_level: str = "off"          # runtime invariant auditing: "off" |
                                      # "alloc" (allocator conservation) |
                                      # "full" (the PagedCache.check()
                                      # oracle); a violation quarantines
                                      # into the recover path instead of
                                      # serving from corrupt state
    audit_interval: int = 1           # audit every N engine steps
    degrade: bool = False             # graceful-degradation ladder under
                                      # sustained pool pressure: shed
                                      # aged waiting requests, clamp
                                      # speculative K to 1, pause
                                      # prefix-cache admission
    shed_queue_age_s: float = 0.5     # degraded: shed waiting requests
                                      # older than this (finish_reason
                                      # "shed" — a retriable rejection)
    pressure_threshold: float = 0.125 # pressured when available blocks
                                      # fall below this pool fraction
                                      # (or the waiting queue is full)
    pressure_window: int = 3          # consecutive pressured (calm)
                                      # steps to engage (disengage)
    drain_timeout_s: float = 0.0      # drain() deadline: running requests
                                      # still unfinished after this many
                                      # seconds are force-preempted into
                                      # the waiting queue (waiting-with-
                                      # prefix, snapshotable) so a
                                      # straggler cannot stall a rolling
                                      # restart (0 = unbounded)

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_len // self.block_size)

    def pool_blocks(self) -> int:
        if self.num_blocks:
            return self.num_blocks
        # worst case every slot full, +1 for the reserved null block
        return self.max_seqs * self.blocks_per_seq + 1


class EngineOverloaded(RuntimeError):
    """Backpressure-aware admission (ServeConfig.max_waiting): the waiting
    queue is full (or the engine is draining), so ``add_request`` refuses
    instead of growing host state without bound.  Callers shed load or
    retry later."""


class AuditViolation(RuntimeError):
    """A runtime invariant audit (ServeConfig.audit_level) failed AND the
    recovery rebuild could not restore a consistent state — the engine
    refuses to keep serving from memory it cannot trust.  The recoverable
    case never raises: it is counted (``audit_violations``,
    ``recoveries``) and serving continues."""


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    prompt: tuple[int, ...]
    tokens: list[int]                 # generated tokens
    preemptions: int
    steps: int                        # engine steps, first admission -> finish
    ttft_s: float = 0.0               # submission -> first sampled token
    queue_wait_s: float = 0.0         # submission -> first admission
    preempt_stall_s: float = 0.0      # total wall spent evicted
    tpot_s: float = 0.0               # mean per-token latency after the
                                      # first token (0 for 1-token requests)
    spec_proposed: int = 0            # draft tokens offered to verification
    spec_accepted: int = 0            # draft tokens the target accepted
    finish_reason: str = "length"     # stop | length | cancelled |
                                      # deadline | shed (load shedding) |
                                      # error (callback raise / fault)


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-unreconciled engine step: the async pipeline's
    in-flight record.

    Holds the plan, the device tensors the step's one fetch reads, and the
    fold metadata captured *at submit time* — which rows sample a token
    (``emit``), where each sampling request's token lives in the fetch
    tensors (``src``, the next step's device-side token feed), and rows a
    later reconcile cancelled (mispredicted finishes) whose samples must be
    discarded.  ``folded`` marks that ``_predict_fold`` already advanced the
    host cursors, so ``_reconcile`` only materializes token values.  The
    fetch's started copy — its host buffer, the CUDA event recorded after
    it, the layout of the stacked values — and the step's pinned upload
    buffers live here until the reconcile has waited."""
    plan: Any
    running: list[RequestState]
    fetch: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    pre_rows: list[tuple[RequestState, int]] = \
        dataclasses.field(default_factory=list)      # sampled prefill rows
    decode_rows: list[tuple[RequestState, int, bool]] = \
        dataclasses.field(default_factory=list)      # (state, slot, emit)
    spec_meta: list[tuple[RequestState, int, int]] = \
        dataclasses.field(default_factory=list)
    src: dict[int, tuple[str, int]] = \
        dataclasses.field(default_factory=dict)      # rid -> (tensor, slot)
    cancelled: set[int] = dataclasses.field(default_factory=set)
    folded: bool = False
    host: torch.Tensor | None = None                 # the fetch's buffer
    event: Any = None                                # torch.cuda.Event
    layout: list[tuple[str, tuple[int, ...]]] = \
        dataclasses.field(default_factory=list)
    pins: list[torch.Tensor] = dataclasses.field(default_factory=list)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


class Engine:
    # extra fetch attempts before a step is aborted: the fetch's host
    # buffer stays alive across attempts, so a retried fetch reads the
    # identical values
    _sync_retries = 2

    def __init__(self, model, params, cfg: ServeConfig | None = None,
                 draft_model=None, draft_params=None,
                 telemetry: Telemetry | None = None, device=None,
                 faults: FaultInjector | None = None):
        if not model.cfg.has_decode:
            raise ValueError(f"{model.cfg.name} has no decode path")
        if model.cfg.family == "vlm":
            raise ValueError("vlm serving needs patch prefill (not supported)")
        self.device = resolve_device(device)
        for tree in (params, draft_params):
            leaf = None if tree is None else _first_leaf(tree)
            if leaf is not None and leaf.device.type != self.device.type:
                raise ValueError(f"params live on {leaf.device}, the engine "
                                 f"runs on {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg or ServeConfig()
        # fault injection: None keeps every hook behind one attribute
        # check.  A plain attribute, not reset() state, so tests can attach
        # and detach an injector mid-life.
        self.faults = faults
        if self.cfg.audit_level not in ("off", "alloc", "full"):
            raise ValueError(f"audit_level {self.cfg.audit_level!r} "
                             f"not in ('off', 'alloc', 'full')")
        if self.cfg.audit_interval < 1:
            raise ValueError("audit_interval must be >= 1")
        # host-side only: phase timers, lifecycle spans and gauges never
        # touch a tensor or the generator; the disabled default is a no-op
        # and the registry's run counters are always live
        self.obs = telemetry if telemetry is not None else \
            Telemetry(enabled=False)
        for field in ("cache_dtype", "draft_cache_dtype"):
            if getattr(self.cfg, field) not in CACHE_DTYPES:
                raise ValueError(f"{field} {getattr(self.cfg, field)!r} "
                                 f"not in {CACHE_DTYPES}")
        self.cache = model.init_paged_cache(
            num_blocks=self.cfg.pool_blocks(),
            block_size=self.cfg.block_size,
            max_seqs=self.cfg.max_seqs,
            dtype=self.cfg.cache_dtype or None,
            device=self.device)
        # prefix caching needs the cached blocks to fully determine the
        # model state they stand for; recurrent SSM/conv state is per-slot
        # and not reconstructable from aliased KV blocks
        self._prefix_ok = (self.cfg.prefix_caching
                           and not self._recurrent)
        # speculative decoding capability gate: rejected drafts roll back
        # by dropping KV cursor positions; recurrent SSM/conv state has no
        # such rewind, so SSM/hybrid fall back to dense-only decode
        self.draft_model = draft_model
        self.draft_params = draft_params
        self.spec_active = (self.cfg.spec_k > 0 and draft_model is not None
                            and not self._recurrent)
        if self.spec_active:
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError("draft/target vocabularies differ")
            self.draft_cache = draft_model.init_paged_cache(
                num_blocks=self.cfg.pool_blocks(),
                block_size=self.cfg.block_size,
                max_seqs=self.cfg.max_seqs,
                dtype=self.cfg.draft_cache_dtype or None,
                device=self.device)
        self.reset()

    @property
    def _recurrent(self) -> bool:
        return self.model.cfg.family == "ssm" or self.model.cfg.hybrid

    @property
    def can_handoff_blocks(self) -> bool:
        """Whether a running sequence could move to another engine as its
        KV blocks: not for recurrent families, whose SSM/conv state is
        per-slot, not per-block (the reference's gate; the port has no
        hand-off yet)."""
        return not self._recurrent

    @property
    def _steps(self) -> int:
        return self._c["steps"].value

    def reset(self) -> None:
        """Clear all request/allocator state; keep params and pools (stale
        pool contents are dead: reads are gated by per-slot positions)."""
        self.cache_host = PagedCache(
            max_seqs=self.cfg.max_seqs,
            num_blocks=self.cfg.pool_blocks(),
            block_size=self.cfg.block_size,
            max_blocks_per_seq=self.cfg.blocks_per_seq,
            prefix_caching=self._prefix_ok)
        self.scheduler = FCFSScheduler(self.cache_host)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.cfg.seed)
        self._rid = 0
        self._c = {k: self.obs.registry.counter("serve/" + k)
                   for k in _RUN_COUNTERS}
        for c in self._c.values():
            c.reset()
        self._admit_step: dict[int, int] = {}
        self._finish_step: dict[int, int] = {}
        # per-request wall clocks (lifecycle spans + the latency fields on
        # FinishedRequest)
        self._submit_wall: dict[int, float] = {}
        self._first_tok_wall: dict[int, float] = {}
        self._last_tok_wall: dict[int, float] = {}
        self._queue_wait: dict[int, float] = {}
        self._preempt_wall: dict[int, float] = {}
        self._preempt_stall: dict[int, float] = {}
        self._chunked: set[int] = set()   # rids whose first chunk is logged
        # async pipeline + serving front-door state
        self._pending: _Inflight | None = None
        self._pins: list[torch.Tensor] = []    # the submitting step's
        self._on_token: dict[int, Any] = {}    # rid -> streaming callback
        self._deadline: dict[int, float] = {}  # rid -> absolute wall time
        self._drained = 0    # scheduler.finished entries already reported
        # fault-tolerance / degradation state
        self._tick = 0                  # monotonic hook tick: hold expiry
        self._fault_held: list[tuple[int, list[int]]] = []
        self._draining = False          # drain(): no new admissions
        self._degraded = False          # degradation ladder engaged
        self._pressure_run = 0
        self._calm_run = 0

    # ----- device steps -----
    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                t_dev: torch.Tensor | None = None) -> torch.Tensor:
        """Greedy rows take the argmax; rows with temperature > 0 draw from
        ``softmax(logits / T)`` with the engine's generator.  ``temps`` is
        the host copy, so an all-greedy batch draws nothing; ``t_dev`` is
        its device copy, which the callers send in their call's one
        upload."""
        greedy = logits.argmax(dim=-1)
        if not (temps > 0).any():
            return greedy.to(torch.int32)
        t = self._upload(temps.view(np.int32))[0].view(torch.float32) \
            if t_dev is None else t_dev
        probs = torch.softmax(logits.float() / t.clamp(min=1e-6)[:, None],
                              dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(t > 0, sampled, greedy).to(torch.int32)

    @staticmethod
    def _dist(logits: torch.Tensor, t: torch.Tensor | None) -> torch.Tensor:
        """The distribution ``_sample`` actually samples from: softmax at
        temperature, a one-hot argmax at 0 (so the rejection-sampling
        identity also covers greedy exact-match acceptance).  ``t`` holds
        the rows' temperatures shaped like ``logits[..., 0]``; None when
        every row is greedy."""
        lf = logits.float()
        hard = F.one_hot(lf.argmax(-1), lf.shape[-1]).float()
        if t is None:
            return hard
        soft = torch.softmax(lf / t.clamp(min=1e-6)[..., None], dim=-1)
        return torch.where(t[..., None] > 0, soft, hard)

    def _draft_impl(self, forced, known_len, start_pos, tables, temps,
                    t_dev):
        """K draft-model decode steps (eager; the reference fuses them into
        one jitted call).

        forced (B, K): known tokens to feed first — normally just the last
        sampled token (known_len == 1), plus catch-up tokens when the draft
        pool lags the target's cursor (the full-acceptance KV gap).  Step i
        feeds ``forced[:, i]`` while i < known_len, else its own previous
        sample; every step writes draft KV at ``start_pos + i``.  Returns
        the K candidate tokens (right-aligned from the step that consumed
        the last known token; positions past ``K - known_len + 1`` are
        padding the verify mask discards) and their proposal distributions
        q (B, K, V)."""
        B, K = forced.shape
        sampled = bool((temps > 0).any())
        prev = forced[:, 0]
        cands, qs = [], []
        for i in range(K):
            tok = torch.where(known_len > i, forced[:, i], prev)
            logits, self.draft_cache = self.draft_model.paged_decode_step(
                self.draft_params, self.draft_cache, tok, start_pos + i,
                tables)
            nxt = self._sample(logits, temps, t_dev)
            cands.append(nxt)
            qs.append(self._dist(logits, t_dev if sampled else None))
            prev = nxt
        cand = torch.stack(cands, 1)                          # (B, K)
        q = torch.stack(qs, 1)                                # (B, K, V)
        # candidates begin at the step that fed the last known token
        idx = ((known_len - 1).long()[:, None]
               + torch.arange(K, device=cand.device)[None]).clamp(0, K - 1)
        cand = cand.gather(1, idx)
        q = q.gather(1, idx[..., None].expand(-1, -1, q.shape[-1]))
        return cand, q

    def _verify_impl(self, base_tok, cand, qprobs, positions0, slots,
                     block_tables, valid, ncand, temps, t_dev):
        """One multi-token target pass over ``[base token, drafts]``, then
        exact speculative acceptance.

        The K verify rows feed ``[base, c_1 .. c_{K-1}]``: row j's logits
        are the target's distribution for sequence position
        ``positions0 + j + 1`` — exactly what a token-by-token decode would
        have sampled from — and score candidate c_{j+1}.  (The last
        candidate's own KV is not written this cycle; if accepted it
        becomes the next cycle's base row.  No "bonus" token is emitted on
        full acceptance: it would leave the draft pool one position behind,
        and the next cycle's row 0 samples it from the identical target
        distribution.)

        Candidate j is accepted with probability min(1, p(c)/q(c)) (greedy:
        p and q are one-hots, so this is exact match); the first rejection
        resamples from norm(max(p - q, 0)), so outputs keep the dense-only
        engine's law.  Rows with ``ncand == 0`` are plain decodes riding
        the verify batch: they emit row 0's target sample.

        Returns (out_tokens (B, K): accepted drafts then the replacement or
        plain-decode sample, n_acc (B,)), both int32."""
        B, K = cand.shape
        dev = cand.device
        tokens = torch.cat([base_tok[:, None], cand[:, :K - 1]], dim=1)
        cand = cand.long()
        j = torch.arange(K, dtype=torch.int32, device=dev)[None]
        logits, self.cache = self.model.paged_verify_step(
            self.params, self.cache, tokens, positions0[:, None] + j, slots,
            block_tables, valid)
        sampled = bool((temps > 0).any())
        p = self._dist(logits, t_dev[:, None].expand(B, K) if sampled
                       else None)                             # (B, K, V)
        c = cand[..., None]
        ratio = p.gather(-1, c)[..., 0] / \
            qprobs.gather(-1, c)[..., 0].clamp(min=1e-30)
        # greedy: the ratio is 0 or 1, and u < 1 always, so an all-greedy
        # batch draws nothing (u = 0 accepts exactly the ratios of 1)
        u = torch.rand((B, K), generator=self._gen, device=dev) if sampled \
            else torch.zeros((B, K), device=dev)
        ok = (u < ratio) & (j < ncand[:, None])
        n_acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)     # (B,)

        # residual distribution at the first rejected position; for plain
        # rows (ncand == 0) q is never consulted — row 0's plain target
        # sample is emitted instead
        rep = p.argmax(-1)                                    # (B, K)
        if sampled:
            res = (p - qprobs).clamp(min=0.0)
            res = res / res.sum(-1, keepdim=True).clamp(min=1e-30)
            # the reference draws categorical(log(res + 1e-30)): the same
            # law, as weights (multinomial refuses an all-zero row)
            draw = torch.multinomial((res + 1e-30).view(B * K, -1), 1,
                                     generator=self._gen).view(B, K)
            rep = torch.where(t_dev[:, None] > 0, draw, rep)
        plain = self._sample(logits[:, 0], temps, t_dev).long()
        rep_at = rep.gather(1, n_acc.clamp(0, K - 1)[:, None])[:, 0]
        fill = torch.where(ncand == 0, plain, rep_at)
        n = n_acc[:, None]
        out = torch.where(j < n, cand,
                          torch.where(j == n, fill[:, None], 0))
        return out.to(torch.int32), n_acc.to(torch.int32)

    def _cow_impl(self, cache: dict, src: int, dst: int) -> dict:
        # scale pools COW in lockstep with their KV pools: a copied block
        # is meaningless without the scales its bytes were written under
        for name in _POOL_KEYS:
            if name in cache:
                cache[name][:, dst] = cache[name][:, src]
        return cache

    def _upload(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """One host->device copy for all of a device call's int32 operands
        (a float32 array rides as its bits, a bool one as 0 / 1): they are
        packed into one buffer and handed back as int32 views.  On the card
        the buffer is staged in pinned memory and copied with
        ``non_blocking=True``, so the copy waits for no earlier device work;
        the pinned buffer is kept (``_pins``, then the step's in-flight
        record) until the step's reconcile has waited."""
        flat = torch.from_numpy(np.concatenate(
            [a.reshape(-1) for a in arrays]).astype(np.int32, copy=False))
        if self.device.type == "cuda":
            pinned = flat.pin_memory()
            self._pins.append(pinned)
            dev = pinned.to(self.device, non_blocking=True)
        else:
            dev = flat
        out, o = [], 0
        for a in arrays:
            out.append(dev[o:o + a.size].view(a.shape))
            o += a.size
        return out

    # ----- request API -----
    def add_request(self, prompt: Iterable[int], max_new_tokens: int = 32,
                    temperature: float = 0.0,
                    stop_tokens: Iterable[int] = (),
                    on_token=None, deadline_s: float | None = None) -> int:
        """Queue one request; returns its rid.

        ``on_token(token, done)`` streams every sampled token as the step
        that produced it folds (async mode: one step after dispatch); a
        tokenless finish (cancellation, deadline) calls it once with
        ``(None, True)``.  ``deadline_s`` is a wall-clock budget from
        submission — the request is cancelled (finish_reason "deadline") at
        the first step boundary past it, admitted or not.  Raises
        EngineOverloaded when ``max_waiting`` requests already wait
        (backpressure) or the engine is draining, ValueError on degenerate
        requests (empty prompt, non-positive max_new_tokens, prompt+budget
        beyond capacity)."""
        if self._draining:
            raise EngineOverloaded(
                "engine is draining; retry on another instance")
        if self.cfg.max_waiting and \
                len(self.scheduler.waiting) >= self.cfg.max_waiting:
            raise EngineOverloaded(
                f"waiting queue full ({self.cfg.max_waiting}); "
                f"shed load or retry")
        rid = self._rid
        self.scheduler.add(Request(     # validates; raises before any
            rid=rid, prompt=tuple(int(t) for t in prompt),   # state lands
            max_new_tokens=max_new_tokens, temperature=temperature,
            stop_tokens=tuple(stop_tokens)))
        self._rid += 1
        now = time.time()
        self._submit_wall[rid] = now
        self.obs.event("submit", rid)
        if on_token is not None:
            self._on_token[rid] = on_token
        if deadline_s is not None:
            self._deadline[rid] = now + deadline_s
        return rid

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Cancel a request by rid; True if it was still live.  Waiting
        requests finish immediately; running ones retire at the next
        scheduling round (their blocks free there), and any sample of
        theirs still in flight is discarded at reconcile."""
        self._deadline.pop(rid, None)
        for s in self.scheduler.running:
            if s.req.rid == rid and not s.done:
                self._finish_early(s, reason)
                return True
        for s in self.scheduler.waiting:
            if s.req.rid == rid:
                self._finish_early(s, reason)
                self.scheduler.drop_waiting(s)
                return True
        return False

    def _finish_early(self, s: RequestState, reason: str) -> None:
        s.stopped = True
        s.finish_reason = reason
        rid = s.req.rid
        self._finish_step[rid] = self._steps
        self.obs.event("finish", rid, reason=reason)
        self._emit_cb(s, None, True)

    def _expire_deadlines(self) -> None:
        if not self._deadline:
            return
        now = time.time()
        for rid, t in list(self._deadline.items()):
            if now >= t:
                self.cancel(rid, reason="deadline")

    @property
    def pending_step(self) -> bool:
        """True while a dispatched step awaits reconciliation — a caller of
        ``step_async`` keeps stepping until both the queue and this drain."""
        return self._pending is not None

    def stream(self, prompt: Iterable[int], max_new_tokens: int = 32,
               temperature: float = 0.0, stop_tokens: Iterable[int] = (),
               deadline_s: float | None = None):
        """Generate one request's tokens as a plain iterator, driving the
        engine between yields (``step_async`` when ``cfg.async_step``).
        Other queued requests ride the same steps — continuous batching is
        unaffected."""
        buf: list[tuple[int | None, bool]] = []
        self.add_request(prompt, max_new_tokens=max_new_tokens,
                         temperature=temperature, stop_tokens=stop_tokens,
                         on_token=lambda t, d: buf.append((t, d)),
                         deadline_s=deadline_s)
        step = self.step_async if self.cfg.async_step else self.step
        while True:
            while buf:
                tok, done = buf.pop(0)
                if tok is not None:
                    yield tok
                if done:
                    return
            if not (self.scheduler.has_work or self.pending_step):
                return
            step()

    def _append_sample(self, s: RequestState, tok: int) -> None:
        self._c["decode_tokens"].inc()
        rid = s.req.rid
        now = time.time()
        if not s.generated:
            self._first_tok_wall[rid] = now
            self.obs.event("first_token", rid)
            if rid in self._submit_wall:
                self.obs.observe("latency/ttft_s",
                                 now - self._submit_wall[rid],
                                 buckets=DEFAULT_TIME_BUCKETS)
        elif rid in self._last_tok_wall:
            self.obs.observe("latency/itl_s",
                             now - self._last_tok_wall[rid],
                             buckets=DEFAULT_TIME_BUCKETS)
        self._last_tok_wall[rid] = now
        s.generated.append(tok)
        if tok in s.req.stop_tokens:
            s.stopped = True
            s.finish_reason = "stop"
        if s.done:
            if not s.finish_reason:
                s.finish_reason = "length"
            self._finish_step[rid] = self._steps + 1
            self.obs.event("finish", rid, reason=s.finish_reason)
        self._emit_cb(s, tok, s.done)

    def _emit_cb(self, s: RequestState, tok: int | None, done: bool
                 ) -> None:
        """Deliver one streaming callback, hardened: user code that raises
        cancels only its own request (finish_reason "error", counted in
        ``callback_errors``) — it can never unwind the step fold or poison
        async reconciliation.  The caller's ordinary ``if s.done:
        _cancel_inflight`` path then rolls back any row already dispatched
        for the request."""
        rid = s.req.rid
        cb = self._on_token.get(rid)
        if cb is None:
            return
        if done:
            del self._on_token[rid]
        try:
            if self.faults is not None and \
                    self.faults.fire("callback_error", self._steps,
                                     rid=rid) is not None:
                self._c["faults_injected"].inc()
                raise FaultError(f"injected on_token exception (rid {rid})")
            cb(tok, done)
        except Exception:
            self._c["callback_errors"].inc()
            self._on_token.pop(rid, None)
            if not done:            # _finish_early re-enters _emit_cb,
                self._finish_early(s, "error")   # cb is already popped
                try:
                    cb(None, True)  # best-effort end-of-stream notice so
                except Exception:   # a consumer blocked on the stream
                    pass            # still observes termination

    def _phase(self, name: str):
        """Step-phase timer (no-op context when telemetry is disabled)."""
        if not self.obs.enabled:
            return NULL_CTX
        return self.obs.phase(name, self._steps)

    def _note_transitions(self, plan) -> None:
        """Queue-wait / preemption-stall wall clocks for this scheduling
        round, surfaced on FinishedRequest, and their lifecycle spans."""
        if not (plan.admitted or plan.preempted):
            return
        now = time.time()
        for s in plan.preempted:
            self._preempt_wall[s.req.rid] = now
            self.obs.event("preempt", s.req.rid)
        for s in plan.admitted:
            rid = s.req.rid
            t0 = self._preempt_wall.pop(rid, None)
            if t0 is not None:                # back from eviction
                self._preempt_stall[rid] = \
                    self._preempt_stall.get(rid, 0.0) + (now - t0)
                self.obs.event("resume", rid)
            else:
                self._queue_wait.setdefault(
                    rid, now - self._submit_wall.get(rid, now))
                self.obs.event("admit", rid)

    def _sample_gauges(self) -> None:
        """Per-step pool occupancy + prefix-index gauges (telemetry only;
        recorded both as registry gauges and trace counter samples)."""
        a = self.cache_host.allocator
        self.obs.sample("pool", {
            "free": a.num_free, "live": a.num_live, "cached": a.num_cached,
            "held": a.num_held, "evictions": a.total_evictions,
            "cow_copies": self._c["cow_copies"].value,
            "degraded": 1.0 if self._degraded else 0.0})
        c = self.cache_host
        if c.prefix_caching:
            self.obs.sample("prefix", {
                "lookups": c.prefix_lookups, "hits": c.prefix_hits,
                "hit_rate": c.prefix_hits / max(c.prefix_lookups, 1)})
        # host bubble fraction: the share of step wall spent blocked in the
        # fetch's wait (lockstep: about the device time a step waits for;
        # the async overlap shrinks it)
        hists = self.obs.registry.histograms
        step_h = hists.get("phase/step")
        if step_h is not None and step_h.total > 0:
            sync_h = hists.get("phase/sync")
            self.obs.sample("engine", {
                "bubble_fraction": (sync_h.total / step_h.total)
                if sync_h is not None else 0.0})

    @torch.no_grad()
    def step(self) -> list[RequestState]:
        """One lockstep engine step: schedule, run prefill chunks + the
        decode (or draft/verify) batch, fetch the results in one transfer,
        fold them back.  Any async-pipelined step still in flight
        reconciles first, so mixed ``step``/``step_async`` driving stays
        safe."""
        with self._phase("step"):
            self._fault_tick()
            self._expire_deadlines()
            self._degrade_tick()
            # audit BEFORE dispatch: corruption is caught before the next
            # step's plan and kernels consume it, so recovery can still
            # rebuild without a corrupt-table step having committed wrong
            # tokens
            self._audit_maybe()
            if self._pending is not None:
                rec, self._pending = self._pending, None
                self._reconcile(rec)
            rec = self._submit_step()
            if rec is not None:
                self._reconcile(rec)
            self._idle_release_holds()
        if self.obs.enabled:
            self._sample_gauges()
        return rec.running if rec is not None else []

    @torch.no_grad()
    def step_async(self) -> list[RequestState]:
        """One double-buffered engine step: while the previous step's device
        work is in flight, predict its host fold (decode growth is
        deterministic; only sampled *values* are unknown), plan and
        dispatch the next step from that predicted state — feeding
        still-unfetched tokens device-to-device — then reconcile the
        previous step on its (now overlapped) wait.  Falls back to lockstep
        when prediction is unsafe: speculative decode or possible
        preemption (``_can_overlap``).  Returns the set the *submitted*
        step runs; its tokens fold one call later."""
        with self._phase("step"):
            out = self._step_async_host()
            self._idle_release_holds()
        if self.obs.enabled:
            self._sample_gauges()
        return out

    def _step_async_host(self) -> list[RequestState]:
        self._fault_tick()
        self._expire_deadlines()
        self._degrade_tick()
        self._audit_maybe()             # pre-dispatch, as in step()
        prev, self._pending = self._pending, None
        if prev is not None and self._can_overlap(prev):
            # the overlap phase measures exactly the host work hidden under
            # the in-flight device step
            with self._phase("overlap"):
                self._predict_fold(prev)
                rec = self._submit_step(prev=prev)
            self._reconcile(prev, newer=rec)
            self._pending = rec
            return rec.running if rec is not None else []
        if prev is not None:              # lockstep fall-back: resolve
            self._reconcile(prev)         # the true state, then plan
        rec = self._submit_step()
        self._pending = rec
        return rec.running if rec is not None else []

    def _can_overlap(self, rec: _Inflight) -> bool:
        """Conservative gate for planning on predicted state, evaluated
        *before* the predicted plan mutates anything.  Overlap needs (a) no
        speculative decode — accepted-draft growth is variable, so the next
        plan depends on the unfetched acceptance counts — and (b) a proof
        the predicted scheduling round cannot preempt: every running slot's
        next-position growth must be backable from the free+evictable pool
        (preemption would re-prefill from ``seq``, which cannot include
        in-flight token values).  Admission, COW and retirement are all
        prediction-safe and stay overlapped."""
        if self.spec_active:
            return False
        cache = self.cache_host
        will_advance = {s.req.rid for s, _, _ in rec.decode_rows}
        need = 0
        for s in self.scheduler.running:
            nc = s.num_cached + (1 if s.req.rid in will_advance else 0)
            need += cache.blocks_needed(s.slot, nc + 1)
        return need <= cache.allocator.num_available

    def _predict_fold(self, rec: _Inflight) -> None:
        """Advance host cursors for a dispatched-but-unfetched step: the
        device KV writes are deterministic and have (logically) happened, so
        ``num_cached`` grows now; the sampled token *values* are still in
        flight and tracked as ``pending`` until reconcile materializes them.
        Rows cancelled by an earlier reconcile (mispredicted finish) are
        skipped entirely — their growth never existed."""
        rec.folded = True
        for s, _ in rec.pre_rows:
            if s.req.rid not in rec.cancelled:
                s.pending += 1
        for s, _, emit in rec.decode_rows:
            if s.req.rid in rec.cancelled:
                continue
            s.num_cached += 1
            if emit:
                s.pending += 1
            else:                         # still streaming known tokens
                self._c["prefill_tokens"].inc()

    def _submit_step(self, prev: _Inflight | None = None
                     ) -> _Inflight | None:
        """The step's host half: schedule, run COW copies, dispatch the
        prefill and decode (or draft/verify) device calls, start the fetch.
        Nothing here waits for the device.  With ``prev`` (async overlap),
        decode rows whose next token is still in flight read it straight
        from ``prev``'s device tensors."""
        spec_k = self.cfg.spec_k if self.spec_active else 0
        # degradation ladder: clamp the *planned* K to 1 under pressure
        # (cheapest cycles, least speculative pool reservation); the device
        # shapes stay (B, cfg.spec_k) by construction
        plan_spec_k = 1 if (spec_k > 1 and self._degraded) else spec_k
        with self._phase("plan"):
            while True:
                try:
                    plan = self.scheduler.plan_step(
                        self.cfg.chunk_size, self.cfg.prefill_budget,
                        plan_spec_k, self.cfg.spec_ema,
                        allow_admission=not self._draining)
                    break
                except OutOfBlocks:
                    # a lone running request outgrew the pool — recover
                    # instead of crashing the engine
                    if not self._unjam():
                        raise
        self._note_transitions(plan)
        if prev is not None:
            # _can_overlap proved the pool could back every growth
            assert not plan.preempted, \
                "overlap gate let a preemption through"
        running = plan.decode + [s for s, _ in plan.prefill]
        for s in running:
            self._admit_step.setdefault(s.req.rid, self._steps)
        if not running:
            return None

        for src, dst in plan.copies:          # copy-on-write pool copies
            self.cache = self._cow_impl(self.cache, int(src), int(dst))
            if spec_k:
                self.draft_cache = self._cow_impl(self.draft_cache,
                                                  int(src), int(dst))
            self._c["cow_copies"].inc()

        rec = _Inflight(plan=plan, running=running)
        self._pins = rec.pins
        if plan.prefill:
            sampled: list[RequestState] = []
            with self._phase("prefill_dispatch"):
                self._dispatch_prefill(plan, spec_k, rec.fetch, sampled)
            rec.pre_rows = [(s, s.slot) for s in sampled]
        if plan.decode:
            with self._phase("decode_dispatch"):   # plain, or draft+verify
                self._dispatch_decode(plan, spec_k, rec.fetch,
                                      rec.spec_meta, prev)
            if not (spec_k and plan.spec):
                # fold metadata, captured before anything moves: emit is
                # "the model just saw the last known token"
                rec.decode_rows = [(s, s.slot,
                                    s.num_cached == s.seq_len - 1)
                                   for s in plan.decode]
        for s, slot, emit in rec.decode_rows:
            if emit:
                rec.src[s.req.rid] = ("dec", slot)
        for s, slot in rec.pre_rows:
            rec.src[s.req.rid] = ("pre", slot)
        if rec.fetch:
            self._fetch_start(rec)
        return rec

    def _fetch_start(self, rec: _Inflight) -> None:
        """The fetch's first half, at dispatch: every int32 value the host
        needs is flattened into one tensor and its copy to the host is
        started.  On the card the copy lands in a pinned buffer with
        ``non_blocking=True`` and a CUDA event is recorded after it, so
        nothing here waits for the device."""
        names = sorted(rec.fetch)
        flat = torch.cat([rec.fetch[n].reshape(-1) for n in names])
        rec.layout = [(n, tuple(rec.fetch[n].shape)) for n in names]
        if flat.is_cuda:
            rec.host = torch.empty(flat.shape, dtype=flat.dtype,
                                   pin_memory=True)
            rec.host.copy_(flat, non_blocking=True)
            rec.event = torch.cuda.Event()
            rec.event.record(torch.cuda.current_stream(self.device))
        else:
            rec.host = flat.cpu()

    def _fetch(self, rec: _Inflight) -> dict[str, np.ndarray]:
        """The step's single device->host synchronization point, the fetch's
        second half: wait for the copy ``_fetch_start`` began, then read the
        buffer.  A retry after an injected sync error re-reads the same
        buffer, so a retried fetch is identical."""
        self._c["host_syncs"].inc()
        if self.faults is not None and \
                self.faults.fire("sync_error", self._steps) is not None:
            self._c["faults_injected"].inc()
            raise FaultError("injected device-sync error")
        if rec.event is not None:
            rec.event.synchronize()
        host = rec.host.numpy()
        out, o = {}, 0
        for n, shape in rec.layout:
            size = int(np.prod(shape))
            out[n] = host[o:o + size].reshape(shape)
            o += size
        return out

    def _reconcile(self, rec: _Inflight, newer: _Inflight | None = None
                   ) -> None:
        """The step's sync half: the ONE fetch's wait, then fold the fetched
        values into request state.  For a predict-folded record only token
        values materialize (``pending`` drains); otherwise this is the
        lockstep fold.  A token that finishes its request mid-pipeline
        (stop token, or a cancel that landed while the step flew) cancels
        the request's row in the ``newer`` in-flight record — the
        misprediction rollback."""
        with self._phase("sync"):             # the ONE fetch per step
            vals: dict | None = {}
            if rec.fetch:
                vals = None
                for attempt in range(1 + self._sync_retries):
                    try:
                        vals = self._fetch(rec)
                        break
                    except FaultError:
                        continue
                if vals is not None and attempt:
                    # transient sync failure, retried clean: the buffer is
                    # still alive, so the refetch reads identical values
                    self._c["recoveries"].inc()
        if vals is None:                      # persistent sync failure
            self._abort_step(rec, newer)
            return

        with self._phase("fold"):
            for s, slot in rec.pre_rows:
                if s.req.rid in rec.cancelled:
                    continue                  # predict skipped it entirely
                if rec.folded:
                    s.pending -= 1
                if s.stopped:                 # cancelled mid-flight: the
                    continue                  # sample is discarded
                self._append_sample(s, int(vals["pre"][slot]))
                if s.done:
                    self._cancel_inflight(s, newer)

            if "out" in vals:                 # spec cycles are lockstep
                self._fold_spec(rec.plan, vals["out"], vals["acc"],
                                rec.spec_meta)
            else:
                for s, slot, emit in rec.decode_rows:
                    if s.req.rid in rec.cancelled:
                        continue
                    if not rec.folded:
                        s.num_cached += 1
                        if not emit:          # still streaming known tokens
                            self._c["prefill_tokens"].inc()
                            continue
                    else:
                        if not emit:
                            continue          # counted at predict time
                        s.pending -= 1
                    if s.stopped:
                        continue
                    self._append_sample(s, int(vals["dec"][slot]))
                    if s.done:
                        self._cancel_inflight(s, newer)

            self._c["steps"].inc()
            self.scheduler.commit_progress()  # register newly-full blocks
            # commit_progress hashes s.seq[:num_cached], which clamps to
            # *known* tokens — blocks holding a pending token's KV only
            # register once its value materializes

    def _cancel_inflight(self, s: RequestState, rec: _Inflight | None
                         ) -> None:
        """Misprediction rollback: ``s`` just finished at reconcile, but the
        next step was already planned and dispatched from the predicted
        still-running state.  Discard its row in that record (the in-flight
        sample never folds; ``_predict_fold`` skips its growth) and hand
        back the blocks the predicted plan over-reserved — the same
        ``PagedCache.truncate`` rollback speculative decode uses; the slot's
        in-flight garbage KV write lands in a freed block that is re-written
        before any gated read (one stream orders them)."""
        rid = s.req.rid
        if rec is None or rid not in rec.src or rid in rec.cancelled:
            return
        rec.cancelled.add(rid)
        if s.slot >= 0:
            self.cache_host.truncate(s.slot, s.num_cached)

    def _dispatch_decode(self, plan, spec_k, fetch, spec_meta, prev=None
                         ) -> None:
        """Build the fixed-shape decode batch and launch either the plain
        decode step or the speculative draft/verify cycle.  Under async
        overlap, rows with a pending token take it from the previous step's
        device tensors with ``torch.where`` on the device (the token never
        passes through the host); the feed masks ride in the call's one
        upload."""
        B = self.cfg.max_seqs
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        active = np.zeros((B,), bool)
        feed = {"dec": np.zeros((B,), bool), "pre": np.zeros((B,), bool)}
        for s in plan.decode:
            if s.pending:
                src, pslot = prev.src[s.req.rid]
                assert pslot == s.slot     # no preemption while pending
                feed[src][s.slot] = True
            else:
                tokens[s.slot] = s.next_token
            positions[s.slot] = s.num_cached
            temps[s.slot] = s.req.temperature
            active[s.slot] = True
        # inactive slots write into the null block, not their tables
        tables = np.where(active[:, None], self.cache_host.tables, 0)
        if spec_k and plan.spec:
            fetch["out"], fetch["acc"] = self._spec_decode(
                plan, tokens, positions, temps, active, tables, spec_meta)
            return
        # only the recurrent state reads the mask: the dense step is sent
        # none, so it uploads and casts nothing more
        extra = [active] if self._recurrent else []
        feeds = [n for n in ("dec", "pre") if feed[n].any()]
        extra += [feed[n] for n in feeds]
        sampled = bool((temps > 0).any())
        if sampled:
            extra.append(temps.view(np.int32))
        tok, pos, tab, *rest = self._upload(tokens, positions, tables,
                                            *extra)
        act = rest.pop(0).bool() if self._recurrent else None
        for n in feeds:
            tok = torch.where(rest.pop(0).bool(), prev.fetch[n], tok)
        t_dev = rest.pop(0).view(torch.float32) if sampled else None
        logits, self.cache = self.model.paged_decode_step(
            self.params, self.cache, tok, pos, tab, act)
        self._c["decode_calls"].inc()
        fetch["dec"] = self._sample(logits, temps, t_dev)

    def _dispatch_prefill(self, plan, spec_k, fetch, sampled_prefills
                          ) -> None:
        """Every planned chunk rides ONE fixed-shape (max_seqs, C) call (and,
        in spec mode, one draft call over the same chunk, which the draft
        attends over later).  Rows with valid == 0 are idle: K/V writes
        land in the null block."""
        B, C = self.cfg.max_seqs, self.cfg.chunk_size
        toks = np.zeros((B, C), np.int32)
        pos = np.zeros((B, C), np.int32)
        valid = np.zeros((B,), np.int32)
        ptemps = np.zeros((B,), np.float32)
        pref_active = np.zeros((B,), bool)
        for s, n in plan.prefill:
            seq = s.seq
            toks[s.slot, :n] = seq[s.num_cached:s.num_cached + n]
            pos[s.slot] = s.num_cached + np.arange(C, dtype=np.int32)
            valid[s.slot] = n
            ptemps[s.slot] = s.req.temperature
            pref_active[s.slot] = True
        ptables = np.where(pref_active[:, None], self.cache_host.tables, 0)
        slots = np.arange(B, dtype=np.int32)
        sampled = bool((ptemps > 0).any())
        args = self._upload(toks, pos, slots, ptables, valid,
                            *([ptemps.view(np.int32)] if sampled else []))
        t_dev = args.pop().view(torch.float32) if sampled else None
        logits, self.cache = self.model.paged_prefill_step(
            self.params, self.cache, *args)
        self._c["prefill_calls"].inc()
        nxt = self._sample(logits, ptemps, t_dev)
        if spec_k:                        # keep the draft pool in step; its
            # logits are discarded (the reference's jit drops them unused)
            _, self.draft_cache = self.draft_model.paged_prefill_step(
                self.draft_params, self.draft_cache, *args)
        for s, n in plan.prefill:
            if self.obs.enabled and s.req.rid not in self._chunked:
                self._chunked.add(s.req.rid)
                self.obs.event("first_chunk", s.req.rid)
            if spec_k:
                s.draft_cached = s.num_cached + n
            covered_last = s.num_cached + n == s.seq_len
            s.num_cached += n
            self._c["prefill_chunks"].inc()
            self._c["prefill_tokens"].inc(n - (1 if covered_last else 0))
            if covered_last:              # chunk saw the last known token
                sampled_prefills.append(s)
        if sampled_prefills:
            fetch["pre"] = nxt

    def _spec_decode(self, plan, tokens, positions, temps, active, tables,
                     spec_meta):
        """Device calls for one speculative cycle: the K-step draft loop,
        then the single multi-token verify, all fed by one upload.  Returns
        the device tensors (out_tokens, n_acc) for the step's one fetch."""
        B, K = self.cfg.max_seqs, self.cfg.spec_k
        forced = np.zeros((B, K), np.int32)
        known_len = np.ones((B,), np.int32)
        start_pos = positions.copy()
        valid = active.astype(np.int32)       # plain decode rows: 1 row
        ncand = np.zeros((B,), np.int32)
        for s in plan.spec:
            seq = s.seq
            gap = s.num_cached - s.draft_cached
            kl = min(gap + 1, K)
            forced[s.slot, :kl] = seq[s.draft_cached:s.draft_cached + kl]
            known_len[s.slot] = kl
            start_pos[s.slot] = s.draft_cached
            # dynamic K (spec_ema > 0) or the degradation ladder: the
            # scheduler planned (and block-reserved) k_s <= K candidates
            # for this slot; the device shapes stay (B, K) — surplus draft
            # positions land in the null block and the verify mask
            # discards them
            k_s = s.spec_k_plan or K
            m = max(0, k_s - gap)             # candidates this cycle
            ncand[s.slot] = m
            valid[s.slot] = max(1, m)         # verify rows consumed
            spec_meta.append((s, m, K))
        tok, pos, tab, frc, kl_d, sp, slots, va, nc, tbits = self._upload(
            tokens, positions, tables, forced, known_len, start_pos,
            np.arange(B, dtype=np.int32), valid, ncand, temps.view(np.int32))
        t_dev = tbits.view(torch.float32)
        cand, qprobs = self._draft_impl(frc, kl_d, sp, tab, temps, t_dev)
        out, n_acc = self._verify_impl(tok, cand, qprobs, pos, slots, tab,
                                       va, nc, temps, t_dev)
        self._c["spec_cycles"].inc()
        return out, n_acc

    def _fold_spec(self, plan, out, n_acc, spec_meta) -> None:
        """Fold one speculative cycle back into request state: append the
        accepted tokens + the replacement (or plain-decode) token, advance
        cursors, roll rejected KV positions back in the host block
        tables."""
        drafted = {s.req.rid: (n_cand, k) for s, n_cand, k in spec_meta}
        for s in plan.decode:
            a = int(n_acc[s.slot])
            n_cand, k = drafted.get(s.req.rid, (0, 0))
            assert a <= n_cand
            was_decode = s.num_cached == s.seq_len - 1
            if not was_decode:                # token-by-token prefill row
                s.num_cached += 1
                self._c["prefill_tokens"].inc()
                continue
            draft_start = s.draft_cached
            # the a accepted drafts, plus the rejection replacement (or the
            # plain-decode sample); full acceptance emits exactly a — the
            # would-be bonus arrives as the next cycle's row 0
            emit = a + (1 if (a < n_cand or n_cand == 0) else 0)
            for j in range(emit):
                s.num_cached += 1
                self._append_sample(s, int(out[s.slot, j]))
                if s.done:
                    break
            if k:
                s.draft_cached = min(draft_start + k, s.num_cached)
                s.spec_proposed += n_cand
                s.spec_accepted += a
                self._c["spec_proposed"].inc(n_cand)
                self._c["spec_accepted"].inc(a)
                if n_cand:
                    # acceptance histograms (telemetry only): accepted
                    # drafts per cycle in [0, K], and the cycle's rate
                    self.obs.observe(
                        "spec/accepted_per_cycle", a,
                        buckets=tuple(float(i)
                                      for i in range(self.cfg.spec_k + 1)))
                    self.obs.observe(
                        "spec/acceptance_rate", a / n_cand,
                        buckets=tuple(i / 10 for i in range(11)))
                if self.cfg.spec_ema > 0 and n_cand:
                    # dynamic K: fold this cycle's acceptance rate into the
                    # slot's EMA; the next plan_step clamps its K to
                    # ceil(ema * spec_k) in [1, spec_k]
                    al = self.cfg.spec_ema
                    s.spec_ema = (1 - al) * s.spec_ema + al * (a / n_cand)
                # rollback: rejected speculative positions release their
                # surplus blocks; the commit cursor rewinds with them
                self.cache_host.truncate(s.slot, s.num_cached)

    # ----- fault tolerance -----
    def _fault_tick(self) -> None:
        """Per-step fault hook: release expired injected holds, then let the
        injector fire the step-scoped kinds (crash / slow_step /
        alloc_hold).  One list check + one attribute check when idle."""
        self._tick += 1
        if self._fault_held:
            a = self.cache_host.allocator
            keep = []
            for rel, blocks in self._fault_held:
                if self._tick >= rel:
                    a.unhold(blocks)
                else:
                    keep.append((rel, blocks))
            self._fault_held = keep
        if self.faults is None:
            return
        f = self.faults.fire("crash", self._steps)
        if f is not None:
            self._c["faults_injected"].inc()
            raise CrashError(f"injected crash at step {self._steps}")
        f = self.faults.fire("slow_step", self._steps)
        if f is not None:
            self._c["faults_injected"].inc()
            time.sleep(f.delay_s)
        f = self.faults.fire("alloc_hold", self._steps)
        if f is not None:
            self._c["faults_injected"].inc()
            a = self.cache_host.allocator
            n = f.blocks or max(1, a.num_available // 2)
            held = a.hold(n)
            if held:
                self._fault_held.append(
                    (self._tick + max(1, f.hold_steps), held))

    def _idle_release_holds(self) -> None:
        """Injected holds simulate pool pressure DURING serving; when a step
        leaves the engine idle (no work, nothing in flight) the pressure is
        moot and outstanding holds are handed back — a hold outliving the
        last request would read as a real block leak."""
        if self._fault_held and not self.scheduler.has_work \
                and self._pending is None:
            a = self.cache_host.allocator
            for _, blocks in self._fault_held:
                a.unhold(blocks)
            self._fault_held = []

    def _abort_step(self, rec: _Inflight, newer: _Inflight | None) -> None:
        """A step's fetch failed past every retry.  Recovery splits on
        pipeline position:

        - *lockstep* (not predict-folded): no host cursor moved and the
          device KV writes are idempotent, so the step simply never
          happened.  Sampled-prefill rows rewind their cursors to re-feed
          the last prompt token; speculative reservations are handed back.
          The redone step is byte-identical at temperature 0 (greedy
          sampling draws nothing; at temperature > 0 the redo legitimately
          re-draws).
        - *folded* (async overlap): the next step already consumed this
          step's device outputs, and the lost sample values cannot be
          recovered — the rows that were waiting on them fail cleanly
          (finish_reason "error", rolled out of the newer record), while
          every non-emitting row keeps its deterministic growth."""
        self._c["recoveries"].inc()
        if not rec.folded:
            for s, _, _ in rec.spec_meta:
                if not s.done and s.slot >= 0:
                    self.cache_host.truncate(s.slot, s.num_cached + 1)
            for s, _ in rec.pre_rows:
                if s.slot >= 0:
                    s.num_cached = min(s.num_cached, s.seq_len - 1)
                    s.draft_cached = min(s.draft_cached,
                                         max(s.num_cached, 0))
            return
        for s, _ in rec.pre_rows:
            if s.req.rid in rec.cancelled:
                continue
            s.pending -= 1
            if not s.stopped:
                self._finish_early(s, "error")
            self._cancel_inflight(s, newer)
        for s, _, emit in rec.decode_rows:
            if s.req.rid in rec.cancelled or not emit:
                continue
            s.pending -= 1
            if not s.stopped:
                self._finish_early(s, "error")
            self._cancel_inflight(s, newer)
        self._c["steps"].inc()

    def _audit_maybe(self) -> None:
        """Runtime invariant auditing (ServeConfig.audit_level): run the
        property-test conservation oracle as a production defense.  On a
        violation, quarantine into the recover path instead of silently
        serving from corrupt state.  "off" costs one string compare."""
        lvl = self.cfg.audit_level
        if lvl == "off":
            return
        if self._steps % self.cfg.audit_interval:
            return
        try:
            with self._phase("audit"):
                if lvl == "alloc":
                    self.cache_host.allocator.check()
                else:
                    self.cache_host.check()
        except AssertionError as e:
            self._c["audit_violations"].inc()
            try:
                self._recover()
            except AssertionError:
                raise AuditViolation(
                    f"invariant audit failed and recovery did not "
                    f"converge: {e}") from e

    def _recover(self) -> None:
        """Quarantine-and-recover: rebuild every derived host structure from
        the authoritative per-slot ownership, fail the requests whose
        bookkeeping cannot be trusted, and resume.

        The in-flight async step (if any) is discarded — its fetch metadata
        may describe the corrupt state — and predicted growth rolls back to
        known tokens; device KV for those positions is rewritten
        idempotently when the requests re-plan (after the discarded step's
        writes: one stream orders them)."""
        self._c["recoveries"].inc()
        self._pending = None
        cache, sched = self.cache_host, self.scheduler
        for s in list(sched.running) + list(sched.waiting):
            s.pending = 0
        cache.rebuild()
        seen: dict[int, RequestState] = {}
        for s in sorted(list(sched.running), key=lambda r: r.req.rid):
            dup = not (0 <= s.slot < cache.max_seqs) or s.slot in seen
            if dup:
                # an invalid or contested slot: the request's blocks are
                # not distinguishable from its neighbor's — fail without
                # releasing (the slot's owner keeps it)
                self._fail_running(s, "error", release=False)
                continue
            seen[s.slot] = s
            cap = len(cache._owned[s.slot]) * cache.block_size
            tgt = max(0, min(s.num_cached, len(s.seq) - 1))
            if tgt > cap:
                # ownership cannot back the KV the cursor claims — the
                # history is gone, fail cleanly and free what's left
                self._fail_running(s, "error", release=True)
                continue
            s.num_cached = tgt
            s.draft_cached = min(s.draft_cached, tgt)
        # the free-slot stack is derived state too: recompute from the
        # surviving running set (descending, preserving LIFO admission)
        used = {s.slot for s in sched.running}
        sched._free_slots = [sl for sl in range(cache.max_seqs - 1, -1, -1)
                             if sl not in used]
        cache.check()                   # recovery must converge

    def _fail_running(self, s: RequestState, reason: str,
                      release: bool = True) -> None:
        """Fail one running request outside a scheduling round: finish it,
        move it straight to the finished list, optionally release its
        slot's blocks (recovery recomputes the free-slot stack itself)."""
        self._finish_early(s, reason)
        self.scheduler.running.remove(s)
        self.scheduler.finished.append(s)
        if release and 0 <= s.slot < self.cache_host.max_seqs:
            self.cache_host.release(s.slot)
        s.slot = -1

    def _unjam(self) -> bool:
        """``plan_step`` hit OutOfBlocks growing a lone running request.
        Release emergency resources instead of crashing the engine: injected
        holds go back first; failing that, the youngest running request
        fails cleanly ("error").  Returns False when nothing is left to
        give — the caller re-raises."""
        self._c["recoveries"].inc()
        if self._fault_held:
            a = self.cache_host.allocator
            for _, blocks in self._fault_held:
                a.unhold(blocks)
            self._fault_held = []
            return True
        live = [s for s in self.scheduler.running if not s.done]
        if not live:
            return False
        victim = max(live, key=lambda s: s.req.rid)
        self._finish_early(victim, "error")
        return True

    def _degrade_tick(self) -> None:
        """Graceful degradation under sustained pool pressure.  Pressure =
        available blocks below ``pressure_threshold`` of the pool, or a full
        waiting queue; ``pressure_window`` consecutive pressured (calm)
        steps engage (disengage) the ladder: shed waiting requests older
        than ``shed_queue_age_s`` (finish_reason "shed" — a retriable
        rejection), clamp the planned speculative K to 1, and pause
        prefix-cache admission."""
        if not self.cfg.degrade:
            return
        a = self.cache_host.allocator
        usable = max(a.num_blocks - 1, 1)
        pressured = (a.num_available < self.cfg.pressure_threshold * usable
                     or (self.cfg.max_waiting > 0 and
                         len(self.scheduler.waiting) >=
                         self.cfg.max_waiting))
        if pressured:
            self._pressure_run += 1
            self._calm_run = 0
        else:
            self._calm_run += 1
            self._pressure_run = 0
        if not self._degraded and \
                self._pressure_run >= self.cfg.pressure_window:
            self._degraded = True
        elif self._degraded and self._calm_run >= self.cfg.pressure_window:
            self._degraded = False
        self.cache_host.admission_paused = self._degraded
        if self._degraded and self.cfg.shed_queue_age_s > 0 \
                and self.scheduler.waiting:
            now = time.time()
            for s in [w for w in self.scheduler.waiting if not w.done]:
                born = self._submit_wall.get(s.req.rid, now)
                if now - born > self.cfg.shed_queue_age_s:
                    self._c["requests_shed"].inc()
                    self._finish_early(s, "shed")
                    self.scheduler.drop_waiting(s)

    def drain(self, timeout_s: float | None = None
              ) -> dict[int, FinishedRequest]:
        """Graceful shutdown: stop admitting waiting requests, run every
        already-admitted request to completion (reconciling any in-flight
        async step), and return the drained records.  Waiting requests stay
        queued — a snapshot taken after ``drain()`` preserves them for a
        restored engine to serve.  ``add_request`` raises EngineOverloaded
        while draining; ``reset()`` clears the state.

        ``timeout_s`` (default ``cfg.drain_timeout_s``; 0 = unbounded)
        deadlines the drain: requests still running when it expires are
        force-preempted into the waiting queue as waiting-with-prefix
        (prompt + generated tokens ride along for recompute on
        re-admission), so one hung or long-tailed request cannot stall a
        rolling restart forever.  Nothing is failed — the preempted
        requests survive into the snapshot."""
        if timeout_s is None:
            timeout_s = self.cfg.drain_timeout_s
        deadline = time.time() + timeout_s if timeout_s > 0 else None
        self._draining = True
        step = self.step_async if self.cfg.async_step else self.step
        while self.scheduler.running or self.pending_step:
            if deadline is not None and time.time() >= deadline:
                self._force_preempt_running()
                break
            step()
        return self.pop_finished()

    def _force_preempt_running(self) -> None:
        """Drain-deadline enforcement: reconcile any in-flight step, then
        preempt every unfinished running request back to the waiting queue —
        exactly the recompute preemption pool pressure applies, so the
        requests stay byte-identically resumable.  Oldest requests end up
        at the queue's head (FCFS is preserved)."""
        if self._pending is not None:
            rec, self._pending = self._pending, None
            self._reconcile(rec)
        self.scheduler.retire_finished()
        now = time.time()
        for s in sorted(self.scheduler.running,
                        key=lambda r: r.req.rid, reverse=True):
            self.scheduler._preempt(s)
            self._preempt_wall[s.req.rid] = now
            self.obs.event("preempt", s.req.rid)
        self._idle_release_holds()

    def snapshot(self) -> dict:
        """Serialize full host state + device pools
        (``repro_torch.serve.snapshot``).  Any in-flight async step is
        reconciled first so the captured state has no pending tokens."""
        from repro_torch.serve import snapshot as _snap
        if self._pending is not None:
            rec, self._pending = self._pending, None
            self._reconcile(rec)
        return _snap.capture(self)

    def restore(self, snap: dict) -> None:
        """Restore a snapshot produced by a config-identical engine; the
        restored engine resumes byte-identically."""
        from repro_torch.serve import snapshot as _snap
        _snap.restore_into(self, snap)

    # ----- results -----
    def _record(self, s: RequestState) -> FinishedRequest:
        """One finished request's result + latency record, built from the
        per-rid wall clocks."""
        rid = s.req.rid
        sub = self._submit_wall.get(rid)
        ft = self._first_tok_wall.get(rid)
        lt = self._last_tok_wall.get(rid)
        n = len(s.generated)
        return FinishedRequest(
            rid=rid, prompt=s.req.prompt, tokens=list(s.generated),
            preemptions=s.preemptions,
            steps=(self._finish_step.get(rid, self._steps)
                   - self._admit_step.get(rid, 0)),
            ttft_s=(max(ft - sub, 0.0)
                    if sub is not None and ft is not None else 0.0),
            queue_wait_s=self._queue_wait.get(rid, 0.0),
            preempt_stall_s=self._preempt_stall.get(rid, 0.0),
            tpot_s=(max(lt - ft, 0.0) / (n - 1)
                    if n > 1 and ft is not None and lt is not None else 0.0),
            spec_proposed=s.spec_proposed,
            spec_accepted=s.spec_accepted,
            finish_reason=s.finish_reason or
            ("stop" if s.stopped else "length"))

    def _forget_rid(self, rid: int) -> None:
        """Retire one drained request's per-rid host bookkeeping — a
        long-lived server would otherwise grow these dicts with every
        request it ever served."""
        for d in (self._admit_step, self._finish_step, self._submit_wall,
                  self._first_tok_wall, self._last_tok_wall,
                  self._queue_wait, self._preempt_wall,
                  self._preempt_stall, self._deadline, self._on_token):
            d.pop(rid, None)
        self._chunked.discard(rid)

    def finished(self) -> dict[int, FinishedRequest]:
        """Records for every request finished so far (manual ``step()``
        driving included).  Non-destructive: latency fields are only valid
        for requests not yet drained by ``run()`` / ``pop_finished()``."""
        return {s.req.rid: self._record(s) for s in self.scheduler.finished}

    def pop_finished(self) -> dict[int, FinishedRequest]:
        """Drain finished requests destructively: build each record, then
        retire its per-rid bookkeeping and the scheduler's finished list.
        Long-lived manual-stepping servers call this instead of
        ``finished()`` so host memory stays bounded by requests in flight,
        not requests ever served."""
        recs = {s.req.rid: self._record(s)
                for s in self.scheduler.finished}
        for rid in recs:
            self._forget_rid(rid)
        self.scheduler.finished.clear()
        self._drained = 0
        return recs

    def run(self, requests: Iterable[dict[str, Any]] | None = None,
            stop_when=None
            ) -> tuple[dict[int, FinishedRequest], dict[str, float]]:
        """Drive until the queue drains (the ``step_async`` pipeline when
        ``cfg.async_step``).  Returns ({rid: result}, stats); drained
        requests' per-rid wall clocks are retired with their records.
        ``stop_when()`` (checked between steps) ends the drive early — the
        signal-driven drain of ``launch/serve.py`` uses it.  Every step's
        fetch waits for its device work, so the wall time covers it."""
        if requests:
            for r in requests:
                self.add_request(**r)
        # registry snapshot so repeated run() calls report THIS drain only;
        # the drained boundary (not len(finished) at entry) so requests
        # cancelled between runs still report here
        c0 = self.obs.registry.counter_values("serve/")
        fin0 = self._drained
        step = self.step_async if self.cfg.async_step else self.step
        t0 = time.time()
        while self.scheduler.has_work or self.pending_step:
            if stop_when is not None and stop_when():
                break
            step()
        dt = time.time() - t0

        out = {s.req.rid: self._record(s)
               for s in self.scheduler.finished[fin0:]}
        self._drained = len(self.scheduler.finished)
        for rid in out:
            self._forget_rid(rid)
        d = {k: float(c.value - c0["serve/" + k])
             for k, c in self._c.items()}
        dec, pre = d["decode_tokens"], d["prefill_tokens"]
        prop, acc = d["spec_proposed"], d["spec_accepted"]
        ttfts = [r.ttft_s for r in out.values()]
        stats = {
            "wall_s": dt,
            "steps": d["steps"],
            "decode_tokens": dec,
            "prefill_tokens": pre,
            "decode_tok_per_s": dec / max(dt, 1e-9),
            "total_tok_per_s": (dec + pre) / max(dt, 1e-9),
            "prefill_chunks": d["prefill_chunks"],
            "cow_copies": d["cow_copies"],
            "host_syncs": d["host_syncs"],
            "spec_cycles": d["spec_cycles"],
            "spec_proposed": prop,
            "spec_accepted": acc,
            "spec_acceptance": acc / prop if prop else 0.0,
            "decode_calls": d["decode_calls"],
            "prefill_calls": d["prefill_calls"],
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "faults_injected": d["faults_injected"],
            "recoveries": d["recoveries"],
            "requests_shed": d["requests_shed"],
            "audit_violations": d["audit_violations"],
            "callback_errors": d["callback_errors"],
        }
        return out, stats
