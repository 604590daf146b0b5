"""Continuous-batching inference engine over the paged KV cache — the
synchronous core of the reference's ``serve/engine.py``.

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
nothing.

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
prefill dispatch / decode-or-spec dispatch / the one fetch / fold), request
lifecycle spans, TTFT and inter-token histograms, pool gauges and the
speculative acceptance histograms.  All of it is host clocks around calls
the engine makes anyway: no device synchronization is added, nothing
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

Not in this module yet (later slices of the port): the double-buffered
``step_async``, fault injection / audits / the degradation ladder,
snapshots, cluster hand-off and meshes.
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
from repro_torch.serve.kv_cache import PagedCache
from repro_torch.serve.scheduler import FCFSScheduler, Request, RequestState

# engine run counters, registry-backed (repro_torch.obs): the keys double as
# the delta-stat names run() reports, so stats are a diff of two snapshots
_RUN_COUNTERS = ("steps", "decode_tokens", "prefill_tokens",
                 "prefill_chunks", "cow_copies", "host_syncs",
                 "spec_cycles", "spec_proposed", "spec_accepted",
                 # target device calls made (each runs every layer once);
                 # a spec cycle adds K draft decode calls and one verify,
                 # and in spec mode every prefill call one draft prefill
                 "decode_calls", "prefill_calls")

# pool entries a copy-on-write block copy moves: KV plus the per-(token,
# head) scale pools sharing block addressing
_POOL_KEYS = ("k", "v", "k_scale", "v_scale")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
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

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_len // self.block_size)

    def pool_blocks(self) -> int:
        if self.num_blocks:
            return self.num_blocks
        # worst case every slot full, +1 for the reserved null block
        return self.max_seqs * self.blocks_per_seq + 1


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
    finish_reason: str = "length"     # stop | length


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


class Engine:
    def __init__(self, model, params, cfg: ServeConfig | None = None,
                 draft_model=None, draft_params=None,
                 telemetry: Telemetry | None = None, device=None):
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
        self._drained = 0    # scheduler.finished entries already reported

    # ----- device steps -----
    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                t_dev: torch.Tensor | None = None) -> torch.Tensor:
        """Greedy rows take the argmax; rows with temperature > 0 draw from
        ``softmax(logits / T)`` with the engine's generator.  ``temps`` is
        the host copy, so an all-greedy batch draws nothing; ``t_dev`` is
        its device copy where the caller uploaded one."""
        greedy = logits.argmax(dim=-1)
        if not (temps > 0).any():
            return greedy.to(torch.int32)
        t = torch.from_numpy(temps).to(logits.device) if t_dev is None \
            else t_dev
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
        (a float32 array rides as its bits): they are packed into one
        buffer and handed back as int32 views."""
        flat = np.concatenate([a.reshape(-1) for a in arrays]).astype(
            np.int32, copy=False)
        dev = torch.from_numpy(flat).to(self.device)
        out, o = [], 0
        for a in arrays:
            out.append(dev[o:o + a.size].view(a.shape))
            o += a.size
        return out

    # ----- request API -----
    def add_request(self, prompt: Iterable[int], max_new_tokens: int = 32,
                    temperature: float = 0.0,
                    stop_tokens: Iterable[int] = ()) -> int:
        """Queue one request; returns its rid.  Raises ValueError on
        degenerate requests (empty prompt, non-positive max_new_tokens,
        prompt+budget beyond capacity)."""
        rid = self._rid
        self.scheduler.add(Request(     # validates; raises before any
            rid=rid, prompt=tuple(int(t) for t in prompt),   # state lands
            max_new_tokens=max_new_tokens, temperature=temperature,
            stop_tokens=tuple(stop_tokens)))
        self._rid += 1
        self._submit_wall[rid] = time.time()
        self.obs.event("submit", rid)
        return rid

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
            "cow_copies": self._c["cow_copies"].value})
        c = self.cache_host
        if c.prefix_caching:
            self.obs.sample("prefix", {
                "lookups": c.prefix_lookups, "hits": c.prefix_hits,
                "hit_rate": c.prefix_hits / max(c.prefix_lookups, 1)})
        # host bubble fraction: the share of step wall spent blocked in the
        # one fetch (the device time a lockstep step waits for)
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
        fold them back."""
        with self._phase("step"):
            rec = self._submit_step()
            if rec is not None:
                self._reconcile(rec)
        if self.obs.enabled:
            self._sample_gauges()
        return rec["running"] if rec is not None else []

    def _submit_step(self) -> dict | None:
        """The step's host half: schedule, run COW copies, dispatch the
        prefill and decode (or draft/verify) device calls.  Nothing here
        waits for the device."""
        spec_k = self.cfg.spec_k if self.spec_active else 0
        with self._phase("plan"):
            plan = self.scheduler.plan_step(
                self.cfg.chunk_size, self.cfg.prefill_budget, spec_k,
                self.cfg.spec_ema)
        self._note_transitions(plan)
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

        rec: dict[str, Any] = {"plan": plan, "running": running,
                               "fetch": {}, "pre_rows": [],
                               "decode_rows": [], "spec_meta": []}
        if plan.prefill:
            sampled: list[RequestState] = []
            with self._phase("prefill_dispatch"):
                self._dispatch_prefill(plan, spec_k, rec["fetch"], sampled)
            rec["pre_rows"] = [(s, s.slot) for s in sampled]
        if plan.decode:
            with self._phase("decode_dispatch"):   # plain, or draft+verify
                self._dispatch_decode(plan, rec["fetch"], rec["spec_meta"])
            if not plan.spec:
                # fold metadata, captured before anything moves: emit is
                # "the model just saw the last known token"
                rec["decode_rows"] = [(s, s.slot,
                                       s.num_cached == s.seq_len - 1)
                                      for s in plan.decode]
        return rec

    def _fetch(self, fetch: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """The step's single device->host synchronization point: every
        int32 value the host needs is flattened into one tensor and copied
        once."""
        self._c["host_syncs"].inc()
        names = sorted(fetch)
        host = torch.cat([fetch[n].reshape(-1) for n in names]).cpu().numpy()
        out, o = {}, 0
        for n in names:
            size = fetch[n].numel()
            out[n] = host[o:o + size].reshape(tuple(fetch[n].shape))
            o += size
        return out

    def _reconcile(self, rec: dict) -> None:
        """The step's sync half: the ONE fetch, then fold the fetched
        values into request state."""
        with self._phase("sync"):
            vals = self._fetch(rec["fetch"]) if rec["fetch"] else {}
        with self._phase("fold"):
            for s, slot in rec["pre_rows"]:
                self._append_sample(s, int(vals["pre"][slot]))
            if "out" in vals:
                self._fold_spec(rec["plan"], vals["out"], vals["acc"],
                                rec["spec_meta"])
            for s, slot, emit in rec["decode_rows"]:
                s.num_cached += 1
                if not emit:                  # still streaming known tokens
                    self._c["prefill_tokens"].inc()
                    continue
                self._append_sample(s, int(vals["dec"][slot]))
            self._c["steps"].inc()
            self.scheduler.commit_progress()  # register newly-full blocks

    def _dispatch_decode(self, plan, fetch, spec_meta) -> None:
        """Build the fixed-shape decode batch and launch either the plain
        decode step or the speculative draft/verify cycle."""
        B = self.cfg.max_seqs
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        active = np.zeros((B,), bool)
        for s in plan.decode:
            tokens[s.slot] = s.next_token
            positions[s.slot] = s.num_cached
            temps[s.slot] = s.req.temperature
            active[s.slot] = True
        # inactive slots write into the null block, not their tables
        tables = np.where(active[:, None], self.cache_host.tables, 0)
        if plan.spec:
            fetch["out"], fetch["acc"] = self._spec_decode(
                plan, tokens, positions, temps, active, tables, spec_meta)
            return
        # only the recurrent state reads the mask: the dense step is sent
        # none, so it uploads and casts nothing more
        recur = (active,) if self._recurrent else ()
        tok, pos, tab, *act = self._upload(tokens, positions, tables, *recur)
        logits, self.cache = self.model.paged_decode_step(
            self.params, self.cache, tok, pos, tab,
            act[0].bool() if act else None)
        self._c["decode_calls"].inc()
        fetch["dec"] = self._sample(logits, temps)

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
        args = self._upload(toks, pos, slots, ptables, valid)
        logits, self.cache = self.model.paged_prefill_step(
            self.params, self.cache, *args)
        self._c["prefill_calls"].inc()
        nxt = self._sample(logits, ptemps)
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
            # dynamic K (spec_ema > 0): the scheduler planned (and block-
            # reserved) k_s <= K candidates for this slot; the device
            # shapes stay (B, K) — surplus draft positions land in the
            # null block and the verify mask discards them
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
        """Retire one drained request's per-rid host bookkeeping."""
        for d in (self._admit_step, self._finish_step, self._submit_wall,
                  self._first_tok_wall, self._last_tok_wall,
                  self._queue_wait, self._preempt_wall,
                  self._preempt_stall):
            d.pop(rid, None)
        self._chunked.discard(rid)

    def finished(self) -> dict[int, FinishedRequest]:
        """Records for every request finished so far (manual ``step()``
        driving included).  Non-destructive: latency fields are only valid
        for requests not yet drained by ``run()``."""
        return {s.req.rid: self._record(s) for s in self.scheduler.finished}

    def run(self, requests: Iterable[dict[str, Any]] | None = None
            ) -> tuple[dict[int, FinishedRequest], dict[str, float]]:
        """Drive until the queue drains.  Returns ({rid: result}, stats);
        drained requests' per-rid wall clocks are retired with their
        records.  Every step ends in the host fetch, so the wall time
        covers the device work."""
        if requests:
            for r in requests:
                self.add_request(**r)
        # registry snapshot so repeated run() calls report THIS drain only
        c0 = self.obs.registry.counter_values("serve/")
        fin0 = self._drained
        t0 = time.time()
        while self.scheduler.has_work:
            self.step()
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
        }
        return out, stats
