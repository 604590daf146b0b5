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

Device placement: the engine runs on the CUDA device unless the caller asks
for ``device="cpu"``; without CUDA and without that request it raises.  The
pools are updated in place by the model steps (where the reference donates
buffers to its jitted steps).

Recurrent families (ssm): every paged step carries the ``active`` mask, so
slots that are idle or mid-prefill keep their SSM/conv state, and a slot
whose position is 0 starts from zero state (slot reuse).  Prefix caching is
gated off for them: recurrent state is per slot and cannot be rebuilt from
aliased KV blocks; there is no speculative path (no rewind of recurrent
state), and ``can_handoff_blocks`` is False.

Not in this module yet (later slices of the port): speculative decoding,
the double-buffered ``step_async``, fault injection / audits / degradation,
snapshots, cluster hand-off, meshes and telemetry.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import CACHE_DTYPES
from repro_torch.serve.kv_cache import PagedCache
from repro_torch.serve.scheduler import FCFSScheduler, Request, RequestState

# engine run counters; the keys double as the delta-stat names run() reports
_RUN_COUNTERS = ("steps", "decode_tokens", "prefill_tokens",
                 "prefill_chunks", "cow_copies", "host_syncs",
                 # device calls made (each runs every layer once)
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
    finish_reason: str = "length"     # stop | length


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


class Engine:
    def __init__(self, model, params, cfg: ServeConfig | None = None,
                 device=None):
        if not model.cfg.has_decode:
            raise ValueError(f"{model.cfg.name} has no decode path")
        if model.cfg.family == "vlm":
            raise ValueError("vlm serving needs patch prefill (not supported)")
        self.device = resolve_device(device)
        leaf = _first_leaf(params)
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine "
                             f"runs on {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg or ServeConfig()
        if self.cfg.cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype {self.cfg.cache_dtype!r} "
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
        self._c = dict.fromkeys(_RUN_COUNTERS, 0)
        self._admit_step: dict[int, int] = {}
        self._finish_step: dict[int, int] = {}
        # per-request wall clocks (the latency fields on FinishedRequest)
        self._submit_wall: dict[int, float] = {}
        self._first_tok_wall: dict[int, float] = {}
        self._last_tok_wall: dict[int, float] = {}
        self._queue_wait: dict[int, float] = {}
        self._preempt_wall: dict[int, float] = {}
        self._preempt_stall: dict[int, float] = {}
        self._drained = 0    # scheduler.finished entries already reported

    # ----- device steps -----
    def _sample(self, logits: torch.Tensor, temps: np.ndarray
                ) -> torch.Tensor:
        """Greedy rows take the argmax; rows with temperature > 0 draw from
        ``softmax(logits / T)`` with the engine's generator.  ``temps`` is
        the host copy, so an all-greedy batch draws nothing."""
        greedy = logits.argmax(dim=-1)
        if not (temps > 0).any():
            return greedy.to(torch.int32)
        t = torch.from_numpy(temps).to(logits.device)
        probs = torch.softmax(logits.float() / t.clamp(min=1e-6)[:, None],
                              dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(t > 0, sampled, greedy).to(torch.int32)

    def _cow_impl(self, cache: dict, src: int, dst: int) -> dict:
        # scale pools COW in lockstep with their KV pools: a copied block
        # is meaningless without the scales its bytes were written under
        for name in _POOL_KEYS:
            if name in cache:
                cache[name][:, dst] = cache[name][:, src]
        return cache

    def _upload(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """One host->device copy for all of a device call's int32 operands:
        they are packed into one buffer and handed back as views."""
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
        return rid

    def _append_sample(self, s: RequestState, tok: int) -> None:
        self._c["decode_tokens"] += 1
        rid = s.req.rid
        now = time.time()
        if not s.generated:
            self._first_tok_wall[rid] = now
        self._last_tok_wall[rid] = now
        s.generated.append(tok)
        if tok in s.req.stop_tokens:
            s.stopped = True
            s.finish_reason = "stop"
        if s.done:
            if not s.finish_reason:
                s.finish_reason = "length"
            self._finish_step[rid] = self._c["steps"] + 1

    def _note_transitions(self, plan) -> None:
        """Queue-wait / preemption-stall wall clocks for this scheduling
        round, surfaced on FinishedRequest."""
        if not (plan.admitted or plan.preempted):
            return
        now = time.time()
        for s in plan.preempted:
            self._preempt_wall[s.req.rid] = now
        for s in plan.admitted:
            rid = s.req.rid
            t0 = self._preempt_wall.pop(rid, None)
            if t0 is not None:                # back from eviction
                self._preempt_stall[rid] = \
                    self._preempt_stall.get(rid, 0.0) + (now - t0)
            else:
                self._queue_wait.setdefault(
                    rid, now - self._submit_wall.get(rid, now))

    @torch.no_grad()
    def step(self) -> list[RequestState]:
        """One lockstep engine step: schedule, run prefill chunks + the
        decode batch, fetch the results in one transfer, fold them back."""
        rec = self._submit_step()
        if rec is not None:
            self._reconcile(rec)
            return rec["running"]
        return []

    def _submit_step(self) -> dict | None:
        """The step's host half: schedule, run COW copies, dispatch the
        prefill and decode device calls.  Nothing here waits for the
        device."""
        plan = self.scheduler.plan_step(self.cfg.chunk_size,
                                        self.cfg.prefill_budget)
        self._note_transitions(plan)
        running = plan.decode + [s for s, _ in plan.prefill]
        for s in running:
            self._admit_step.setdefault(s.req.rid, self._c["steps"])
        if not running:
            return None

        for src, dst in plan.copies:          # copy-on-write pool copies
            self.cache = self._cow_impl(self.cache, int(src), int(dst))
            self._c["cow_copies"] += 1

        rec: dict[str, Any] = {"plan": plan, "running": running,
                               "fetch": {}, "pre_rows": [],
                               "decode_rows": []}
        if plan.prefill:
            sampled: list[RequestState] = []
            self._dispatch_prefill(plan, rec["fetch"], sampled)
            rec["pre_rows"] = [(s, s.slot) for s in sampled]
        if plan.decode:
            self._dispatch_decode(plan, rec["fetch"])
            # fold metadata, captured before anything moves: emit is "the
            # model just saw the last known token"
            rec["decode_rows"] = [(s, s.slot, s.num_cached == s.seq_len - 1)
                                  for s in plan.decode]
        return rec

    def _fetch(self, fetch: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """The step's single device->host synchronization point: every
        value the host needs is stacked into one tensor and copied once."""
        self._c["host_syncs"] += 1
        names = sorted(fetch)
        host = torch.stack([fetch[n] for n in names]).cpu().numpy()
        return {n: host[i] for i, n in enumerate(names)}

    def _reconcile(self, rec: dict) -> None:
        """The step's sync half: the ONE fetch, then fold the fetched
        values into request state."""
        vals = self._fetch(rec["fetch"]) if rec["fetch"] else {}
        for s, slot in rec["pre_rows"]:
            self._append_sample(s, int(vals["pre"][slot]))
        for s, slot, emit in rec["decode_rows"]:
            s.num_cached += 1
            if not emit:                      # still streaming known tokens
                self._c["prefill_tokens"] += 1
                continue
            self._append_sample(s, int(vals["dec"][slot]))
        self._c["steps"] += 1
        self.scheduler.commit_progress()      # register newly-full blocks

    def _dispatch_decode(self, plan, fetch) -> None:
        """Build the fixed-shape decode batch and launch the decode step."""
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
        # only the recurrent state reads the mask: the dense step is sent
        # none, so it uploads and casts nothing more
        recur = (active,) if self._recurrent else ()
        tok, pos, tab, *act = self._upload(tokens, positions, tables, *recur)
        logits, self.cache = self.model.paged_decode_step(
            self.params, self.cache, tok, pos, tab,
            act[0].bool() if act else None)
        self._c["decode_calls"] += 1
        fetch["dec"] = self._sample(logits, temps)

    def _dispatch_prefill(self, plan, fetch, sampled_prefills) -> None:
        """Every planned chunk rides ONE fixed-shape (max_seqs, C) call.
        Rows with valid == 0 are idle: K/V writes land in the null block."""
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
        d_toks, d_pos, d_slots, d_tab, d_valid = self._upload(
            toks, pos, slots, ptables, valid)
        logits, self.cache = self.model.paged_prefill_step(
            self.params, self.cache, d_toks, d_pos, d_slots, d_tab, d_valid)
        self._c["prefill_calls"] += 1
        nxt = self._sample(logits, ptemps)
        for s, n in plan.prefill:
            covered_last = s.num_cached + n == s.seq_len
            s.num_cached += n
            self._c["prefill_chunks"] += 1
            self._c["prefill_tokens"] += n - (1 if covered_last else 0)
            if covered_last:              # chunk saw the last known token
                sampled_prefills.append(s)
        if sampled_prefills:
            fetch["pre"] = nxt

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
            steps=(self._finish_step.get(rid, self._c["steps"])
                   - self._admit_step.get(rid, 0)),
            ttft_s=(max(ft - sub, 0.0)
                    if sub is not None and ft is not None else 0.0),
            queue_wait_s=self._queue_wait.get(rid, 0.0),
            preempt_stall_s=self._preempt_stall.get(rid, 0.0),
            tpot_s=(max(lt - ft, 0.0) / (n - 1)
                    if n > 1 and ft is not None and lt is not None else 0.0),
            finish_reason=s.finish_reason or
            ("stop" if s.stopped else "length"))

    def _forget_rid(self, rid: int) -> None:
        """Retire one drained request's per-rid host bookkeeping."""
        for d in (self._admit_step, self._finish_step, self._submit_wall,
                  self._first_tok_wall, self._last_tok_wall,
                  self._queue_wait, self._preempt_wall,
                  self._preempt_stall):
            d.pop(rid, None)

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
        c0 = dict(self._c)
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
        d = {k: float(self._c[k] - c0[k]) for k in _RUN_COUNTERS}
        dec, pre = d["decode_tokens"], d["prefill_tokens"]
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
            "decode_calls": d["decode_calls"],
            "prefill_calls": d["prefill_calls"],
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0,
        }
        return out, stats
