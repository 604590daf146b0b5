"""Serving CLI: continuous-batching engine over the paged KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 16 --prompt-len 32 --gen 32 \
      --max-seqs 8 --block-size 16 --chunk-size 32 --prefill-budget 64 \
      [--reduced] [--no-prefix-caching] [--temperature 0.8] \
      [--cache-dtype int8] [--prune-ratio 0.5 [--obspa]] [--device cpu]

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --spec-k 3 --draft-ratio 0.5 [--spec-ema 0.5] \
      [--draft-cache-dtype int8] [--metrics] [--trace-out t.json] --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --async-step [--audit-level full] [--degrade] \
      [--snapshot-out s.rsrv | --restore s.rsrv] --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --replicas 2 [--prefill-replicas 1] --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --mesh 1x1 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --reduced --mesh 2x2 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --reduced --prune-ratio 0.5 [--obspa] --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
      --reduced --prune-ratio 0.5 [--obspa] --device cpu

Runs on the CUDA device; ``--device cpu`` asks for the CPU explicitly (the
paged-attention kernel then gives way to its plain PyTorch version).  The
model is random-initialised from ``--seed``.

Prefill is chunked through ``paged_prefill_step`` (``--chunk-size`` tokens
per step per slot, ``--prefill-budget`` tokens per step across slots;
``--chunk-size 0`` restores token-by-token prefill), and requests sharing a
prompt prefix alias full KV blocks via refcounted prefix caching unless
``--no-prefix-caching``.

``--prune-ratio`` structurally prunes the model before serving it: by L1
magnitude per group (``core.pruner.prune_model``), or with ``--obspa`` by
OBSPA with data-free calibration (4 batches of 4 x ``--prompt-len`` uniform
tokens, the reference CLI's calibration), whose sweeps run the K4 kernel on
the card.  ``--arch mamba2-1.3b`` serves the ssm family and ``--arch
hymba-1.5b`` the hybrid one (no prefix caching for either: the recurrent
state is per slot); both prune by magnitude or by OBSPA, and the pruned
model's line prints its attention and SSM dims.  ``--arch qwen2-moe-a2.7b``
serves the moe family (routed experts with shared experts; the serving
steps pass their real tokens to the dispatch, so padding takes no expert
capacity), and a pruned model's line adds its expert count, expert width
and shared-expert width.

``--spec-k K`` serves with self-speculative decoding: the draft is the
served model L1-pruned at ``--draft-ratio`` (``prune_model``, per group), K
drafted tokens a cycle verified by the target in one multi-token pass
(``--spec-ema`` for a dynamic K, ``--draft-cache-dtype`` for a narrower
draft pool); it is gated off, with a message, for the ssm and hybrid
families.  ``--metrics`` turns telemetry on and prints the step-phase table
and the Prometheus text after the run; ``--trace-out PATH`` writes a
Chrome trace of it (load it in https://ui.perfetto.dev).

``--async-step`` drives the engine's double-buffered ``step_async``: step
N+1 is planned and dispatched while step N's device work is in flight
(outputs stay byte-identical at temperature 0).  ``--audit-level
{off,alloc,full}`` turns on runtime invariant auditing (allocator / full
cache conservation checked every ``--audit-interval`` steps, with
quarantine-and-recover on violation) and ``--degrade`` enables the
load-shedding ladder.

On SIGTERM/SIGINT the server drains gracefully: it stops admitting,
finishes in-flight requests, and — with ``--snapshot-out PATH`` — writes an
engine snapshot whose waiting queue a fresh process can resume
byte-identically via ``--restore PATH`` (which rebuilds the engine from the
snapshot's own ServeConfig; CLI engine flags are ignored).
``--drain-timeout S`` bounds any drain: stragglers past the deadline are
force-preempted back to the waiting queue instead of blocking shutdown.

``--replicas N`` (N > 1) serves behind a ``Cluster`` of N engine replicas
sharing the weights: least-loaded routing, tick heartbeats, failover by
block hand-off, and a rolling restart of every replica on SIGHUP (drain,
backlog re-homed, snapshot round-trip; zero failed requests); SIGTERM /
SIGINT drain every replica and exit.  ``--prefill-replicas M`` (M > 0)
disaggregates: M prefill-role replicas take the prompts and hand each
finished prompt's KV blocks to one of ``--replicas`` decode-role replicas.
The previous SIGTERM / SIGINT / SIGHUP handlers come back after the run.

``--mesh DxM`` (or ``auto``: every device on the data axis) serves over a
(data, model) mesh of the CUDA devices — with ``--device cpu``, over a
logical mesh of D·M shards of the one CPU device — and so does every
replica and a ``--restore``d engine: request slots data-parallel, pools
and heads tensor-parallel (``distributed.tensor_parallel``), for every
decoder family (dense, moe, ssm, hybrid); a mesh larger than the CUDA
devices fails with the reference's message.

``generate`` (sequential, token-by-token over a contiguous cache) is kept as
the correctness oracle the engine is tested against.
"""
from __future__ import annotations

import argparse
import math
import signal
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.models import build


@torch.no_grad()
def generate(model, params, prompt: torch.Tensor, gen_len: int,
             max_len: int | None = None) -> torch.Tensor:
    """Sequential greedy generation (reference implementation).

    prompt (B, P) int -> (B, P+gen_len).  The contiguous-cache,
    single-position decode loop the paged engine must match token-for-token.
    Runs on the device ``prompt`` lives on.
    """
    B, P = prompt.shape
    max_len = max_len or (P + gen_len)
    cache = model.init_cache(batch=B, max_len=max_len, device=prompt.device)
    logits = None
    for t in range(P):
        logits, cache = model.decode_step(params, cache, prompt[:, t], t)
    toks = [logits.argmax(-1)]
    for t in range(P, P + gen_len - 1):
        logits, cache = model.decode_step(params, cache, toks[-1], t)
        toks.append(logits.argmax(-1))
    return torch.cat([prompt, torch.stack(toks, 1).to(prompt.dtype)], dim=1)


def synthetic_prompts(vocab_size: int, requests: int, prompt_len: int,
                      seed: int) -> tuple[np.ndarray, list[int]]:
    """Seeded random token prompts with the reference CLI's variable-length
    rule: request ``i`` keeps ``prompt_len - (i % 4) * prompt_len // 8``
    tokens (at least 4)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab_size, size=(requests, prompt_len),
                        dtype=np.int64)
    lens = [max(4, prompt_len - (i % 4) * (prompt_len // 8))
            for i in range(requests)]
    return toks, lens


def drain_on_signal(stop: dict):
    """The SIGTERM / SIGINT handler: it only records the signal in
    ``stop``; ``Engine.run`` notices between steps and the server then
    drains (and snapshots).  It does no engine work itself, so a signal
    mid-step is safe."""
    def handler(signum, frame):
        stop.setdefault("sig", signum)
    return handler


def serve_mesh(args, device):
    """The ``--mesh`` mesh (None without the flag): over the CUDA devices,
    or, when ``device`` is the CPU, a logical mesh whose every shard is the
    CPU ('auto': one shard)."""
    if not args.mesh:
        return None
    from repro_torch.launch.mesh import mesh_dims, parse_mesh
    if device.type == "cuda":
        return parse_mesh(args.mesh)
    n = 1 if args.mesh == "auto" else math.prod(mesh_dims(args.mesh))
    return parse_mesh(args.mesh, devices=[device] * n)


def build_engine(model, params, args, draft_model, draft_params,
                 telemetry, device, role: str = "mixed"):
    """One engine from the CLI's engine flags (every replica of a cluster
    is built by this, with its own role)."""
    from repro_torch.serve import Engine, ServeConfig
    return Engine(model, params, ServeConfig(
        role=role,
        max_seqs=args.max_seqs, block_size=args.block_size,
        max_len=args.max_len or (args.prompt_len + args.gen),
        num_blocks=args.num_blocks, seed=args.seed,
        chunk_size=args.chunk_size, prefill_budget=args.prefill_budget,
        prefix_caching=not args.no_prefix_caching,
        spec_k=args.spec_k, spec_ema=args.spec_ema,
        draft_cache_dtype=args.draft_cache_dtype,
        cache_dtype=args.cache_dtype, async_step=args.async_step,
        audit_level=args.audit_level,
        audit_interval=args.audit_interval, degrade=args.degrade,
        drain_timeout_s=args.drain_timeout), draft_model=draft_model,
        draft_params=draft_params, telemetry=telemetry, device=device,
        mesh=serve_mesh(args, device))


def _serve_replicated(engines, args, toks, lens, stop, hup, telemetry):
    """Replicated serving: N health-checked engine replicas behind a
    ``Cluster`` router.  A SIGHUP (recorded in ``hup`` by the caller's
    handler) triggers a rolling restart — drain, backlog re-homing and a
    snapshot round-trip per replica, zero failed requests; SIGTERM /
    SIGINT (in ``stop``) drain every replica and end the run."""
    from repro_torch.serve import Cluster, ClusterConfig
    cluster = Cluster(engines, ClusterConfig(
        drain_timeout_s=args.drain_timeout or 30.0), telemetry=telemetry)
    t0 = time.time()
    for i in range(args.requests):
        cluster.submit([int(t) for t in toks[i, :lens[i]]],
                       max_new_tokens=args.gen,
                       temperature=args.temperature)
    if args.prefill_replicas:
        print(f"cluster ready ({args.prefill_replicas} prefill + "
              f"{args.replicas} decode replicas)", flush=True)
    else:
        print(f"cluster ready ({args.replicas} replicas)", flush=True)
    while True:
        out, stats = cluster.run(
            stop_when=lambda: "sig" in stop or "hup" in hup)
        if "hup" in hup and "sig" not in stop:
            hup.clear()
            print("SIGHUP: rolling restart", flush=True)
            cluster.rolling_restart()
            continue
        break
    if "sig" in stop:
        print(f"signal {stop['sig']}: draining replicas", flush=True)
        out.update(cluster.drain_all(args.drain_timeout))
    dt = time.time() - t0
    n_new = sum(len(r.tokens) for r in out.values())
    print(f"served {len(out)} requests / {n_new} new tokens in {dt:.2f}s")
    print(f"cluster: {stats['ticks']:.0f} ticks | "
          f"{stats['steps']:.0f} engine steps | "
          f"{stats['alive']:.0f}/{stats['replicas']:.0f} alive | "
          f"failovers {stats['failovers']:.0f} | "
          f"migrated blocks {stats['migrated_blocks']:.0f} | "
          f"disagg migrations {stats['disagg_migrations']:.0f}")
    if out:
        first = out[min(out)]
        print("sample token ids:", first.tokens[:16])
    if args.trace_out:
        from repro_torch.obs import write_chrome
        write_chrome(telemetry.trace, args.trace_out)
        print(f"chrome trace -> {args.trace_out} "
              f"(one phase track per replica)")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="KV pool blocks (0 = worst-case sized)")
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="prefill chunk tokens (0 = token-by-token)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max prefill tokens per engine step (0 = no cap)")
    ap.add_argument("--no-prefix-caching", action="store_true",
                    help="disable shared-prefix block aliasing")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dtype", default="",
                    help="KV pool dtype: float32/bfloat16 cast; "
                         "int8/fp8_e4m3 quantize with fused kernel "
                         "dequant (default: model dtype)")
    ap.add_argument("--prune-ratio", type=float, default=0.0,
                    help="structurally prune this fraction of every "
                         "prunable group before serving (0 = dense)")
    ap.add_argument("--obspa", action="store_true",
                    help="with --prune-ratio: OBSPA with data-free "
                         "calibration instead of L1 magnitude")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft tokens per cycle (0 = off)")
    ap.add_argument("--draft-ratio", type=float, default=0.5,
                    help="SPA prune ratio for the speculative draft")
    ap.add_argument("--spec-ema", type=float, default=0.0,
                    help="dynamic speculative K: EMA coefficient of the "
                         "per-slot acceptance rate (0 = fixed K)")
    ap.add_argument("--draft-cache-dtype", default="",
                    help="draft KV pool dtype, e.g. bfloat16 or int8 "
                         "(default: the draft's dtype)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable serving telemetry and print phase "
                         "timings + Prometheus metrics after the run")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace JSON of the run "
                         "(load in https://ui.perfetto.dev)")
    ap.add_argument("--async-step", action="store_true",
                    help="double-buffered engine steps: plan/dispatch "
                         "step N+1 while step N's device work is in "
                         "flight (outputs stay byte-identical at "
                         "temperature 0)")
    ap.add_argument("--audit-level", default="off",
                    choices=("off", "alloc", "full"),
                    help="runtime invariant auditing after each step "
                         "(alloc: allocator conservation; full: cache "
                         "tables + prefix index too)")
    ap.add_argument("--audit-interval", type=int, default=1,
                    help="audit every N steps (amortizes full audits)")
    ap.add_argument("--degrade", action="store_true",
                    help="graceful degradation under pool pressure: "
                         "shed aged waiting requests, clamp spec K, "
                         "pause prefix-cache admission")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve behind a fault-tolerant Cluster of N "
                         "engine replicas: health-checked routing, "
                         "failover by block hand-off, and SIGHUP-triggered "
                         "rolling restarts")
    ap.add_argument("--prefill-replicas", type=int, default=0,
                    help="disaggregated serving: N prefill-role replicas "
                         "in front of --replicas decode-role replicas; "
                         "prompts prefill on the prefill tier and migrate "
                         "their KV blocks to the decode tier once their "
                         "last chunk is done (0 = colocated)")
    ap.add_argument("--drain-timeout", type=float, default=0.0,
                    help="drain() deadline in seconds: running requests "
                         "past it are force-preempted to the waiting "
                         "queue (0 = unbounded)")
    ap.add_argument("--snapshot-out", default="",
                    help="write an engine snapshot here after a "
                         "SIGTERM/SIGINT drain (resume via --restore)")
    ap.add_argument("--restore", default="",
                    help="restore engine state from a snapshot file and "
                         "resume its waiting queue (engine flags come "
                         "from the snapshot, not the CLI)")
    ap.add_argument("--mesh", default="",
                    help="serving mesh 'DxM' (data x model) or 'auto'; "
                         "empty = single-device engine")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the CUDA "
                         "device; fails when there is none)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only; no decode path")
    model = build(cfg)
    params = model.init(args.seed, device=device)

    if args.prune_ratio:
        if args.obspa:
            from repro_torch.core.obspa import obspa_prune
            from repro_torch.data.synthetic import batches
            calib = batches(cfg, "datafree", 4, 4, args.prompt_len, seed=5,
                            device=device)
            pr = obspa_prune(model, params, args.prune_ratio, calib,
                             calib_mode="datafree")
        else:
            from repro_torch.core.pruner import prune_model
            pr = prune_model(model, params, args.prune_ratio)
        model, params = build(pr.cfg), pr.params
        pc = pr.cfg
        dims = []
        if pc.family != "ssm":
            dims.append(f"heads {pc.n_heads}, kv heads {pc.n_kv_heads}, "
                        f"v_head_dim {pc.v_head_dim_}, d_ff {pc.d_ff}")
        if pc.n_experts:
            dims.append(f"experts {pc.n_experts} top-{pc.top_k}, moe_d_ff "
                        f"{pc.moe_d_ff}, shared width "
                        f"{pc.n_shared_experts * pc.shared_d_ff}")
        if pc.family == "ssm" or pc.hybrid:
            dims.append(f"ssm heads {pc.ssm_n_heads}, ssm head_dim "
                        f"{pc.ssm_head_dim}, state {pc.ssm_state}")
        print(f"serving pruned model: {pc.name} ({'; '.join(dims)})")

    draft_model = draft_params = None
    if args.spec_k > 0:
        from repro_torch.core.pruner import prune_model
        dr = prune_model(model, params, args.draft_ratio, criterion="l1")
        draft_model, draft_params = build(dr.cfg), dr.params
        print(f"speculative draft: {dr.cfg.name} "
              f"({dr.cfg.param_count()} params, K={args.spec_k})")

    telemetry = None
    if args.metrics or args.trace_out:
        from repro_torch.obs import Telemetry
        telemetry = Telemetry(enabled=True)
    toks, lens = synthetic_prompts(cfg.vocab_size, args.requests,
                                   args.prompt_len, args.seed)
    if args.restore:
        from repro_torch.serve import load_snapshot, restore_engine
        engine = restore_engine(
            load_snapshot(args.restore), model, params,
            draft_model=draft_model, draft_params=draft_params,
            telemetry=telemetry, device=device,
            mesh=serve_mesh(args, device))
        print(f"restored snapshot {args.restore}: "
              f"{len(engine.scheduler.waiting)} waiting / "
              f"{len(engine.scheduler.running)} running requests")
    if args.prefill_replicas > 0:
        # disaggregated tiers: prefill-role replicas feed the decode-role
        # ones, each built with its role (a restored engine is no member)
        roles = ["prefill"] * args.prefill_replicas + \
            ["decode"] * args.replicas
        engines = [build_engine(model, params, args, draft_model,
                                draft_params, None, device, role)
                   for role in roles]
    else:
        if not args.restore:
            engine = build_engine(model, params, args, draft_model,
                                  draft_params, telemetry, device)
        engines = [engine] + [
            build_engine(model, params, args, draft_model, draft_params,
                         None, device)
            for _ in range(args.replicas - 1)]
    if engines[0].mesh is not None:
        mesh = engines[0].mesh
        print(f"serving mesh: "
              f"{dict(zip(mesh.axis_names, mesh.devices.shape))}"
              f" | slots per data shard: "
              f"{args.max_seqs // engines[0]._data_shards}")
    if args.spec_k > 0 and not engines[0].spec_active:
        print("speculative decoding gated off for this family "
              "(recurrent state cannot be rewound)")
    # graceful shutdown: a signal flips the flag, run() notices between
    # steps, then the engine drains (finish in-flight, refuse admissions)
    # and optionally snapshots; the previous handlers come back after
    stop: dict[str, int] = {}
    handlers = dict.fromkeys((signal.SIGTERM, signal.SIGINT),
                             drain_on_signal(stop))
    replicated = args.replicas > 1 or args.prefill_replicas > 0
    hup: dict[str, int] = {}
    if replicated:          # SIGHUP: a rolling restart of the cluster
        handlers[signal.SIGHUP] = \
            lambda signum, frame: hup.setdefault("hup", signum)
    prev = {sig: signal.signal(sig, h) for sig, h in handlers.items()}
    try:
        if replicated:
            _serve_replicated(engines, args, toks, lens, stop, hup,
                              telemetry)
            return
        t0 = time.time()
        if not args.restore:
            for i in range(args.requests):
                engine.add_request([int(t) for t in toks[i, :lens[i]]],
                                   max_new_tokens=args.gen,
                                   temperature=args.temperature)
        print(f"engine ready on {device}", flush=True)
        out, stats = engine.run(stop_when=lambda: "sig" in stop)
        if "sig" in stop:
            print(f"signal {stop['sig']}: draining "
                  f"({len(engine.scheduler.running)} in flight, "
                  f"{len(engine.scheduler.waiting)} waiting)", flush=True)
            out.update(engine.drain())
            if args.snapshot_out:
                from repro_torch.serve import save_snapshot
                save_snapshot(engine, args.snapshot_out)
                print(f"snapshot -> {args.snapshot_out} "
                      f"({len(engine.scheduler.waiting)} waiting requests "
                      f"resumable via --restore)", flush=True)
        dt = time.time() - t0
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    n_new = sum(len(r.tokens) for r in out.values())
    print(f"served {len(out)} requests / {n_new} new tokens in {dt:.2f}s")
    if not out:
        return
    print(f"decode {stats['decode_tok_per_s']:.1f} tok/s | "
          f"prefill+decode {stats['total_tok_per_s']:.1f} tok/s | "
          f"{stats['steps']:.0f} steps | "
          f"{stats['prefill_chunks']:.0f} prefill chunks | "
          f"mean ttft {stats['mean_ttft_s'] * 1e3:.1f}ms")
    if engine.spec_active:
        print(f"speculative: {stats['spec_cycles']:.0f} cycles | "
              f"acceptance {stats['spec_acceptance']:.1%} "
              f"({stats['spec_accepted']:.0f}/{stats['spec_proposed']:.0f})")
    rb = ("faults_injected", "recoveries", "requests_shed",
          "audit_violations", "callback_errors")
    if any(stats.get(k) for k in rb):
        print("robustness: " + " | ".join(
            f"{k} {stats[k]:.0f}" for k in rb if stats.get(k)))
    first = out[min(out)]
    print("sample token ids:", first.tokens[:16])

    if args.metrics:
        from repro_torch.obs import prometheus_text
        reg = telemetry.registry
        print("\n-- step phases (per-step wall, us) --")
        for name in ("step", "plan", "overlap", "prefill_dispatch",
                     "decode_dispatch", "sync", "fold", "audit"):
            h = reg.histograms.get("phase/" + name)
            if h is None:
                continue
            s = h.summary()
            print(f"{name:18s} p50 {s['p50'] * 1e6:9.1f}  "
                  f"p99 {s['p99'] * 1e6:9.1f}  "
                  f"mean {s['mean'] * 1e6:9.1f}  n={s['count']}")
        step_h = reg.histograms.get("phase/step")
        sync_h = reg.histograms.get("phase/sync")
        if step_h is not None and step_h.total > 0 and sync_h is not None:
            print(f"host bubble fraction "
                  f"{sync_h.total / step_h.total:.3f} "
                  f"(phase sync / phase step wall)")
        lat = [(out[r].queue_wait_s, out[r].preempt_stall_s, out[r].tpot_s)
               for r in out]
        print(f"mean queue wait {np.mean([x[0] for x in lat]) * 1e3:.2f}ms | "
              f"mean preempt stall {np.mean([x[1] for x in lat]) * 1e3:.2f}ms"
              f" | mean tpot {np.mean([x[2] for x in lat]) * 1e3:.2f}ms")
        print("\n-- prometheus --")
        print(prometheus_text(reg))
    if args.trace_out:
        from repro_torch.obs import write_chrome
        write_chrome(telemetry.trace, args.trace_out)
        print(f"chrome trace -> {args.trace_out} "
              f"(load in https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
