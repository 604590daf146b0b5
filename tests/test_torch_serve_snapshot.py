"""The port's engine snapshot/restore (``repro_torch.serve.snapshot``),
mirroring ``tests/test_serve_snapshot.py``.

The contract under test: a snapshot of a quiescent engine, restored into a
FRESH config-identical engine, resumes serving **byte-identically** — same
tokens, same finish reasons, same conservation state — across dense,
int8-pool and speculative-decode configurations, through both the in-memory
and the on-disk (versioned header + pickle) paths; the pools round-trip bit
for bit as raw bytes; every malformed file raises ValueError before any
engine state is touched; the generator state rides along, so sampled
serving resumes identically; and the serving CLI drains on a signal, writes
the snapshot and serves the preserved backlog with ``--restore``.  Reduced
TinyLlama, f32, the port's own weights, on the CPU.
"""
import json
import os
import signal
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.pruner import prune_model
from repro_torch.models import build
from repro_torch.serve import (Engine, EngineOverloaded, ServeConfig,
                               load_snapshot, restore_into, save_snapshot)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import snapshot as snapmod

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(pruned_ratio: float = 0.0):
    if pruned_ratio not in _MODELS:
        m = build(reduced(get_config("tinyllama-1.1b")))
        params = m.init(0, device="cpu")
        if pruned_ratio:
            pr = prune_model(m, params, pruned_ratio, criterion="l1")
            m, params = build(pr.cfg), pr.params
        _MODELS[pruned_ratio] = (m, params)
    return _MODELS[pruned_ratio]


def _prompts(V, n=4, base=10, seed=41):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, base - (i % 3))]
            for i in range(n)]


def _finish(eng):
    n = 0
    while eng.scheduler.has_work or eng.pending_step:
        (eng.step_async if eng.cfg.async_step else eng.step)()
        n += 1
        assert n <= 400
    return {r: (tuple(rec.tokens), rec.finish_reason)
            for r, rec in eng.pop_finished().items()}


def _engine(spec=False, **kw):
    m, params = _model()
    kw.setdefault("max_seqs", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_len", 48)
    kw.setdefault("chunk_size", 8)
    if spec:
        kw.setdefault("spec_k", 3)
        dm, dp = _model(0.5)
        return Engine(m, params, ServeConfig(**kw), draft_model=dm,
                      draft_params=dp, device="cpu")
    return Engine(m, params, ServeConfig(**kw), device="cpu")


def _pool_bytes(pools: dict) -> dict:
    return {k: v.contiguous().view(torch.uint8).clone()
            for k, v in pools.items()}


VARIANTS = {"dense": {}, "int8": {"cache_dtype": "int8"},
            "spec": {"spec": True, "draft_cache_dtype": "bfloat16"},
            "async": {"async_step": True}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_roundtrip_resume_byte_identical(variant):
    """Mid-run snapshot -> restore into a fresh engine -> the restored
    engine's pools equal the source's byte for byte and its full results
    equal the uninterrupted run's, for dense, int8, speculative (a bf16
    draft pool) and async-driven engines."""
    kw = VARIANTS[variant]
    eng = _engine(**kw)
    prompts = _prompts(eng.model.cfg.vocab_size)
    eng.reset()
    for p in prompts:
        eng.add_request(p, max_new_tokens=8)
    ref = _finish(eng)

    eng.reset()
    for p in prompts:
        eng.add_request(p, max_new_tokens=8)
    for _ in range(4):
        (eng.step_async if eng.cfg.async_step else eng.step)()
    snap = eng.snapshot()
    assert not eng.pending_step          # the in-flight step reconciled
    pools = _pool_bytes(eng.cache)
    draft = _pool_bytes(eng.draft_cache) if eng.spec_active else {}
    assert _finish(eng) == ref           # source engine is undisturbed

    eng2 = _engine(**kw)
    restore_into(eng2, snap)
    for k, v in _pool_bytes(eng2.cache).items():
        assert torch.equal(v, pools[k]), k
    if eng2.spec_active:
        assert eng2.draft_cache["k"].dtype == torch.bfloat16
        for k, v in _pool_bytes(eng2.draft_cache).items():
            assert torch.equal(v, draft[k]), k
    if variant == "int8":
        assert set(snap["pools"]) == {"k", "v", "k_scale", "v_scale"}
        assert snap["pools"]["k"][0] == "int8"
    got = _finish(eng2)
    assert got == ref
    a = eng2.cache_host.allocator
    assert a.num_live == 0 and a.num_held == 0
    eng2.cache_host.check()


def test_file_roundtrip_and_header(tmp_path):
    """save -> load through the on-disk format; the JSON header carries
    identity/version without unpickling, and the restored run matches."""
    eng = _engine()
    prompts = _prompts(eng.model.cfg.vocab_size)
    for p in prompts:
        eng.add_request(p, max_new_tokens=6)
    ref = _finish(eng)

    eng.reset()
    for p in prompts:
        eng.add_request(p, max_new_tokens=6)
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "engine.rsrv")
    header = save_snapshot(eng, path)
    assert header["format"] == "repro-serve-snapshot"
    assert header["version"] == snapmod.VERSION
    assert header["model"] == eng.model.cfg.name
    assert header["serve_config"]["block_size"] == eng.cfg.block_size
    with open(path, "rb") as f:
        assert f.read(len(snapmod.MAGIC)) == snapmod.MAGIC
        (hlen,) = struct.unpack("<I", f.read(4))
        assert json.loads(f.read(hlen)) == header

    snap = load_snapshot(path)
    eng2 = _engine()
    restore_into(eng2, snap)
    _finish(eng)                        # source completes its own run
    assert _finish(eng2) == ref


def test_load_rejects_garbage_and_mismatch(tmp_path):
    bad = tmp_path / "not_a_snapshot.bin"
    bad.write_bytes(b"definitely not a snapshot")
    with pytest.raises(ValueError, match="not a serve snapshot"):
        load_snapshot(str(bad))

    eng = _engine()
    snap = eng.snapshot()
    other = _engine(block_size=8, max_len=64)
    with pytest.raises(ValueError, match="ServeConfig mismatch"):
        restore_into(other, snap)
    spec = _engine(spec=True)
    with pytest.raises(ValueError, match="speculative"):
        restore_into(spec, snap)


def test_load_rejects_truncated_and_corrupt_files(tmp_path):
    """Every malformed-file mode raises ValueError (never struct.error /
    JSONDecodeError / pickle internals): truncated length word, truncated
    header, corrupt JSON, version skew, truncated body."""
    eng = _engine()
    eng.add_request(_prompts(eng.model.cfg.vocab_size)[0], max_new_tokens=4)
    good = str(tmp_path / "good.rsrv")
    save_snapshot(eng, good)
    raw = open(good, "rb").read()
    (hlen,) = struct.unpack("<I", raw[8:12])

    def write(name, data):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(data)
        return p

    cases = [
        ("no_len.rsrv", raw[:10], "truncated"),          # cut length word
        ("no_header.rsrv", raw[:12 + hlen // 2], "truncated"),
        ("no_body.rsrv", raw[:12 + hlen + 5], "corrupt"),
        ("bad_json.rsrv",
         raw[:12] + b"{" * hlen + raw[12 + hlen:], "corrupt"),
    ]
    for name, data, match in cases:
        with pytest.raises(ValueError, match=match):
            load_snapshot(write(name, data))

    hdr = json.loads(raw[12:12 + hlen])
    hdr["version"] = snapmod.VERSION + 1
    enc = json.dumps(hdr, sort_keys=True).encode()
    skew = raw[:8] + struct.pack("<I", len(enc)) + enc + raw[12 + hlen:]
    with pytest.raises(ValueError, match="version"):
        load_snapshot(write("version_skew.rsrv", skew))

    assert load_snapshot(good)["header"]["version"] == snapmod.VERSION


def test_failed_restore_leaves_engine_untouched():
    """restore_into validates BEFORE reset: a mid-run engine given a
    mismatched snapshot (config, model, or pools of another shape) raises
    cleanly and then finishes its own run byte-identically."""
    eng = _engine()
    prompts = _prompts(eng.model.cfg.vocab_size)
    for p in prompts:
        eng.add_request(p, max_new_tokens=6)
    ref = _finish(eng)

    bad_snap = _engine(block_size=8, max_len=64).snapshot()
    eng.reset()
    for p in prompts:
        eng.add_request(p, max_new_tokens=6)
    for _ in range(3):
        eng.step()
    running_before = [s.req.rid for s in eng.scheduler.running]
    with pytest.raises(ValueError, match="ServeConfig mismatch"):
        restore_into(eng, bad_snap)
    ws = _engine().snapshot()
    ws["header"] = dict(ws["header"], model="other-arch")
    with pytest.raises(ValueError, match="model"):
        restore_into(eng, ws)
    short = _engine().snapshot()
    dtype, shape, raw = short["pools"]["k"]
    short["pools"]["k"] = (dtype, (shape[0] - 1,) + shape[1:], raw)
    with pytest.raises(ValueError, match="pool k"):
        restore_into(eng, short)
    assert [s.req.rid for s in eng.scheduler.running] == running_before
    assert _finish(eng) == ref


@pytest.mark.parametrize("async_step", [False, True],
                         ids=["lockstep", "async"])
def test_temperature_resume_identical(async_step):
    """The generator's state rides the snapshot, so sampled (temperature >
    0) serving resumes byte-identically."""
    eng = _engine(async_step=async_step)
    prompts = _prompts(eng.model.cfg.vocab_size, n=3)

    def run(snapshot_at=None):
        eng.reset()
        for p in prompts:
            eng.add_request(p, max_new_tokens=8, temperature=0.8)
        snap = None
        n = 0
        while eng.scheduler.has_work or eng.pending_step:
            if snapshot_at is not None and eng._steps == snapshot_at \
                    and snap is None:
                snap = eng.snapshot()
            (eng.step_async if async_step else eng.step)()
            n += 1
            assert n <= 400
        return {r: (tuple(rec.tokens), rec.finish_reason)
                for r, rec in eng.pop_finished().items()}, snap

    ref, _ = run()
    again, snap = run(snapshot_at=3)
    eng2 = _engine(async_step=async_step)
    restore_into(eng2, snap)
    resumed = _finish(eng2)
    if not async_step:
        assert again == ref and resumed == ref
    else:
        # the snapshot reconciles the in-flight step, so the run that took
        # it and the restored run continue from the same lockstep point
        assert resumed == again
    assert all(len(t) == 8 for t, _ in resumed.values())


def test_drain_preserves_waiting_for_restore():
    """drain() finishes in-flight work, refuses new admissions, and the
    post-drain snapshot hands the still-waiting queue to a fresh engine:
    drained + restored results together equal the uninterrupted run."""
    eng = _engine(max_seqs=2)
    prompts = _prompts(eng.model.cfg.vocab_size, n=6)
    for p in prompts:
        eng.add_request(p, max_new_tokens=6)
    ref = _finish(eng)

    eng.reset()
    for p in prompts:
        eng.add_request(p, max_new_tokens=6)
    eng.step()                          # some admitted, some waiting
    assert eng.scheduler.waiting, "need a backlog for this test"
    drained = {r: (tuple(rec.tokens), rec.finish_reason)
               for r, rec in eng.drain().items()}
    assert drained and not eng.scheduler.running
    with pytest.raises(EngineOverloaded, match="draining"):
        eng.add_request(prompts[0], max_new_tokens=6)
    snap = eng.snapshot()

    eng2 = _engine(max_seqs=2)
    restore_into(eng2, snap)
    assert eng2.scheduler.waiting
    resumed = _finish(eng2)
    assert set(drained) | set(resumed) == set(ref)
    for r, v in {**drained, **resumed}.items():
        assert v == ref[r]


def test_drain_timeout_force_preempts_stragglers(monkeypatch):
    """A drain deadline (on a patched clock) preempts the running requests
    back to the waiting queue instead of failing them; a restore serves
    them to the uninterrupted run's tokens."""
    from test_torch_serve_async import FakeClock
    monkeypatch.setattr(engine_mod, "time", FakeClock())
    eng = _engine(max_seqs=2, async_step=True)
    prompts = _prompts(eng.model.cfg.vocab_size, n=3)
    for p in prompts:
        eng.add_request(p, max_new_tokens=12)
    ref = _finish(eng)

    eng.reset()
    for p in prompts:
        eng.add_request(p, max_new_tokens=12)
    for _ in range(3):
        eng.step_async()
    drained = eng.drain(timeout_s=0.005)
    assert not eng.scheduler.running and not eng.pending_step
    assert len(eng.scheduler.waiting) == 3 and not drained
    assert eng.cache_host.allocator.num_live == 0
    eng2 = _engine(max_seqs=2, async_step=True)
    restore_into(eng2, eng.snapshot())
    assert _finish(eng2) == ref


def _cli(argv, stop_after=None):
    """Run the serving CLI in this process; with ``stop_after``, deliver a
    SIGTERM to the handler it installs once that many engine steps ran (the
    handler is recorded instead of installed)."""
    from repro_torch.launch import serve as cli
    installed: dict = {}

    def fake_signal(sig, handler):
        old = installed.get(sig, signal.SIG_DFL)
        installed[sig] = handler
        return old

    steps = [0]
    real_step = engine_mod.Engine.step_async

    def step_async(self):
        steps[0] += 1
        if stop_after is not None and steps[0] == stop_after:
            installed[signal.SIGTERM](signal.SIGTERM, None)
        return real_step(self)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(cli.signal, "signal", fake_signal)
        mp.setattr(engine_mod.Engine, "step_async", step_async)
        cli.main(argv)
    finally:
        mp.undo()
    return installed


def test_cli_snapshot_out_and_restore(tmp_path, capsys):
    """``--snapshot-out``: a SIGTERM (through the handler the CLI installs)
    drains the server and writes a snapshot holding the backlog;
    ``--restore`` rebuilds the engine from it and serves exactly that
    backlog."""
    snap = str(tmp_path / "drain.rsrv")
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--requests", "8",
            "--prompt-len", "12", "--gen", "16", "--max-seqs", "2",
            "--block-size", "4", "--async-step", "--audit-level", "full",
            "--audit-interval", "2", "--degrade", "--drain-timeout", "60",
            "--device", "cpu"]
    installed = _cli(argv + ["--snapshot-out", snap], stop_after=3)
    assert set(installed) == {signal.SIGTERM, signal.SIGINT}
    out = capsys.readouterr().out
    assert f"signal {int(signal.SIGTERM)}: draining" in out
    assert "served 2 requests / 32 new tokens" in out
    loaded = load_snapshot(snap)
    cfg = loaded["header"]["serve_config"]
    assert cfg["async_step"] and cfg["audit_level"] == "full"
    assert cfg["degrade"] and cfg["drain_timeout_s"] == 60.0
    n_wait = len(loaded["host"]["scheduler"]["waiting"])
    assert n_wait == 6

    _cli(argv + ["--restore", snap])
    out = capsys.readouterr().out
    assert f"restored snapshot {snap}: {n_wait} waiting / 0 running" in out
    assert f"served {n_wait} requests / {16 * n_wait} new tokens" in out


@pytest.mark.slow
def test_sigterm_drains_and_snapshot_restores(tmp_path):
    """The serving CLI drains on a real SIGTERM, writes a loadable
    snapshot, and --restore serves the preserved backlog (exit 0 both
    times).  The port serves the reduced model on the CPU fast enough that
    the run is sized to outlast the second before the signal."""
    snap = str(tmp_path / "drain.rsrv")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "tinyllama-1.1b", "--reduced", "--requests", "16",
           "--prompt-len", "12", "--gen", "256", "--max-seqs", "2",
           "--block-size", "4", "--device", "cpu", "--snapshot-out", snap]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
    try:
        for line in p.stdout:
            if "engine ready" in line:
                break
        time.sleep(1.0)
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, out
    assert "draining" in out and os.path.exists(snap)

    loaded = load_snapshot(snap)
    assert loaded["header"]["format"] == "repro-serve-snapshot"
    n_wait = len(loaded["host"]["scheduler"]["waiting"])
    assert n_wait > 0

    r = subprocess.run(cmd[:-2] + ["--restore", snap],
                       capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"served {n_wait} requests" in r.stdout
