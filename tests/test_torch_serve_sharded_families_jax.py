"""Mesh serving of the ssm, hybrid and moe families against the JAX engine:
reduced mamba2-1.3b, hymba-1.5b, qwen2-moe-a2.7b and a Hymba with 5 query
heads, 5 KV heads and vocab 257 (heads and vocab that divide no model axis
above 1) served by the reference's ``Engine`` over 4 forced host devices in
a subprocess (this process never sets ``XLA_FLAGS``),
and by the port over logical CPU meshes of the same shapes, from the same
weights.

The subprocess records, through ``jax.debug.callback``, the top-2 logit gap
of every row a step feeds (active decode rows, prefill rows with tokens)
and, for qwen2-moe, the gap between every real token's k-th and (k+1)-th
router probability.  Both are asserted before the port's tokens are held
equal to the reference's on every mesh — qwen2-moe's 2x1 included, where
the reference runs "dp" and each data shard's expert capacity comes from
its own token count, so its tokens differ from one device's (pinned here;
ROADMAP Queue 3).
"""
import json
import os
import pickle
import subprocess
import sys

import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import build
from repro_torch.models import moe as moe_mod
from repro_torch.serve import Engine, ServeConfig

from test_torch_serve_sharded import GAP, mesh

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ROUTER_GAP = 1e-5
CONFIGS = {"mamba2": ("mamba2-1.3b", {}), "hymba": ("hymba-1.5b", {}),
           "moe": ("qwen2-moe-a2.7b", {}),
           "hymba55": ("hymba-1.5b", dict(n_heads=5, n_kv_heads=5,
                                          vocab_size=257))}
SERVE = dict(max_seqs=4, block_size=4, max_len=32, chunk_size=8)

JAX_RUN = '''
import json, os, pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.launch.mesh import make_serve_mesh
from repro.models import build
from repro.models import moe as moe_mod
from repro.serve import Engine, ServeConfig
assert len(jax.devices()) == 4
out_dir, CONFIGS, SERVE = sys.argv[1], json.loads(sys.argv[2]), \\
    json.loads(sys.argv[3])
REC = {"gap": [], "router": []}
real_moe = moe_mod.moe_block


def moe_block(params, cfg, x, token_mask=None):
    if token_mask is not None:
        xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        top = jax.lax.top_k(jax.nn.softmax(xt @ params["router"], axis=-1),
                            cfg.top_k + 1)[0]
        gap = jnp.where(token_mask.reshape(-1),
                        top[:, cfg.top_k - 1] - top[:, cfg.top_k], jnp.inf)
        jax.debug.callback(lambda g: REC["router"].append(float(g.min())),
                           gap)
    return real_moe(params, cfg, x, token_mask)


moe_mod.moe_block = moe_block


def record(logits, rows):
    top = jax.lax.top_k(logits.astype(jnp.float32), 2)[0]
    gap = jnp.where(rows, top[:, 0] - top[:, 1], jnp.inf)
    jax.debug.callback(lambda g: REC["gap"].append(float(g.min())), gap)


class Recording(Engine):
    def _step_impl(self, params, cache, tokens, positions, block_tables,
                   temps, active, key):
        logits, cache = self.model.paged_decode_step(
            params, cache, tokens, positions, block_tables, active)
        record(logits, active)
        return self._sample(logits, temps, key), cache

    def _prefill_impl(self, params, cache, tokens, positions, slots,
                      block_tables, valid, temps, key):
        logits, cache = self.model.paged_prefill_step(
            params, cache, tokens, positions, slots, block_tables, valid)
        record(logits, valid > 0)
        return self._sample(logits, temps, key), cache


res = {}
for name, (arch, kw) in CONFIGS.items():
    cfg = reduced(get_config(arch)).replace(**kw)
    m = build(cfg)
    params = jax.jit(m.init)(jax.random.PRNGKey(0))   # eager init: ~5 s
    with open(os.path.join(out_dir, name + ".pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 5 + i % 3)]
               for i in range(4)]
    runs = {}
    for dm in [(2, 1), (1, 2), (2, 2)]:
        REC["gap"].clear()
        REC["router"].clear()
        eng = Recording(m, params, ServeConfig(**SERVE),
                        mesh=make_serve_mesh(*dm))
        for p in prompts:
            eng.add_request(p, max_new_tokens=6)
        out, _ = eng.run()
        runs["%dx%d" % dm] = {
            "tokens": [out[r].tokens for r in sorted(out)],
            "mode": eng.shard_mode, "gap": min(REC["gap"]),
            "router_gap": min(REC["router"]) if REC["router"] else None}
    res[name] = {"prompts": prompts, "runs": runs}
with open(os.path.join(out_dir, "ref.json"), "w") as f:
    json.dump(res, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs: one subprocess a config, side by side (each
    engine's compilation is most of their time).  This
    process's ``XLA_FLAGS`` stay as the fixture found them (another test of
    the worker may have imported ``repro.launch.dryrun``, which sets
    them)."""
    flags = os.environ.get("XLA_FLAGS")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = tmp_path_factory.mktemp("jax_families")
    halves = [[name] for name in CONFIGS]
    procs = []
    for k, names in enumerate(halves):
        (out / str(k)).mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", JAX_RUN, str(out / str(k)),
             json.dumps({n: CONFIGS[n] for n in names}), json.dumps(SERVE)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    ref = {}
    for k, p in enumerate(procs):
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, so[-2000:] + se[-3000:]
        ref.update(json.loads((out / str(k) / "ref.json").read_text()))
        for n in halves[k]:
            (out / str(k) / f"{n}.pkl").rename(out / f"{n}.pkl")
    assert os.environ.get("XLA_FLAGS") == flags
    return out, ref


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_meshes_match_the_jax_engine(reference, name):
    out_dir, ref = reference
    arch, kw = CONFIGS[name]
    cfg = reduced(get_config(arch)).replace(**kw)
    model = build(cfg)
    with open(out_dir / f"{name}.pkl", "rb") as f:
        params = convert.convert_params(pickle.load(f))
    runs = ref[name]["runs"]
    for dm, run in runs.items():
        assert run["gap"] > GAP, (name, dm, run["gap"])
        if cfg.n_experts:
            assert run["router_gap"] > ROUTER_GAP, (name, dm, run)
        d, m = (int(a) for a in dm.split("x"))
        eng = Engine(model, params, ServeConfig(**SERVE), device="cpu",
                     mesh=mesh(d, m))
        for p in ref[name]["prompts"]:
            eng.add_request(p, max_new_tokens=6)
        moe_mod.reset_dropped()
        out, _ = eng.run()
        assert eng.shard_mode == run["mode"], (name, dm)
        assert [out[r].tokens for r in sorted(out)] == run["tokens"], \
            (name, dm, eng.shard_mode)
        eng.replica_audit()
        if name == "moe" and dm == "2x1":
            # the dp shards' own capacities drop what one device keeps
            assert moe_mod.dropped_assignments() > 0
    if name == "moe":
        # the reference's 2x1 ("dp") run differs from the one-device run
        # (the port's engine, whose paged steps test_torch_moe_serve.py
        # holds to the reference's), and its gspmd runs do not
        eng = Engine(model, params, ServeConfig(**SERVE), device="cpu")
        for p in ref[name]["prompts"]:
            eng.add_request(p, max_new_tokens=6)
        moe_mod.reset_dropped()
        out, _ = eng.run()
        one = [out[r].tokens for r in sorted(out)]
        assert moe_mod.dropped_assignments() == 0
        assert runs["2x1"]["mode"] == "dp" and runs["2x1"]["tokens"] != one
        assert runs["1x2"]["tokens"] == runs["2x2"]["tokens"] == one
