"""The data-parallel bookkeeping of the port against the JAX engine's: the
reference's staged cross-shard scenario (``tests/test_serve_sharded.py``'s
``_staged_cross_shard``) on the JAX engine over 2 forced host devices, in
a subprocess (this process never sets ``XLA_FLAGS``),
and on the port over a 2x1 logical CPU mesh.  Tokens, ``shard_moves``,
``alias_refusals`` and every request's slot and data shard must be equal;
the JAX run's top-2 logit gaps are asserted before the tokens are
compared.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro_torch.serve import Engine, ServeConfig

from test_torch_serve_sharded import GAP, mesh, models

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# The scenario, run by both engines: A alone on shard 0 until it finishes
# and its prefix blocks are cached; a filler takes slot 0; B (A's prefix)
# lands on shard 1 and aliases A's blocks across shards.  ``Engine``,
# ``ServeConfig`` and ``mesh_`` are the caller's; ``placed`` keeps each
# request's (slot, shard) from its first step on.
SCENARIO = '''
def staged(Engine, ServeConfig, m, params, mesh_, **kw):
    rng = np.random.default_rng(17)
    V = m.cfg.vocab_size
    common = [int(t) for t in rng.integers(0, V, 12)]
    pa, pb = common + [1, 2], common + [3, 4]
    filler = [int(t) for t in rng.integers(0, V, 6)]
    eng = Engine(m, params, ServeConfig(max_seqs=2, block_size=4, max_len=48,
                                        chunk_size=8), mesh=mesh_, **kw)
    placed = {}

    def step():
        eng.step()
        eng.cache_host.check()
        for s in eng.scheduler.running:
            placed.setdefault(s.req.rid, (s.slot,
                                          eng.scheduler.shard_of(s.slot)))

    ra = eng.add_request(pa, max_new_tokens=6)
    while eng.scheduler.has_work:
        step()
    rf = eng.add_request(filler, max_new_tokens=16)
    step()
    rb = eng.add_request(pb, max_new_tokens=6)
    while eng.scheduler.has_work:
        step()
    done = {s.req.rid: list(s.generated) for s in eng.scheduler.finished}
    return {"prompts": [pa, filler, pb],
            "tokens": [done[ra], done[rf], done[rb]],
            "placed": [list(placed[r]) for r in (ra, rf, rb)],
            "shard_moves": int(eng._c["shard_moves"].value),
            "alias_refusals": int(eng.cache_host.alias_refusals),
            "mode": eng.shard_mode}
'''

JAX_RUN = '''
import json, os, sys
import numpy as np
import jax
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
from test_serve_sharded import _models
from repro.launch.mesh import make_serve_mesh
from repro.serve import Engine, ServeConfig
assert len(jax.devices()) == 2
''' + SCENARIO + '''
m, params = _models(jax.random.PRNGKey(0), False)
out = staged(Engine, ServeConfig, m, params, make_serve_mesh(2, 1))
json.dump(out, open(sys.argv[2], "w"))
'''


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_staged_cross_shard_matches_the_jax_engine(tmp_path):
    path = tmp_path / "jax_staged.json"
    # this process's flags, as the test found them (another test of the
    # same worker may have imported ``repro.launch.dryrun``, which sets
    # them): the subprocess's device count must not leak into them
    flags = os.environ.get("XLA_FLAGS")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", JAX_RUN, REPO, str(path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    ref = json.loads(path.read_text())
    assert os.environ.get("XLA_FLAGS") == flags
    assert ref["mode"] == "dp" and ref["shard_moves"] > 0
    assert ref["alias_refusals"] == 0

    jm, jp, tm, tp = models()
    for p, toks in zip(ref["prompts"], ref["tokens"]):
        seq = jnp.asarray([p + toks], jnp.int32)
        logits = np.sort(np.asarray(jm.forward(jp, {"tokens": seq}))[0][
            len(p) - 1:len(p) - 1 + len(toks)], axis=-1)
        assert (logits[:, -1] - logits[:, -2]).min() > GAP

    scope: dict = {"np": np}
    exec(SCENARIO, scope)
    out = scope["staged"](Engine, ServeConfig, tm, tp, mesh(2, 1),
                          device="cpu")
    assert out == ref
