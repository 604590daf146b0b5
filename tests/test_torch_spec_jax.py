"""The port's speculative decoding against the JAX package, on the same
weights (carried across by ``repro_torch.convert``): greedy spec tokens
equal the JAX package's ``generate``, and with a draft whose acceptance lies
strictly between 0 and 1 the port's speculative bookkeeping — cycles,
drafts proposed and accepted, steps, each step's plan and each request's
tokens — equals the JAX spec engine's.

Greedy choices are discrete, so each comparison first asserts the top-2 gap
of the reference's logits at every choice that decides the outcome, as
``test_torch_encoder_prune.assert_same_cuts`` does for pruning cuts.  Under
greedy speculation those choices are the target's argmax at every emitted
position and the draft's argmax at every prefix of the emitted sequence:
a candidate is accepted exactly when it equals the target's token, so every
candidate that can change a count was drafted from a prefix of the final
sequence.  Reduced TinyLlama, f32, on the CPU.
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.pruner import prune_model as j_prune
from repro.launch.serve import generate as j_generate
from repro.models import build as j_build
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.models import build as t_build
from repro_torch.serve import Engine, ServeConfig
from test_torch_engine import _plan_trace

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the top-2 gap every deciding choice must clear: f32 logits of the two
# frameworks differ by ~1e-6 at these widths
MARGIN = 1e-4
B, P, GEN = 3, 11, 10
SC = dict(max_seqs=3, block_size=4, max_len=32, chunk_size=4, spec_k=3)
_MODELS: dict = {}


def _port(jm, jp):
    tm = t_build(convert.convert_config(dataclasses.asdict(jm.cfg)))
    return tm, convert.convert_params(jax.tree.map(np.asarray, jp))


def models(ratio: float = 0.0):
    """(JAX model, JAX params, port model, port params) of reduced
    TinyLlama from PRNGKey(0); with ``ratio``, its L1-pruned draft (the
    JAX pruner, then converted)."""
    if ratio not in _MODELS:
        jm = j_build(j_reduced(j_get_config("tinyllama-1.1b")))
        jp = jm.init(jax.random.PRNGKey(0))
        if ratio:
            pr = j_prune(jm, jp, ratio, criterion="l1")
            jm, jp = j_build(pr.cfg), pr.params
        _MODELS[ratio] = (jm, jp, *_port(jm, jp))
    return _MODELS[ratio]


def _prompts(V):
    return np.random.default_rng(97).integers(0, V, size=(B, P))


def _jax_generate(jm, jp, prompt):
    if "generate" not in _MODELS:
        _MODELS["generate"] = np.asarray(j_generate(
            jm, jp, jnp.asarray(prompt, jnp.int32), GEN))
    return _MODELS["generate"]


def assert_gaps(jm, jp, seqs, what):
    """The reference's top-2 logit gap exceeds MARGIN at every position
    from the last prompt token on, over each final sequence."""
    logits = np.asarray(jm.forward(
        jp, {"tokens": jnp.asarray(np.asarray(seqs, np.int32))}))
    at = np.sort(logits[:, P - 1:-1], axis=-1)
    gap = at[..., -1] - at[..., -2]
    assert gap.min() > MARGIN, (what, float(gap.min()))


def _serve(eng, prompt):
    trace = _plan_trace(eng)
    rids = [eng.add_request([int(t) for t in row], max_new_tokens=GEN)
            for row in prompt]
    out, stats = eng.run()
    return [out[r] for r in rids], stats, trace


def test_greedy_spec_tokens_equal_jax_generate():
    """The port's spec engine with the CLI's draft (L1 at 0.5) emits the
    JAX package's ``generate`` tokens, every target choice clear of a
    tie."""
    jm, jp, tm, tp = models()
    _, _, dm, dp = models(0.5)
    prompt = _prompts(tm.cfg.vocab_size)
    ref = _jax_generate(jm, jp, prompt)
    assert_gaps(jm, jp, ref, "target")
    eng = Engine(tm, tp, ServeConfig(**SC), draft_model=dm,
                 draft_params=dp, device="cpu")
    res, stats, _ = _serve(eng, prompt)
    assert stats["spec_cycles"] > 0
    for b, r in enumerate(res):
        assert r.tokens == ref[b, P:].tolist(), b


def test_spec_bookkeeping_equals_jax_spec_engine():
    """A draft L1-pruned at 0.125 accepts some drafts and not others; the
    port's cycles, proposals, acceptances, steps, plans and tokens equal
    the JAX spec engine's on the same weights and requests."""
    jm, jp, tm, tp = models()
    jdm, jdp, dm, dp = models(0.125)
    prompt = _prompts(tm.cfg.vocab_size)

    jeng = JEngine(jm, jp, JServeConfig(**SC), draft_model=jdm,
                   draft_params=jdp)
    jres, jstats, jtrace = _serve(jeng, prompt)
    assert 0.0 < jstats["spec_acceptance"] < 1.0, jstats["spec_acceptance"]
    seqs = [list(row) + r.tokens for row, r in zip(prompt, jres)]
    assert_gaps(jm, jp, seqs, "target")
    assert_gaps(jdm, jdp, seqs, "draft")

    eng = Engine(tm, tp, ServeConfig(**SC), draft_model=dm,
                 draft_params=dp, device="cpu")
    res, stats, trace = _serve(eng, prompt)
    for k in ("spec_cycles", "spec_proposed", "spec_accepted", "steps",
              "decode_tokens", "prefill_tokens", "prefill_chunks",
              "host_syncs"):
        assert stats[k] == jstats[k], k
    assert trace == jtrace
    for b, (r, jr) in enumerate(zip(res, jres)):
        assert r.tokens == jr.tokens, b
        assert (r.spec_proposed, r.spec_accepted, r.steps) == \
            (jr.spec_proposed, jr.spec_accepted, jr.steps), b
