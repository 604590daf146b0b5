"""PyTorch port vs JAX reference: OBSPA after training, from the same
trained weights.

Reduced TinyLlama (f32) is trained by the port's ``Trainer`` on a pool of
two batches until it has memorised them, as ``chip_smoke.py`` phase 11 trains
full-width TinyLlama on a pool of eight; the trained weights (numpy) and the
same data-free calibration batches then go to the JAX package's
``obspa_prune`` and to the port's.  Both must prune the same units,
reconstruct the same weights (1e-4 relative), move the loss on the seen
batches and on a held-out batch the same way, and leave every consumer's
layer-output error at the same ratio to plain slicing: whatever OBSPA does
to a trained model's loss is then the method's, not the port's.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.obspa import obspa_prune as j_obspa_prune
from repro.data.synthetic import batches as j_batches
from repro.models import build as j_build
from repro_torch import convert
from repro_torch.core.graph import tree_paths
from repro_torch.core.obspa import layer_output_errors, obspa_prune
from repro_torch.data.synthetic import batches
from repro_torch.models import build
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optim import OptConfig

torch.backends.cuda.matmul.allow_tf32 = False


class _Warm:
    """A model whose ``init`` returns given parameters."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params

    def init(self, seed, device):
        return self.params


def _np_tree(tree):
    """The same nesting with every tensor as a numpy array."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().numpy().copy()


def _mean_loss(loss_fn, params, evalb) -> float:
    return float(np.mean([float(loss_fn(params, b)[0]) for b in evalb]))


def test_obspa_after_training_matches_jax():
    jcfg = j_reduced(j_get_config("tinyllama-1.1b"))
    tcfg = convert.convert_config(dataclasses.asdict(jcfg))
    tm = build(tcfg)
    init = convert.convert_params(
        jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.PRNGKey(0))))

    # train on a pool of two batches (cycled) until they are memorised
    pool = batches(tcfg, "id", 2, 8, 32, seed=21, device="cpu")
    heldout = batches(tcfg, "id", 1, 8, 32, seed=99, device="cpu")
    with torch.no_grad():
        init_seen = _mean_loss(tm.loss, init, pool)
    steps = 40
    res = Trainer(_Warm(tcfg, init),
                  OptConfig(lr=3e-3, warmup_steps=4, total_steps=steps),
                  TrainerConfig(total_steps=steps, log_every=steps),
                  "cpu").train(itertools.cycle(pool))
    trained = _np_tree(res.params)
    tp = convert.convert_params(trained)
    jm, jp = j_build(jcfg), jax.tree.map(jnp.asarray, trained)
    with torch.no_grad():
        seen0 = _mean_loss(tm.loss, tp, pool)
        held0 = _mean_loss(tm.loss, tp, heldout)
    assert seen0 < init_seen - 1.0, (init_seen, seen0)   # it has learnt

    # the same data-free calibration batches, token for token
    jc = j_batches(jcfg, "datafree", 4, 8, 16, seed=5, with_targets=False)
    tc = batches(tcfg, "datafree", 4, 8, 16, seed=5, device="cpu")
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a["tokens"]),
                                      b["tokens"].numpy())
    jr = j_obspa_prune(jm, jp, 0.5, jc, recalibrate=False,
                       calib_mode="datafree")
    tr = obspa_prune(tm, tp, 0.5, tc, calib_mode="datafree")

    assert tr.pruned_units == jr.pruned_units
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        ref = jleaves[path]
        err = np.abs(leaf.numpy() - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < 1e-4, (path, err)

    # the loss change on the seen and the held-out batches: same sign, and
    # the same value within the reconstruction's 1e-4
    jpm = j_build(jr.cfg)
    tpm = build(tr.cfg)
    with torch.no_grad():
        t_seen = _mean_loss(tpm.loss, tr.params, pool) - seen0
        t_held = _mean_loss(tpm.loss, tr.params, heldout) - held0
    jb = [{"tokens": jnp.asarray(b["tokens"].numpy())} for b in pool]
    jh = [{"tokens": jnp.asarray(b["tokens"].numpy())} for b in heldout]
    j_seen = (_mean_loss(jpm.loss, jr.params, jb)
              - _mean_loss(jm.loss, jp, jb))
    j_held = (_mean_loss(jpm.loss, jr.params, jh)
              - _mean_loss(jm.loss, jp, jh))
    print(f"loss change by OBSPA: seen {t_seen:+.5f} (JAX {j_seen:+.5f}), "
          f"held out {t_held:+.5f} (JAX {j_held:+.5f}); dense seen "
          f"{seen0:.4f}, held out {held0:.4f}")
    for t_d, j_d in ((t_seen, j_seen), (t_held, j_held)):
        assert np.sign(t_d) == np.sign(j_d), (t_seen, j_seen, t_held, j_held)
        assert t_d == pytest.approx(j_d, abs=1e-3)

    # every consumer's layer-output error against plain slicing, for the
    # port's reconstruction and for the reference's (as port tensors)
    j_as_port = dataclasses.replace(
        tr, params=convert.convert_params(jax.tree.map(np.asarray,
                                                       jr.params)))
    t_err = layer_output_errors(tm, tp, tr, tc)
    j_err = layer_output_errors(tm, tp, j_as_port, tc)
    assert set(t_err) == set(j_err) and len(t_err) == 2 * tcfg.num_layers
    for name, (e_ob, e_cut) in t_err.items():
        j_ob, j_cut = j_err[name]
        assert j_cut == e_cut
        assert 0 <= e_ob < e_cut, (name, e_ob, e_cut)
        assert e_ob / e_cut == pytest.approx(j_ob / j_cut, rel=1e-3,
                                             abs=1e-6), name
        print(f"{name}: error / slicing {e_ob / e_cut:.4f} (JAX "
              f"{j_ob / j_cut:.4f})")
