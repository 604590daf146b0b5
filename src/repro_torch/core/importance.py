"""Group-level importance estimation (paper Eq. 1 + App. A.4/A.5).

    s_{i,j} = Norm_{CC_l in g_i}( { AGG( S(θ_k), ∀θ_k in CC_j ) } )

``S`` is a per-weight criterion (L1/L2 magnitude, random); ``AGG`` collapses
a coupled-channel set to one score; ``Norm`` makes scores comparable across
groups.  Per-weight scores and their per-axis reductions run on the device
the parameters live on; the per-unit sums are host (numpy) work, as in the
reference.

The gradient criteria (SNIP ``|g·θ|``, GraSP ``-θ·Hg``, CroP ``|θ·Hg|``)
take the gradient from ``torch.func.grad`` and the Hessian-gradient product
from ``torch.func.jvp`` over it, as the reference takes ``jax.jvp`` over
``jax.grad``.  ``random`` draws from a seeded ``torch.Generator``: it
cannot reproduce JAX's PRNG bits, only their distribution.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.graph import tree_paths
from repro_torch.core.groups import Group

GRADIENT_CRITERIA = ("snip", "grasp", "crop")


def hessian_grad_product(loss_fn, params, *args):
    """(g, Hg) where g = ∇loss — one jvp over the gradient function
    (GraSP / CroP)."""
    grad_fn = torch.func.grad(loss_fn)
    g = grad_fn(params, *args)
    _, hg = torch.func.jvp(lambda p: grad_fn(p, *args), (params,), (g,))
    return g, hg


class LeafScores(Mapping):
    """Dotted path -> the f32 per-weight score of that leaf,
    ``fn(path, leaf)``, computed when asked for and not kept: the scores
    held at once would be an f32 copy of every parameter (67 GB for a
    16.8 B-parameter model).  Iterates in ``tree_paths`` order."""

    def __init__(self, params, fn):
        self._leaves = dict(tree_paths(params))
        self._fn = fn

    def __getitem__(self, path: str) -> torch.Tensor:
        return self._fn(path, self._leaves[path])

    def __iter__(self):
        return iter(self._leaves)

    def __len__(self) -> int:
        return len(self._leaves)


def leaf_scores(params, criterion: str, grads=None, hg=None, seed: int = 0
                ) -> Mapping[str, torch.Tensor]:
    """Per-weight importance S(θ): dotted path -> f32 scores of that leaf's
    shape.  Each leaf's scores are made when read, except ``random``'s,
    which are drawn at once in path order (a read order must not change
    them)."""
    if criterion in ("l1", "magnitude"):
        return LeafScores(params, lambda _, x: x.float().abs())
    if criterion == "l2":
        return LeafScores(params, lambda _, x: x.float().square())
    if criterion in GRADIENT_CRITERIA:
        other = grads if criterion == "snip" else hg
        if other is None:
            raise ValueError(f"criterion {criterion!r} needs "
                             f"{'grads' if criterion == 'snip' else 'Hg'}")
        by = dict(tree_paths(other))
        if criterion == "grasp":
            # GraSP scores -θ·Hg; the lowest scores are pruned, so the sign
            # makes "high = keep"
            return LeafScores(params,
                              lambda k, x: -(x.float() * by[k].float()))
        return LeafScores(params,
                          lambda k, x: (x.float() * by[k].float()).abs())
    if criterion == "random":
        leaves = tree_paths(params)
        dev = leaves[0][1].device if leaves else torch.device("cpu")
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return {k: torch.rand(x.shape, generator=gen, device=x.device,
                              dtype=torch.float32) for k, x in leaves}
    raise ValueError(f"unknown criterion {criterion!r}")


def unit_scores(groups: list[Group], scores, agg: str = "mean",
                norm: str = "mean") -> dict[str, np.ndarray]:
    """Eq. 1: per-group arrays of unit scores (len == n_units).

    ``agg`` is ``mean`` or ``sum`` over a unit's weights; ``norm`` is
    ``mean`` (divide by the group's mean) or ``none`` — the values the
    port's callers use (the reference's other choices serve no caller).
    ``scores`` is ``leaf_scores``' mapping."""
    if agg not in ("mean", "sum") or norm not in ("mean", "none"):
        raise ValueError(f"unit_scores: agg {agg!r} / norm {norm!r}")
    out: dict[str, np.ndarray] = {}
    for gr in groups:
        # cache per-(path, axis) position sums/counts
        cache: dict[tuple[str, int], tuple[np.ndarray, int]] = {}
        for sl in gr.units[0].slices:
            leaf = scores[sl.path]
            other = tuple(a for a in range(leaf.ndim) if a != sl.axis)
            red = leaf.sum(dim=other) if other else leaf
            cnt = int(np.prod([leaf.shape[a] for a in other])) if other else 1
            cache[(sl.path, sl.axis)] = (red.cpu().numpy(), cnt)
            del leaf, red

        vals = np.zeros(gr.n_units, np.float64)
        counts = np.zeros(gr.n_units, np.float64)
        for u, cc in enumerate(gr.units):
            for sl in cc.slices:
                red, cnt = cache[(sl.path, sl.axis)]
                pos = np.asarray(sl.positions)
                vals[u] += float(red[pos].sum())
                counts[u] += cnt * len(pos)
        if agg == "mean":
            vals = vals / np.maximum(counts, 1)
        if norm == "mean":
            vals = vals / max(vals.mean(), 1e-12)
        out[gr.key] = vals
    return out
