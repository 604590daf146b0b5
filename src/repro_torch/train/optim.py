"""AdamW + LR schedules, hand-rolled (the port of ``repro.train.optim``).

Optimizer state (m, v) is f32 regardless of param dtype; updates are
computed in f32 and cast back.  Weight decay applies to every leaf with
``ndim >= 2``, as in the reference: on the stacked ``(L, d)`` layer layout
that includes the stacked norm scales.

In-place updates: where the reference returns new arrays (donated by its
jitted step), ``adamw_update`` writes the new m, v and parameters into the
tensors it is given and returns the same objects — the full-width state is
8.8 GB of f32 m / v that a functional update would hold twice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.graph import tree_map_paths, tree_paths


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then cosine decay to ``min_lr_frac * lr``
    (an f32 scalar on ``step``'s device)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def f32_zeros(tree):
    """The same nesting, every leaf an f32 zero tensor of its shape on its
    device."""
    return tree_map_paths(
        lambda _, x: torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device), tree)


def init_opt_state(params) -> dict:
    dev = tree_paths(params)[0][1].device
    return {"m": f32_zeros(params), "v": f32_zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for _, x in tree_paths(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step with global-norm clipping.  ``step`` is incremented
    first, so the first step's lr is ``lr / warmup_steps``.  Returns
    (params, state, {"lr", "grad_norm"}); m, v and the parameters are
    updated in place."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    g_by = dict(tree_paths(grads))
    m_by, v_by = dict(tree_paths(state["m"])), dict(tree_paths(state["v"]))
    for path, p in tree_paths(params):
        g = g_by[path].float() * scale
        m, v = m_by[path], v_by[path]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:                      # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def value_and_grad(loss_fn, params, batch):
    """``(grads, (loss, metrics))`` of ``loss_fn(params, batch) -> (loss,
    metrics)``: what ``torch.func.grad_and_value(..., has_aux=True)`` gives,
    taken by ``torch.autograd`` on detached leaves instead, so that the
    model's remat (``torch.utils.checkpoint``) can run inside.  A leaf the
    loss does not reach gets zeros."""
    leaves = tree_map_paths(
        lambda _, x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
    paths = tree_paths(leaves)
    gs = torch.autograd.grad(loss, [x for _, x in paths], allow_unused=True)
    by = {k: torch.zeros_like(x) if g is None else g
          for (k, x), g in zip(paths, gs)}
    return (tree_map_paths(lambda k, _: by[k], leaves),
            (loss.detach(), {k: v.detach() for k, v in metrics.items()}))


def make_train_step(model, opt_cfg: OptConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics).  The loss
    is differentiated on the model's plain attention (``use_kernels=False``),
    as the reference trains with ``use_pallas=False``."""
    from repro_torch.models.api import Model
    plain = Model(model.cfg.replace(use_kernels=False))

    def train_step(params, opt_state, batch):
        grads, (loss, metrics) = value_and_grad(plain.loss, params, batch)
        new_params, new_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return new_params, new_state, metrics
    return train_step
