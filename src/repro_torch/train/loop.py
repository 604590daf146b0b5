"""Fault-tolerant training loop: resume, failure injection, stragglers (the
port of ``repro.train.loop``).

  - auto-resume from the newest *valid* checkpoint (corrupt ones skipped);
  - ``run_with_restarts`` supervisor that survives injected failures and,
    on the CPU, continues bitwise-identically;
  - straggler watchdog: steps slower than ``straggler_factor`` x the
    running median are logged as events;
  - gradient-accumulation microbatching over a leading ``(accum, micro,
    ...)`` batch axis;
  - optional int8 + error-feedback gradient compression.

The loss is differentiated with ``torch.autograd`` on the model's plain
attention (``use_kernels=False``), as the reference trains with
``use_pallas=False``: the flash-attention kernel is forward only.  With
``cfg.remat`` every layer is recomputed in the backward pass
(``torch.utils.checkpoint``, which ``torch.func`` transforms refuse).  The
parameters, m, v and the error state are updated in place (the reference
donates them to its jitted step).
"""
from __future__ import annotations

import dataclasses
import time
from statistics import median
from typing import Any, Callable, Iterator

import torch

from repro_torch.core.graph import tree_paths
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compress import compress_grads, init_error_state
from repro_torch.train.optim import (OptConfig, adamw_update, f32_zeros,
                                     init_opt_state, value_and_grad)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    accum_steps: int = 1
    compress_grads: bool = False
    straggler_factor: float = 3.0
    fail_at_step: int = -1           # failure injection (tests / drills)
    seed: int = 0


class SimulatedFailure(RuntimeError):
    pass


def make_grad_step(model, opt_cfg: OptConfig, trainer_cfg: TrainerConfig):
    """The step: grads (accumulated) -> optional EF-compress -> AdamW.
    ``step(params, opt_state, err_state, batch) -> (params, opt_state,
    err_state, metrics)``."""
    from repro_torch.models.api import Model
    plain = Model(model.cfg.replace(use_kernels=False))
    accum = trainer_cfg.accum_steps

    def step(params, opt_state, err_state, batch):
        if accum > 1:
            grads = f32_zeros(params)
            acc_by = dict(tree_paths(grads))
            loss = 0.0
            for i in range(accum):
                mb = {k: v[i] for k, v in batch.items()}
                g, (l_mb, _) = value_and_grad(plain.loss, params, mb)
                for path, gi in tree_paths(g):
                    acc_by[path].add_(gi.float() / accum)
                loss = loss + l_mb / accum
                del g
            metrics = {"ce": loss}
        else:
            grads, (loss, metrics) = value_and_grad(plain.loss, params, batch)
        if trainer_cfg.compress_grads:
            grads, err_state = compress_grads(grads, err_state)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, err_state, dict(metrics, loss=loss, **om)

    return step


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    history: list[dict]
    straggler_events: list[dict]
    resumed_from: int


class Trainer:
    """Trains ``model`` (anything with ``cfg`` and ``init(seed, device)``)
    on ``device`` (None: the CUDA device; raises when there is none)."""

    def __init__(self, model, opt_cfg: OptConfig, cfg: TrainerConfig,
                 device=None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step_fn = make_grad_step(model, opt_cfg, cfg)

    def _init_state(self):
        params = self.model.init(self.cfg.seed, self.device)
        return params, init_opt_state(params), init_error_state(params)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, data_iter: Iterator[dict],
              on_step: Callable[[int, dict], None] | None = None
              ) -> TrainResult:
        params, opt_state, err_state = self._init_state()
        start_step = 0
        if self.cfg.ckpt_dir:
            latest = ckpt.latest_checkpoint(self.cfg.ckpt_dir)
            if latest is not None:
                start_step, state, _ = ckpt.load_checkpoint(
                    latest, {"params": params, "opt": opt_state,
                             "err": err_state})
                params, opt_state, err_state = (
                    state["params"], state["opt"], state["err"])

        history: list[dict] = []
        stragglers: list[dict] = []
        durations: list[float] = []
        for step in range(start_step, self.cfg.total_steps):
            batch = next(data_iter)
            t0 = time.perf_counter()
            if step == self.cfg.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            params, opt_state, err_state, metrics = self.step_fn(
                params, opt_state, err_state, batch)
            self._sync()                 # the step's time is the device's
            dt = time.perf_counter() - t0
            durations.append(dt)
            med = median(durations[-50:])
            if len(durations) > 5 and dt > self.cfg.straggler_factor * med:
                stragglers.append({"step": step, "dt": dt, "median": med})
            if (step + 1) % self.cfg.log_every == 0 or step == start_step:
                rec = {k: float(v) for k, v in metrics.items()}
                rec["step"] = step
                rec["step_s"] = dt
                history.append(rec)
                if on_step:
                    on_step(step, rec)
            if self.cfg.ckpt_dir and (step + 1) % self.cfg.ckpt_every == 0:
                ckpt.save_checkpoint(
                    ckpt.ckpt_path(self.cfg.ckpt_dir, step + 1), step + 1,
                    {"params": params, "opt": opt_state, "err": err_state})
                ckpt.prune_old(self.cfg.ckpt_dir, keep=self.cfg.keep_ckpts)
        if self.cfg.ckpt_dir:
            ckpt.save_checkpoint(
                ckpt.ckpt_path(self.cfg.ckpt_dir, self.cfg.total_steps),
                self.cfg.total_steps,
                {"params": params, "opt": opt_state, "err": err_state})
        return TrainResult(params, opt_state, history, stragglers, start_step)


def run_with_restarts(model, opt_cfg: OptConfig, cfg: TrainerConfig,
                      data_factory: Callable[[int], Iterator[dict]],
                      max_failures: int = 3, device=None) -> TrainResult:
    """Supervisor: restart from the newest valid checkpoint on failure."""
    failures = 0
    while True:
        trainer = Trainer(model, opt_cfg, cfg, device)
        try:
            # a restarted job replays data from its resume step
            start = 0
            if cfg.ckpt_dir:
                latest = ckpt.latest_checkpoint(cfg.ckpt_dir)
                if latest is not None:
                    start = ckpt.load_raw(latest)["step"]
            return trainer.train(data_factory(start))
        except SimulatedFailure:
            failures += 1
            if failures > max_failures:
                raise
            cfg = dataclasses.replace(cfg, fail_at_step=-1)
