"""Training CLI (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --reduced --steps 200 --ckpt-dir /tmp/run1 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --reduced --steps 100 --prune-ratio 0.5 --prune-at 50   # prune mid-run
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18-cifar \
      --reduced --steps 4 --prune-ratio 0.5 --prune-at 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch vit-mini \
      --reduced --steps 4 --seq 16 --prune-ratio 0.5 --prune-at 2 \
      --device cpu          # encoders train on FrameTask frames

Runs on the CUDA device; ``--device cpu`` asks for the CPU explicitly.  The
supervisor restarts from the newest valid checkpoint on failure
(``--max-failures``).  Training differentiates the model's plain attention;
evaluation forwards on the card go through the flash-attention kernel.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data.synthetic import batches
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.models.cnn import stage_widths
from repro_torch.train.loop import Trainer, TrainerConfig, run_with_restarts
from repro_torch.train.optim import OptConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--max-failures", type=int, default=3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--prune-ratio", type=float, default=0.0)
    ap.add_argument("--prune-at", type=int, default=0,
                    help="prune after this many steps, then keep training")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "must be asked for)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build(cfg)

    def data_factory(start: int, c=cfg, seq=None):
        s = seq or args.seq

        def gen():
            i = start
            while True:
                yield batches(c, "id", 1, args.batch, s, seed=1234 + i,
                              device=dev)[0]
                i += 1
        return gen()

    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                    total_steps=args.steps)

    if args.prune_ratio and args.prune_at:
        # phase 1: dense training
        tc1 = TrainerConfig(total_steps=args.prune_at,
                            log_every=max(args.prune_at // 10, 1),
                            compress_grads=args.compress_grads)
        res1 = Trainer(model, opt, tc1, dev).train(data_factory(0))
        # prune
        from repro_torch.core.pruner import prune_model
        pr = prune_model(model, res1.params, ratio=args.prune_ratio)
        if cfg.family == "cnn":
            print(f"pruned ({pr.report['mode']}): channels a stage "
                  f"{[c for c, _ in cfg.cnn_stages]} -> kept "
                  f"{stage_widths(cfg, pr.params['params'])}")
        else:
            print(f"pruned: d_ff {cfg.d_ff}->{pr.cfg.d_ff}, "
                  f"heads {cfg.n_heads}->{pr.cfg.n_heads}")

        class Warm:
            cfg = pr.cfg
            init = staticmethod(lambda seed, device: pr.params)
        tc2 = TrainerConfig(total_steps=args.steps - args.prune_at,
                            log_every=max(args.steps // 10, 1),
                            ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every)
        res = Trainer(Warm(), opt, tc2, dev).train(
            data_factory(args.prune_at, c=pr.cfg))
        history = res1.history + res.history
    else:
        tc = TrainerConfig(total_steps=args.steps,
                           log_every=max(args.steps // 10, 1),
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           accum_steps=args.accum_steps,
                           compress_grads=args.compress_grads)
        res = run_with_restarts(model, opt, tc, data_factory,
                                max_failures=args.max_failures, device=dev)
        history = res.history
        if res.straggler_events:
            print(f"straggler events: {len(res.straggler_events)}")

    print(f"loss: {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)


if __name__ == "__main__":
    main()
