"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
      --smoke --steps 50 --batch 8 --seq 64 [--checkpoint-dir ckpt] \
      [--device cpu]

Runs the real training loop (synthetic deterministic data) on one
device.  ``--smoke`` selects the reduced config (CPU-sized).
``--device`` defaults to cuda and fails without a card.
"""
from __future__ import annotations

import argparse

from ..core.kernels import resolve_device
from ..data import DataConfig
from ..models import registry
from ..optim import AdamWConfig
from ..train import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mcfg = registry.get_config(args.arch, smoke=args.smoke)
    opt = AdamWConfig(lr=args.lr)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      seed=args.seed)
    tcfg = TrainerConfig(
        total_steps=args.steps, microbatches=args.microbatches,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, log_every=args.log_every,
        seed=args.seed)
    print(f"training {mcfg.name} ({mcfg.n_params()/1e6:.1f}M params) "
          f"for {args.steps} steps, batch={args.batch} seq={args.seq} "
          f"on {device}")
    res = Trainer(mcfg, opt, dcfg, tcfg, device).run()
    print(f"done: {res.steps_run} steps in {res.wall_seconds:.1f}s, "
          f"loss {res.losses[0]:.4f} -> {res.final_loss:.4f}"
          + (f" (resumed from step {res.restored_from})"
             if res.restored_from else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
