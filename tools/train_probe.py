#!/usr/bin/env python3
"""The training runs' gradient norm at init against depth, and phase 18
of ``chip_smoke.py`` alone.

    python3 tools/train_probe.py [ROOT] [--arch A ...] [--depths 1,8,38]
        [--dtype float32] [--steps 5 --lr 3e-4 --warmup 0] [--phase]
    python3 tools/train_probe.py --device cpu [--arch A ...]
        [--depths 1,2] [--dtype float32] [--steps 5]

Imports ``chip_smoke.py`` and ``repro_torch`` from the checkout at ROOT
(default: the current directory; JAX and the JAX package stay blocked,
as ``chip_smoke.py`` blocks them).  For each architecture (default: the
runs of phase 18, ``chip_smoke.TRAIN_RUNS``) it prints the train step's
gradient norm at init (seed 0, the trainer's) on the synthetic stream's
first batch, for the model cut to each depth (default: 1, 8 (on the
cpu the smoke depth) and the run's own): on the card at full width, 4 x 2048 tokens in the run's
microbatches, in ``--dtype`` compute (bf16, the training dtype, unless
asked); with ``--device cpu`` at the smoke config's width, 2 x 64
tokens, one microbatch.  ``--steps N`` then trains each at its run's depth (the
smoke depth on the cpu) for N steps of AdamW at ``--lr`` (after a
linear ``--warmup``) in that compute, with a held-out batch's loss
before and after, from a fresh init.  ``--phase`` then runs the
checkout's phase 18 (the three trainings, the bf16-against-fp32 reading
and the launcher).  The last line is the norms as one JSON object.
Exits non-zero on any failure.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

DTYPES = ("bfloat16", "float32")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--arch", action="append")
    ap.add_argument("--depths", help="comma-separated layer counts")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=DTYPES, default="bfloat16")
    ap.add_argument("--steps", type=int, default=0,
                    help="then train each arch this many steps at its "
                    "run's depth (smoke depth on the cpu)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear warmup steps to --lr")
    ap.add_argument("--phase", action="store_true",
                    help="then run phase 18 (card only)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as S           # blocks jax and repro on import
    import torch

    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 2
    if cpu and args.phase:
        ap.error("--phase needs the card")
    from repro_torch import data as D
    from repro_torch import models as M
    from repro_torch import optim as O
    from repro_torch import train as TR

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cpu:
        where = "cpu"
    else:
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"== {root}: {where}", flush=True)
    dtype = getattr(torch, args.dtype)
    batch, seq = (2, 64) if cpu else (S.TRAIN_BATCH, S.TRAIN_SEQ)
    found = {}
    for arch in args.arch or list(S.TRAIN_RUNS):
        layers, micro = S.TRAIN_RUNS.get(arch, (0, 1))
        cfg = M.get_config(arch, smoke=cpu).replace(dtype=dtype)
        micro = 1 if cpu else micro
        depths = ([int(n) for n in args.depths.split(",")] if args.depths
                  else sorted({1, cfg.n_layers if cpu else 8, layers} - {0}))
        data = D.SyntheticLMDataset(D.DataConfig(global_batch=batch,
                                                 seq_len=seq), cfg)
        first = {k: torch.from_numpy(v).to(args.device)
                 for k, v in data[0].items()}
        t0 = time.perf_counter()
        norms = S.grad_norms(M, TR, cfg, first, micro, depths,
                             args.device)
        width = "smoke width" if cpu else "full width"
        print(f"== {arch} ({width}, d_model {cfg.d_model}, {args.dtype}, "
              f"{batch} x {seq}, {micro} microbatches): gradient norm at "
              "init by depth: " + ", ".join(f"{n} layers {g:.4e}"
                                            for n, g in norms.items())
              + f" ({time.perf_counter() - t0:.2f} s)", flush=True)
        found[arch] = {str(n): g for n, g in norms.items()}
        if args.steps:
            opt = O.AdamWConfig(lr=O.linear_warmup(args.lr, args.warmup)
                                if args.warmup else args.lr)
            run = cfg if cpu or not layers else cfg.replace(n_layers=layers)
            state = TR.init_train_state(run, opt, seed=0,
                                        device=args.device).tree()
            S.learn(M, D, TR, run, opt, micro, state, args.steps,
                    f"== {arch} ({run.n_layers} layers, {args.dtype}, lr "
                    f"{args.lr}, warmup {args.warmup})", args.device,
                    (batch, seq))
            del state
    if args.phase:
        from repro_torch.core import kernels as K
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import mamba2_ssd as SSD
        from repro_torch.kernels import rwkv6_scan as WKV

        kernels = {**{n: getattr(K, n) for n in S.ACQ_OPS},
                   "flash_attention": FA.flash_attention, "ssd": SSD.ssd,
                   "wkv6": WKV.wkv6}
        t0 = time.perf_counter()
        S.train_runs_phase(M, O, D, TR, kernels)
        print(f"== phase 18: {time.perf_counter() - t0:.2f} s", flush=True)
    print(json.dumps(found), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
