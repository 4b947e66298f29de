"""Serving launcher: batched greedy generation with the KV cache engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
      --smoke --batch 4 --prompt-len 16 --new-tokens 32 --device cpu

``--device`` defaults to cuda and fails without a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.kernels import resolve_device
from ..models import registry, transformer
from ..serve import ServeEngine


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    if args.kv_quant:
        cfg = cfg.replace(kv_quant=True)
    if not cfg.supports_decode:
        print(f"{cfg.name} is encoder-only: no decode step")
        return 1
    # initialised in cfg.dtype: a model at full size never holds its
    # float32 tree (qwen2-moe-a2.7b's alone would take 57 GB)
    params = transformer.init_params(cfg.replace(param_dtype=cfg.dtype),
                                     args.seed, device)
    eng = ServeEngine(cfg, params,
                      max_len=args.prompt_len + args.new_tokens,
                      device=device)
    del params
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=gen).numpy().astype(np.int32)
    t0 = time.time()
    out = eng.generate(prompts, args.new_tokens)
    dt = time.time() - t0
    print(f"{cfg.name}: generated {out.shape[0]}x{out.shape[1]} tokens "
          f"in {dt:.2f}s ({out.size / dt:.1f} tok/s) on {device}")
    print("first row:", out[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
