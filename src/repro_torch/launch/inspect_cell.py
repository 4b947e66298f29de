"""Dry-run profiler: where one cell's bytes, FLOPs and collective traffic
go, and its peak memory by kind.

The rows are ``OpCounter``'s (``launch/op_cost.py``): one device's local
ops, keyed by op, output shape and the port function that issued it (in
place of the reference's HLO loop nesting), extended to the cell's
depth and microbatches as the dry run extends its totals.  The peak is
``OpCounter``'s, by kind: parameters, optimizer state and inputs as the
dry run registers them, activations (forward and recomputation) and
backward temporaries (gradients among them).

  PYTHONPATH=src python -m repro_torch.launch.inspect_cell \\
      --arch deepseek-67b --shape train_4k [--multi-pod] [--top 15] \\
      [--json PATH]

``--json`` also writes every row and total, with the torch version, to
PATH: two such files, from two PyTorch versions or two commits, diff op
by op.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from . import dryrun
from .mesh import make_production_mesh


def breakdown(numbers: dict[str, float], top: int = 15) -> str:
    out = []
    for title, kind in zip(("BYTES", "FLOPS", "COLLECTIVE"),
                           dryrun.ROW_KINDS):
        prefix = f"rows/{kind}/"
        rows = sorted(((v, k[len(prefix):]) for k, v in numbers.items()
                       if k.startswith(prefix)), reverse=True)[:top]
        out.append(f"--- top {title} ---")
        for v, key in rows:
            op, shape, fn = key.split("|")
            out.append(f"  {v / 1e9:10.2f}G {op:32s} {fn:28s} {shape}")
    return "\n".join(out)


def memory_split(numbers: dict[str, float]) -> str:
    kinds = {k.split("/", 1)[1]: v for k, v in numbers.items()
             if k.startswith("memory/") and v}
    parts = " ".join(f"{k}={v / 2 ** 30:.2f}GiB"
                     for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
    return f"peak={numbers['live'] / 2 ** 30:.2f}GiB a device: {parts}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    numbers, _ = dryrun.measure_cell(args.arch, args.shape, mesh,
                                     record=True)
    print(breakdown(numbers, args.top))
    print(memory_split(numbers))
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"torch": torch.__version__, "arch": args.arch,
                       "shape": args.shape, "numbers": numbers}, f,
                      indent=0, sort_keys=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
