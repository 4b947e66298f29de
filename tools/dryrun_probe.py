#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` alone, and the whole dry run on the
card's host.

    python3 tools/dryrun_probe.py [ROOT] [--all] [--mesh single|multi|both]
        [--out DIR] [--jobs N] [--cell-seconds S]
    python3 tools/dryrun_probe.py --compare DIR_A DIR_B

Imports ``chip_smoke.py`` and ``repro_torch`` from the checkout at ROOT
(default: the current directory; JAX and the JAX package stay blocked,
as ``chip_smoke.py`` blocks them), builds the kernels and runs phase 19:
deepseek-7b's, zamba2-1.2b's and rwkv6-7b's DTensor prefills with their
kernels on a one-rank CUDA mesh, the dry run's predicted FLOPs and peak
bytes against the card's, seven production cells on the 16 x 16 mesh,
a sharded checkpoint's round trip and flash with query offsets.  With ``--all`` it then runs
``python -m repro_torch.launch.dryrun --arch ARCH --mesh MESH --out DIR``
(default DIR: ``experiments/dryrun``) for every architecture, ``--jobs``
at a time in fresh processes, each stopped after ``--cell-seconds``
(its log in DIR): every cell on the card's host and torch.  Prints the
card's name and power limit; exits non-zero on any failure.

``--compare`` needs no card: it reads the records two runs wrote (two
PyTorch versions, or two commits) and prints, cell by cell, each
record's torch version, peak bytes a device, FLOPs, bytes and
collective bytes a device, and whether the two agree to 1e-9.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

KEYS = (("memory", "live_bytes_per_device"), ("op_cost", "flops_per_device"),
        ("op_cost", "bytes_per_device"),
        ("op_cost", "collective_bytes_per_device"))


def compare(dir_a: str, dir_b: str) -> int:
    """Print the two runs' records cell by cell -> the number of cells
    whose numbers differ (a cell in one run only counts too)."""
    def load(d):
        out = {}
        for path in glob.glob(os.path.join(d, "*.json")):
            with open(path) as f:
                rec = json.load(f)
            out[(rec["arch"], rec["shape"], rec["mesh"])] = rec
        return out
    a, b = load(dir_a), load(dir_b)
    differ = 0
    for cell in sorted(set(a) | set(b)):
        ra, rb = a.get(cell), b.get(cell)
        name = " ".join(cell)
        if ra is None or rb is None:
            differ += 1
            print(f"{name}: only in {dir_a if rb is None else dir_b}")
            continue
        va = [ra[k][j] for k, j in KEYS]
        vb = [rb[k][j] for k, j in KEYS]
        same = all(abs(x - y) <= 1e-9 * max(abs(x), abs(y), 1.0)
                   for x, y in zip(va, vb))
        differ += not same
        print(f"{name}: torch {ra.get('torch')} / {rb.get('torch')}; "
              f"peak {va[0] / 2 ** 30:.3f} / {vb[0] / 2 ** 30:.3f} GiB; "
              f"flops {va[1]:.6e} / {vb[1]:.6e}; bytes {va[2]:.6e} / "
              f"{vb[2]:.6e}; collective {va[3]:.6e} / {vb[3]:.6e}; "
              f"{'same' if same else 'DIFFER'}")
    both = len(set(a) & set(b))
    print(f"{both} cells in both runs, {differ - len(set(a) ^ set(b))} of "
          f"them differ; {len(set(a) ^ set(b))} in one run only")
    return differ


def run_all(root: str, mesh: str, out: str, jobs: int,
            cell_seconds: float) -> int:
    """Every architecture's cells, ``jobs`` processes at a time -> the
    number of architectures whose run failed or was stopped."""
    from repro_torch.launch import shapes as shp
    archs = sorted({a for a, _ in shp.cells()})
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    os.makedirs(out, exist_ok=True)

    def one(arch):
        with open(os.path.join(out, f"{arch}.{mesh}.log"), "w") as log:
            try:
                return subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--mesh", mesh, "--out", out],
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                    timeout=cell_seconds).returncode
            except subprocess.TimeoutExpired:
                return "stopped"
    with ThreadPoolExecutor(jobs) as pool:
        rcs = dict(zip(archs, pool.map(one, archs)))
    for arch, rc in rcs.items():
        print(f"dry run {arch} --mesh {mesh}: {rc}", flush=True)
    return sum(rc != 0 for rc in rcs.values())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--out", default=os.path.join("experiments", "dryrun"))
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--cell-seconds", type=float, default=3000.0)
    ap.add_argument("--compare", nargs=2, metavar="DIR")
    args = ap.parse_args(argv)
    if args.compare:
        return 1 if compare(*args.compare) else 0
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as S           # blocks jax and repro on import
    import torch

    if not torch.cuda.is_available():
        print("dryrun_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import models as M
    from repro_torch import serve as E
    from repro_torch.core import kernels as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba2_ssd as SSD
    from repro_torch.kernels import rwkv6_scan as WKV
    from repro_torch.models import transformer as T

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    S.log(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    K.build_all()
    kernels = {**{n: getattr(K, n) for n in S.ACQ_OPS},
               "flash_attention": FA.flash_attention, "ssd": SSD.ssd,
               "wkv6": WKV.wkv6}
    t0 = time.perf_counter()
    S.dist_phase(M, T, E, FA, kernels)
    S.lap("phase 19", t0)
    if args.all:
        t0 = time.perf_counter()
        failed = sum(run_all(root, m, args.out, args.jobs, args.cell_seconds)
                     for m in ((args.mesh,) if args.mesh != "both"
                               else ("single", "multi")))
        S.lap(f"dry run --all --mesh {args.mesh} ({failed} failed)", t0)
        if failed:
            print(smi)
            return 1
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
