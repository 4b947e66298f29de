#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone: the multi-process shard fabric
on one CUDA card.

    python3 tools/fabric_probe.py [ROOT]

Imports ``chip_smoke.py`` and ``repro_torch`` from the checkout at ROOT
(default: the current directory; JAX and the JAX package stay blocked,
as ``chip_smoke.py`` blocks them), builds the kernels, prints the card's
name and power limit, and runs the checkout's own fabric phase: 8 TPE
studies at 1,000 trials each behind ``ShardFabric`` at w = 1 (inline),
2 and 4 with 32 client threads (pairs/s, ask p50/p99, owners, the
workers' own ``tpe_score`` launches), the direct mode and a GP study at
w = 4, and a failover of a semisync-replicated leader (the gap, no lost
acknowledged tell, the promoted leader's launches).  Exits non-zero on
any failure.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as S           # blocks jax and repro on import
    import torch

    if not torch.cuda.is_available():
        print("fabric_probe: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.core as core
    from repro_torch.core import kernels as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"== {root}: card {smi}; built {K.build_all()}", flush=True)
    t0 = time.perf_counter()
    S.fabric_phase(core, K)
    print(f"== phase 14: {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
