#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone: MoE on one CUDA card.

    python3 tools/moe_probe.py [ROOT]

Imports ``chip_smoke.py`` and ``repro_torch`` from the checkout at ROOT
(default: the current directory; JAX and the JAX package stay blocked,
as ``chip_smoke.py`` blocks them), builds the kernels, prints the card's
name and power limit, and runs the checkout's own MoE phase: qwen2-moe's
dispatch against its one-hot form and flash against ref at full width
(2 layers, fp32), decode against prefill, then qwen2-moe-a2.7b served at
full size and mixtral-8x7b at full width cut to 8 layers (bf16: prefill
tokens/s, decode ms a step, peak memory, the device time by part, 24
and 8 flash launches a prefill).  Exits non-zero on any failure.
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
        print("moe_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import models as M
    from repro_torch import serve as E
    from repro_torch.core import kernels as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"== {root}: card {smi}; built {K.build_all()}", flush=True)
    t0 = time.perf_counter()
    launches = S.moe_phase(M, T, E, MOE, FA,
                           {"flash_attention": FA.flash_attention})
    print(f"== phase 15: {time.perf_counter() - t0:.2f} s; {launches}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
