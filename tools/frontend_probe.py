#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone: the frontends and head padding
on one CUDA card.

    python3 tools/frontend_probe.py [ROOT]

Imports ``chip_smoke.py`` and ``repro_torch`` from the checkout at ROOT
(default: the current directory; JAX and the JAX package stay blocked,
as ``chip_smoke.py`` blocks them), builds the kernels, prints the card's
name and power limit, holds flash against its plain version at the two
prefill shapes the phase adds to phase 6 (pixtral-12b's S 2304 and
qwen1.5-32b's 40 heads and the 48 they are padded to), runs the
checkout's own phase 16 (pixtral-12b and padded qwen1.5-32b parity at
full width in fp32, pixtral-12b served at full size, hubert-xlarge
encoded and its training step timed at full size, qwen1.5-32b at 8
layers served unpadded and padded), then sweeps hubert-xlarge's
gradient norm at init over depth: the first 1 to 32 layers of the
full-size tree, its bf16 training copy, one batch of 4 x 2048 frames.
Exits non-zero on any failure.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

HUBERT_DEPTHS = (1, 2, 4, 8, 16, 24, 32)


def first_layers(tree: dict, n: int) -> dict:
    """The first ``n`` layers of a tree stacked along its leading dim."""
    return {k: first_layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def hubert_norms(S, M, O, D, TR) -> dict:
    """hubert-xlarge's gradient norm at init against depth: the first
    layers of the full-size tree (the trainer's seed 0), the train
    step's bf16 copy, the synthetic stream's first batch."""
    import torch

    cfg = M.get_config("hubert-xlarge")
    params = M.transformer.init_params(cfg, seed=0, device="cuda")
    data = D.SyntheticLMDataset(D.DataConfig(
        global_batch=S.HUBERT_BATCH, seq_len=S.HUBERT_FRAMES), cfg)
    b = {k: torch.from_numpy(v).to("cuda") for k, v in data[0].items()}
    norms = {}
    for n in HUBERT_DEPTHS:
        cut = cfg.replace(n_layers=n)
        tree = {**params, "blocks": first_layers(params["blocks"], n)}
        weights = TR.step.cast_weights(cut, tree)
        loss, _ = M.transformer.loss_fn(weights, cut, b)
        grads = torch.autograd.grad(loss, list(M.registry.leaves(weights)))
        norms[n] = float(O.global_norm(dict(enumerate(grads))))
        del tree, weights, loss, grads
    del params, b
    torch.cuda.empty_cache()
    return norms


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as S           # blocks jax and repro on import
    import torch

    if not torch.cuda.is_available():
        print("frontend_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import data as D
    from repro_torch import models as M
    from repro_torch import optim as O
    from repro_torch import serve as E
    from repro_torch import train as TR
    from repro_torch.core import kernels as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import shapes as SH
    from repro_torch.models import surgery as SURG
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"== {root}: card {smi}; built {K.build_all()}", flush=True)
    t0 = time.perf_counter()
    S.flash_parity(FA, [c for c in S.FLASH_CASES
                        if c[0] in ("pixtral-12b", "qwen1.5-32b",
                                    "qwen1.5-32b padded")])
    kernels = {**{n: getattr(K, n) for n in S.ACQ_OPS},
               "flash_attention": FA.flash_attention}
    launches = S.frontend_phase(M, T, E, O, D, TR, SURG, SH, FA, kernels)
    print(f"== phase 16: {time.perf_counter() - t0:.2f} s; flash "
          f"launches {launches}", flush=True)
    norms = hubert_norms(S, M, O, D, TR)
    print("== hubert-xlarge: the init's gradient norm on one batch at "
          "depth " + ", ".join(f"{n}: {g:.4e}" for n, g in norms.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
