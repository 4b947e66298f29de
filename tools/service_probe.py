#!/usr/bin/env python3
"""The acquisition kernels and the service phases of a checkout, on one
CUDA card, for comparing two trees in one call.

    python3 tools/service_probe.py ROOT

Imports ``chip_smoke.py`` and ``repro_torch`` from the checkout at ROOT
(its ``chip_smoke.py`` and ``src``; JAX and the JAX package stay blocked,
as ``chip_smoke.py`` blocks them), builds its kernels and runs that
checkout's own phases 2-5: the kernels against their plain versions and
their times, the TPE study (ask, tell and ask_batch(16) latency, the
profiled window's busy share), the GP study and the speculative
pipeline.  Run it on two checkouts in turns (A, B, B, A) in one call to
compare them on one card.
"""
from __future__ import annotations

import inspect
import os
import sys
import tempfile


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as S           # blocks jax and repro on import
    import torch

    if not torch.cuda.is_available():
        print("service_probe: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.core as core
    from repro_torch.core import kernels as K
    from repro_torch.core.samplers import gp as gp_mod
    from repro_torch.core.samplers import tpe as tpe_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"== {root}: built {K.build_all()}", flush=True)
    S.check_kernels(K)
    space = core.SearchSpace.from_properties(S.PROPS)
    with tempfile.TemporaryDirectory(prefix="service-probe-") as tmp:
        storage = core.DurableStorage(os.path.join(tmp, "wal"),
                                      fsync="group")
        try:
            tokens = core.TokenManager()
            token = tokens.issue("service-probe")
            key, _ = S.tpe_phase(core, K, tpe_mod, storage, tokens, space,
                                 token)
            # the GP phase took no sampler module before the masked kernel
            if "gp_mod" in inspect.signature(S.gp_phase).parameters:
                S.gp_phase(core, K, gp_mod, storage, tokens, space, token)
            else:
                S.gp_phase(core, K, storage, tokens, space, token)
            S.speculative_phase(core, K, storage, tokens, space, token, key)
        finally:
            storage.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
