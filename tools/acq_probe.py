#!/usr/bin/env python3
"""What the TPE and GP acquisition costs on one CUDA card, per call.

    python3 tools/acq_probe.py [--src SRC] [--label NAME]

Imports ``repro_torch`` from SRC (default: the ``src`` of this checkout;
point it at another checkout's ``src`` to measure that version on the
same card in the same call), builds its kernels, and times the samplers'
acquisition steps at the service's shapes:

- ``tpe round``: ``samplers.tpe._tpe_score`` on 64 (and 256) candidates
  against 32 good (25 valid) and 8192 bad (4975 valid) rows, D = 5 (a
  5,000-trial history);
- ``parzen_log_density``: one mixture, the bad one;
- ``gp K`` and ``gp Ks``: the GP's masked covariances at its 512 cap
  (K = Matérn(X, X) masked, with the jitter diagonal; Ks = Matérn(256
  candidates, X) column-masked), as ``samplers.gp._gp_ei`` forms them;
- ``gp ei``: the whole ``_gp_ei`` (Cholesky and solves included).

Each is first held against the same call on CPU copies of its inputs
(the plain versions; rtol = atol = 2e-4, 1e-3 for ``gp ei`` as in the
CPU tests).  For each it prints one JSON line: the median per-call
CUDA-event time (``event_ms``), and from the profiler the device time
of all the call's device events (``device_us``), their number
(``device_events``) and the keys of the largest.  The last line holds
the card's name and power limit from nvidia-smi.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.modules["jax"] = None        # the port runs without JAX ...
sys.modules["repro"] = None      # ... and without the JAX package

import numpy as np  # noqa: E402
import torch  # noqa: E402


def event_ms(fn, warmup: int = 10, reps: int = 50) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_profile(fn, reps: int = 20) -> dict:
    """Per call: device µs of all device events, their count, and the
    three largest keys."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        return {"device_us": "not measured (no device events)"}
    top = sorted(rows, key=lambda r: -r[2])[:3]
    return {"device_us": sum(us for _, _, us in rows) / reps,
            "device_events": sum(n for _, n, _ in rows) / reps,
            "top": [f"{key[:60]} x{n / reps:g} {us / reps:.2f}us"
                    for key, n, us in top]}


def cuda(*arrays):
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def tpe_inputs(c: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    xg = np.zeros((32, 5)); xg[:25] = rng.uniform(0.3, 0.5, (25, 5))
    xb = np.zeros((8192, 5)); xb[:4975] = rng.uniform(size=(4975, 5))
    return cuda(rng.uniform(size=(c, 5)), xg, np.arange(32) < 25, xb,
                np.arange(8192) < 4975, rng.uniform(0.05, 0.5, 5),
                rng.uniform(0.08, 0.7, 5))


def gp_inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(512, 5))
    y = ((X - 0.4) ** 2).sum(1)
    return cuda(X, y, np.ones(512), rng.uniform(size=(256, 5)),
                np.full(5, 0.25))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("acq_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.core import kernels as K
    from repro_torch.core.samplers import gp, tpe

    torch.backends.cuda.matmul.allow_tf32 = False
    K.build_all()
    X, y, mask, cands, ls = gp_inputs()
    jitter = 1e-6 + 1e-3

    def gp_k(X=X, mask=mask, ls=ls):
        if hasattr(K, "matern52_masked"):
            return K.matern52_masked(X, X, ls, mask, mask, jitter=jitter)
        k = K.matern52_cross(X, X, ls)
        k = torch.where(mask[:, None] * mask[None, :] > 0, k, 0.0)
        return k + torch.diag(torch.where(mask > 0, jitter, 1.0))

    def gp_ks(cands=cands, X=X, mask=mask, ls=ls):
        if hasattr(K, "matern52_masked"):
            return K.matern52_masked(cands, X, ls, col_mask=mask)
        return K.matern52_cross(cands, X, ls) * mask[None, :]

    t64, t256 = tpe_inputs(64), tpe_inputs(256, seed=2)
    bad = [t64[0], t64[3], t64[4], t64[6]]
    cases = [("tpe round C 64", tpe._tpe_score, t64, 2e-4),
             ("tpe round C 256", tpe._tpe_score, t256, 2e-4),
             ("parzen_log_density", K.parzen_log_density, bad, 2e-4),
             ("gp K", gp_k, [X, mask, ls], 2e-4),
             ("gp Ks", gp_ks, [cands, X, mask, ls], 2e-4),
             ("gp ei", gp._gp_ei, [X, y, mask, cands, ls], 1e-3)]
    for label, fn, inputs, tol in cases:
        got = fn(*inputs)
        want = fn(*(t.cpu() for t in inputs))
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
        row = {"src": args.label, "op": label,
               "max_abs_err": float((got.cpu() - want).abs().max()),
               "event_ms": event_ms(lambda: fn(*inputs)),
               **device_profile(lambda: fn(*inputs))}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
