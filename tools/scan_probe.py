#!/usr/bin/env python3
"""Where the SSD and WKV6 scan kernels spend their time, on one CUDA card.

    python3 tools/scan_probe.py [--src SRC] [--label NAME]

Imports ``repro_torch`` from SRC (default: the ``src`` of this checkout;
point it at another checkout's ``src`` to measure that version on the
same card in the same call), builds its kernels, and times each scan in
bf16 at the models' shape (zamba2-1.2b's SSD and rwkv6-7b's WKV6: b 4,
S 2048, 64 heads of 64, ds 64, chunk 64) and at variations that tell
the bottlenecks apart:

- b 1, 2 and 8 (64, 128 and 512 blocks against 256, at most two to
  three resident an SM): if a call does not get faster with fewer
  blocks, each block's serial walk over its chunks sets the time, not
  the card's throughput;
- S 1024: half the chunk steps, so the time of one step.

For each it prints one JSON line: the kernel's own mean device time
from the profiler (``device_us``; the key of the one device kernel the
call runs) and the median per-call CUDA-event time (``event_ms``).  The
last line holds the card's name and power limit from nvidia-smi.
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

VARIANTS = {"model": (4, 2048), "b 1": (1, 2048), "b 2": (2, 2048),
            "b 8": (8, 2048), "S 1024": (4, 1024)}


def device_us(fn, reps: int = 20) -> tuple[str, float]:
    """(key, mean µs a launch) of the one device kernel ``fn`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and ("ssd" in e.key or "wkv6" in e.key)]
    if len(rows) != 1:
        raise RuntimeError(f"expected one scan kernel, got {rows}")
    key, n, us = rows[0]
    return key, us / n


def event_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
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


def scan_calls(SSD, WKV, b: int, S: int):
    """{name: a call of the kernel} at b, S, 64 heads of 64, chunk 64."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    bf = torch.bfloat16
    x, B, C = rnd(b, S, 64, 64).to(bf), rnd(b, S, 64).to(bf), rnd(
        b, S, 64).to(bf)
    dt = torch.nn.functional.softplus(rnd(b, S, 64)).to(bf)
    a_log = rnd(64) * 0.5
    r, k, v = (rnd(b, S, 64, 64).to(bf) for _ in range(3))
    logw = (-torch.exp(rnd(b, S, 64, 64) * 0.8 - 0.5)).to(bf)
    u = (rnd(64, 64) * 0.5).to(bf)
    return {"ssd": lambda: SSD.ssd(x, dt, a_log, B, C, chunk=64),
            "wkv6": lambda: WKV.wkv6(r, k, v, logw, u, chunk=64)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(Path(__file__).resolve()
                                             .parents[1] / "src"))
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import kernels as K
    from repro_torch.kernels import mamba2_ssd as SSD
    from repro_torch.kernels import rwkv6_scan as WKV

    K.build_all()
    with torch.no_grad():
        for variant, (b, S) in VARIANTS.items():
            for name, fn in scan_calls(SSD, WKV, b, S).items():
                key, us = device_us(fn)
                print(json.dumps({
                    "label": args.label, "kernel": name, "variant": variant,
                    "b": b, "S": S, "blocks": 64 * b, "chunk_steps": S // 64,
                    "device_us": us, "event_ms": event_ms(fn),
                    "symbol": key[:90]}), flush=True)
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
