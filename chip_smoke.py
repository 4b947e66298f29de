#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py

Runs from the root of a checkout, with JAX and the JAX package blocked
from import, and exits non-zero on any failure:

 1. builds every CUDA kernel of the port (``csrc/*.cu`` under
    ``src/repro_torch``: Parzen, Matérn, flash attention, the SSD scan,
    the WKV6 scan; one nvcc per source, in parallel) into the ``build/``
    beside each ``csrc/``;
 2. holds the two acquisition kernels against their plain PyTorch
    versions on the card (rtol = atol = 2e-4): the Parzen kernel as
    ``parzen_log_density`` (27 shapes) and as ``tpe_score``, a whole
    proposal round (36 shapes, C up to 256, Ng 32 / Nb 8192), and edge
    cases (cluster slices made only of padding, one valid row in the
    last slice, fully masked mixtures, tiles smaller than a slice); the
    Matérn kernel unmasked and as the GP's masked K and Ks (6 shapes
    each); times the wrappers and the plain versions (median of
    per-launch CUDA-event times after warm-up) beside the launch floor
    and reads each kernel's device time from the profiler by symbol;
 3. serves a TPE study over HTTP (2 API workers, event-loop frontend,
    durable storage with group fsync): 5,000 completed trials on the
    5-parameter space of ``benchmarks/bench_ask_latency.py``, then timed
    single asks and tells and ``ask_batch(16)`` calls, then a profiled
    window of asks for the device's busy share and device events per
    ask; exactly one ``tpe_score`` launch per proposal round;
 4. serves a GP study to 20 below its 512-observation cap, times 20
    ask/tell pairs, then a few asks at the cap; exactly two Matérn
    launches (K and Ks) per EI evaluation;
 5. runs the speculative pipeline (depth 64) under 64 client threads;
 6. holds the flash-attention kernels against their plain version on
    the card (deepseek-7b's, zamba2-1.2b's and qwen3-32b's shapes, a 4096
    window at S 8192, windows of 200 and 32, S = 96, 100, 200, 300 and
    1000 with GQA up to 8:1, hd 16 to 128, unaligned views; 2e-4 in fp32,
    2e-2 in bf16) and times the kernel, the plain version and
    ``F.scaled_dot_product_attention`` (the yardstick only; the port
    never calls it) at deepseek-7b's and zamba2-1.2b's shapes;
 7. deepseek-7b at full width, 2 layers, fp32: prefill logits with
    ``attn_impl="flash"`` against ``"ref"`` (2e-3), and token-by-token
    decode logits against the prefill's at the end of a 64-token prompt;
 8. serves deepseek-7b at full size (30 layers, bf16 compute, random
    weights from a seeded generator on the card): ``make_prefill_step``
    on 4 x 2048 tokens (30 flash launches per call, each the Hopper
    kernel at hd 128 by its profiler symbol) and
    ``ServeEngine.generate`` on 4 x 64-token prompts, 32 new tokens;
 9. holds the SSD and WKV6 kernels against their plain versions (the
    sequential recurrences) on the card: zamba2-1.2b's and rwkv6-7b's
    prefill shapes in bf16 and fp32, strong decays (logw down to -30 a
    step, dt * A down to -50) at those shapes in bf16, chunks of 8 and
    16, one chunk, hd 16, 32 and 128 (ds 128), the model's strided views
    and unaligned views, a carried WKV6 state (2e-4 in fp32; 5e-2 for SSD
    and 6e-2 for WKV6 in bf16), and times the kernels (bf16: the
    tensor-core kernels, by profiler symbol) and the plain versions at
    the model shapes;
10. zamba2-1.2b (7 layers: one shared-attention group and one tail
    layer) and rwkv6-7b (2 layers) at full width in fp32: prefill logits
    with ``ssm_impl="pallas"`` (and flash) against ``"ref"`` (2e-3), and
    decode logits against the prefill's at the end of a 64-token prompt;
11. serves zamba2-1.2b (38 layers) and then rwkv6-7b (32 layers) at full
    size in bf16 as phase 8 serves deepseek-7b: 38 SSD and 6 flash
    launches (the Hopper kernel at hd 64) per zamba2 prefill, 32 WKV6
    launches per rwkv6 prefill; the profiled prefills must run the
    tensor-core SSD and WKV6 kernels by their profiler symbols;
12. trains deepseek-7b at full width with its depth cut from 30 to 8
    layers (2.46e9 parameters: fp32 masters and AdamW moments, a bf16
    copy and bf16 gradients take ~44 GB; all 30 layers would need ~124
    GB): bf16 compute, remat on, ref attention, 4 x 2048 tokens of the
    synthetic stream, one warm-up and 4 timed steps at lr 3e-4 (ms a
    step, tokens/s, peak memory, model-FLOPs share), a profiled step
    (busy share, largest device entries), AdamW alone, then the same
    batch unsplit and in 2 microbatches (losses within 1e-2); finite and
    falling losses, no kernel of this repo launched (none has a
    backward);
13. the HPO loop of ``benchmarks/bench_hpo_train.py`` on the card: a
    TPE study (``HopaasServer(device="cuda")``, ``DirectTransport``) over
    lr and weight decay with the median pruner, each trial
    ``hopaas_objective`` on deepseek-7b's smoke config (20 steps); 12
    trials and on until two were proposed past TPE's 10 startup trials
    (pruned trials are no observations), so ``tpe_score`` launches;
    every trial told, best loss <= median; then a checkpoint at step 10
    restored by a fresh ``Trainer`` ends where an uninterrupted run does
    (1e-4);
14. the multi-process shard fabric (after timing a fresh process's
    imports, most of a worker's start: ``ShardFabric``, durable storage,
    group fsync, ``device="cuda"``) at w = 1 (inline), 2 and 4 worker
    processes: 8 TPE studies on the 5-parameter space told 1,000 trials
    each, then 32 keep-alive client threads (4 a study) doing ask/tell
    pairs for 8 s through the router (pairs/s, ask p50/p99, the owners
    of the 8 studies, at least 3 at w = 4), and at w = 4 once more
    through ``ShardedHttpTransport`` (no router hop) and a GP study;
    every ask launches exactly one ``tpe_score`` in the process of the
    worker that owns its study, and the GP's asks ``matern52_masked``
    only in its owner, read from each worker's own health endpoint;
    every worker that owns a study maps libcuda and the Parzen library
    (the GP's owner also Matérn's) and no worker maps anything under a
    ``jax`` or ``jaxlib`` directory (``/proc/<pid>/maps``); then a
    failover: 2 workers with one semisync follower each (fsync always),
    a TPE study past startup, 4 clients, SIGKILL of its leader
    mid-campaign: the gap to the first pair started after the kill,
    every acknowledged tell read back from the promoted leader, whose
    asks launch ``tpe_score`` on the card, and a new follower attached.

The launch counters are set to 0 just before each of phases 3-5, 8, 11
(each model of it), 12, 13 and 14 and read just after it (a fabric
worker's counters are its own process's: they start at 0 with it and
phase 14 reads them before and after each window).  The last three
lines are the kernels' JSON record, the card's name and power limit
from nvidia-smi, and the result line.
"""
from __future__ import annotations

import sys

sys.modules["jax"] = None        # the port must run without JAX ...
sys.modules["repro"] = None      # ... and without the JAX package

import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
TOL = dict(rtol=2e-4, atol=2e-4)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
# exp2 on the SFUs (MUFU.EX2): 16 results a clock an SM on sm_90 (NVIDIA's
# table of arithmetic instruction throughput), 132 SMs, 1.98 GHz
SFU_OPS_PER_S = 132 * 16 * 1.98e9
FLASH_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# the reference's own (tests/kernels/test_ssd_wkv.py)
SCAN_TOL = {("ssd", torch.float32): dict(rtol=2e-4, atol=2e-4),
            ("ssd", torch.bfloat16): dict(rtol=5e-2, atol=5e-2),
            ("wkv6", torch.float32): dict(rtol=2e-4, atol=2e-4),
            ("wkv6", torch.bfloat16): dict(rtol=6e-2, atol=6e-2)}
PROPS = {"lr": {"type": "loguniform", "low": 1e-5, "high": 1e-1},
         "wd": {"type": "loguniform", "low": 1e-6, "high": 1e-2},
         "width": {"type": "int", "low": 32, "high": 1024},
         "act": {"type": "categorical", "choices": ["relu", "gelu", "silu"]},
         "dropout": {"type": "uniform", "low": 0.0, "high": 0.5}}
HISTORY = 5000
GP_HISTORY = 512
FLEET = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def objective(space, params: dict) -> float:
    """Shifted sphere on the unit cube: optimum at u = 0.3 everywhere."""
    u = space.to_unit_matrix([params])[0]
    return float(((u - 0.3) ** 2).sum())


def event_times_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    """Median over ``reps`` launches, each between two CUDA events."""
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


def profiled(fn) -> tuple[float, dict[str, tuple[int, float]]]:
    """Run ``fn`` under the PyTorch profiler.  Returns the wall seconds
    and, per device-side event name, (count, total device µs); an empty
    dict means the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = {e.key: (e.count, e.self_device_time_total)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    return wall, device


def kernel_device_us(fn, kernel: str, reps: int = 50) -> str:
    """Mean device time of one launch of ``kernel``, the symbol of the
    kernel ``fn`` launches (a template's instance with its arguments, as
    ``flash_fwd_wgmma_kernel<128>``), and its launch count over ``reps``
    calls of ``fn``.  Fails if more than one profiler key matches."""
    _, device = profiled(lambda: [fn() for _ in range(reps)])
    if not device:
        return "not measured (no device events)"
    hits = [(key, n, us) for key, (n, us) in device.items() if kernel in key]
    check(len(hits) == 1, f"{len(hits)} profiler keys match {kernel!r}: "
          f"{[key for key, _, _ in hits]}")
    _, n, us = hits[0]
    return (f"{us / n:.2f} us per launch ({kernel}, profiler, {n} launches "
            f"in {reps} calls)")


def lap(what: str, t0: float) -> float:
    """Log the wall time since ``t0``; returns the time now."""
    now = time.perf_counter()
    log(f"{what}: {now - t0:.2f} s")
    return now


def pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q))


# --------------------------------------------------------------------- #
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------- #
def parzen_inputs(c, d, mixtures, seed):
    """cands (C, D) and, for each mixture (rows, valid rows as a slice),
    obs (rows, D), its 0/1 mask and bandwidths (D,), on the card."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(size=(c, d))]
    for n, valid in mixtures:
        mask = np.zeros(n)
        mask[valid] = 1.0
        out += [rng.uniform(size=(n, d)), mask,
                rng.uniform(0.05, 0.7, size=d)]
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in out]


def matern_inputs(a, b, d, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(size=(a, d)), rng.uniform(size=(b, d)),
              rng.uniform(0.1, 0.5, size=d))
    return [torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in arrays]


def agree(out, ref, what: str) -> tuple[float, float]:
    """Hold ``out`` against ``ref`` at TOL (equal infinities agree);
    returns the largest finite |difference| and the largest share of its
    tolerance (atol + rtol |ref|) that a difference takes."""
    torch.cuda.synchronize()
    try:
        torch.testing.assert_close(out, ref, **TOL)
    except AssertionError as e:
        raise RuntimeError(f"check failed: {what}: {e}") from None
    diff = (out - ref).abs()
    share = diff / (TOL["atol"] + TOL["rtol"] * ref.abs())
    finite = torch.isfinite(diff)
    if not finite.any():
        return 0.0, 0.0
    return float(diff[finite].max()), float(share[finite].max())


class Agreement:
    """The largest |difference| and tolerance share over many checks."""

    def __init__(self):
        self.err = self.share = 0.0

    def add(self, out, ref, what: str) -> None:
        err, share = agree(out, ref, what)
        self.err, self.share = max(self.err, err), max(self.share, share)

    def __str__(self) -> str:
        return (f"max |err| {self.err:.3e}, at most {self.share:.3f} of "
                "the tolerance")


def acq_timing(label, fn, plain, args, symbol, nbytes, flops, exps,
               floor_ms) -> dict:
    """Wrapper, plain and device time of one acquisition op, its bound
    (bytes at the HBM rate against FMAs at the fp32 rate and
    exponentials at the SFU rate), logged beside the launch floor."""
    ms = event_times_ms(lambda: fn(*args))
    plain_ms = event_times_ms(lambda: plain(*args))
    fields = dict(ms=ms, plain_ms=plain_ms, **bound(nbytes, flops,
                                                      exps=exps),
                  library_ms=None)
    device = kernel_device_us(lambda: fn(*args), symbol)
    log(f"{label}: wrapper {ms:.4f} ms ({ms / floor_ms:.2f} launch "
        f"floors), plain {plain_ms:.4f} ms, bound "
        f"{fields['bound_ms'] * 1e3:.4f} us ({fields['bound_by']}; "
        f"{nbytes} bytes, {flops:.4e} flops, {exps:.4e} exponentials); "
        f"kernel device time {device}")
    return fields


def parzen_work(c, d, mixtures):
    """(bytes, flops, exponentials) of a Parzen launch with this run's
    masks: each input read once, the output written once; per valid
    (candidate, row) pair D FMAs, four other operations and one
    exponential."""
    sizes = [obs.shape[0] for obs, _, _ in mixtures]
    valid = sum(int((mask > 0).sum()) for _, mask, _ in mixtures)
    nbytes = 4 * (c * d + sum(sizes) * (d + 1) + len(mixtures) * d + c)
    return nbytes, c * valid * (2 * d + 4), c * valid


def matern_work(a, b, d, masks: int):
    """(bytes, flops, exponentials) of a Matérn launch: per output D FMAs,
    ten other operations and one exponential."""
    nbytes = 4 * (a * d + b * d + d + a * b + masks)
    return nbytes, a * b * (2 * d + 10), a * b


# Parzen cases beyond the 27 prefix-masked shapes: (label, C, D,
# [(rows, valid rows) of each mixture]); one mixture runs
# ``parzen_log_density``, two ``tpe_score`` ([good, bad])
PARZEN_EDGE = [
    ("padding-only cluster slices", 64, 5, [(8192, slice(0, 100))]),
    ("one valid row in the last slice", 64, 5, [(8192, slice(8191, 8192))]),
    ("fully masked", 64, 3, [(300, slice(0, 0))]),
    ("padding-only cluster slices", 64, 5, [(32, slice(0, 25)),
                                            (8192, slice(0, 100))]),
    ("one valid row in the last slice", 128, 5,
     [(8, slice(0, 1)), (1000, slice(999, 1000))]),
    ("fully masked good mixture", 64, 5, [(32, slice(0, 0)),
                                          (300, slice(0, 250))]),
    ("tiles smaller than a slice", 256, 100, [(32, slice(0, 30)),
                                              (4096, slice(0, 3000))]),
]


def check_parzen(K, floor_ms) -> dict:
    agreed = Agreement()
    n_cases = 0
    seed = 0
    for c in (64, 96, 128):                    # one mixture, masked tail
        for n in (32, 300, 8192):
            for d in (1, 5, 11):
                x, *mix = parzen_inputs(c, d, [(n, slice(0, max(
                    1, n - n // 5)))], seed)
                seed += 1
                agreed.add(K.parzen_log_density(x, *mix),
                           K.parzen_log_density_plain(x, *mix),
                           f"parzen C={c} N={n} D={d}")
                n_cases += 1
    for c in (64, 96, 128, 256):               # the TPE score
        for ng, nb in ((32, 8192), (8, 16), (32, 300)):
            for d in (1, 5, 11):
                args = parzen_inputs(c, d, [(ng, slice(0, ng - ng // 5)),
                                            (nb, slice(0, nb - nb // 3))],
                                     seed)
                seed += 1
                args = [args[0], *args[1:3], *args[4:6], args[3], args[6]]
                agreed.add(K.tpe_score(*args), K.tpe_score_plain(*args),
                           f"tpe_score C={c} {ng}/{nb} D={d}")
                n_cases += 1
    for label, c, d, mixes in PARZEN_EDGE:
        args = parzen_inputs(c, d, mixes, seed)
        seed += 1
        if len(mixes) == 1:
            out = K.parzen_log_density(*args)
            ref = K.parzen_log_density_plain(*args)
        else:
            args = [args[0], *args[1:3], *args[4:6], args[3], args[6]]
            out, ref = K.tpe_score(*args), K.tpe_score_plain(*args)
        agreed.add(out, ref, f"parzen {label}")
        check(bool(torch.isfinite(out).all()) or label == "fully masked",
              f"parzen {label}: not finite")
        n_cases += 1
    log(f"parzen kernel: {n_cases} cases agree ({agreed}): 27 "
        "parzen_log_density shapes, 36 tpe_score shapes (C up to 256, "
        f"Ng 32 / Nb 8192), {len(PARZEN_EDGE)} edge cases")

    mixes = [(32, slice(0, 25)), (8192, slice(0, 4975))]   # a 5k history
    x, xg, mg, bwg, xb, mb, bwb = parzen_inputs(64, 5, mixes, 1234)
    work = parzen_work(64, 5, [(xg, mg, bwg), (xb, mb, bwb)])
    fields = acq_timing(
        "tpe_score at C=64, Ng 32 (25 valid), Nb 8192 (4975), D=5",
        K.tpe_score, K.tpe_score_plain, (x, xg, mg, xb, mb, bwg, bwb),
        "parzen_cluster_kernel<4>", *work, floor_ms)
    acq_timing("parzen_log_density at C=64, N 8192 (4975 valid), D=5",
               K.parzen_log_density, K.parzen_log_density_plain,
               (x, xb, mb, bwb), "parzen_cluster_kernel<4>",
               *parzen_work(64, 5, [(xb, mb, bwb)]), floor_ms)
    return dict(name="tpe_score", route="cuda",
                source="src/repro_torch/core/kernels/csrc/parzen.cu",
                replaces="src/repro/core/kernels/parzen.py:88",
                max_abs_err=agreed.err, **fields)


def gp_masks(n, n_valid):
    return torch.as_tensor(np.arange(n) < n_valid, dtype=torch.float32,
                           device="cuda")


def check_matern(K, floor_ms) -> dict:
    agreed = Agreement()
    shapes = [(512, 512, 5), (256, 512, 5), (1024, 1024, 5), (100, 37, 5),
              (100, 37, 1), (100, 37, 11)]
    for i, (a, b, d) in enumerate(shapes):
        xa, xb, ls = matern_inputs(a, b, d, 100 + i)
        agreed.add(K.matern52_cross(xa, xb, ls),
                   K.matern52_cross_plain(xa, xb, ls),
                   f"matern52_cross {a}x{b} D={d}")
        # the GP's K over b padded rows (two thirds valid) and its Ks
        cm = gp_masks(b, 2 * b // 3)
        agreed.add(
            K.matern52_masked(xb, xb, ls, cm, cm, jitter=1e-6 + 1e-3),
            K.matern52_masked_plain(xb, xb, ls, cm, cm, jitter=1e-6 + 1e-3),
            f"matern52_masked K {b}x{b} D={d}")
        agreed.add(K.matern52_masked(xa, xb, ls, col_mask=cm),
                   K.matern52_masked_plain(xa, xb, ls, col_mask=cm),
                   f"matern52_masked Ks {a}x{b} D={d}")
    log(f"matern kernel: {len(shapes)} shapes agree, unmasked, as the "
        f"GP's K and as its Ks ({agreed})")

    X, cands, ls = matern_inputs(512, 256, 5, 99)
    mask = gp_masks(512, 512)
    jitter = 1e-6 + 1e-3
    fields = acq_timing(
        "matern52_masked K at 512 x 512, D=5 (the GP cap)",
        lambda X, m, ls: K.matern52_masked(X, X, ls, m, m, jitter=jitter),
        lambda X, m, ls: K.matern52_masked_plain(X, X, ls, m, m,
                                                 jitter=jitter),
        (X, mask, ls), "matern52_tile_kernel",
        *matern_work(512, 512, 5, 512), floor_ms)
    acq_timing("matern52_masked Ks at 256 x 512, D=5",
               lambda c, X, m, ls: K.matern52_masked(c, X, ls, col_mask=m),
               lambda c, X, m, ls: K.matern52_masked_plain(c, X, ls,
                                                           col_mask=m),
               (X[:256], X, mask, ls), "matern52_tile_kernel",
               *matern_work(256, 512, 5, 512), floor_ms)
    acq_timing("matern52_cross at 512 x 512, D=5", K.matern52_cross,
               K.matern52_cross_plain, (X, X, ls), "matern52_tile_kernel",
               *matern_work(512, 512, 5, 0), floor_ms)
    return dict(name="matern52_masked", route="cuda",
                source="src/repro_torch/core/kernels/csrc/matern.cu",
                replaces="src/repro/core/kernels/matern.py:50",
                max_abs_err=agreed.err, **fields)


def check_kernels(K) -> dict[str, dict]:
    one = torch.zeros(1, device="cuda")
    floor_ms = event_times_ms(lambda: one.add_(1))
    log(f"launch floor: one 1-element PyTorch op takes {floor_ms:.4f} ms "
        "per call (same per-call CUDA-event timing)")
    rows = {"tpe_score": check_parzen(K, floor_ms),
            "matern52_masked": check_matern(K, floor_ms)}
    log("library_ms: null for both; neither function is a single "
        "PyTorch call")
    return rows


def bound(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S,
          exps: int = 0) -> dict:
    """The larger of the bytes at the HBM rate, the operations at
    ``ops_per_s`` and the exponentials at the SFU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ops_per_s, exps / SFU_OPS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- #
# phases 3-5: the service on the card
# --------------------------------------------------------------------- #
def start_service(core, storage, tokens, speculate_depth=0):
    servers = [core.HopaasServer(storage=storage, tokens=tokens,
                                 worker_name=f"api-{i}", device="cuda",
                                 speculate_depth=speculate_depth)
               for i in range(2)]
    runner = core.HttpServiceRunner(servers, backend="evloop").start()
    return servers, runner


def fill(client, space, key, n_total, batch):
    done = 0
    while done < n_total:
        trials = client.ask_batch(key, min(batch, n_total - done))
        client.tell_batch([{"trial_uid": t["uid"],
                            "value": objective(space, t["params"])}
                           for t in trials])
        done += len(trials)


def in_space(space, params) -> bool:
    u = space.to_unit_matrix([params])[0]
    return bool(np.all((u >= 0) & (u <= 1)))


def tpe_phase(core, K, tpe_mod, storage, tokens, space, token):
    servers, runner = start_service(core, storage, tokens)
    rounds = [0]
    propose = tpe_mod._tpe_propose

    def counted(*args, **kwargs):
        rounds[0] += 1
        return propose(*args, **kwargs)

    tpe_mod._tpe_propose = counted
    try:
        client = core.Client(core.HttpTransport(runner.host, runner.port),
                             token)
        key, _ = client.ensure_study({"name": "smoke-tpe",
                                      "properties": PROPS,
                                      "sampler": {"name": "tpe"}})
        reset_counts(K)
        t0 = time.perf_counter()
        fill(client, space, key, HISTORY, 256)
        log(f"tpe: seeded {HISTORY} completed trials in "
            f"{time.perf_counter() - t0:.2f} s")
        ask_s, tell_s, batch_s = [], [], []
        for _ in range(50):
            t0 = time.perf_counter()
            trial = client.ask(key)
            ask_s.append(time.perf_counter() - t0)
            check(in_space(space, trial["params"]), "ask out of space")
            t0 = time.perf_counter()
            client.tell(trial["uid"], objective(space, trial["params"]))
            tell_s.append(time.perf_counter() - t0)
        for _ in range(10):
            t0 = time.perf_counter()
            trials = client.ask_batch(key, 16)
            batch_s.append(time.perf_counter() - t0)
            check(len({t["uid"] for t in trials}) == 16, "batch size")
            client.tell_batch([{"trial_uid": t["uid"],
                                "value": objective(space, t["params"])}
                               for t in trials])
        busy = busy_share(client, space, key)
        launches = K.tpe_score.launches
        check(launches > 0, "parzen kernel never launched")
        check(launches == rounds[0],
              f"{launches} tpe_score launches for {rounds[0]} rounds")
        others = {n: c for n, c in K.launch_counts().items()
                  if n != "tpe_score"}
        check(not any(others.values()), f"other launches by TPE: {others}")
        study = client.study(key)
        n_done = HISTORY + 50 + 160 + 20
        check(study["n_completed"] == n_done,
              f"n_completed {study['n_completed']} != {n_done}")
        check(math.isfinite(study["best_value"]), "best value not finite")
        log(f"tpe: {study['n_completed']} completed, best "
            f"{study['best_value']:.6f}; {rounds[0]} proposal rounds, "
            f"{launches} tpe_score launches (one per round)")
        log(f"tpe ask  p50 {pct(ask_s, 50):.3f} ms  p99 "
            f"{pct(ask_s, 99):.3f} ms  (n=50, history {HISTORY})")
        log(f"tpe tell p50 {pct(tell_s, 50):.3f} ms  p99 "
            f"{pct(tell_s, 99):.3f} ms")
        log(f"tpe ask_batch(16) p50 {pct(batch_s, 50):.3f} ms  p99 "
            f"{pct(batch_s, 99):.3f} ms  (n=10)")
        log(busy)
        check_tpe_scores(servers, key, tpe_mod)
    finally:
        tpe_mod._tpe_propose = propose
        runner.stop()
        for s in servers:
            s.close()
    return key, launches


def busy_share(client, space, key, n: int = 20) -> str:
    """Device busy share over ``n`` ask/tell pairs, from a separate
    profiled window (the timed asks above run without the profiler)."""
    def drive():
        for _ in range(n):
            trial = client.ask(key)
            client.tell(trial["uid"], objective(space, trial["params"]))

    wall, device = profiled(drive)
    if not device:
        return "tpe: device busy share not measured (no device events)"
    busy_us = sum(us for _, us in device.values())
    events = sum(c for c, _ in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    every = sorted(device.items(), key=lambda kv: -kv[1][0])
    return (f"tpe: {n} profiled ask/tell pairs, wall {wall * 1e3:.1f} ms, "
            f"device busy {busy_us / 1e3:.3f} ms (share "
            f"{busy_us / 1e6 / wall:.4f}), {events} device events "
            f"({events / n:g} per ask/tell pair); top device events: "
            + "; ".join(f"{k[:40]} x{c} {us:.0f}us"
                        for k, (c, us) in top)
            + "\ntpe: device events per ask/tell pair, by name: "
            + "; ".join(f"{event_name(k)} x{c / n:g}" for k, (c, _) in every))


def event_name(key: str) -> str:
    """A device event's key cut short, with the functors and sort or
    random-number kernels named past the cut, which tell PyTorch's
    generic elementwise and reduce kernels apart."""
    tags = re.findall(r"\w*(?:[Ff]unctor|[Ss]ort|[Rr]adix|multinomial|"
                      r"normal|uniform|index|[Cc]at)\w*", key[40:])
    tags = [t for t in dict.fromkeys(tags) if t != "func_wrapper_t"]
    return key[:40] + (f" [{','.join(tags)[:70]}]" if tags else "")


def check_tpe_scores(servers, key, tpe_mod):
    """The live study's split buffers, scored on the card (kernel) and
    on the CPU (plain version), agree on the same candidates."""
    for server in servers:
        ctx = server._context_for_key(key)
        if ctx is not None and ctx.sampler._split is not None:
            xg, mg, xb, mb = ctx.sampler._split
            break
    else:
        raise RuntimeError("no TPE split found on the server")
    gen = torch.Generator(device=xg.device).manual_seed(0)
    cands, bw, bw_b = tpe_mod._tpe_candidates(xg, mg, xb, mb, gen, 128)
    gpu = tpe_mod._tpe_score(cands, xg, mg, xb, mb, bw, bw_b)
    cpu = tpe_mod._tpe_score(*(t.cpu() for t in (cands, xg, mg, xb, mb,
                                                  bw, bw_b)))
    torch.testing.assert_close(gpu.cpu(), cpu, **TOL)
    log(f"tpe: live split ({int(mg.sum())} good / {int(mb.sum())} bad "
        f"rows) scores agree with the CPU plain version, max |err| "
        f"{float((gpu.cpu() - cpu).abs().max()):.3e}")


def gp_phase(core, K, gp_mod, storage, tokens, space, token):
    servers, runner = start_service(core, storage, tokens)
    evals = [0]
    gp_ei = gp_mod._gp_ei

    def counted(*args, **kwargs):
        evals[0] += 1
        return gp_ei(*args, **kwargs)

    gp_mod._gp_ei = counted
    try:
        client = core.Client(core.HttpTransport(runner.host, runner.port),
                             token)
        key, _ = client.ensure_study({"name": "smoke-gp",
                                      "properties": PROPS,
                                      "sampler": {"name": "gp"}})
        reset_counts(K)
        t0 = time.perf_counter()
        fill(client, space, key, GP_HISTORY - 20, 64)
        log(f"gp: seeded {GP_HISTORY - 20} completed trials in "
            f"{time.perf_counter() - t0:.2f} s")
        near_s = []
        for _ in range(20):            # 492..511 observations: K 512 x 512
            t0 = time.perf_counter()
            trial = client.ask(key)
            near_s.append(time.perf_counter() - t0)
            check(in_space(space, trial["params"]), "gp ask")
            client.tell(trial["uid"], objective(space, trial["params"]))
        ask_s = []
        trials = []
        for _ in range(4):              # at the cap; pending rows pad to 1024
            t0 = time.perf_counter()
            trials.append(client.ask(key))
            ask_s.append(time.perf_counter() - t0)
            check(in_space(space, trials[-1]["params"]), "gp ask")
        client.tell_batch([{"trial_uid": t["uid"],
                            "value": objective(space, t["params"])}
                           for t in trials])
        launches = K.matern52_masked.launches
        check(launches > 0, "matern kernel never launched")
        check(launches == 2 * evals[0],
              f"{launches} matern launches for {evals[0]} EI evaluations")
        others = {n: c for n, c in K.launch_counts().items()
                  if n != "matern52_masked"}
        check(not any(others.values()), f"other launches by GP: {others}")
        study = client.study(key)
        check(math.isfinite(study["best_value"]), "gp best not finite")
        log(f"gp: {study['n_completed']} completed, best "
            f"{study['best_value']:.6f}; {evals[0]} EI evaluations, "
            f"{launches} matern launches (K and Ks, one each)")
        log(f"gp ask at 492-511 observations p50 {pct(near_s, 50):.3f} ms "
            f" p99 {pct(near_s, 99):.3f} ms (n=20, K 512 x 512)")
        log(f"gp ask at the cap p50 {pct(ask_s, 50):.3f} ms  max "
            f"{pct(ask_s, 100):.3f} ms (n=4; the first at 512 rows, then "
            "pending rows pad K to 1024)")
    finally:
        gp_mod._gp_ei = gp_ei
        runner.stop()
        for s in servers:
            s.close()
    return launches


ACQ_OPS = ("tpe_score", "parzen_log_density", "matern52_masked",
           "matern52_cross")


def reset_counts(K) -> None:
    for n in ACQ_OPS:
        getattr(K, n).launches = 0


def speculative_phase(core, K, storage, tokens, space, token, key):
    servers, runner = start_service(core, storage, tokens,
                                    speculate_depth=FLEET)
    errors: list[BaseException] = []
    counts = [0] * FLEET
    stop_at = time.monotonic() + 5.0

    def worker(i: int) -> None:
        try:
            client = core.Client(
                core.HttpTransport(runner.host, runner.port), token,
                worker_id=f"w{i}")
            while time.monotonic() < stop_at:
                trial = client.ask(key, parallelism=FLEET)
                client.tell(trial["uid"], objective(space, trial["params"]))
                counts[i] += 1
        except BaseException as e:  # reported and re-raised below
            errors.append(e)

    try:
        reset_counts(K)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(FLEET)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "client hung")
        if errors:
            raise errors[0]
        stats = [s.speculation_stats() for s in servers]
        hits = sum(s["hits"] + s["stale_hits"] for s in stats)
        misses = sum(s["misses"] for s in stats)
        rounds = sum(s["rounds"] for s in stats)
        check(sum(s["errors"] for s in stats) == 0, "precompute errors")
        check(K.tpe_score.launches > 0, "no tpe_score launches")
        rate = hits / max(1, hits + misses)
        log(f"speculative: {FLEET} threads, {sum(counts)} ask/tell pairs "
            f"in {wall:.2f} s, {rounds} precompute rounds, queue_hit_rate "
            f"{rate:.4f}, {K.tpe_score.launches} tpe_score launches")
    finally:
        runner.stop()
        for s in servers:
            s.close()


# --------------------------------------------------------------------- #
# phase 6: flash attention against its plain version
# --------------------------------------------------------------------- #
# (label, B, Hq, Hkv, S, hd, dtype, causal, window); fp32 runs the scalar
# kernel, bf16 the Hopper pipeline at hd 64 and 128 and mma.sync at hd 16
# and 32 (``kernel_symbol``)
BF16, FP32 = torch.bfloat16, torch.float32
FLASH_CASES = [
    ("deepseek-7b", 4, 32, 32, 2048, 128, BF16, True, None),
    ("zamba2-1.2b", 4, 32, 32, 2048, 64, BF16, True, None),
    ("qwen3-32b GQA", 2, 64, 8, 1024, 128, BF16, True, None),
    ("qwen3-32b GQA", 2, 64, 8, 1024, 128, FP32, True, None),
    ("window 4096", 1, 32, 8, 8192, 128, BF16, True, 4096),
    ("S 1000 GQA 8:1", 1, 32, 4, 1000, 128, BF16, True, None),
    ("window 200", 2, 8, 8, 1024, 64, BF16, True, 200),
    ("S 300 full", 1, 8, 2, 300, 128, BF16, False, None),
    ("S 200 full", 2, 4, 4, 200, 64, BF16, False, None),
    ("window 32", 2, 8, 8, 256, 64, FP32, True, 32),
    ("window 32", 2, 8, 8, 256, 64, BF16, True, 32),
    ("S 96", 2, 4, 4, 96, 64, FP32, True, None),
    ("S 96", 2, 4, 4, 96, 64, BF16, True, None),
    ("S 100", 2, 4, 2, 100, 32, BF16, True, None),
    ("S 100 full", 2, 4, 2, 100, 32, FP32, False, None),
    ("S 100 full", 2, 4, 2, 100, 32, BF16, False, None),
    ("hd 16", 2, 4, 2, 128, 16, FP32, True, None),
    ("hd 16", 2, 4, 2, 100, 16, BF16, True, None),
    ("unaligned view", 2, 4, 2, 100, 32, BF16, True, None),
    ("unaligned view", 1, 8, 2, 200, 128, BF16, True, None),
]
# the serving shapes, timed: deepseek-7b's (the JSON row) and zamba2's
FLASH_TIMED = ("deepseek-7b", "zamba2-1.2b")


def flash_inputs(b, hq, hkv, s, hd, dtype, seed, unaligned=False):
    """q (b, s, hq, hd), k and v (b, s, hkv, hd); ``unaligned``: views
    whose rows start off 16-byte boundaries."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pad = 1 if unaligned else 0
    return [torch.randn((b, s, h, hd + pad), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)[..., pad:]
            for h in (hq, hkv, hkv)]


def visible_pairs(s: int, causal: bool, window: int | None) -> int:
    """(q, k) pairs the mask lets through, S = T, positions from 0."""
    q = np.arange(s)
    lo = np.zeros(s, np.int64) if window is None else np.maximum(
        0, q - window + 1)
    hi = q + 1 if causal else np.full(s, s)
    return int((hi - lo).sum())


def time_flash(FA, case: tuple, seed: int) -> dict:
    """The kernel, the plain version and SDPA at one shape; returns the
    kernel's JSON fields."""
    label, b, hq, hkv, s, hd, dt, causal, window = case
    q, k, v = flash_inputs(b, hq, hkv, s, hd, dt, seed)
    ms = event_times_ms(lambda: FA.flash_attention(q, k, v), 2, 10)
    plain_ms = event_times_ms(lambda: FA.attention_ref(q, k, v), 2, 10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = event_times_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                                2, 10)
    symbol = FA.ops.kernel_symbol(dt, hd)
    device = kernel_device_us(lambda: FA.flash_attention(q, k, v), symbol,
                              reps=10)
    _, sdpa_events = profiled(lambda: [sdpa(qt, kt, vt, is_causal=True)
                                       for _ in range(10)])
    sdpa_device = (f"{sum(us for _, us in sdpa_events.values()) / 10:.2f} "
                   "us per call (profiler, all its device events: "
                   + ", ".join(f"{key[:60]} x{n}" for key, (n, _)
                               in sdpa_events.items()) + ")"
                   if sdpa_events else "not measured (no device events)")
    pairs = b * hq * visible_pairs(s, causal, window)
    ops = 4 * hd * pairs              # q.k and p.v, a multiply-add each
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    fields = dict(ms=ms, plain_ms=plain_ms,
                  **bound(nbytes, ops, BF16_OPS_PER_S), library_ms=library_ms)
    log(f"flash_attention at {label}'s shape (B {b}, {hq} heads of {hd}, "
        f"S {s}, {dt}): wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {fields['bound_ms']:.4f} ms "
        f"({fields['bound_by']}; {ops:.4e} ops, {nbytes} bytes); kernel "
        f"device time {device}; SDPA device time {sdpa_device}; achieved "
        f"{ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s (wrapper)")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return fields


def check_flash(FA) -> dict:
    err = 0.0
    for i, (label, b, hq, hkv, s, hd, dt, causal, window) in enumerate(
            FLASH_CASES):
        q, k, v = flash_inputs(b, hq, hkv, s, hd, dt, 500 + i,
                               unaligned=label == "unaligned view")
        out = FA.flash_attention(q, k, v, causal=causal, window=window)
        ref = FA.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(out.dtype == dt and out.shape == q.shape, f"{label} shape")
        torch.testing.assert_close(out.float(), ref.float(),
                                   **FLASH_TOL[dt])
        case_err = float((out.float() - ref.float()).abs().max())
        err = max(err, case_err)
        log(f"flash {label}: B {b} heads {hq}/{hkv} S {s} hd {hd} {dt} "
            f"causal {causal} window {window} "
            f"({FA.ops.kernel_symbol(dt, hd)}): agrees, max |err| "
            f"{case_err:.3e}")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    log(f"flash_attention: {len(FLASH_CASES)} cases agree (max |err| "
        f"{err:.3e})")

    timed = {c[0]: c for c in FLASH_CASES if c[0] in FLASH_TIMED}
    fields = [time_flash(FA, timed[label], 500) for label in FLASH_TIMED]
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:114",
                max_abs_err=err, **fields[0])


# --------------------------------------------------------------------- #
# phase 7: model parity at full width
# --------------------------------------------------------------------- #
def model_parity(M, T, E) -> None:
    cfg = M.get_config("deepseek-7b").replace(n_layers=2,
                                               dtype=torch.float32)
    params = T.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                         device="cuda")
    flash = E.make_prefill_step(cfg.replace(attn_impl="flash"))(
        params, {"tokens": toks})
    ref = E.make_prefill_step(cfg.replace(attn_impl="ref"))(
        params, {"tokens": toks})
    torch.cuda.synchronize()
    check(flash.shape == (*toks.shape, cfg.vocab_size), "prefill shape")
    check(bool(torch.isfinite(flash).all()), "prefill logits not finite")
    torch.testing.assert_close(flash, ref, rtol=2e-3, atol=2e-3)
    prefill_err = float((flash - ref).abs().max())
    del flash, ref

    prompt = toks[:, :64]
    prefill = E.make_prefill_step(cfg.replace(attn_impl="flash"))(
        params, {"tokens": prompt})
    decode = E.make_decode_step(cfg)
    cache = T.init_cache(cfg, 2, 64, "cuda")
    for t in range(64):
        logits, cache = decode(params, cache, prompt[:, t:t + 1], t)
    torch.cuda.synchronize()
    torch.testing.assert_close(logits[:, 0], prefill[:, -1], rtol=2e-3,
                               atol=2e-3)
    decode_err = float((logits[:, 0] - prefill[:, -1]).abs().max())
    log(f"model parity: deepseek-7b, d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, fp32, {toks.shape[0]} x {toks.shape[1]} "
        "tokens: "
        f"flash vs ref prefill logits max |err| {prefill_err:.3e}; decode "
        f"vs prefill at position 63 of a 64-token prompt max |err| "
        f"{decode_err:.3e} (tolerance 2e-3)")
    del params, cache, logits, prefill
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phases 8 and 11: a served model, full size
# --------------------------------------------------------------------- #
# arch -> (n_layers, d_model) of the published configuration
FULL_SIZE = {"deepseek-7b": (30, 4096), "zamba2-1.2b": (38, 2048),
             "rwkv6-7b": (32, 4096)}


def serve_phase(M, T, E, kernels: dict, arch: str, per_prefill: dict,
                symbols: dict, **impl) -> dict:
    """Serve ``arch`` at full size in bf16 (random weights from a seeded
    generator on the card): 1 + 3 + 1 profiled prefills of 4 x 2048
    tokens, each checked for ``per_prefill`` launches of each kernel and,
    in the profiled one, for ``symbols[s]`` device launches of each kernel
    symbol ``s``, then greedy generation.  Every kernel counter is set to
    0 just before and read just after; returns the counts."""
    cfg = M.get_config(arch).replace(**impl)
    check((cfg.n_layers, cfg.d_model) == FULL_SIZE[arch], "not full size")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    engine = E.ServeEngine(cfg, params, max_len=96, device="cuda")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in M.registry.leaves(engine.params))
    log(f"serve: {arch}, {cfg.n_layers} layers, {n_params} "
        f"parameters: init (fp32) + cast to {cfg.dtype} in "
        f"{time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    prefill = E.make_prefill_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                     generator=gen, device="cuda")}
    for fn in kernels.values():
        fn.launches = 0

    def one_prefill():
        before = {n: fn.launches for n, fn in kernels.items()}
        out = prefill(engine.params, batch)
        for n, fn in kernels.items():
            got = fn.launches - before[n]
            check(got == per_prefill.get(n, 0),
                  f"{got} {n} launches in one {arch} prefill, expected "
                  f"{per_prefill.get(n, 0)}")
        return out

    logits = one_prefill()                        # warm-up
    torch.cuda.synchronize()
    check(logits.shape == (*batch["tokens"].shape, cfg.vocab_size),
          "logits shape")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits = one_prefill()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall, device = profiled(one_prefill)
    prefill_s = float(np.median(times))
    b, s = batch["tokens"].shape
    log(f"serve prefill {arch}: {b} x {s} tokens, {prefill_s * 1e3:.2f} ms "
        f"median of 3 ({[round(t * 1e3, 2) for t in times]}), "
        f"{b * s / prefill_s:.1f} prefill tokens/s")
    log(breakdown(f"serve prefill {arch} (profiled)", wall, device))
    for symbol, n in symbols.items():
        hits = {key: v for key, v in device.items() if symbol in key}
        got = sum(c for c, _ in hits.values())
        check(not device or got == n, f"{got} device launches of {symbol} "
              f"in one {arch} prefill, expected {n}")
        log(f"serve prefill {arch}: {symbol} x{got} in the profiled "
            f"prefill, {sum(us for _, us in hits.values()) / 1e3:.3f} ms "
            f"of device time" if device else
            f"serve prefill {arch}: {symbol} not measured (no device "
            "events)")

    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, 32)
    gen_s = time.perf_counter() - t0
    check(out.shape == (4, 32) and out.dtype == np.int32, "generate shape")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token range")
    steps = 64 + 32 - 1
    log(f"serve generate {arch}: 4 x 64-token prompts, 32 new tokens: "
        f"{steps} decode steps in {gen_s:.3f} s, "
        f"{4 * steps / gen_s:.1f} decode tokens/s "
        f"({1e3 * gen_s / steps:.2f} ms per step of 4 tokens), "
        f"{4 * 32 / gen_s:.1f} new tokens/s; first row {out[0][:8].tolist()}")
    wall, device = profiled(lambda: engine.generate(prompts[:, :8], 8))
    log(breakdown(f"serve decode {arch}, 15 steps (profiled)", wall, device))
    counts = {n: fn.launches for n, fn in kernels.items()}
    for n, got in counts.items():         # decode launches no kernel
        check(got == 5 * per_prefill.get(n, 0), f"{got} {n} launches")
    log(f"serve {arch}: launches over 5 prefills {counts}; peak memory "
        f"while serving {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (max_memory_allocated)")
    del engine, logits, batch
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------- #
# phase 9: the SSD and WKV6 scans against their plain versions
# --------------------------------------------------------------------- #
# (label, b, S, nh, hd, ds, chunk, dtype); bf16 at hd, ds <= 64 runs the
# tensor-core kernel, the rest the float32 FMA kernel (``kernel_symbol``)
SSD_CASES = [
    ("zamba2-1.2b", 4, 2048, 64, 64, 64, 64, BF16),
    ("zamba2-1.2b", 4, 2048, 64, 64, 64, 64, FP32),
    ("strong decay", 4, 2048, 64, 64, 64, 64, BF16),
    ("chunk 8", 2, 256, 4, 64, 64, 8, FP32),
    ("chunk 8", 2, 256, 4, 64, 64, 8, BF16),
    ("chunk 16", 2, 256, 4, 64, 32, 16, BF16),
    ("one chunk", 2, 64, 4, 64, 64, 64, FP32),
    ("hd 16", 2, 128, 4, 16, 16, 16, FP32),
    ("hd 16", 2, 128, 4, 16, 16, 16, BF16),
    ("hd 32 ds 16", 2, 256, 4, 32, 16, 64, BF16),
    ("hd 128 ds 128", 1, 256, 2, 128, 128, 64, FP32),
    ("hd 128 ds 128", 1, 256, 2, 128, 128, 64, BF16),
    ("model views", 2, 256, 8, 64, 64, 64, BF16),
    ("unaligned view", 2, 256, 8, 64, 64, 64, BF16),
]
# (label, b, S, nh, hd, chunk, dtype, with S0); bf16 at hd <= 64 runs the
# tensor-core kernel, the rest the float32 FMA kernel (``kernel_symbol``)
WKV_CASES = [
    ("rwkv6-7b", 4, 2048, 64, 64, 64, BF16, False),
    ("rwkv6-7b", 4, 2048, 64, 64, 64, FP32, False),
    ("strong decay", 4, 2048, 64, 64, 64, BF16, False),
    ("chunk 8", 2, 256, 4, 64, 8, FP32, False),
    ("chunk 8", 2, 256, 4, 64, 8, BF16, False),
    ("chunk 16", 2, 256, 4, 64, 16, BF16, False),
    ("one chunk", 2, 64, 4, 64, 64, FP32, False),
    ("hd 16", 2, 128, 4, 16, 16, FP32, False),
    ("hd 16", 2, 128, 4, 16, 16, BF16, False),
    ("hd 32", 2, 256, 4, 32, 64, BF16, False),
    ("hd 128", 1, 256, 2, 128, 64, FP32, False),
    ("hd 128", 1, 256, 2, 128, 64, BF16, False),
    ("S0", 2, 256, 4, 64, 64, FP32, True),
    ("S0", 2, 256, 4, 64, 32, BF16, True),
    ("S0", 2, 256, 4, 64, 64, BF16, True),
    ("model views", 2, 256, 8, 64, 64, BF16, True),
    ("unaligned view", 2, 256, 8, 64, 64, BF16, False),
]


def ssd_inputs(b, S, nh, hd, ds, dtype, seed, kind=""):
    """x (b,S,nh,hd), dt (b,S,nh) > 0, a_log (nh,) fp32, B and C (b,S,ds).
    ``kind``: "model views": x, B and C are slices of one (b, S, nh*hd +
    2 ds) tensor, as the model's Mamba2 block passes them; "unaligned
    view": their rows start off 16-byte boundaries; "strong decay": dt up
    to 10 and A down to -5, so dt * A reaches -50 a step."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if kind in ("model views", "unaligned view"):
        pad = 1 if kind == "unaligned view" else 0
        x, B, C = torch.split(rnd(b, S, pad + nh * hd + 2 * ds).to(dtype),
                              [pad + nh * hd, ds, ds], dim=-1)
        x = x[..., pad:].unflatten(-1, (nh, hd))
    else:
        x, B, C = (rnd(b, S, nh, hd).to(dtype), rnd(b, S, ds).to(dtype),
                   rnd(b, S, ds).to(dtype))
    if kind == "strong decay":
        dt = (torch.rand((b, S, nh), generator=gen, device="cuda") * 9.99
              + 0.01).to(dtype)
        return x, dt, torch.linspace(-1.0, math.log(5.0), nh,
                                     device="cuda"), B, C
    dt = torch.nn.functional.softplus(rnd(b, S, nh)).to(dtype)
    return x, dt, rnd(nh) * 0.5, B, C


def wkv_inputs(b, S, nh, hd, dtype, seed, with_s0, kind=""):
    """r, k, v, logw < 0 (b,S,nh,hd) and u (nh,hd) in ``dtype`` (the
    model passes u cast), S0 (b,nh,hd,hd) fp32 or None.  ``kind``:
    "model views": r, k, v and logw are slices of one (b, S, nh, 4 hd)
    tensor; "unaligned view": their rows start off 16-byte boundaries;
    "strong decay": logw log-uniform in [-30, -1e-3] a step."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if kind == "strong decay":
        lw = torch.rand((b, S, nh, hd), generator=gen, device="cuda")
        logw = -torch.exp(math.log(1e-3) + lw * math.log(3e4))
    else:
        logw = -torch.exp(rnd(b, S, nh, hd) * 0.8 - 0.5)
    if kind in ("model views", "unaligned view"):
        pad = 1 if kind == "unaligned view" else 0
        fused = rnd(b, S, nh, pad + 4 * hd)
        fused[..., pad + 3 * hd:] = logw
        r, k, v, logw = fused.to(dtype)[..., pad:].split(hd, dim=-1)
    else:
        r, k, v = (rnd(b, S, nh, hd).to(dtype) for _ in range(3))
        logw = logw.to(dtype)
    u = (rnd(nh, hd) * 0.5).to(dtype)
    return r, k, v, logw, u, (rnd(b, nh, hd, hd) * 0.5 if with_s0 else None)


def scan_bound(nbytes: int, flops: int, exps: int) -> dict:
    """The least time for a scan's least work: its bytes at the HBM rate
    against its products at the bf16 tensor-core rate plus one
    exponential per decay element at the SFU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / BF16_OPS_PER_S + exps / SFU_OPS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def wkv6_design_exps(b: int, S: int, nh: int, hd: int, Q: int) -> int:
    """Exponentials the tensor-core WKV6 kernel evaluates (chunk Q a
    multiple of 16), counted from its code: per chunk, one per strict
    (t, s, d) term of the two diagonal 8 x 8 quadrants of each sub-block,
    16 hd a sub-block for the factors of its lower-left quadrant, one per
    r~ and K^ element, one per k~ element of every earlier sub-block, 8 hd
    a sub-block for exp(W_{b_i-1}) and 4 hd for exp(W_last)."""
    nsub = Q // 16
    per_chunk = (nsub * 56 * hd + nsub * 16 * hd + 2 * Q * hd
                 + 16 * hd * nsub * (nsub - 1) // 2 + nsub * 8 * hd + 4 * hd)
    return b * nh * (S // Q) * per_chunk


def ssd_design_exps(b: int, S: int, nh: int, hd: int, Q: int) -> int:
    """Exponentials the tensor-core SSD kernel evaluates (chunk Q a
    multiple of 16), per block of a chunk: one per element of M's tiles
    on or below the diagonal (masked ones included), the tail for 64
    rows, exp(cum) twice a lane of the output warps and exp(cum_last)
    once a lane of the state warps."""
    nsub = Q // 16
    return b * nh * (S // Q) * (128 * nsub * (nsub + 1) + 64 + 64 * nsub
                                + 2 * hd)


def compare_scan(name, label, dtype, got, want) -> float:
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} {label}: {g.shape} {g.dtype} against {w.shape} "
              f"{w.dtype}")
        torch.testing.assert_close(g.float(), w.float(),
                                   **SCAN_TOL[(name, dtype)])
        err = max(err, float((g.float() - w.float()).abs().max()))
    return err


def check_ssd(SSD) -> dict:
    err = 0.0
    for i, (label, b, S, nh, hd, ds, chunk, dt) in enumerate(SSD_CASES):
        x, dtv, a_log, B, C = ssd_inputs(b, S, nh, hd, ds, dt, 700 + i,
                                         kind=label)
        got = SSD.ssd(x, dtv, a_log, B, C, chunk=chunk)
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"ssd {label}: not finite")
        case_err = compare_scan("ssd", label, dt, got,
                                SSD.ssd_ref(x, dtv, a_log, B, C))
        err = max(err, case_err)
        log(f"ssd {label}: b {b} S {S} heads {nh} hd {hd} ds {ds} chunk "
            f"{chunk} {dt} ({SSD.ops.kernel_symbol(dt, hd, ds)}): agrees, "
            f"max |err| {case_err:.3e}")
        del x, dtv, a_log, B, C
        torch.cuda.empty_cache()

    label, b, S, nh, hd, ds, Q, dt = SSD_CASES[0]
    args = ssd_inputs(b, S, nh, hd, ds, dt, 700)
    x, dtv, a_log, B, C = args
    ms = event_times_ms(lambda: SSD.ssd(*args, chunk=Q), 2, 10)
    plain_ms = event_times_ms(lambda: SSD.ssd_ref(*args), 1, 3)
    device = kernel_device_us(lambda: SSD.ssd(*args, chunk=Q),
                              SSD.ops.kernel_symbol(dt, hd, ds), reps=10)
    n_ch = b * nh * (S // Q)
    pairs = Q * (Q + 1) // 2              # causal (t, s) pairs of a chunk
    flops = 2 * n_ch * (pairs * ds + pairs * hd + 2 * Q * hd * ds)
    exps = b * S * nh                     # one decay a token and head
    design = ssd_design_exps(b, S, nh, hd, Q)
    nbytes = (x.element_size() * (2 * x.numel() + dtv.numel() + B.numel()
                                  + C.numel())
              + 4 * (a_log.numel() + b * nh * hd * ds))
    row = dict(name="ssd", route="cuda",
               source="src/repro_torch/kernels/mamba2_ssd/csrc/ssd.cu",
               replaces="src/repro/kernels/mamba2_ssd/kernel.py:81",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **scan_bound(nbytes, flops, exps), library_ms=None)
    log(f"ssd: {len(SSD_CASES)} cases agree (max |err| {err:.3e}); "
        f"zamba2-1.2b shape: wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; {flops:.4e} "
        f"flops, {exps:.4e} exps, {nbytes} bytes); the kernel's own "
        f"{design:.4e} exps take {design / SFU_OPS_PER_S * 1e3:.4f} ms on "
        f"the SFUs; kernel device time {device}; achieved "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    del args, x, dtv, a_log, B, C
    torch.cuda.empty_cache()
    return row


def check_wkv6(WKV) -> dict:
    err = 0.0
    for i, (label, b, S, nh, hd, chunk, dt, with_s0) in enumerate(
            WKV_CASES):
        r, k, v, logw, u, S0 = wkv_inputs(b, S, nh, hd, dt, 800 + i,
                                          with_s0, kind=label)
        got = WKV.wkv6(r, k, v, logw, u, chunk=chunk, S0=S0)
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"wkv6 {label}: not finite")
        case_err = compare_scan("wkv6", label, dt, got,
                                WKV.wkv6_ref(r, k, v, logw, u, S0))
        err = max(err, case_err)
        log(f"wkv6 {label}: b {b} S {S} heads {nh} hd {hd} chunk {chunk} "
            f"{dt} S0 {with_s0} ({WKV.ops.kernel_symbol(dt, hd)}): agrees, "
            f"max |err| {case_err:.3e}")
        del r, k, v, logw, u, S0
        torch.cuda.empty_cache()

    label, b, S, nh, hd, Q, dt, _ = WKV_CASES[0]
    r, k, v, logw, u, _ = wkv_inputs(b, S, nh, hd, dt, 800, False)
    args = (r, k, v, logw, u)
    ms = event_times_ms(lambda: WKV.wkv6(*args, chunk=Q), 2, 10)
    plain_ms = event_times_ms(lambda: WKV.wkv6_ref(*args), 1, 3)
    device = kernel_device_us(lambda: WKV.wkv6(*args, chunk=Q),
                              WKV.ops.kernel_symbol(dt, hd), reps=10)
    n_ch = b * nh * (S // Q)
    strict = Q * (Q - 1) // 2             # (t, s) pairs with s < t
    pairs = strict + Q
    # decayed r.k terms, the u bonus, scores @ v, (r decayed) @ S and the
    # rank-Q state update
    flops = n_ch * (3 * strict * hd + 3 * Q * hd + 2 * pairs * hd
                    + 4 * Q * hd * hd)
    exps = b * S * nh * hd                # one decay a token and channel
    design = wkv6_design_exps(b, S, nh, hd, Q)
    nbytes = (r.element_size() * (5 * r.numel() + u.numel())
              + 4 * b * nh * hd * hd)
    row = dict(name="wkv6", route="cuda",
               source="src/repro_torch/kernels/rwkv6_scan/csrc/wkv6.cu",
               replaces="src/repro/kernels/rwkv6_scan/kernel.py:86",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **scan_bound(nbytes, flops, exps), library_ms=None)
    log(f"wkv6: {len(WKV_CASES)} cases agree (max |err| {err:.3e}); "
        f"rwkv6-7b shape: wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; {flops:.4e} "
        f"flops, {exps:.4e} exps, {nbytes} bytes); the kernel's own "
        f"{design:.4e} exps take {design / SFU_OPS_PER_S * 1e3:.4f} ms on "
        f"the SFUs; kernel device time {device}; achieved "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    log("library_ms: null for ssd and wkv6; neither function is a single "
        "PyTorch call")
    del r, k, v, logw, u, args
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------- #
# phase 10: SSM model parity at full width
# --------------------------------------------------------------------- #
def ssm_parity(M, T, E) -> None:
    """zamba2-1.2b at 7 layers (one group of 6 Mamba2 layers and the
    shared attention block, then one tail layer) and rwkv6-7b at 2
    layers, full width, fp32, 2 x 256 tokens."""
    for arch, n_layers in (("zamba2-1.2b", 7), ("rwkv6-7b", 2)):
        cfg = M.get_config(arch).replace(n_layers=n_layers,
                                         dtype=torch.float32)
        fast = cfg.replace(ssm_impl="pallas", attn_impl="flash")
        params = T.init_params(cfg, seed=0, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(7)
        toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                             device="cuda")
        kern = E.make_prefill_step(fast)(params, {"tokens": toks})
        ref = E.make_prefill_step(cfg.replace(ssm_impl="ref",
                                              attn_impl="ref"))(
            params, {"tokens": toks})
        torch.cuda.synchronize()
        check(kern.shape == (*toks.shape, cfg.vocab_size), "prefill shape")
        check(bool(torch.isfinite(kern).all()), "prefill logits not finite")
        torch.testing.assert_close(kern, ref, rtol=2e-3, atol=2e-3)
        prefill_err = float((kern - ref).abs().max())
        del kern, ref

        prompt = toks[:, :64]
        prefill = E.make_prefill_step(fast)(params, {"tokens": prompt})
        decode = E.make_decode_step(cfg)
        cache = T.init_cache(cfg, 2, 64, "cuda")
        for t in range(64):
            logits, cache = decode(params, cache, prompt[:, t:t + 1], t)
        torch.cuda.synchronize()
        torch.testing.assert_close(logits[:, 0], prefill[:, -1], rtol=2e-3,
                                   atol=2e-3)
        decode_err = float((logits[:, 0] - prefill[:, -1]).abs().max())
        log(f"model parity: {arch}, d_model {cfg.d_model}, {n_layers} "
            f"layers, fp32, {toks.shape[0]} x {toks.shape[1]} tokens: "
            f"pallas (+flash) vs ref prefill logits max |err| "
            f"{prefill_err:.3e}; decode vs prefill at position 63 of a "
            f"64-token prompt max |err| {decode_err:.3e} (tolerance 2e-3)")
        del params, cache, logits, prefill
        torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phases 12 and 13: training on the card
# --------------------------------------------------------------------- #
TRAIN_LAYERS = 8                  # deepseek-7b's 30 do not train on 80 GB
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
HELD_OUT = 1000                   # index of a batch no step trains on
HPO_TRIALS, HPO_MAX_TRIALS = 12, 40


def train_phase(M, O, D, TR, kernels: dict) -> None:
    """deepseek-7b at full width, ``TRAIN_LAYERS`` layers, bf16 compute,
    remat on, ``attn_impl="ref"`` (the kernels have no backward): one
    warm-up step, 4 timed steps and a profiled one on 4 x 2048 tokens of
    the synthetic stream, AdamW at lr 3e-4, with the loss of a held-out
    batch before and after.  Then one step at lr 0 (the parameters stay)
    and one with 2 microbatches on the same batch."""
    full = M.get_config("deepseek-7b")
    check((full.n_layers, full.d_model) == FULL_SIZE["deepseek-7b"],
          "not full size")
    cfg = full.replace(n_layers=TRAIN_LAYERS)
    check(cfg.remat and cfg.attn_impl == "ref" and cfg.dtype == BF16,
          "training config")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = O.AdamWConfig(lr=3e-4)
    t0 = time.perf_counter()
    state = TR.init_train_state(cfg, opt, seed=0, device="cuda").tree()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in M.registry.leaves(state["params"]))
    log(f"train: deepseek-7b at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), depth cut {full.n_layers} -> {cfg.n_layers} "
        f"layers: {n_params} parameters; fp32 masters and AdamW moments "
        f"in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    data = D.SyntheticLMDataset(D.DataConfig(global_batch=TRAIN_BATCH,
                                             seq_len=TRAIN_SEQ), cfg)

    def batch(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in data[i].items()}

    held = batch(HELD_OUT)

    def held_out_loss():        # one batch that no step trains on
        with torch.no_grad():
            params = TR.step.cast_weights(cfg, state["params"])
            return float(M.transformer.loss_fn(params, cfg, held)[0])

    step = TR.make_train_step(cfg, opt)
    for fn in kernels.values():
        fn.launches = 0
    held_before = held_out_loss()
    losses, times = [], []
    for i in range(5):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"train step {i + 1}: loss {loss:.6f}, grad norm "
            f"{float(metrics['grad_norm']):.6f}, {times[-1] * 1e3:.2f} ms")
    # each step's loss is on another batch, which moves it by ~0.02 here;
    # the held-out batch's loss before and after has no such noise
    held_after = held_out_loss()
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[4] < losses[0], f"loss did not fall: {losses}")
    check(held_after < held_before,
          f"held-out loss {held_before} -> {held_after}")
    log(f"train: held-out batch {HELD_OUT}: loss {held_before:.6f} before "
        f"step 1, {held_after:.6f} after step 5 "
        f"({held_after - held_before:+.6f})")
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"train: {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, "
        f"{step_s * 1e3:.2f} ms a step (median of 4 after a warm-up: "
        f"{[round(t * 1e3, 2) for t in times[1:]]}), {tokens / step_s:.1f} "
        f"tokens/s; peak device memory {peak / 2**30:.2f} GiB "
        f"({peak} B, max_memory_allocated); model-FLOPs share of the bf16 "
        f"peak (6 N tokens / (step time x 989e12)): "
        f"{6 * n_params * tokens / (step_s * BF16_OPS_PER_S):.4f}")

    b = batch(5)
    out = {}

    def one_step():
        out["state"], out["metrics"] = step(state, b)

    wall, device = profiled(one_step)
    state = out["state"]
    check(math.isfinite(float(out["metrics"]["loss"])), "profiled loss")
    log(breakdown("train step (profiled)", wall, device))
    if device:
        top = sorted(device.items(), key=lambda kv: -kv[1][1])[:5]
        log("train step: five largest device-time entries: " + "; ".join(
            f"{event_name(k)} x{c} {us / 1e3:.3f} ms" for k, (c, us) in top))
        log("train step: device time by kind: " + "; ".join(
            f"{kind} x{c} {us / 1e3:.2f} ms"
            for kind, (c, us) in device_kinds(device)))

    def zeros(tree):            # the train step's gradient dtypes
        return {k: zeros(v) if isinstance(v, dict) else torch.zeros_like(
            v, dtype=BF16 if v.dim() >= 2 else FP32) for k, v in tree.items()}

    grads = zeros(state["params"])
    adamw_ms = event_times_ms(
        lambda: O.adamw_update(grads, state["opt_state"], state["params"],
                               O.AdamWConfig(lr=0.0)), warmup=1, reps=3)
    del grads
    log(f"train: adamw_update alone on the {n_params}-parameter state: "
        f"{adamw_ms:.2f} ms (CUDA events, median of 3, eager)")

    # the loss of any split is the unsplit loss, so the accumulated
    # gradient's norm is what tests the split and the accumulation
    b = batch(7)
    state, m1 = TR.make_train_step(cfg, O.AdamWConfig(lr=0.0))(state, b)
    state, m2 = TR.make_train_step(cfg, opt, n_microbatches=2)(state, b)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    g1, g2 = float(m1["grad_norm"]), float(m2["grad_norm"])
    check(math.isfinite(l2) and abs(l2 - l1) <= 1e-2 * abs(l1),
          f"microbatches=2 loss {l2} against {l1}")
    check(math.isfinite(g2) and abs(g2 - g1) <= 1e-3 * abs(g1),
          f"microbatches=2 grad norm {g2} against {g1}")
    log(f"train: the same batch unsplit (lr 0) and in 2 microbatches: "
        f"loss {l1:.6f} / {l2:.6f} (relative {abs(l2 - l1) / abs(l1):.3e}, "
        f"tolerance 1e-2), grad norm {g1:.6f} / {g2:.6f} (relative "
        f"{abs(g2 - g1) / abs(g1):.3e}, tolerance 1e-3); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB over the "
        "phase")
    counts = {n: fn.launches for n, fn in kernels.items()}
    check(not any(counts.values()), f"kernel launches in training {counts}")
    del state, b, out
    torch.cuda.empty_cache()


def device_kinds(device: dict) -> list[tuple[str, tuple[int, float]]]:
    """Device events summed by kind (GEMM, softmax, elementwise, casts
    and copies, reductions, indexing), largest first."""
    kinds: dict[str, list] = {}
    for key, (c, us) in device.items():
        k = key.lower()
        kind = ("gemm" if re.search(r"nvjet|gemm|cutlass|xmma", k) else
                "softmax" if "softmax" in k else
                "reduce" if "reduce" in k else
                "index" if re.search(r"index|scatter|gather", k) else
                "cast/copy" if re.search(r"memcpy|memset|copy", k) else
                "elementwise" if "elementwise" in k else "other")
        acc = kinds.setdefault(kind, [0, 0.0])
        acc[0] += c
        acc[1] += us
    return sorted(((k, tuple(v)) for k, v in kinds.items()),
                  key=lambda kv: -kv[1][1])


def hpo_phase(core, K, M, O, D, TR, kernels: dict) -> int:
    """The HPO loop of ``benchmarks/bench_hpo_train.py`` on the card: a
    TPE study over (lr, weight_decay) with the median pruner, each trial
    ``hopaas_objective`` on deepseek-7b's smoke config (20 steps, 8 x 32
    tokens).  Pruned trials are no observations for TPE, so the study
    runs ``HPO_TRIALS`` trials and then on until two trials have been
    proposed past TPE's 10 startup trials.  Then a checkpoint round trip,
    whose uninterrupted run must learn.
    Returns the ``tpe_score`` launches of the loop."""
    t_phase = time.perf_counter()
    cfg = M.get_config("deepseek-7b", smoke=True)
    objective = TR.hopaas_objective(cfg, total_steps=20, global_batch=8,
                                    seq_len=32, report_every=10,
                                    device="cuda")
    server = core.HopaasServer(tokens=core.TokenManager(), seed=3,
                               device="cuda")
    try:
        client = core.Client(core.DirectTransport(server),
                             server.tokens.issue("chip-smoke-hpo"))
        study = core.ClientStudy(
            name="hpo-train",
            properties={"lr": core.suggestions.loguniform(1e-5, 3e-2),
                        "weight_decay": core.suggestions.loguniform(1e-4,
                                                                    0.3)},
            sampler={"name": "tpe"},
            pruner={"name": "median", "n_warmup_steps": 10}, client=client)
        for fn in kernels.values():
            fn.launches = 0
        losses, n_pruned, tpe_asks, best = [], 0, 0, (math.inf, None)
        n = 0
        while n < HPO_TRIALS or tpe_asks < 2:
            check(n < HPO_MAX_TRIALS, f"TPE left startup in no {n} trials")
            before = K.tpe_score.launches
            trial = study.ask()
            tpe_asks += K.tpe_score.launches > before
            value = objective(trial.params, trial.should_prune)
            check(math.isfinite(value), f"trial {n}: loss {value}")
            study.tell(trial, value=value,
                       state="pruned" if trial.pruned else None)
            n += 1
            if trial.pruned:
                n_pruned += 1
                continue
            losses.append(value)
            best = min(best, (value, trial.params["lr"]))
        summary = client.study(study.study_key)
        told = summary["n_completed"] + summary.get("n_pruned", 0)
        check(told == n, f"{told} trials told of {n}: {summary}")
        launches = K.tpe_score.launches
        check(launches >= 1, "tpe_score never launched in the HPO loop")
        counts = {k: fn.launches for k, fn in kernels.items()
                  if k != "tpe_score"}
        check(not any(counts.values()), f"other launches {counts}")
        median = float(np.median(losses))
        check(best[0] <= median, f"best {best[0]} above median {median}")
    finally:
        server.close()
    log(f"hpo: {n} trials ({n - n_pruned} completed, {n_pruned} pruned), "
        f"{tpe_asks} proposed by TPE past startup with {launches} "
        f"tpe_score launches; median loss {median:.6f}, best loss "
        f"{best[0]:.6f} (lr {best[1]:.6g}); "
        f"{time.perf_counter() - t_phase:.2f} s")

    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as root:
        def trainer(steps, ckpt_dir=None):
            return TR.Trainer(
                cfg, O.AdamWConfig(lr=3e-3, weight_decay=0.0),
                D.DataConfig(global_batch=8, seq_len=32),
                TR.TrainerConfig(total_steps=steps, checkpoint_every=10,
                                 checkpoint_dir=ckpt_dir), device="cuda")
        whole = trainer(20).run()
        first = trainer(10, root).run()
        resumed = trainer(20, root).run()
    check(first.steps_run == 10 and resumed.restored_from == 10
          and resumed.steps_run == 10, "restart did not resume at 10")
    # the smoke model learns: its last losses fall below ln(vocab), the
    # loss of a uniform guess, from above it
    late = float(np.mean(whole.losses[-5:]))
    check(late < math.log(cfg.vocab_size) < whole.losses[0],
          f"smoke losses {whole.losses} against ln V")
    log(f"hpo: the uninterrupted 20 steps: loss {whole.losses[0]:.6f} at "
        f"step 1, {late:.6f} over the last 5 (ln V "
        f"{math.log(cfg.vocab_size):.6f})")
    rel = abs(resumed.final_loss - whole.final_loss) / abs(whole.final_loss)
    check(rel <= 1e-4, f"resumed loss {resumed.final_loss} against "
          f"{whole.final_loss}")
    log(f"hpo: checkpoint at step 10, restored in a fresh Trainer: final "
        f"loss {resumed.final_loss:.6f} against {whole.final_loss:.6f} "
        f"uninterrupted (relative {rel:.3e}, tolerance 1e-4); phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    return launches


# --------------------------------------------------------------------- #
# phase 14: the multi-process shard fabric on the card
# --------------------------------------------------------------------- #
FABRIC_STUDIES = 8            # TPE studies, 4 client threads each
FABRIC_HISTORY = 1000         # completed trials a study, told in bulk
FABRIC_WINDOW_S = 8.0         # each timed window of ask/tell pairs
FABRIC_CLIENTS = 4            # keep-alive client threads a study
FAILOVER_HISTORY = 200
SCOPE_LOCAL = {"X-Fabric-Scope": "local"}   # a worker's own health


def fabric_spec(name: str, sampler: str) -> dict:
    return {"name": name, "properties": PROPS, "sampler": {"name": sampler}}


def worker_health(core, endpoint) -> dict:
    """One worker's own health (its data port, scoped so that it does
    not forward): device and this process's kernel launches."""
    status, payload, _ = core.HttpTransport(*endpoint).request_full(
        "GET", "/api/v2/health", headers=SCOPE_LOCAL)
    check(status == 200, f"health of {endpoint}: {status} {payload}")
    return payload


def worker_launches(core, fab) -> dict[int, dict[str, int]]:
    """Kernel launches of every leader, read from its own process."""
    out = {}
    for wid, endpoint in enumerate(fab.endpoints):
        health = worker_health(core, endpoint)
        check(health["device"]["type"] == "cuda",
              f"worker {wid} computes on {health['device']}")
        out[wid] = dict(health["device"]["kernel_launches"])
    return out


def worker_pids(fab) -> dict[int, int]:
    """Leader pids by ring id (the parent itself when inline)."""
    if fab.inline:
        return {0: os.getpid()}
    return {w["worker"]: w["pid"] for w in fab.health()["workers"]
            if w.get("role") == "leader" and "error" not in w}


def mapped(pid: int) -> set[str]:
    with open(f"/proc/{pid}/maps") as f:
        return {line.split()[-1] for line in f if "/" in line}


def check_maps(pid: int, what: str, libs: tuple[str, ...]) -> str:
    """``pid`` maps libcuda and each kernel library in ``libs``, and
    nothing under a ``jax`` or ``jaxlib`` directory."""
    from repro_torch.core.kernels import _backend
    paths = mapped(pid)
    jax = sorted(p for p in paths if {"jax", "jaxlib"} & set(Path(p).parts))
    check(not jax, f"{what} (pid {pid}) maps JAX: {jax[:3]}")
    cuda = sorted(p for p in paths if Path(p).name.startswith("libcuda.so"))
    check(cuda, f"{what} (pid {pid}) does not map libcuda")
    found = [str(_backend._lib_path(n).resolve()) for n in libs]
    for lib in found:
        check(lib in paths, f"{what} (pid {pid}) does not map {lib}")
    return f"{what} pid {pid}: " + ", ".join(
        [Path(cuda[0]).name, *(Path(lib).name for lib in found), "no jax"])


def drive_window(core, make_transport, token, keys, seconds):
    """``FABRIC_CLIENTS`` threads a study, each with its own keep-alive
    transport, doing ask/tell pairs for ``seconds``.  Returns the pairs
    and every ask's latency; any error fails the phase."""
    space = core.SearchSpace.from_properties(PROPS)
    errors: list[BaseException] = []
    asks: list[list[float]] = []
    # the window opens once every client holds its connection
    window: dict[str, float] = {}
    start = threading.Barrier(
        len(keys) * FABRIC_CLIENTS + 1,
        action=lambda: window.update(t0=time.monotonic()))

    def worker(i: int, key: str, lat: list[float]) -> None:
        try:
            client = core.Client(make_transport(), token,
                                 worker_id=f"fabric-client-{i}")
            start.wait()
            while time.monotonic() < window["t0"] + seconds:
                t0 = time.perf_counter()
                trial = client.ask(key)
                lat.append(time.perf_counter() - t0)
                client.tell(trial["uid"], objective(space, trial["params"]))
        except BaseException as e:  # reported and re-raised below
            errors.append(e)
            start.abort()

    threads = []
    for key in keys:
        for _ in range(FABRIC_CLIENTS):
            asks.append([])
            threads.append(threading.Thread(
                target=worker, args=(len(threads), key, asks[-1])))
    for t in threads:
        t.start()
    start.wait()
    for t in threads:
        t.join(timeout=seconds + 120)
    wall = time.monotonic() - window["t0"]
    check(not any(t.is_alive() for t in threads), "a fabric client hung")
    if errors:
        raise errors[0]
    lat = [x for lane in asks for x in lane]
    return len(lat), wall, lat


def scaling_run(core, root, w):
    """One ``ShardFabric(workers=w)``: fill the studies, a routed window
    (and at w = 4 a direct window and the GP study).  Returns the rows."""
    fab = core.ShardFabric(workers=w, storage="durable", fsync="group",
                           root=os.path.join(root, f"w{w}"), device="cuda",
                           spawn_timeout=180.0)
    rows = []
    t_start = time.perf_counter()
    try:
        fab.start()
        t_up = time.perf_counter() - t_start
        token = fab.issue_token("chip-smoke-fabric")
        client = core.Client(core.HttpTransport(fab.host, fab.port), token)
        keys = [client.ensure_study(fabric_spec(f"fabric-{i}", "tpe"))[0]
                for i in range(FABRIC_STUDIES)]
        owners = [fab.owner_of(k) for k in keys]
        space = core.SearchSpace.from_properties(PROPS)
        t0 = time.perf_counter()
        for key in keys:             # one proposal round per ask_batch
            fill(client, space, key, FABRIC_HISTORY, 250)
        t_fill = time.perf_counter() - t0
        modes = [("inline" if fab.inline else "routed",
                  lambda: core.HttpTransport(fab.host, fab.port))]
        if w == 4:
            modes.append(("direct", lambda: core.ShardedHttpTransport(
                fab.endpoints)))
        for mode, make in modes:
            before = worker_launches(core, fab)
            n, wall, lat = drive_window(core, make, token, keys,
                                        FABRIC_WINDOW_S)
            after = worker_launches(core, fab)
            delta = {wid: after[wid]["tpe_score"] - before[wid]["tpe_score"]
                     for wid in after}
            others = {wid: {op: after[wid][op] - before[wid][op]
                            for op in after[wid] if op != "tpe_score"}
                      for wid in after}
            check(sum(delta.values()) == n,
                  f"w={w} {mode}: {sum(delta.values())} tpe_score launches "
                  f"for {n} asks")
            check(not any(v for d in others.values() for v in d.values()),
                  f"w={w} {mode}: other kernels launched: {others}")
            for wid in set(owners):
                check(delta[wid] > 0, f"w={w}: worker {wid} owns a study "
                      "and launched no tpe_score")
            rows.append({"w": w, "mode": mode, "pairs": n, "wall": wall,
                         "pairs_s": n / wall, "p50": pct(lat, 50),
                         "p99": pct(lat, 99), "owners": owners,
                         "launches": delta})
            log(f"fabric w={w} {mode}: {n} ask/tell pairs in {wall:.3f} s "
                f"= {n / wall:.2f} pairs/s, ask p50 {pct(lat, 50):.3f} ms "
                f"p99 {pct(lat, 99):.3f} ms; owners {owners} "
                f"({len(set(owners))} distinct); tpe_score launches by "
                f"worker {delta} (one per ask)")
        # every worker that owns a study runs on the card and maps the
        # Parzen library; none maps JAX
        pids = worker_pids(fab)
        for wid, pid in sorted(pids.items()):
            libs = ("parzen",) if wid in owners else ()
            log("fabric w=%d maps: %s" % (w, check_maps(
                pid, f"worker {wid}", libs)))
        if w == 4:
            check(len(set(owners)) >= 3,
                  f"w=4: the 8 studies have {len(set(owners))} owners")
            rows.append(gp_through_fabric(core, fab, token))
            log(compute_apps(pids))
        log(f"fabric w={w}: up in {t_up:.2f} s, {FABRIC_STUDIES} x "
            f"{FABRIC_HISTORY} trials told in {t_fill:.2f} s")
    finally:
        fab.stop()
    return rows


def gp_through_fabric(core, fab, token) -> dict:
    """A GP study routed through the fabric: its asks launch the Matérn
    kernel (K and Ks) in the worker that owns it, not elsewhere."""
    space = core.SearchSpace.from_properties(PROPS)
    client = core.Client(core.HttpTransport(fab.host, fab.port), token)
    key, _ = client.ensure_study(fabric_spec("fabric-gp", "gp"))
    owner = fab.owner_of(key)
    fill(client, space, key, 64, 64)
    before = worker_launches(core, fab)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        trial = client.ask(key)
        lat.append(time.perf_counter() - t0)
        check(in_space(space, trial["params"]), "gp ask out of space")
        client.tell(trial["uid"], objective(space, trial["params"]))
    after = worker_launches(core, fab)
    delta = {wid: after[wid]["matern52_masked"]
             - before[wid]["matern52_masked"] for wid in after}
    check(delta[owner] > 0 and delta[owner] % 2 == 0,
          f"gp owner {owner}: {delta[owner]} matern launches")
    check(not any(v for wid, v in delta.items() if wid != owner),
          f"matern launched off the owner: {delta}")
    pid = worker_pids(fab)[owner]
    log("fabric gp: owner worker %d, 5 asks at 64 observations, p50 "
        "%.3f ms; matern52_masked launches by worker %s; %s" % (
            owner, pct(lat, 50), delta,
            check_maps(pid, f"gp owner {owner}", ("parzen", "matern"))))
    return {"w": 4, "mode": "gp", "owner": owner, "launches": delta}


def compute_apps(pids: dict[int, int]) -> str:
    """nvidia-smi's compute processes, and which worker pids it lists
    (in a container it may list none)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    listed = {int(line.split(",")[0]) for line in out.splitlines()
              if line.split(",")[0].strip().isdigit()}
    return (f"fabric w=4: nvidia-smi compute apps {out.splitlines()!r}; "
            f"worker pids listed: "
            f"{sorted(w for w, p in pids.items() if p in listed)} of "
            f"{sorted(pids)}")


def failover_run(core, root) -> dict:
    """SIGKILL the leader owning a TPE study past startup mid-campaign
    (2 workers, 1 semisync follower each, fsync always): the gap to the
    first ask/tell pair started after the kill, every acknowledged tell
    read back, and the promoted leader's asks on the card."""
    fab = core.ShardFabric(workers=2, replicas=1, replication="semisync",
                           fsync="always", root=os.path.join(root, "fo"),
                           respawn_poll=0.1, device="cuda",
                           spawn_timeout=180.0)
    space = core.SearchSpace.from_properties(PROPS)
    patient = core.RetryPolicy(max_attempts=12, base_delay=0.05,
                               max_delay=0.5)
    try:
        fab.start()
        token = fab.issue_token("chip-smoke-failover")
        client = core.Client(core.HttpTransport(fab.host, fab.port), token,
                             retry=patient)
        key, _ = client.ensure_study(fabric_spec("fabric-failover", "tpe"))
        fill(client, space, key, FAILOVER_HISTORY, 100)
        wid = fab.owner_of(key)
        old_pid = fab._workers[wid].pid
        lock = threading.Lock()
        told: list[str] = []
        pairs: list[tuple[float, float]] = []     # (started, done)
        errors: list[BaseException] = []
        stop = threading.Event()
        killed_at = [math.inf]

        def campaign(i: int) -> None:
            try:
                cl = core.Client(core.HttpTransport(fab.host, fab.port),
                                 token, worker_id=f"fo{i}", retry=patient)
                while not stop.is_set():
                    t0 = time.monotonic()
                    trial = cl.ask(key)
                    cl.tell(trial["uid"], objective(space, trial["params"]))
                    with lock:
                        told.append(trial["uid"])
                        pairs.append((t0, time.monotonic()))
            except BaseException as e:  # reported and re-raised below
                errors.append(e)

        def after_kill() -> int:
            with lock:
                return sum(t0 > killed_at[0] for t0, _ in pairs)

        threads = [threading.Thread(target=campaign, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while len(pairs) < 40 and not errors:
            check(time.monotonic() < deadline, "failover campaign stalled")
            time.sleep(0.01)
        killed_at[0] = time.monotonic()
        fab.kill_worker(wid, sig=signal.SIGKILL)
        fab.wait_respawn(wid, old_pid, timeout=120)
        promoted_after = time.monotonic() - killed_at[0]
        deadline = time.monotonic() + 60
        while after_kill() < 40 and not errors:
            check(time.monotonic() < deadline, "no pairs after failover")
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        check(not any(t.is_alive() for t in threads), "a client hung")
        if errors:
            raise errors[0]
        # the fleet heals: a fresh follower streams from the promoted
        # leader (and no spawn is in flight when the fabric stops)
        t_heal = time.monotonic()
        while not any(w["worker"] == wid and w.get("role") == "follower"
                      and (w.get("client") or {}).get("connected")
                      for w in fab.health()["workers"]):
            check(time.monotonic() - t_heal < 180,
                  "no follower reattached to the promoted leader")
            time.sleep(0.1)
        healed_after = time.monotonic() - killed_at[0]
        event = [e for e in fab.events if e["event"] == "failover"]
        check(event and event[-1]["worker"] == wid
              and event[-1]["digest_match"] is True,
              f"failover event {event}")
        gap = min(done for t0, done in pairs if t0 > killed_at[0]) \
            - killed_at[0]
        completed = {t["uid"] for t in client.iter_trials(
            key, state="completed")}
        lost = sorted(set(told) - completed)
        check(not lost, f"{len(lost)} acknowledged tells lost: {lost[:5]}")
        check(len(told) == len(set(told)), "a tell counted twice")
        n_completed = client.study(key)["n_completed"]
        check(n_completed == len(completed),
              f"n_completed {n_completed} != {len(completed)}")
        # the promoted follower served no ask before the kill: every
        # launch it counts is a proposal of the promoted leader
        promoted = fab._workers[wid]
        health = worker_health(core, (promoted.host, promoted.port))
        check(health["device"]["type"] == "cuda", "promoted off the card")
        launches = health["device"]["kernel_launches"]["tpe_score"]
        check(launches > 0, "the promoted leader launched no tpe_score")
        maps = check_maps(promoted.pid, f"promoted leader {wid}",
                          ("parzen",))
        log(f"fabric failover: SIGKILL of worker {wid} (pid {old_pid}) "
            f"after {len(pairs) - after_kill()} pairs; promoted pid "
            f"{promoted.pid} at epoch {event[-1]['epoch']}, digest match, "
            f"in the route table {promoted_after:.3f} s after the kill; "
            f"failover gap {gap:.3f} s (kill to the first pair started "
            f"after it and completed); a new follower attached "
            f"{healed_after:.3f} s after the kill; "
            f"{len(told)} acknowledged tells, 0 lost, "
            f"n_completed {n_completed}; the promoted leader's tpe_score "
            f"launches {launches} for {after_kill()} pairs after the kill; "
            f"{maps}")
        return {"gap": gap, "told": len(told), "launches": launches}
    finally:
        fab.stop()


def worker_imports() -> str:
    """What a fresh process spends importing torch, then the fabric
    module, before a worker can print its ready line."""
    code = ("import time; t0 = time.perf_counter(); import torch; "
            "t1 = time.perf_counter(); import repro_torch.core.fabric; "
            "print(t1 - t0, time.perf_counter() - t1)")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout.split()
    return (f"fabric: a fresh process imports torch in {float(out[0]):.3f} "
            f"s and repro_torch.core.fabric in {float(out[1]):.3f} s more")


def fabric_phase(core, K) -> dict:
    """Phase 14: ``ShardFabric`` at w = 1 (inline), 2 and 4 on the card,
    the direct mode and a GP study at w = 4, then a failover."""
    torch.cuda.empty_cache()
    reset_counts(K)          # the inline fabric's worker is this process
    log(worker_imports())
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fabric-") as root:
        rows = []
        for w in (1, 2, 4):
            rows += scaling_run(core, root, w)
        base = rows[0]["pairs_s"]
        log("fabric scaling against w=1 in this run: " + "; ".join(
            f"w={r['w']} {r['mode']} {r['pairs_s'] / base:.3f}x"
            for r in rows if "pairs_s" in r))
        failover = failover_run(core, root)
    parzen = sum(sum(r["launches"].values()) for r in rows
                 if r["mode"] != "gp") + failover["launches"]
    matern = sum(sum(r["launches"].values()) for r in rows
                 if r["mode"] == "gp")
    log(f"fabric: {parzen} tpe_score launches in the timed windows and "
        f"the promoted leader, {matern} matern52_masked launches in the "
        "GP study's owner, all in the workers' own processes")
    return {"tpe_score": parzen, "matern52_masked": matern}


def breakdown(label: str, wall: float, device: dict) -> str:
    if not device:
        return f"{label}: device time not measured (no device events)"
    busy_us = sum(us for _, us in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    return (f"{label}: wall {wall * 1e3:.1f} ms, device busy "
            f"{busy_us / 1e3:.3f} ms (share {busy_us / 1e6 / wall:.4f}); "
            "top device events: "
            + "; ".join(f"{k[:48]} x{c} {us / 1e3:.2f}ms"
                        for k, (c, us) in top))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    from repro_torch.core import kernels as K
    from repro_torch.core.samplers import gp as gp_mod
    from repro_torch.core.samplers import tpe as tpe_mod
    from repro_torch import models as M
    from repro_torch import serve as E
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba2_ssd as SSD
    from repro_torch.kernels import rwkv6_scan as WKV
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"needs compute capability 9.0, found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = K.build_all()
    log(f"build: {built} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()

    rows = check_kernels(K)

    space = core.SearchSpace.from_properties(PROPS)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as root:
        storage = core.DurableStorage(os.path.join(root, "wal"),
                                      fsync="group")
        try:
            tokens = core.TokenManager()
            token = tokens.issue("chip-smoke")
            key, parzen_launches = tpe_phase(core, K, tpe_mod, storage,
                                             tokens, space, token)
            matern_launches = gp_phase(core, K, gp_mod, storage, tokens,
                                       space, token)
            speculative_phase(core, K, storage, tokens, space, token, key)
        finally:
            storage.close()
    rows["tpe_score"]["launches"] = parzen_launches
    rows["matern52_masked"]["launches"] = matern_launches

    t0 = lap("phases 2-5", t0)
    rows["flash_attention"] = check_flash(FA)
    t0 = lap("phase 6", t0)
    model_parity(M, T, E)
    t0 = lap("phase 7", t0)
    kernels = {**{n: getattr(K, n) for n in ACQ_OPS},
               "flash_attention": FA.flash_attention, "ssd": SSD.ssd,
               "wkv6": WKV.wkv6}
    dense = serve_phase(M, T, E, kernels, "deepseek-7b",
                        {"flash_attention": 30},
                        {FA.ops.kernel_symbol(BF16, 128): 30},
                        attn_impl="flash")
    t0 = lap("phase 8", t0)
    rows["ssd"] = check_ssd(SSD)
    rows["wkv6"] = check_wkv6(WKV)
    t0 = lap("phase 9", t0)
    ssm_parity(M, T, E)
    t0 = lap("phase 10", t0)
    hybrid = serve_phase(M, T, E, kernels, "zamba2-1.2b",
                         {"ssd": 38, "flash_attention": 6},
                         {SSD.ops.kernel_symbol(BF16, 64, 64): 38,
                          FA.ops.kernel_symbol(BF16, 64): 6},
                         ssm_impl="pallas", attn_impl="flash")
    rwkv = serve_phase(M, T, E, kernels, "rwkv6-7b", {"wkv6": 32},
                       {WKV.ops.kernel_symbol(BF16, 64): 32},
                       ssm_impl="pallas")
    t0 = lap("phase 11", t0)
    from repro_torch import data as D
    from repro_torch import optim as O
    from repro_torch import train as TR
    train_phase(M, O, D, TR, kernels)
    t0 = lap("phase 12", t0)
    hpo_launches = hpo_phase(core, K, M, O, D, TR, kernels)
    t0 = lap("phase 13", t0)
    fabric_phase(core, K)
    lap("phase 14", t0)
    log(f"tpe_score launches: {parzen_launches} in the TPE phase (3), "
        f"{hpo_launches} in the HPO loop (13)")
    # launches on the serving paths: flash on deepseek-7b's and zamba2's
    rows["flash_attention"]["launches"] = (dense["flash_attention"]
                                           + hybrid["flash_attention"])
    rows["ssd"]["launches"] = hybrid["ssd"]
    rows["wkv6"]["launches"] = rwkv["wkv6"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
