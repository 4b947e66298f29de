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
    the card (the served prefills' shapes: deepseek-7b's, zamba2-1.2b's,
    qwen2-moe-a2.7b's, mixtral-8x7b's, pixtral-12b's (S 2304, GQA 4:1)
    and qwen1.5-32b's at its 40 heads and padded to 48; qwen3-32b's, a 4096
    window at S 8192, windows of 200 and 32, S = 96, 100, 200, 300 and
    1000 with GQA up to 8:1, hd 16 to 128, unaligned views; 2e-4 in fp32,
    2e-2 in bf16) and times the kernel, the plain version and
    ``F.scaled_dot_product_attention`` (the yardstick only; the port
    never calls it) at deepseek-7b's, zamba2-1.2b's, pixtral-12b's and
    both of qwen1.5-32b's shapes;
 7. deepseek-7b at full width, 2 layers, fp32: prefill logits with
    ``attn_impl="flash"`` against ``"ref"`` (2e-3), and token-by-token
    decode logits against the prefill's at the end of a 64-token prompt;
 8. serves deepseek-7b at full size (30 layers, bf16 compute, random
    weights from a seeded generator on the card, initialised in bf16
    as every served model's are): ``make_prefill_step``
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
    asks launch ``tpe_score`` on the card, and a new follower attached;
15. MoE: qwen2-moe-a2.7b at full width, 2 layers, fp32, its own
    grouping (1024 tokens, capacity factor 1.25) on 4 x 1024 tokens:
    on each layer's input the gather/bmm dispatch against the one-hot
    form (outputs and aux at 2e-4, identical kept (token, k, expert,
    slot) sets, the dropped assignments counted), flash against ref
    prefill logits (2e-3), and at a capacity that drops nothing decode
    logits against the prefill's at the end of a 64-token prompt; then
    qwen2-moe-a2.7b served at full size (24 layers, 14.3e9 parameters,
    24 flash launches a prefill by the hd-128 symbol) and mixtral-8x7b at full width cut from 32 to 8 layers
    (11.9e9; GQA 4:1, window 4096, 8 flash launches a prefill), as
    phase 8 serves deepseek-7b, with the profiled prefill's device time
    split into routing, dispatch, expert GEMMs, shared experts and
    flash;
16. the frontends and head padding: (a) pixtral-12b at full width, 2
    layers, fp32, 2 x (256 patches + 512 tokens): flash against ref
    prefill logits (2e-3), the image positions included; (b)
    qwen1.5-32b at full width, 2 layers, fp32, its 40/40 heads padded to
    48/48 (divisor 16, as its prefill cell in ``launch/shapes.py``):
    padded against unpadded flash prefill logits (2e-4), and the same
    two trees through the ref attention core as a witness (reported:
    the gap that the GEMMs of two widths leave without the kernel); (c)
    pixtral-12b served at full size (40 layers, 12.25e9 parameters) as
    phase 8 serves deepseek-7b, on 4 x (256 patches + 2048 tokens): 40
    flash launches a prefill by the hd-128 symbol, the device time as
    GEMMs, flash and the rest; (d) hubert-xlarge at full size (48
    layers, 9.45e8 parameters, hd 80): the bf16 encoder forward on 4 x
    2048 frames (frames/s), then the training step timed with fp32
    masters, AdamW, remat and the ref attention, one warm-up and 3 timed
    steps, finite losses (the init's gradient norm overflows at 48
    layers, so the clipped update is the decay alone;
    ``tools/frontend_probe.py`` sweeps the norm over depth); no kernel
    of this repo launched (encoder-only models take the ref attention
    core); (e) qwen1.5-32b at full width cut from 64 to 8 layers in
    bf16, unpadded and padded: prefill ms of each on 4 x 2048 tokens, 8
    flash launches each, the max logit difference reported;
17. the service on the card under the port's sanitizers: the port's
    repro-check (``repro_torch.analysis``) over its core exits 0 against
    its empty baseline, its ``--stats`` logged; then
    ``tools/sanitize_probe.py`` twice in fresh processes on one load,
    without a sanitizer and with ``install_race()`` before the core is
    imported: two ``HopaasServer(device="cuda", speculate_depth=64)``
    behind the event-loop frontend, durable storage with group fsync, a
    TPE study filled to 1,000 trials, 64 keep-alive client threads for
    5 s, a GP study told 64 trials and 10 ask/tell pairs.  The
    sanitized run must show no inversion, stall or race, all 8
    configured classes instrumented from ``repro_torch.core``, every
    core lock keyed to its static class, one ``tpe_score`` launch a
    proposal round, ``matern52_masked`` launches and no module of JAX
    or the JAX package; both runs' pairs/s and ask p50/p99 and their
    ratio (the sanitizer's overhead) are reported.  Before them, eight
    threads make a fresh process's first CUDA linalg call at once: after
    ``GPSampler(device="cuda")`` none may fail (with PyTorch alone some
    do, which a sanitized run first met in the GP's speculative worker);
18. trains the hybrid, SSM and MoE families at full width as phase 12
    trains deepseek-7b (4 x 2048 tokens a step, bf16, remat, ref
    attention and ref scans, AdamW at lr 3e-4; ``TRAIN_RUNS``):
    zamba2-1.2b at full size (38 layers), rwkv6-7b cut to 8 of 32
    layers in 4 microbatches of one row, qwen2-moe-a2.7b cut to 4 of 24
    layers.  Before each, the gradient norm at init at 1 and 8 layers
    and the run's depth (it must be finite, and at the run's depth the
    first step's).  Each run prints phase 12's lines (its step losses,
    grad norms and times, which must fall below the first step's, or
    below the second's where the first update raised the loss (rwkv6's
    does; the reference's rises too), the held-out batch's loss before
    and after 5 steps, which must fall, ms a step, tokens/s, peak memory, the
    model-FLOPs share 6 x ``count_active_params`` x tokens / (step x
    989e12) and for zamba2 also with its shared block counted at each of
    its 6 applications, the profiled step's busy share and device time by
    kind, AdamW alone) and a microbatched check: zamba2 2 microbatches
    against the unsplit step, rwkv6 2 against 4 (loss 1e-2, grad norm
    1e-3), each with its ref scan's part of a step estimated from the
    scan timed alone;
    qwen2-moe the moe_aux and dropped assignments by layer, and
    the 2-microbatch step's gradients against the mean of its two
    halves', read from the first moments, within 4x the difference of
    two identical steps.  Then the bf16 step's gradients against the
    fp32 step's on one batch of 1 x 2048 (zamba2-1.2b at 8 layers,
    rwkv6-7b at 2): relative L2 error and cosine by leaf group; then
    ``python -m repro_torch.launch.train --arch zamba2-1.2b --steps 3
    --batch 4 --seq 2048`` in a fresh process, which must exit 0 with
    finite losses; no kernel of this repo launched.

19. ``repro_torch.dist`` and the dry run against the card: (a) a
    one-rank NCCL group and a ``(1, 1)`` ``("data", "model")`` CUDA mesh;
    deepseek-7b's, zamba2-1.2b's and rwkv6-7b's full-size bf16 weights
    distributed by ``RULES_DECODE`` as DTensors; a 4 x 2048 prefill of
    each with ``attn_sp`` and its kernels (flash at each shard's query
    offset; SSD and WKV6 under ``ssm_impl="pallas"`` on each device's
    rows and heads) against the plain-tensor prefill (2e-2): 30 flash,
    38 SSD + 6 flash and 32 WKV6 launches; (b) on that mesh the dry
    run's own ``build_cell`` with seeded tensors: deepseek-7b's prefill
    (full size, 4 x 2048, ``configure_for_cell``'s blocked attention)
    and phase 12's train step (8 layers, 4 x 2048), each run once under
    ``FlopCounterMode`` with the peak from ``max_memory_allocated``,
    against the dry run's prediction on a ``(1, 1)`` mesh of the fake
    group (``measure_cell``: FLOPs equal, peak within 10%); (c)
    ``launch.dryrun.run_cell`` for the seven ``DIST_CELLS`` (deepseek-7b's
    three, qwen1.5-32b's prefill and head_dim-sharded decode, zamba2's
    prefill and rwkv6's decode) on the production 16 x 16 mesh on the
    card's host, one record line each; (d) the deepseek-7b smoke train
    state as DTensors through ``CheckpointManager.save`` and
    ``restore(..., shardings=)`` into another layout: bit-equal; (e)
    flash with ``q_offset``: at deepseek-7b's shape and at hd 64, with
    and without a window, the queries cut into slices at offsets 0, 512,
    1024, 1536 and 700 (off the tile grid), each against
    ``attention_ref`` at the same offset and the whole call's rows (2e-2).

The launch counters are set to 0 just before each of phases 3-5, 8, 11
(each model of it), 12, 13, 14, 15 (each served model), 16 (pixtral's
serving, hubert's encoding and training steps, each qwen1.5 tree), 17
(in each probe process), 18 and 19 and read just after it (a fabric worker's
counters are its own process's: they start at 0 with it and phase 14
reads them before and after each window).  The last three
lines are the kernels' JSON record, the card's name and power limit
from nvidia-smi, and the result line.
"""
from __future__ import annotations

import sys

sys.modules["jax"] = None        # the port must run without JAX ...
sys.modules["repro"] = None      # ... and without the JAX package

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402
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
GEMM_RE = r"nvjet|gemm|cutlass|xmma"     # cuBLAS's kernels, by name
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


def profiled(fn, ranges: tuple[str, ...] = ()
             ) -> tuple[float, dict[str, tuple[int, float]]]:
    """Run ``fn`` under the PyTorch profiler.  Returns the wall seconds
    and, per device-side event name, (count, total device µs); an empty
    dict means the profiler recorded no device activity.  Each name in
    ``ranges`` (a ``record_function`` label) adds a key ``"range:<name>"``
    with its count and the device time of every kernel launched inside
    it, nested ranges included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # a range also leaves an annotation on the device's timeline: not a
    # kernel, so not device time
    device = {e.key: (e.count, e.self_device_time_total)
              for e in events
              if e.device_type == DeviceType.CUDA and e.key not in ranges}
    # a range's CPU-side event: its device time is the sum of the kernels
    # launched inside it (the annotation's is its span, idle gaps included)
    if device:
        device.update({f"range:{e.key}": (e.count, e.device_time_total)
                       for e in events
                       if e.device_type == DeviceType.CPU
                       and e.key in ranges})
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
    ("qwen2-moe-a2.7b", 4, 16, 16, 2048, 128, BF16, True, None),
    ("mixtral-8x7b", 4, 32, 8, 2048, 128, BF16, True, 4096),
    ("pixtral-12b", 4, 32, 8, 2304, 128, BF16, True, None),
    ("qwen1.5-32b", 4, 40, 40, 2048, 128, BF16, True, None),
    ("qwen1.5-32b padded", 4, 48, 48, 2048, 128, BF16, True, None),
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
# the first seven rows are the served prefills' shapes (pixtral-12b's: 256
# image positions, then 2048 tokens; qwen1.5-32b's 40 heads and the 48
# they are padded to); deepseek-7b's (the JSON row), zamba2's, pixtral's
# and both of qwen1.5's are timed
FLASH_TIMED = ("deepseek-7b", "zamba2-1.2b", "pixtral-12b", "qwen1.5-32b",
               "qwen1.5-32b padded")


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
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention,
                             is_causal=True, enable_gqa=hq != hkv)
    library_ms = event_times_ms(lambda: sdpa(qt, kt, vt), 2, 10)
    symbol = FA.ops.kernel_symbol(dt, hd)
    device = kernel_device_us(lambda: FA.flash_attention(q, k, v), symbol,
                              reps=10)
    _, sdpa_events = profiled(lambda: [sdpa(qt, kt, vt)
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


def flash_parity(FA, cases: list) -> float:
    """Each case's kernel output against ``attention_ref`` at
    ``FLASH_TOL``; returns the largest error."""
    err = 0.0
    for i, (label, b, hq, hkv, s, hd, dt, causal, window) in enumerate(
            cases):
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
    log(f"flash_attention: {len(cases)} cases agree (max |err| "
        f"{err:.3e})")
    return err


def check_flash(FA) -> dict:
    err = flash_parity(FA, FLASH_CASES)

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
             "rwkv6-7b": (32, 4096), "qwen2-moe-a2.7b": (24, 2048),
             "mixtral-8x7b": (32, 4096), "pixtral-12b": (40, 5120),
             "hubert-xlarge": (48, 1280), "qwen1.5-32b": (64, 5120)}


@contextlib.contextmanager
def labelled(labels: dict):
    """Wrap each function ``labels[module]`` names in a
    ``record_function`` of its own name while the block runs (the
    module's callers look it up at each call); yields the names."""
    saved = []
    for mod, names in labels.items():
        for name in names:
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **kw)
            saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
    try:
        yield tuple(n for names in labels.values() for n in names)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def serve_phase(M, T, E, kernels: dict, arch: str, per_prefill: dict,
                symbols: dict, n_layers: int | None = None,
                labels: dict | None = None, **impl) -> dict:
    """Serve ``arch`` at full size in bf16 (random weights from a seeded
    generator on the card, initialised in bf16: no float32 tree;
    ``n_layers`` cuts the depth only): 1 + 3 + 1 profiled prefills of
    4 x 2048 tokens (a vision model's after 256 patch embeddings of its
    own: 4 x 2304 positions), each checked for ``per_prefill`` launches
    of each
    kernel and, in the profiled one, for ``symbols[s]`` device launches
    of each kernel symbol ``s``, then greedy generation.  ``labels`` maps
    a module to the names of its functions whose device time the
    profiled prefill reports.  Every kernel counter is set to 0 just before and
    read just after; returns the counts and the profiled prefill's
    device events (``profiled``'s)."""
    cfg = M.get_config(arch).replace(**impl)
    check((cfg.n_layers, cfg.d_model) == FULL_SIZE[arch], "not full size")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg.replace(param_dtype=cfg.dtype), seed=0,
                           device="cuda")
    engine = E.ServeEngine(cfg, params, max_len=96, device="cuda")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in M.registry.leaves(engine.params))
    log(f"serve: {arch}, {cfg.n_layers} layers, {n_params} "
        f"parameters: initialised in {cfg.dtype} in "
        f"{time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    prefill = E.make_prefill_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                     generator=gen, device="cuda")}
    b, s = batch["tokens"].shape
    positions, what = s, f"{b} x {s} tokens"
    if cfg.frontend == "vision":
        from repro_torch.configs.pixtral_12b import N_PATCHES
        batch["patch_embeds"] = torch.randn(
            (b, N_PATCHES, cfg.frontend_dim), generator=gen, device="cuda")
        positions, what = (s + N_PATCHES,
                           f"{b} x ({N_PATCHES} patches + {s} tokens)")
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
    check(logits.shape == (b, positions, cfg.vocab_size), "logits shape")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits = one_prefill()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with labelled(labels or {}) as names:
        wall, device = profiled(one_prefill, names)
    profile = device
    prefill_s = float(np.median(times))
    log(f"serve prefill {arch}: {what}, {prefill_s * 1e3:.2f} ms "
        f"median of 3 ({[round(t * 1e3, 2) for t in times]}), "
        f"{b * positions / prefill_s:.1f} prefill tokens/s")
    log(breakdown(f"serve prefill {arch} (profiled)", wall, device))
    for name in names:
        n, us = device.get(f"range:{name}", (0, 0.0))
        log(f"serve prefill {arch}: {name} x{n}, {us / 1e3:.3f} ms of device "
            "time inside it" if device else
            f"serve prefill {arch}: {name} not measured (no device events)")
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
    return counts, profile


# --------------------------------------------------------------------- #
# phase 15: MoE on the card
# --------------------------------------------------------------------- #
# the functions of ``models/moe.py`` whose device time the profiled MoE
# prefills report: ``route`` (router product, softmax, top-k, aux) and
# ``slots`` (the cumsum) are the routing, ``_grouped`` is the dispatch
# (its gathers and scatters) around ``slots`` and ``_experts`` (the three
# batched expert products), ``_shared`` the shared experts
MOE_FNS = ("route", "slots", "_grouped", "_experts", "_shared")


def moe_kept(MOE, p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """The assignments ``moe_ffn``'s grouped dispatch keeps, as rows
    (token, k, expert, slot) in token-major order."""
    xt = x.reshape(-1, x.shape[-1])
    _, expert_idx, _ = MOE.route(p, cfg, xt)
    slot, keep, _, _ = MOE.slots(expert_idx, cfg.moe)
    tok, k = torch.nonzero(keep, as_tuple=True)
    return torch.stack([tok, k, expert_idx[tok, k], slot[tok, k]], dim=1)


def moe_onehot_kept(MOE, p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """``moe_kept`` read off the nonzeros of the one-hot dispatch."""
    xt = x.reshape(-1, x.shape[-1])
    _, expert_idx, _ = MOE.route(p, cfg, xt)
    g, t, k, e, c = torch.nonzero(
        MOE.onehot_dispatch(expert_idx, cfg.moe, torch.float32),
        as_tuple=True)
    Tg, _ = MOE.group_capacity(cfg.moe, expert_idx.shape[0])
    return torch.stack([g * Tg + t, k, e, c], dim=1)


def moe_parity(M, T, E, MOE) -> None:
    """qwen2-moe-a2.7b at full width, 2 layers, fp32, its own grouping
    (``group_size`` 1024, capacity factor 1.25) on 4 x 1024 tokens:
    the gather/bmm dispatch against the one-hot form on each layer's
    real input (outputs and aux at 2e-4, identical kept (token, k,
    expert, slot) sets), flash against ref prefill logits (2e-3), then
    at a capacity that drops nothing (E / top_k) decode logits against
    the prefill's at the end of a 64-token prompt (2e-3)."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import rmsnorm

    cfg = M.get_config("qwen2-moe-a2.7b").replace(n_layers=2,
                                                   dtype=torch.float32)
    m = cfg.moe
    check((cfg.d_model, m.n_experts, m.top_k, m.n_shared, m.group_size,
           m.capacity_factor) == (2048, 60, 4, 4, 1024, 1.25),
          "qwen2-moe-a2.7b is not at its published width")
    params = T.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (4, 1024), generator=gen,
                         device="cuda")
    with torch.no_grad():
        x, positions = T.embed_inputs(params, cfg, {"tokens": toks})
        for i in range(cfg.n_layers):
            p = T.layer(params["blocks"], i)
            x = x + A.attention(p["attn"], cfg,
                                rmsnorm(x, p["norm1"], cfg.norm_eps),
                                positions)
            h = rmsnorm(x, p["norm2"], cfg.norm_eps)
            y, aux = MOE.moe_ffn(p["moe"], cfg, h)
            y1, aux1 = MOE.moe_ffn_onehot(p["moe"], cfg, h)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all()), "MoE output not finite")
            torch.testing.assert_close(y, y1, **TOL)
            torch.testing.assert_close(aux, aux1, **TOL)
            kept = moe_kept(MOE, p["moe"], cfg, h)
            check(torch.equal(kept, moe_onehot_kept(MOE, p["moe"], cfg, h)),
                  f"layer {i}: kept sets differ")
            Tg, cap = MOE.group_capacity(m, h.shape[0] * h.shape[1])
            n = h.shape[0] * h.shape[1] * m.top_k
            log(f"moe parity: qwen2-moe-a2.7b layer {i}, {tuple(h.shape)}, "
                f"groups of {Tg}, capacity {cap}: gather/bmm vs one-hot max "
                f"|err| {float((y - y1).abs().max()):.3e}, aux "
                f"{float(aux):.6f} vs {float(aux1):.6f}; kept sets "
                f"identical, {n - len(kept)} of {n} assignments dropped")
            x = x + y
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

    nodrop = cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    prompt = toks[:, :64]
    prefill = E.make_prefill_step(nodrop.replace(attn_impl="flash"))(
        params, {"tokens": prompt})
    decode = E.make_decode_step(nodrop)
    cache = T.init_cache(nodrop, 4, 64, "cuda")
    for t in range(64):
        logits, cache = decode(params, cache, prompt[:, t:t + 1], t)
    torch.cuda.synchronize()
    torch.testing.assert_close(logits[:, 0], prefill[:, -1], rtol=2e-3,
                               atol=2e-3)
    decode_err = float((logits[:, 0] - prefill[:, -1]).abs().max())
    log(f"moe parity: qwen2-moe-a2.7b, d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, fp32, {toks.shape[0]} x {toks.shape[1]} "
        f"tokens: flash vs ref prefill logits max |err| {prefill_err:.3e}; "
        f"at capacity factor {nodrop.moe.capacity_factor} (no drops) "
        f"decode vs prefill at position 63 of a 64-token prompt max |err| "
        f"{decode_err:.3e} (tolerance 2e-3)")
    del params, cache, logits, prefill
    torch.cuda.empty_cache()


def moe_phase(M, T, E, MOE, FA, kernels: dict) -> dict:
    """Phase 15: MoE parity, then qwen2-moe-a2.7b served at full size and
    mixtral-8x7b at full width cut to 8 layers (all 32 take ~93 GB in
    bf16, more than the card holds); returns the flash launches of the
    two."""
    moe_parity(M, T, E, MOE)
    symbol = FA.ops.kernel_symbol(BF16, 128)
    qwen, device = serve_phase(M, T, E, kernels, "qwen2-moe-a2.7b",
                               {"flash_attention": 24}, {symbol: 24},
                               labels={MOE: MOE_FNS}, attn_impl="flash")
    log(moe_breakdown("qwen2-moe-a2.7b", device, symbol))
    full = M.count_params(M.get_config("mixtral-8x7b"))
    cut = M.count_params(M.get_config("mixtral-8x7b").replace(n_layers=8))
    log(f"serve: mixtral-8x7b depth cut 32 -> 8 layers: {cut} of {full} "
        f"parameters ({2 * full / 1e9:.1f} GB in bf16 for all 32)")
    mixtral, device = serve_phase(M, T, E, kernels, "mixtral-8x7b",
                                  {"flash_attention": 8}, {symbol: 8},
                                  n_layers=8, labels={MOE: MOE_FNS},
                                  attn_impl="flash")
    log(moe_breakdown("mixtral-8x7b", device, symbol))
    return {"flash_attention": qwen["flash_attention"]
            + mixtral["flash_attention"]}


def moe_breakdown(arch: str, device: dict, symbol: str) -> str:
    """The profiled MoE prefill's device time by part, from the
    ``MOE_FNS`` ranges and the flash kernel's symbol."""
    if not device:
        return f"moe breakdown {arch}: not measured (no device events)"

    def ms(name):
        return device.get(f"range:{name}", (0, 0.0))[1] / 1e3
    busy = sum(us for k, (_, us) in device.items()
               if not k.startswith("range:")) / 1e3
    parts = {"routing": ms("route") + ms("slots"),
             "dispatch gathers/scatters": ms("_grouped") - ms("slots")
             - ms("_experts"),
             "expert GEMMs": ms("_experts"),
             "shared experts": ms("_shared"),
             "flash": sum(us for k, (_, us) in device.items()
                          if symbol in k) / 1e3}
    parts["the rest (attention projections, norms, LM head)"] = (
        busy - sum(parts.values()))
    return (f"moe breakdown {arch} (profiled prefill, device ms of "
            f"{busy:.3f} busy): " + ", ".join(f"{k} {v:.3f}"
                                             for k, v in parts.items()))


# --------------------------------------------------------------------- #
# phase 16: the frontends and head padding on the card
# --------------------------------------------------------------------- #
PAD_DIVISOR = 16                  # qwen1.5-32b's prefill cell: 40 -> 48
QWEN_LAYERS = 8      # of 64: all 64 take 70.4 GB in bf16, and the init's
#                      float32 draw of blocks.mlp.up 35.9 GB more
HUBERT_BATCH, HUBERT_FRAMES = 4, 2048


def device_split(device: dict, symbol: str) -> str:
    """A profiled prefill's device time as ``device_kinds``' GEMMs, flash
    (``symbol``) and the rest."""
    if not device:
        return "not measured (no device events)"
    device = {k: v for k, v in device.items() if not k.startswith("range:")}
    kinds = dict(device_kinds(device))
    gemm = kinds.get("gemm", (0, 0.0))[1]
    flash = sum(us for k, (_, us) in device.items() if symbol in k)
    busy = sum(us for _, us in kinds.values())
    return (f"device {busy / 1e3:.3f} ms: GEMMs {gemm / 1e3:.3f}, flash "
            f"{flash / 1e3:.3f}, the rest {(busy - gemm - flash) / 1e3:.3f}")


def frontend_parity(M, T, E, SURG, SH) -> None:
    """(a) pixtral-12b at full width, 2 layers, fp32, 2 x (256 patches +
    512 tokens): flash against ref prefill logits (2e-3), the image
    positions included; (b) qwen1.5-32b at full width, 2 layers, fp32,
    heads padded 40 -> 48 as its prefill cell pads them: the padded
    tree's flash prefill logits against the unpadded tree's (2e-4)."""
    from repro_torch.configs.pixtral_12b import N_PATCHES

    cfg = M.get_config("pixtral-12b").replace(n_layers=2, dtype=FP32)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.rope_theta) == (5120, 32, 8, 128, 1e9),
          "pixtral-12b is not at its published width")
    params = T.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512),
                                     generator=gen, device="cuda"),
             "patch_embeds": torch.randn((2, N_PATCHES, cfg.frontend_dim),
                                         generator=gen, device="cuda")}
    flash = E.make_prefill_step(cfg.replace(attn_impl="flash"))(
        params, batch)
    ref = E.make_prefill_step(cfg.replace(attn_impl="ref"))(params, batch)
    torch.cuda.synchronize()
    check(flash.shape == (2, N_PATCHES + 512, cfg.vocab_size),
          "prefill shape")
    check(bool(torch.isfinite(flash).all()), "prefill logits not finite")
    torch.testing.assert_close(flash, ref, rtol=2e-3, atol=2e-3)
    diff = (flash - ref).abs()
    log(f"frontend parity: pixtral-12b, d_model {cfg.d_model}, "
        f"{cfg.n_heads}:{cfg.n_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.n_layers} layers, fp32, 2 x ({N_PATCHES} patches + 512 "
        f"tokens): flash vs ref prefill logits max |err| "
        f"{float(diff.max()):.3e} (image positions "
        f"{float(diff[:, :N_PATCHES].max()):.3e}, text "
        f"{float(diff[:, N_PATCHES:].max()):.3e}; tolerance 2e-3)")
    del params, flash, ref, diff
    torch.cuda.empty_cache()

    cfg = M.get_config("qwen1.5-32b").replace(n_layers=2, dtype=FP32,
                                               attn_impl="flash")
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.qkv_bias) == (5120, 40, 40, 128, True),
          "qwen1.5-32b is not at its published width")
    new = SURG.pad_heads_config(cfg, PAD_DIVISOR)
    cell = SH.configure_for_cell(M.get_config("qwen1.5-32b"),
                                 SH.SHAPES["prefill_32k"])
    check((new.n_heads, new.n_kv_heads) == (cell.n_heads, cell.n_kv_heads)
          == (48, 48), "padded heads")
    params = T.init_params(cfg, seed=0, device="cuda")
    padded = SURG.pad_heads_params(params, cfg, new)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512),
                                     generator=gen, device="cuda")}
    want = E.make_prefill_step(cfg)(params, batch)
    got = E.make_prefill_step(new)(padded, batch)
    # the witness: both trees through the ref core, no kernel
    want_ref = E.make_prefill_step(cfg.replace(attn_impl="ref"))(
        params, batch)
    got_ref = E.make_prefill_step(new.replace(attn_impl="ref"))(
        padded, batch)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "padded logits not finite")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    diff = (got - want).abs()
    share = float((diff / (2e-4 + 2e-4 * want.abs())).max())
    gap = {"padded vs unpadded, ref core": (got_ref - want_ref),
           "flash vs ref core, unpadded": (want - want_ref),
           "flash vs ref core, padded": (got - got_ref)}
    log(f"frontend parity: qwen1.5-32b, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} -> {new.n_heads} (divisor {PAD_DIVISOR}, QKV "
        f"bias), {cfg.n_layers} layers, fp32, flash, 2 x 512 tokens: "
        f"padded vs unpadded prefill logits max |err| "
        f"{float(diff.max()):.3e}, at most {share:.3f} of the tolerance "
        f"2e-4 + 2e-4 |logit| (logits up to "
        f"{float(want.abs().max()):.3e}); witness, max |diff| "
        + ", ".join(f"{k} {float(v.abs().max()):.3e}"
                    for k, v in gap.items()))
    del params, padded, got, want, got_ref, want_ref, diff, gap
    torch.cuda.empty_cache()


def hubert_phase(M, O, D, TR, E, kernels: dict) -> None:
    """(d) hubert-xlarge at full size (48 layers, hd 80, encoder-only:
    the ref attention core even under ``attn_impl="flash"``, as in the
    reference): the bf16 encoder forward on 4 x 2048 frames of the
    synthetic stream, then the training step (fp32 masters, AdamW,
    remat, ref attention): one warm-up and 3 timed steps.  Launches no
    kernel of this repo."""
    cfg = M.get_config("hubert-xlarge")
    check((cfg.n_layers, cfg.d_model) == FULL_SIZE["hubert-xlarge"]
          and cfg.encoder_only and cfg.head_dim == 80, "not full size")
    check(cfg.remat and cfg.attn_impl == "ref" and cfg.dtype == BF16,
          "training config")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    opt = O.AdamWConfig(lr=3e-4)
    t0 = time.perf_counter()
    state = TR.init_train_state(cfg, opt, seed=0, device="cuda").tree()
    n_params = sum(t.numel() for t in M.registry.leaves(state["params"]))
    check(n_params == M.count_params(cfg), "parameter count")
    data = D.SyntheticLMDataset(D.DataConfig(global_batch=HUBERT_BATCH,
                                             seq_len=HUBERT_FRAMES), cfg)

    def batch(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in data[i].items()}

    params = E.engine.cast_params(state["params"], cfg,
                                  torch.device("cuda"))
    encode = E.make_prefill_step(cfg.replace(attn_impl="flash"))
    b = batch(0)
    torch.cuda.synchronize()
    log(f"hubert: hubert-xlarge, {cfg.n_layers} layers, {n_params} "
        f"parameters: fp32 masters, AdamW moments and a bf16 copy in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    logits = encode(params, b)
    torch.cuda.synchronize()
    check(logits.shape == (HUBERT_BATCH, HUBERT_FRAMES, cfg.vocab_size),
          "encoder logits shape")
    check(bool(torch.isfinite(logits).all()), "encoder logits not finite")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode(params, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall, device = profiled(lambda: encode(params, b))
    enc_s = float(np.median(times))
    frames = HUBERT_BATCH * HUBERT_FRAMES
    log(f"hubert encode: {HUBERT_BATCH} x {HUBERT_FRAMES} frames, "
        f"{enc_s * 1e3:.2f} ms median of 3 "
        f"({[round(t * 1e3, 2) for t in times]}), {frames / enc_s:.1f} "
        "frames/s")
    log(breakdown("hubert encode (profiled)", wall, device))
    if device:
        log("hubert encode: device time by kind: " + "; ".join(
            f"{kind} x{c} {us / 1e3:.2f} ms"
            for kind, (c, us) in device_kinds(device)))
    del params, logits
    torch.cuda.empty_cache()

    step = TR.make_train_step(cfg, opt)
    losses, times = [], []
    for i in range(4):
        b = batch(i + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"hubert train step {i + 1}: loss {loss:.6f}, grad norm "
            f"{float(metrics['grad_norm']):.6f}, {times[-1] * 1e3:.2f} ms")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    step_s = float(np.median(times[1:]))
    peak = torch.cuda.max_memory_allocated()
    log(f"hubert train: {HUBERT_BATCH} x {HUBERT_FRAMES} frames a step, "
        f"{step_s * 1e3:.2f} ms a step (median of 3 after a warm-up: "
        f"{[round(t * 1e3, 2) for t in times[1:]]}), {frames / step_s:.1f} "
        f"frames/s; peak device memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated over the phase, the encoder forward "
        f"included); "
        f"model-FLOPs share of the bf16 peak (6 N frames / (step time x "
        f"989e12)): {6 * n_params * frames / (step_s * BF16_OPS_PER_S):.4f}")
    counts = {n: fn.launches for n, fn in kernels.items()}
    check(not any(counts.values()), f"kernel launches in hubert {counts}")
    del state, b
    torch.cuda.empty_cache()


def padded_serve(M, T, E, SURG, kernels: dict, symbol: str) -> int:
    """(e) qwen1.5-32b at full width cut to ``QWEN_LAYERS`` layers, bf16:
    the tree and its heads padded 40 -> 48, each prefilled 1 + 3 + 1
    (profiled) times on 4 x 2048 tokens through flash (``QWEN_LAYERS``
    launches a prefill); the max logit difference is reported, not
    bounded (bf16 GEMMs of two widths may sum in other orders).
    Returns the flash launches."""
    full = M.get_config("qwen1.5-32b")
    check((full.n_layers, full.d_model) == FULL_SIZE["qwen1.5-32b"],
          "not full size")
    cfg = full.replace(n_layers=QWEN_LAYERS, attn_impl="flash")
    new = SURG.pad_heads_config(cfg, PAD_DIVISOR)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = E.engine.cast_params(
        T.init_params(cfg.replace(param_dtype=cfg.dtype), seed=0,
                      device="cuda"), cfg, torch.device("cuda"))
    padded = SURG.pad_heads_params(params, cfg, new)
    n = sum(t.numel() for t in M.registry.leaves(params))
    n_pad = sum(t.numel() for t in M.registry.leaves(padded))
    check(n == M.count_params(cfg) and n_pad == M.count_params(new),
          "parameter counts")
    torch.cuda.synchronize()
    log(f"serve: qwen1.5-32b depth cut {full.n_layers} -> {cfg.n_layers} "
        f"layers: {n} parameters, padded to {new.n_heads}/"
        f"{new.n_kv_heads} heads {n_pad} (+{n_pad - n}); initialised in "
        f"{cfg.dtype} in {time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                     generator=gen, device="cuda")}
    logits, launches = {}, 0
    for label, c, p in (("unpadded", cfg, params), ("padded", new, padded)):
        prefill = E.make_prefill_step(c)
        for fn in kernels.values():
            fn.launches = 0
        logits[label] = prefill(p, batch)                 # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            prefill(p, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        wall, device = profiled(lambda: prefill(p, batch))
        counts = {k: fn.launches for k, fn in kernels.items()}
        check(counts == {k: 5 * QWEN_LAYERS if k == "flash_attention" else 0
                         for k in kernels}, f"{label} launches {counts}")
        got = sum(m for k, (m, _) in device.items() if symbol in k)
        check(not device or got == QWEN_LAYERS,
              f"{got} device launches of {symbol}")
        launches += counts["flash_attention"]
        ms = float(np.median(times)) * 1e3
        log(f"serve prefill qwen1.5-32b {label} ({c.n_heads}/"
            f"{c.n_kv_heads} heads, {QWEN_LAYERS} layers): 4 x 2048 "
            f"tokens, {ms:.2f} ms median of 3 "
            f"({[round(t * 1e3, 2) for t in times]}), "
            f"{4 * 2048 / ms * 1e3:.1f} prefill tokens/s; {symbol} x{got} in "
            f"the profiled prefill; {device_split(device, symbol)}")
        log(breakdown(f"serve prefill qwen1.5-32b {label} (profiled)", wall,
                      device))
    check(all(bool(torch.isfinite(v).all()) for v in logits.values()),
          "logits not finite")
    diff = (logits["padded"] - logits["unpadded"]).abs().max()
    log(f"serve: qwen1.5-32b padded vs unpadded bf16 prefill logits max "
        f"|diff| {float(diff):.3e} (reported, not bounded); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, padded, logits, batch
    torch.cuda.empty_cache()
    return launches


def frontend_phase(M, T, E, O, D, TR, SURG, SH, FA, kernels: dict) -> int:
    """Phase 16: frontend and surgery parity, pixtral-12b served at full
    size, hubert-xlarge encoded and its training step timed at full
    size, qwen1.5-32b served padded and unpadded; returns the flash launches of the
    served prefills."""
    symbol = FA.ops.kernel_symbol(BF16, 128)
    t0 = time.perf_counter()
    frontend_parity(M, T, E, SURG, SH)
    t0 = lap("phase 16 (a, b): parity", t0)
    pixtral, device = serve_phase(M, T, E, kernels, "pixtral-12b",
                                  {"flash_attention": 40}, {symbol: 40},
                                  attn_impl="flash")
    log(f"serve prefill pixtral-12b (profiled): "
        f"{device_split(device, symbol)}")
    t0 = lap("phase 16 (c): pixtral-12b", t0)
    hubert_phase(M, O, D, TR, E, kernels)
    t0 = lap("phase 16 (d): hubert-xlarge", t0)
    qwen = padded_serve(M, T, E, SURG, kernels, symbol)
    lap("phase 16 (e): qwen1.5-32b", t0)
    return pixtral["flash_attention"] + qwen


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


# phase 18: arch -> (layers, microbatches of a step), each at full width on
# TRAIN_BATCH x TRAIN_SEQ tokens a step (~18 B a parameter of state: fp32
# masters and moments, the bf16 copy and its gradients)
TRAIN_RUNS = {
    "zamba2-1.2b": (38, 1),       # full size: ~19.6 GiB of state
    # all 32 layers need ~126 GiB; at b 4 the ref WKV's (b, n, Q, Q, nh,
    # hd) fp32 tensors take 8 GiB each, at b 1 2 GiB
    "rwkv6-7b": (8, 4),
    "qwen2-moe-a2.7b": (4, 1)}    # all 24 layers need ~240 GiB
NORM_DEPTHS = (1, 8)              # and each run's own depth
# the bf16-against-fp32 reading: arch -> layers, one row of TRAIN_SEQ
FIDELITY_LAYERS = {"zamba2-1.2b": 8, "rwkv6-7b": 2}
# its leaf groups, by path prefix: each leaf in exactly one
LEAF_GROUPS = {
    "zamba2-1.2b": ("embed", "mamba_groups/mamba", "mamba_groups/norm",
                    "mamba_tail/mamba", "mamba_tail/norm", "shared/attn",
                    "shared/mlp", "shared/norm", "final_norm", "lm_head"),
    "rwkv6-7b": ("embed", "blocks/tmix", "blocks/cmix", "blocks/norm",
                 "final_norm", "lm_head")}
LAUNCHER = ("--arch", "zamba2-1.2b", "--steps", "3", "--batch", "4",
            "--seq", "2048")


def tree_items(tree: dict, prefix: str = ""):
    """(``/``-joined path, leaf) pairs of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def rows(batch: dict, j: int, n: int) -> dict:
    """Microbatch ``j`` of ``n``: rows j, n + j, ... (the step's split)."""
    return {k: v[j::n] for k, v in batch.items()}


@contextlib.contextmanager
def moe_calls(MOE):
    """Record each MoE layer's aux loss and its dropped and total (token,
    k) assignments while the block runs: one entry a layer a forward, in
    call order (``moe_ffn`` looks ``route`` and ``slots`` up at each
    call)."""
    calls: list[list] = []
    route, slots = MOE.route, MOE.slots

    def routed(*a, **kw):
        out = route(*a, **kw)
        calls.append([out[2], 0, 0])
        return out

    def slotted(*a, **kw):
        out = slots(*a, **kw)
        calls[-1][1:] = [(~out[1]).sum(), out[1].numel()]
        return out
    MOE.route, MOE.slots = routed, slotted
    try:
        yield calls
    finally:
        MOE.route, MOE.slots = route, slots


def moe_layers(calls: list, n_layers: int) -> str:
    """``moe_calls``' entries summed over the microbatches, by layer."""
    out = []
    for i in range(n_layers):
        mine = calls[i::n_layers]
        aux = sum(float(a) for a, _, _ in mine) / len(mine)
        dropped = sum(int(d) for _, d, _ in mine)
        total = sum(int(t) for _, _, t in mine)
        out.append(f"layer {i}: moe_aux {aux:.6f}, {dropped} of {total} "
                   "assignments dropped")
    return "; ".join(out)


def grad_norms(M, TR, cfg, batch: dict, micro: int, depths,
               device: str = "cuda") -> dict[int, float]:
    """The train step's gradient norm at init on ``batch`` for each depth
    of ``depths``: ``cfg`` cut to that many layers, initialised from seed
    0 as the trainer does (so the run's own depth gives its first step's
    norm), its ``cfg.dtype`` copy, the gradients of ``micro`` strided
    microbatches summed in fp32 (float64 for a float64 tree) and scaled
    by 1 / ``micro``, each leaf's squares summed in that type as
    ``global_norm`` sums them.  A leaf the cut model does not use
    (zamba2's shared block below 6 layers) has a zero gradient."""
    norms = {}
    for n in depths:
        cut = cfg.replace(n_layers=n)
        weights = TR.step.cast_weights(
            cut, M.transformer.init_params(cut, seed=0, device=device))
        leaves = list(M.registry.leaves(weights))
        acc = [torch.zeros(t.shape, device=t.device,
                           dtype=torch.promote_types(t.dtype, FP32))
               for t in leaves]
        for j in range(micro):
            loss, _ = M.transformer.loss_fn(weights, cut,
                                            rows(batch, j, micro))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g)
            del loss, grads
        squares = sum(float(torch.sum(torch.square(a))) for a in acc)
        norms[n] = math.sqrt(squares) / micro
        del weights, leaves, acc
        if device == "cuda":
            torch.cuda.empty_cache()
    return norms


def learn(M, D, TR, cfg, opt, micro: int, state: dict, steps: int,
          tag: str, device: str = "cuda",
          shape: tuple[int, int] | None = None):
    """``steps`` train steps of ``opt`` in ``micro`` strided microbatches
    on the synthetic stream's batches 0, 1, ... of ``shape`` (batch, seq;
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` unless given), each step's loss, grad
    norm and time logged, with the loss of a held-out batch before and
    after (an MoE's aux loss and dropped assignments by layer beside it).
    Returns a namespace: the ``state``; the steps' ``losses``, ``norms``
    and ``times`` (s); the ``held`` losses (before, after); the ``step``
    function and ``batch(i)``, the stream's batch ``i`` on ``device``."""
    n_rows, seq = shape or (TRAIN_BATCH, TRAIN_SEQ)
    data = D.SyntheticLMDataset(D.DataConfig(global_batch=n_rows,
                                             seq_len=seq), cfg)

    def batch(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data[i].items()}

    held = batch(HELD_OUT)

    def held_out_loss(when: str) -> float:
        """One batch that no step trains on, in the step's microbatches
        (a mean of equal-sized means)."""
        with torch.no_grad(), moe_calls(M.moe) as calls:
            params = TR.step.cast_weights(cfg, state["params"])
            loss = sum(float(M.transformer.loss_fn(
                params, cfg, rows(held, j, micro))[0])
                for j in range(micro)) / micro
        if cfg.moe is not None:
            log(f"{tag}: held-out batch {when}: "
                + moe_layers(calls, cfg.n_layers))
        return loss

    step = TR.make_train_step(cfg, opt, micro)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    held_before = held_out_loss("before step 1")
    losses, norms, times = [], [], []
    for i in range(steps):
        b = batch(i)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        loss = float(metrics["loss"])
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        aux = (f", moe_aux {float(metrics['moe_aux']):.6f}"
               if cfg.moe is not None else "")
        log(f"{tag} step {i + 1}: loss {loss:.6f}, grad norm "
            f"{norms[-1]:.6f}, {times[-1] * 1e3:.2f} ms{aux}")
    # each step's loss is on another batch, which moves it by ~0.02 here;
    # the held-out batch's loss before and after has no such noise
    held_after = held_out_loss(f"after step {steps}")
    log(f"{tag}: held-out batch {HELD_OUT}: loss {held_before:.6f} before "
        f"step 1, {held_after:.6f} after step {steps} "
        f"({held_after - held_before:+.6f})")
    return types.SimpleNamespace(state=state, losses=losses, norms=norms,
                                 times=times, held=(held_before, held_after),
                                 step=step, batch=batch)


def train_phase(M, O, D, TR, kernels: dict, arch: str = "deepseek-7b",
                layers: int = TRAIN_LAYERS, micro: int = 1,
                tag: str = "train") -> dict:
    """``arch`` at full width, ``layers`` layers, bf16 compute, remat on,
    ``attn_impl="ref"`` and ``ssm_impl="ref"`` (the kernels have no
    backward): ``learn``'s 5 steps (a warm-up and 4 timed; every loss
    and norm finite, the held-out batch's loss falling, and the fifth
    step's below the first's, or below the second's where the first
    update raised the loss) and a
    profiled one on 4 x 2048 tokens of the synthetic stream in ``micro``
    strided microbatches, AdamW at lr 3e-4; AdamW alone; then
    ``split_check`` (an MoE's ``moe_split_check``).  The caller sets the
    kernel counters to 0; they must still read 0.  Returns ms a step,
    peak bytes, the model-FLOPs shares and the first step's grad
    norm."""
    full = M.get_config(arch)
    check((full.n_layers, full.d_model) == FULL_SIZE[arch],
          "not full size")
    cfg = full.replace(n_layers=layers)
    check(cfg.remat and cfg.attn_impl == "ref" and cfg.ssm_impl == "ref"
          and cfg.dtype == BF16, "training config")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = O.AdamWConfig(lr=3e-4)
    t0 = time.perf_counter()
    state = TR.init_train_state(cfg, opt, seed=0, device="cuda").tree()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in M.registry.leaves(state["params"]))
    check(n_params == M.count_params(cfg), "parameter count")
    depth = (f"depth cut {full.n_layers} -> {cfg.n_layers} layers"
             if layers < full.n_layers else f"full depth, {layers} layers")
    log(f"{tag}: {arch} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), {depth}: {n_params} parameters; fp32 masters "
        f"and AdamW moments in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    run = learn(M, D, TR, cfg, opt, micro, state, 5, tag)
    state, losses, norms, times, held = (run.state, run.losses, run.norms,
                                         run.times, run.held)
    step, batch = run.step, run.batch
    del run
    check(all(math.isfinite(x) for x in losses + norms),
          f"losses {losses}, grad norms {norms}")
    # Adam's first steps move every parameter by ~lr whatever its
    # gradient: at rwkv6-7b's width that raises the loss, in the reference
    # as in the port (tests/test_torch_full_width.py); the loss must then
    # fall below the raised one
    check(losses[4] < max(losses[0], losses[1]),
          f"loss did not fall: {losses}")
    check(held[1] < held[0], f"held-out loss {held[0]} -> {held[1]}")
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the reference's count (launch/dryrun.py's model_flops): 6 x active
    # parameters x tokens
    n_active = M.count_active_params(cfg)
    share = 6 * n_active * tokens / (step_s * BF16_OPS_PER_S)
    split = f" in {micro} microbatches" if micro > 1 else ""
    log(f"{tag}: {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step{split}, "
        f"{step_s * 1e3:.2f} ms a step (median of 4 after a warm-up: "
        f"{[round(t * 1e3, 2) for t in times[1:]]}), {tokens / step_s:.1f} "
        f"tokens/s; peak device memory {peak / 2**30:.2f} GiB "
        f"({peak} B, max_memory_allocated); model-FLOPs share of the bf16 "
        f"peak (6 N tokens / (step time x 989e12)): {share:.4f}")
    out = {"ms": step_s * 1e3, "peak": peak, "share": share,
           "norm": norms[0]}
    if cfg.moe is not None:
        log(f"{tag}: N is count_active_params, {n_active} of {n_params} "
            f"(top-{cfg.moe.top_k} of {cfg.moe.n_experts} experts and the "
            f"{cfg.moe.n_shared} shared)")
    if cfg.block == "zamba2":
        n_groups = cfg.n_layers // cfg.shared_attn_period
        shared = sum(t.numel()
                     for t in M.registry.leaves(state["params"]["shared"]))
        tied = n_active + (n_groups - 1) * shared
        out["share_tied"] = 6 * tied * tokens / (step_s * BF16_OPS_PER_S)
        log(f"{tag}: counting the weight-tied shared block ({shared} "
            f"parameters) once for each of its {n_groups} applications "
            f"(N = {tied}): model-FLOPs share {out['share_tied']:.4f}")

    b = batch(5)
    res = {}

    def one_step():
        res["state"], res["metrics"] = step(state, b)

    wall, device = profiled(one_step)
    state = res["state"]
    check(math.isfinite(float(res["metrics"]["loss"])), "profiled loss")
    log(breakdown(f"{tag} step (profiled)", wall, device))
    if device:
        top = sorted(device.items(), key=lambda kv: -kv[1][1])[:5]
        log(f"{tag} step: five largest device-time entries: " + "; ".join(
            f"{event_name(k)} x{c} {us / 1e3:.3f} ms" for k, (c, us) in top))
        log(f"{tag} step: device time by kind: " + "; ".join(
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
    log(f"{tag}: adamw_update alone on the {n_params}-parameter state: "
        f"{adamw_ms:.2f} ms (CUDA events, median of 3, eager)")

    check_split = moe_split_check if cfg.moe is not None else split_check
    state, said = check_split(M, O, TR, cfg, state, batch(7), micro)
    log(f"{tag}: {said}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB over the "
        "phase")
    counts = {n: fn.launches for n, fn in kernels.items()}
    check(not any(counts.values()), f"kernel launches in training {counts}")
    del state, b, res
    torch.cuda.empty_cache()
    return out


def split_check(M, O, TR, cfg, state: dict, b: dict, micro: int
                ) -> tuple[dict, str]:
    """The batch ``b`` in the run's ``micro`` microbatches (unsplit when
    1; lr 0, so the parameters stay) and in 2: the loss of any split is
    the unsplit loss, so the accumulated gradient's norm is what tests the
    split and the accumulation (loss within 1e-2, grad norm within
    1e-3).  Returns the state and what it read."""
    opt = O.AdamWConfig(lr=3e-4)
    state, m1 = TR.make_train_step(cfg, O.AdamWConfig(lr=0.0), micro)(
        state, b)
    state, m2 = TR.make_train_step(cfg, opt, n_microbatches=2)(state, b)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    g1, g2 = float(m1["grad_norm"]), float(m2["grad_norm"])
    check(math.isfinite(l2) and abs(l2 - l1) <= 1e-2 * abs(l1),
          f"microbatches=2 loss {l2} against {l1}")
    check(math.isfinite(g2) and abs(g2 - g1) <= 1e-3 * abs(g1),
          f"microbatches=2 grad norm {g2} against {g1}")
    what = "unsplit" if micro == 1 else f"in {micro} microbatches"
    return state, (
        f"the same batch {what} (lr 0) and in 2 microbatches: "
        f"loss {l1:.6f} / {l2:.6f} (relative {abs(l2 - l1) / abs(l1):.3e}, "
        f"tolerance 1e-2), grad norm {g1:.6f} / {g2:.6f} (relative "
        f"{abs(g2 - g1) / abs(g1):.3e}, tolerance 1e-3)")


def moe_split_check(M, O, TR, cfg, state: dict, b: dict, micro: int
                    ) -> tuple[dict, str]:
    """An MoE's split regroups the tokens into capacity groups of each
    microbatch's own, which changes the kept sets: so the 2-microbatch
    step's gradients are held against the mean of the two half-batch
    steps' (rows 0, 2 and 1, 3, the same rows as the microbatches), all
    read exactly from the first moments (lr 0, b1 0, no clipping: m =
    g; the parameters stay).  The expert dispatch's backward accumulates
    with atomics, so the tolerance, relative to each leaf's largest
    gradient, is 4 x the largest such difference between two identical
    unsplit steps on the first half (0 when they agree bit for bit).  The
    halves' gradients wait in pinned host memory.  Returns the state and
    what it read."""
    check(micro == 1, "an MoE run's timed step is unsplit")
    opt = O.AdamWConfig(lr=0.0, b1=0.0, grad_clip=0.0)
    one, two = TR.make_train_step(cfg, opt), TR.make_train_step(cfg, opt, 2)
    halves = [rows(b, j, 2) for j in range(2)]

    def moments():
        return list(M.registry.leaves(state["opt_state"]["m"]))

    def rel(t, h):              # max |t - h| over h's largest magnitude
        h = h.to(t.device, non_blocking=True)
        return float((t - h).abs().max()
                     / h.abs().max().clamp(min=1e-30))

    state, m0 = one(state, halves[0])
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            for t in moments()]
    state, m0b = one(state, halves[0])
    ident = max(rel(t, h) for t, h in zip(moments(), host))
    state, m1 = one(state, halves[1])
    for t, h in zip(moments(), host):
        h.copy_((h.to(t.device) + t) * 0.5)
    state, ms = two(state, b)
    torch.cuda.synchronize()
    err = max(rel(t, h) for t, h in zip(moments(), host))
    tol = 4 * ident
    losses = [float(m["loss"]) for m in (m0, m0b, m1, ms)]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(err <= tol, f"2-microbatch gradients {err} against the halves' "
          f"mean, tolerance {tol}")
    del host
    return state, (
        f"two identical unsplit steps on rows 0, 2: losses "
        f"{losses[0]:.6f} / {losses[1]:.6f}, gradients apart by {ident:.3e} "
        f"of a leaf's largest at most; the 2-microbatch step's gradients "
        f"against the mean of the two halves' (rows 0, 2 and 1, 3): "
        f"{err:.3e} of a leaf's largest at most (tolerance {tol:.3e}); "
        f"loss {losses[3]:.6f} against the halves' mean "
        f"{(losses[0] + losses[2]) / 2:.6f}")


def bf16_fidelity(M, O, D, TR, arch: str, layers: int
                  ) -> dict[str, tuple[float, float]]:
    """``arch`` at full width cut to ``layers`` layers, one row of
    ``TRAIN_SEQ`` tokens: the train step's gradients with bf16 compute and
    with fp32 compute (TF32 off) from one set of fp32 masters, read
    exactly from the first moments (lr 0, b1 0, no clipping); for each
    leaf group of ``LEAF_GROUPS`` the relative L2 error ||g16 - g32|| /
    ||g32|| and the cosine, summed in float64.  Readings, not bounds."""
    cfg = M.get_config(arch).replace(n_layers=layers)
    opt = O.AdamWConfig(lr=0.0, b1=0.0, grad_clip=0.0)
    state = TR.init_train_state(cfg, opt, seed=0, device="cuda").tree()
    data = D.SyntheticLMDataset(D.DataConfig(global_batch=1,
                                             seq_len=TRAIN_SEQ), cfg)
    b = {k: torch.from_numpy(v).to("cuda") for k, v in data[0].items()}
    state, m16 = TR.make_train_step(cfg, opt)(state, b)
    g16 = {k: t.clone() for k, t in tree_items(state["opt_state"]["m"])}
    state, m32 = TR.make_train_step(cfg.replace(dtype=FP32), opt)(state, b)
    g32 = dict(tree_items(state["opt_state"]["m"]))
    groups = {g: [k for k in g32 if k.startswith(g)]
              for g in LEAF_GROUPS[arch]}
    check(all(groups.values()) and sorted(sum(groups.values(), []))
          == sorted(g32), f"leaf groups {groups} against {sorted(g32)}")
    where = f"bf16 vs fp32 [{arch}, {layers} layers, 1 x {TRAIN_SEQ}]"
    log(f"{where}: loss {float(m16['loss']):.6f} / "
        f"{float(m32['loss']):.6f}, grad norm "
        f"{float(m16['grad_norm']):.6f} / {float(m32['grad_norm']):.6f}")
    out = {}
    for name, keys in groups.items():
        sums = torch.zeros(4, dtype=torch.float64, device="cuda")
        for k in keys:
            a, c = g16[k].double(), g32[k].double()
            sums += torch.stack([((a - c) ** 2).sum(), (c * c).sum(),
                                 (a * a).sum(), (a * c).sum()])
        diff, n32, n16, dot = sums.tolist()
        err = math.sqrt(diff / n32) if n32 else float("nan")
        cos = dot / math.sqrt(n16 * n32) if n16 * n32 else float("nan")
        out[name] = (err, cos)
        log(f"{where}: {name}: {sum(g32[k].numel() for k in keys)} "
            f"elements, relative L2 error {err:.4e}, cosine {cos:.6f}")
    del state, g16, g32
    torch.cuda.empty_cache()
    return out


def launcher_run() -> None:
    """``python -m repro_torch.launch.train`` with ``LAUNCHER``'s
    arguments in a fresh process: zamba2-1.2b at full size on the card (the
    launcher's own defaults otherwise); it must exit 0 and print finite
    losses."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *LAUNCHER], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0, f"launcher exited {out.returncode}: "
          f"{lines[-5:]} {out.stderr.strip().splitlines()[-5:]}")
    done = re.search(r"done: (\d+) steps in .*, loss (\S+) -> (\S+)",
                     out.stdout)
    check(done is not None and int(done[1]) == 3, f"launcher: {lines}")
    losses = [float(x) for x in re.findall(r"loss (\S+)", out.stdout)
              ] + [float(done[3])]
    check(all(math.isfinite(x) for x in losses), f"launcher: {lines}")
    log(f"launcher: python -m repro_torch.launch.train {' '.join(LAUNCHER)} "
        f"exited 0 in {time.perf_counter() - t0:.2f} s: "
        + " | ".join(line.strip() for line in lines))


def scan_share(M, cfg, micro: int, step_ms: float, tag: str) -> float:
    """An estimate of the ref scan's part of a training step of ``cfg``
    (Mamba2's ``ssd_chunked``, RWKV6's ``wkv6_chunked``), not a reading of
    the step: the scan alone at a layer's shape in a microbatch of
    ``TRAIN_BATCH // micro`` rows, on seeded inputs (the ref scan has no
    branch on its values, so their scale does not change its work), timed
    with CUDA events (median of 3): its forward under no_grad (remat's
    first pass) plus its forward and backward (the recompute and the
    backward), times the layers and microbatches of a step.  Returns the
    estimated ms a step."""
    b, S = TRAIN_BATCH // micro, TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, dtype=BF16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype).requires_grad_()

    if cfg.block == "rwkv6":
        nh, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        logw = (-torch.exp(-0.5 + 0.1 * torch.randn(
            (b, S, nh, hd), generator=gen, device="cuda"))).requires_grad_()
        args = (rnd(b, S, nh, hd), rnd(b, S, nh, hd), rnd(b, S, nh, hd),
                logw, rnd(nh, hd, dtype=FP32, scale=0.1))
        name = "wkv6_chunked"

        def fn():
            return M.rwkv6.wkv6_chunked(*args, chunk=64)[0]
    else:
        s = cfg.ssm
        hd, ds = s.head_dim, s.d_state
        nh = s.expand * cfg.d_model // hd
        dt = torch.nn.functional.softplus(torch.randn(
            (b, S, nh), generator=gen, device="cuda") - 2).to(BF16)
        args = (rnd(b, S, nh, hd), dt.requires_grad_(),
                rnd(nh, dtype=FP32), rnd(b, S, ds), rnd(b, S, ds))
        name = "ssd_chunked"

        def fn():
            return M.mamba2.ssd_chunked(*args, chunk=s.chunk)[0]
    with torch.no_grad():
        fwd = event_times_ms(fn, warmup=1, reps=3)
    cot = torch.randn(fn().shape, generator=gen, device="cuda").to(BF16)
    both = event_times_ms(lambda: torch.autograd.grad(fn(), args, cot),
                          warmup=1, reps=3)
    per_step = cfg.n_layers * micro * (fwd + both)
    log(f"{tag}: the ref scan {name} alone at {b} x {S}: forward "
        f"{fwd:.2f} ms (no_grad), forward and backward {both:.2f} ms (CUDA "
        f"events, median of 3); estimated for {cfg.n_layers} layers x "
        f"{micro} microbatches: {per_step:.2f} of the step's "
        f"{step_ms:.2f} ms (estimated share {per_step / step_ms:.4f})")
    del args, cot
    torch.cuda.empty_cache()
    return per_step


def train_runs_phase(M, O, D, TR, kernels: dict) -> None:
    """Phase 18: each run of ``TRAIN_RUNS`` at full width, its gradient
    norm at init by depth (``NORM_DEPTHS`` and its own) before
    ``train_phase``; then ``bf16_fidelity`` for each of
    ``FIDELITY_LAYERS`` and ``launcher_run``.  Each SSM run also estimates
    its ref scan's part of a step from the scan timed alone
    (``scan_share``).  The kernel counters are set to 0 at its start and must read 0 at its end: no kernel of this
    repo runs in training."""
    for fn in kernels.values():
        fn.launches = 0
    readings = {}
    for arch, (layers, micro) in TRAIN_RUNS.items():
        cfg = M.get_config(arch).replace(n_layers=layers)
        data = D.SyntheticLMDataset(D.DataConfig(global_batch=TRAIN_BATCH,
                                                 seq_len=TRAIN_SEQ), cfg)
        first = {k: torch.from_numpy(v).to("cuda")
                 for k, v in data[0].items()}
        t0 = time.perf_counter()
        norms = grad_norms(M, TR, cfg, first, micro,
                           sorted({*NORM_DEPTHS, layers}))
        log(f"train[{arch}]: gradient norm at init on the first batch "
            f"({TRAIN_BATCH} x {TRAIN_SEQ}, {micro} microbatches) by depth: "
            + ", ".join(f"{n} layers {g:.4e}" for n, g in norms.items())
            + f" ({time.perf_counter() - t0:.2f} s)")
        check(all(math.isfinite(g) for g in norms.values()),
              f"{arch}: gradient norm overflows at depth: {norms}")
        readings[arch] = train_phase(M, O, D, TR, kernels, arch, layers,
                                     micro, tag=f"train[{arch}]")
        if cfg.block in ("zamba2", "rwkv6"):
            scan_share(M, cfg, micro, readings[arch]["ms"], f"train[{arch}]")
        check(abs(readings[arch]["norm"] - norms[layers])
              <= 1e-2 * norms[layers],
              f"{arch}: step 1's grad norm {readings[arch]['norm']} against "
              f"the probe's {norms[layers]}")
    for arch, layers in FIDELITY_LAYERS.items():
        bf16_fidelity(M, O, D, TR, arch, layers)
    launcher_run()
    counts = {n: fn.launches for n, fn in kernels.items()}
    check(not any(counts.values()), f"kernel launches in phase 18 {counts}")
    log("phase 18: " + "; ".join(
        f"{arch} {TRAIN_RUNS[arch][0]} layers {r['ms']:.2f} ms a step, "
        f"peak {r['peak'] / 2**30:.2f} GiB, model-FLOPs share "
        f"{r['share']:.4f}" + (f" ({r['share_tied']:.4f} tied)"
                               if "share_tied" in r else "")
        for arch, r in readings.items()))


def device_kinds(device: dict) -> list[tuple[str, tuple[int, float]]]:
    """Device events summed by kind (GEMM, softmax, elementwise, casts
    and copies, reductions, indexing), largest first."""
    kinds: dict[str, list] = {}
    for key, (c, us) in device.items():
        k = key.lower()
        kind = ("gemm" if re.search(GEMM_RE, k) else
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


# --------------------------------------------------------------------- #
# phase 17: the service on the card under the port's sanitizers
# --------------------------------------------------------------------- #
SANITIZED_CLASSES = 8          # shared_state.DEFAULT_CONFIG["classes"]


def static_analysis() -> None:
    """The port's repro-check over its core against its committed empty
    baseline, then its coverage counts."""
    from repro_torch.analysis import cli as AC

    for argv in ([], ["--stats"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = AC.main(argv)
        for line in buf.getvalue().splitlines():
            log(f"analysis{' --stats' if argv else ''}: {line}")
        check(rc == 0, f"python -m repro_torch.analysis {' '.join(argv)} "
              f"exited {rc}")


def sanitize_probe(mode: str) -> dict:
    """``tools/sanitize_probe.py`` in a fresh process (this one has
    imported the core already, so its locks cannot be wrapped now)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "sanitize_probe.py"),
         "--sanitize", mode], env=env, capture_output=True, text=True,
        timeout=240)
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
    check(proc.returncode == 0,
          f"sanitize_probe --sanitize {mode} exited {proc.returncode}")
    return json.loads(proc.stdout.splitlines()[-1])


# eight threads make a process's first CUDA linalg call at once, with
# PyTorch alone ("torch") or after the port's GP sampler was made ("port")
LINALG_FIRST_USE = """
import json, sys, threading
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
if sys.argv[1] == "port":
    from repro_torch.core.samplers.gp import GPSampler
    GPSampler(device="cuda")
K = torch.eye(64, device="cuda") * 2.0
torch.cuda.synchronize()
start = threading.Barrier(8)
errors = []
def first():
    start.wait()
    try:
        torch.linalg.cholesky(K)
    except RuntimeError as e:
        errors.append(str(e).splitlines()[0])
threads = [threading.Thread(target=first) for _ in range(8)]
for t in threads:
    t.start()
for t in threads:
    t.join()
torch.cuda.synchronize()
print(json.dumps(errors))
"""


def linalg_first_use() -> None:
    """PyTorch's first CUDA linalg call of a process is not thread-safe
    (its library loads then); a GP sampler made on the card loads it
    first, under a lock.  Each side in a fresh process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    errors = {}
    for side in ("torch", "port"):
        proc = subprocess.run([sys.executable, "-c", LINALG_FIRST_USE, side],
                              env=env, capture_output=True, text=True,
                              timeout=180)
        check(proc.returncode == 0, f"linalg first use ({side}) exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        errors[side] = json.loads(proc.stdout.splitlines()[-1])
    check(errors["port"] == [], f"after GPSampler(device='cuda'): "
          f"{errors['port']}")
    log(f"linalg first use, 8 threads at once: PyTorch alone "
        f"{len(errors['torch'])} of 8 calls raised "
        f"{sorted(set(errors['torch']))}; after GPSampler(device='cuda') "
        "0 of 8")


def sanitizer_phase(smi: str) -> None:
    """Phase 17: the static checkers, then one load twice in fresh
    processes, without a sanitizer and under the race sanitizer."""
    static_analysis()
    linalg_first_use()
    runs = {mode: sanitize_probe(mode) for mode in ("none", "race")}
    race = runs["race"]
    for mode, r in runs.items():
        check(r["foreign"] == [], f"{mode}: loaded {r['foreign']}")
        check(r["tpe_completed"] >= 1000, f"{mode}: TPE study "
              f"{r['tpe_completed']} completed")
        check(r["launches"]["tpe_score"] > 0, f"{mode}: no tpe_score")
        check(r["launches"]["tpe_score"] == r["tpe_rounds"],
              f"{mode}: {r['launches']['tpe_score']} tpe_score launches "
              f"for {r['tpe_rounds']} proposal rounds")
        check(r["launches"]["matern52_masked"] > 0,
              f"{mode}: no matern52_masked launches")
    check(not race["inversions"], f"inversions: {race['inversions']}")
    check(not race["stalls"], f"stalls: {race['stalls']}")
    check(not race["races"], f"races: {race['races']}")
    check(len(race["classes"]) == SANITIZED_CLASSES
          and all(m.startswith("repro_torch.core.")
                  for m in race["classes"].values()),
          f"instrumented classes: {race['classes']}")
    check(not race["unkeyed_core"], "core locks with no static class: "
          f"{race['unkeyed_core']}")
    log(f"sanitizer: {race['lock_classes']} lock classes created "
        f"({race['locks_created']} locks), {race['edges']} edges observed, "
        f"{race['unknown']} not in the static graph "
        f"{race['unknown_edges']}, 0 inversions, 0 stalls; race mode "
        f"instrumented {len(race['classes'])}/{SANITIZED_CLASSES} classes "
        f"from repro_torch.core, tracked {race['fields_tracked']} fields, "
        "0 races")
    for mode, r in runs.items():
        log(f"sanitizer {mode}: {r['pairs']} ask/tell pairs in "
            f"{r['wall_s']:.3f} s, {r['pairs_s']:.1f} pairs/s, ask p50 "
            f"{r['ask_p50_ms']:.3f} ms p99 {r['ask_p99_ms']:.3f} ms; "
            f"{r['tpe_rounds']} TPE rounds = {r['launches']['tpe_score']} "
            f"tpe_score launches, {r['gp_evals']} EI evaluations, "
            f"{r['launches']['matern52_masked']} matern52_masked launches; "
            f"load {r['load_s']:.2f} s")
    none = runs["none"]
    log(f"sanitizer overhead on the card ({smi}): pairs/s x"
        f"{race['pairs_s'] / none['pairs_s']:.4f}, ask p50 x"
        f"{race['ask_p50_ms'] / none['ask_p50_ms']:.4f}, p99 x"
        f"{race['ask_p99_ms'] / none['ask_p99_ms']:.4f} (race / none)")


# --------------------------------------------------------------------- #
# phase 19: repro_torch.dist and the dry run against the card
# --------------------------------------------------------------------- #
DIST_ARCH = "deepseek-7b"
# 19a: the DTensor prefills on the (1, 1) mesh: (arch, impls, kernel
# launches a prefill)
DIST_PREFILLS = (
    ("deepseek-7b", dict(attn_impl="flash"), {"flash_attention": 30}),
    ("zamba2-1.2b", dict(attn_impl="flash", ssm_impl="pallas"),
     {"ssd": 38, "flash_attention": 6}),
    ("rwkv6-7b", dict(ssm_impl="pallas"), {"wkv6": 32}))
DIST_PREFILL_TOL = 2e-2
# 19b's two steps on the (1, 1) mesh: (cell, its shape here, layers)
DIST_JOBS = (("prefill_32k", ("prefill_4x2048", 2048, 4, "prefill"), None),
             ("train_4k", ("train_4x2048", 2048, 4, "train"), TRAIN_LAYERS))
# 19c: the production cells run on the card's host
DIST_CELLS = (("deepseek-7b", "train_4k"), ("deepseek-7b", "prefill_32k"),
              ("deepseek-7b", "decode_32k"), ("qwen1.5-32b", "prefill_32k"),
              ("zamba2-1.2b", "prefill_32k"), ("rwkv6-7b", "decode_32k"),
              ("qwen1.5-32b", "decode_32k"))
PEAK_TOL = 0.10
# 19e: flash with a query offset: (B, Hq, Hkv, S, hd, window), the query
# slices (offset, rows) of each; the last is off every tile grid
FLASH_OFFSET_CASES = [(4, 32, 32, 2048, hd, window)
                      for hd in (128, 64) for window in (None, 700)]
FLASH_OFFSET_SLICES = ((0, 512), (512, 512), (1024, 512), (1536, 512),
                       (700, 300))


def dtensor_prefill(M, T, E, kernels: dict, mesh, arch: str, impl: dict,
                    per_prefill: dict) -> dict:
    """(a) ``arch`` at full size in bf16 (seeded weights drawn in bf16,
    as phases 8 and 11 draw them), its parameters distributed by
    ``RULES_DECODE`` over the ``(1, 1)`` CUDA mesh: a prefill of 4 x 2048
    with ``impl`` and ``attn_sp`` (each device's local q, k, v into flash
    at its shard's query offset, each device's rows and heads into the
    SSD and WKV6 kernels) against the plain-tensor prefill
    (``DIST_PREFILL_TOL``; the same local ops run).  Every kernel counter
    is set to 0 just before the DTensor prefill and read just after:
    ``per_prefill`` launches of each kernel, none of the others."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun as DRY
    cfg = M.get_config(arch).replace(**impl)
    check((cfg.n_layers, cfg.d_model) == FULL_SIZE[arch], "not full size")
    params = T.init_params(cfg.replace(param_dtype=cfg.dtype), seed=0,
                           device="cuda")
    engine = E.ServeEngine(cfg, params, max_len=96, device="cuda")
    del params
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                     generator=gen, device="cuda")}
    want = E.make_prefill_step(cfg)(engine.params, batch)
    sp = cfg.replace(attn_sp=True)
    dparams = shd.distribute(engine.params, T.param_specs(sp), mesh,
                             shd.RULES_DECODE)
    del engine
    torch.cuda.empty_cache()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with DRY.step_context(mesh, shd.batch_axis(mesh, 4, shd.RULES_DECODE)):
        got = E.make_prefill_step(sp)(dparams, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in kernels.items()}
    check(isinstance(got, DTensor), "the DTensor prefill returned no DTensor")
    err = float((got.full_tensor().float() - want.float()).abs().max())
    log(f"dist (a): {arch} full size, bf16, on the (1, 1) mesh "
        f"({mesh.device_type}, {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        f"), RULES_DECODE, {impl} + attn_sp: logits against the plain "
        f"prefill max |diff| {err:.3e} (tolerance {DIST_PREFILL_TOL}), "
        f"launches {({n: c for n, c in counts.items() if c})}, "
        f"{seconds:.2f} s")
    check(err <= DIST_PREFILL_TOL, f"{arch}: DTensor prefill logits differ "
          f"by {err}")
    check(counts == {n: per_prefill.get(n, 0) for n in counts},
          f"{arch}: launches {counts}, expected {per_prefill}")
    del got, want, dparams, batch
    torch.cuda.empty_cache()
    return counts


def flash_offsets(FA) -> float:
    """(e) flash with a query offset on the card: each case's queries cut
    into ``FLASH_OFFSET_SLICES``, each slice through the kernel at its
    offset against ``attention_ref`` with the same offset and against
    the same rows of the kernel's call on the whole sequence (bf16,
    ``FLASH_TOL``).  Launches made to compare: not the main path's."""
    worst = 0.0
    for i, (b, hq, hkv, s, hd, window) in enumerate(FLASH_OFFSET_CASES):
        q, k, v = flash_inputs(b, hq, hkv, s, hd, BF16, 900 + i)
        whole = FA.flash_attention(q, k, v, window=window)
        errs = []
        for off, rows in FLASH_OFFSET_SLICES:
            q_l = q[:, off:off + rows]
            out = FA.flash_attention(q_l, k, v, window=window, q_offset=off)
            ref = FA.attention_ref(q_l, k, v, window=window, q_offset=off)
            torch.cuda.synchronize()
            for other in (ref, whole[:, off:off + rows]):
                torch.testing.assert_close(out.float(), other.float(),
                                           **FLASH_TOL[BF16])
            errs.append((float((out.float() - ref.float()).abs().max()),
                         float((out.float() - whole[:, off:off + rows]
                                .float()).abs().max())))
        worst = max(worst, *(max(e) for e in errs))
        log(f"flash q_offset (e): B {b} heads {hq}/{hkv} S {s} hd {hd} "
            f"window {window} ({FA.ops.kernel_symbol(BF16, hd)}): slices "
            + ", ".join(f"[{o}:{o + r}] {e[0]:.3e} / {e[1]:.3e}"
                        for (o, r), e in zip(FLASH_OFFSET_SLICES, errs))
            + " max |diff| against attention_ref / the whole call's rows "
            f"(tolerance {FLASH_TOL[BF16]['atol']})")
        del q, k, v, whole
        torch.cuda.empty_cache()
    return worst


def checkpoint_round_trip(M, O, mesh) -> None:
    """(d) a smoke model's train state as DTensors on the ``(1, 1)``
    CUDA mesh (``RULES_TRAIN``) through ``CheckpointManager.save``
    (blocking, then async and ``wait``) and ``restore(...,
    shardings=)`` into ``RULES_DECODE``'s layout: bit-equal."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import sharding as shd
    from repro_torch.models.registry import leaves
    from repro_torch.train.step import (init_train_state,
                                        train_state_shardings,
                                        train_state_specs)
    cfg = M.get_config(DIST_ARCH, smoke=True)
    state = init_train_state(cfg, O.AdamWConfig(), seed=4,
                             device="cuda").tree()
    specs = train_state_specs(cfg)
    dstate = shd.distribute(state, specs, mesh, shd.RULES_TRAIN)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as d:
        mgr = CheckpointManager(d)
        mgr.save(1, dstate, blocking=True)
        mgr.save(2, dstate)
        mgr.wait()
        sh = train_state_shardings(specs, state, mesh, shd.RULES_DECODE)
        got, meta = mgr.restore(2, state, sh)
    pairs = list(zip(leaves(got), leaves(state), leaves(sh)))
    same = all(torch.equal(g.full_tensor(), w) and tuple(g.placements)
               == tuple(s.placements) for g, w, s in pairs)
    log(f"dist (d): {DIST_ARCH} smoke train state, {len(pairs)} leaves, "
        f"saved sharded (RULES_TRAIN) and restored with shardings "
        f"(RULES_DECODE) on the (1, 1) CUDA mesh: bit-equal {same}, "
        f"step {meta['step']}")
    check(same and meta["step"] == 2, "sharded checkpoint round trip")


def measured_steps(DRY, SH, mesh) -> dict:
    """(b), on the card: each of ``DIST_JOBS`` built by the dry run's own
    ``build_cell`` on the CUDA mesh (seeded weights and inputs), run once
    under ``FlopCounterMode``; peak from ``max_memory_allocated`` after
    ``reset_peak_memory_stats``."""
    from torch.utils.flop_counter import FlopCounterMode
    out = {}
    for name, shape, layers in DIST_JOBS:
        shape = SH.Shape(*shape)
        torch.cuda.empty_cache()
        step, state, cfg = DRY.build_cell(DIST_ARCH, name, mesh, layers, 1,
                                          shape=shape, cell_micro=1,
                                          device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        counter = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with DRY.step_context(mesh, DRY._batch_axis(shape, 1, mesh)), \
                counter:
            res = step()
        torch.cuda.synchronize()
        out[name] = {"flops": counter.get_total_flops(),
                     "peak": torch.cuda.max_memory_allocated(),
                     "before": before, "layers": cfg.n_layers,
                     "s": time.perf_counter() - t0}
        del step, state, res
        torch.cuda.empty_cache()
    return out


def dist_phase(M, T, E, FA, kernels: dict) -> dict:
    """Phase 19: (a) ``dtensor_prefill`` of each of ``DIST_PREFILLS``;
    (b) the dry run's predicted FLOPs and peak bytes of ``DIST_JOBS`` on
    a ``(1, 1)`` mesh of the fake group against ``measured_steps`` (FLOPs
    equal, peak within ``PEAK_TOL``); (c) ``run_cell`` on ``DIST_CELLS``
    on the production 16 x 16 mesh, one record line each; (d)
    ``checkpoint_round_trip``; (e) ``flash_offsets``.  Returns the
    kernels' launches in (a)."""
    import torch.distributed as dist
    from repro_torch import optim as O
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import shapes as SH
    mesh = MESH.make_local_mesh(1, 1, "cuda")
    launches = dict.fromkeys(kernels, 0)
    try:
        for arch, impl, per_prefill in DIST_PREFILLS:
            for n, c in dtensor_prefill(M, T, E, kernels, mesh, arch, impl,
                                        per_prefill).items():
                launches[n] += c
        for fn in kernels.values():
            fn.launches = 0
        got = measured_steps(DRY, SH, mesh)
        counts = {n: fn.launches for n, fn in kernels.items()}
        check(not any(counts.values()), f"kernel launches in (b) {counts}")
        checkpoint_round_trip(M, O, mesh)
    finally:
        dist.destroy_process_group()
    props = torch.cuda.get_device_properties(0)
    log(f"dist: total_memory {props.total_memory} B "
        f"({props.total_memory / 2**30:.2f} GiB); launch.mesh.HBM_PER_CHIP "
        f"{MESH.HBM_PER_CHIP}")
    fmesh = MESH.make_fake_mesh((1, 1))
    for name, shape, layers in DIST_JOBS:
        t0 = time.perf_counter()
        want, _ = DRY.measure_cell(DIST_ARCH, name, fmesh,
                                   shape=SH.Shape(*shape), units=layers,
                                   micro=1)
        m = got[name]
        ratio = want["live"] / m["peak"]
        log(f"dist (b): {DIST_ARCH} {shape[0]} ({m['layers']} layers): "
            f"predicted {want['flops']:.6e} FLOPs, {want['live']} B peak "
            f"({want['live'] / 2**30:.2f} GiB; dry run "
            f"{time.perf_counter() - t0:.1f} s); measured on the card "
            f"{m['flops']:.6e} FLOPs (FlopCounterMode), {m['peak']} B "
            f"({m['peak'] / 2**30:.2f} GiB; max_memory_allocated, "
            f"{m['before'] / 2**30:.2f} GiB allocated before the step, "
            f"{m['s']:.2f} s); predicted/measured peak {ratio:.4f}")
        check(want["flops"] == m["flops"],
              f"{name}: predicted FLOPs {want['flops']} != {m['flops']}")
        check(abs(ratio - 1) <= PEAK_TOL,
              f"{name}: predicted peak off by {ratio - 1:+.3f}")
    for arch, name in DIST_CELLS:
        rec = DRY.run_cell(arch, name, False, verbose=True)
        r, mem = rec["roofline"], rec["memory"]
        log("dist (c): " + json.dumps({
            "arch": arch, "shape": name, "mesh": rec["mesh"],
            "seconds": rec["seconds"],
            "live_gib": round(mem["live_bytes_per_device"] / 2**30, 3),
            "fits_hbm": mem["fits_hbm"],
            "compute_ms": round(r["compute_s"] * 1e3, 3),
            "memory_ms": round(r["memory_s"] * 1e3, 3),
            "collective_ms": round(r["collective_s"] * 1e3, 3),
            "dominant": r["dominant"],
            "roofline_fraction": round(r["roofline_fraction"], 5)}))
    dist.destroy_process_group()
    worst = flash_offsets(FA)
    log(f"flash q_offset (e): {len(FLASH_OFFSET_CASES)} cases x "
        f"{len(FLASH_OFFSET_SLICES)} slices agree (max |diff| {worst:.3e})")
    return launches


def breakdown(label: str, wall: float, device: dict) -> str:
    if not device:
        return f"{label}: device time not measured (no device events)"
    device = {k: v for k, v in device.items() if not k.startswith("range:")}
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
    from repro_torch.models import moe as MOE
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
    dense, _ = serve_phase(M, T, E, kernels, "deepseek-7b",
                        {"flash_attention": 30},
                        {FA.ops.kernel_symbol(BF16, 128): 30},
                        attn_impl="flash")
    t0 = lap("phase 8", t0)
    rows["ssd"] = check_ssd(SSD)
    rows["wkv6"] = check_wkv6(WKV)
    t0 = lap("phase 9", t0)
    ssm_parity(M, T, E)
    t0 = lap("phase 10", t0)
    hybrid, _ = serve_phase(M, T, E, kernels, "zamba2-1.2b",
                         {"ssd": 38, "flash_attention": 6},
                         {SSD.ops.kernel_symbol(BF16, 64, 64): 38,
                          FA.ops.kernel_symbol(BF16, 64): 6},
                         ssm_impl="pallas", attn_impl="flash")
    rwkv, _ = serve_phase(M, T, E, kernels, "rwkv6-7b", {"wkv6": 32},
                       {WKV.ops.kernel_symbol(BF16, 64): 32},
                       ssm_impl="pallas")
    t0 = lap("phase 11", t0)
    from repro_torch import data as D
    from repro_torch import optim as O
    from repro_torch import train as TR
    for fn in kernels.values():
        fn.launches = 0
    train_phase(M, O, D, TR, kernels)
    t0 = lap("phase 12", t0)
    hpo_launches = hpo_phase(core, K, M, O, D, TR, kernels)
    t0 = lap("phase 13", t0)
    fabric_phase(core, K)
    t0 = lap("phase 14", t0)
    moe = moe_phase(M, T, E, MOE, FA, kernels)
    t0 = lap("phase 15", t0)
    from repro_torch.launch import shapes as SH
    from repro_torch.models import surgery as SURG
    frontends = frontend_phase(M, T, E, O, D, TR, SURG, SH, FA, kernels)
    t0 = lap("phase 16", t0)
    sanitizer_phase(smi)
    t0 = lap("phase 17", t0)
    train_runs_phase(M, O, D, TR, kernels)
    t0 = lap("phase 18", t0)
    dist_counts = dist_phase(M, T, E, FA, kernels)
    lap("phase 19", t0)
    log(f"tpe_score launches: {parzen_launches} in the TPE phase (3), "
        f"{hpo_launches} in the HPO loop (13)")
    # launches on the serving paths: flash on deepseek-7b's, zamba2's,
    # qwen2-moe's, mixtral's, pixtral's and qwen1.5's, the scans on
    # zamba2's and rwkv6's, and phase 19's DTensor prefills
    rows["flash_attention"]["launches"] = (dense["flash_attention"]
                                           + hybrid["flash_attention"]
                                           + moe["flash_attention"]
                                           + frontends
                                           + dist_counts["flash_attention"])
    rows["ssd"]["launches"] = hybrid["ssd"] + dist_counts["ssd"]
    rows["wkv6"]["launches"] = rwkv["wkv6"] + dist_counts["wkv6"]
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
