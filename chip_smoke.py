#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py

Runs from the root of a checkout, with JAX and the JAX package blocked
from import, and exits non-zero on any failure:

 1. builds the CUDA kernels of ``src/repro_torch/core/kernels/csrc`` (one
    nvcc per source, in parallel) into that package's ``build/``;
 2. holds each kernel against its plain PyTorch version on the card at
    the service's shapes plus ragged ones (rtol = atol = 2e-4), times
    both (median of per-launch CUDA-event times after warm-up) and reads
    the kernel's own device time from the PyTorch profiler;
 3. serves a TPE study over HTTP (2 API workers, event-loop frontend,
    durable storage with group fsync): 5,000 completed trials on the
    5-parameter space of ``benchmarks/bench_ask_latency.py``, then timed
    single asks and tells and ``ask_batch(16)`` calls, then a profiled
    window of asks for the device's busy share;
 4. serves a GP study to its 512-observation cap, then a few asks;
 5. runs the speculative pipeline (depth 64) under 64 client threads.

The launch counters are set to 0 just before each of phases 3-5 and read
just after it.  The last three lines are the kernels' JSON record, the
card's name and power limit from nvidia-smi, and the result line.
"""
from __future__ import annotations

import sys

sys.modules["jax"] = None        # the port must run without JAX ...
sys.modules["repro"] = None      # ... and without the JAX package

import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
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
    """Mean device time of one launch of ``kernel`` (by symbol name)."""
    _, device = profiled(lambda: [fn() for _ in range(reps)])
    hits = [(n, us) for key, (n, us) in device.items() if kernel in key]
    if not hits:
        return "not measured (no device events)"
    n, us = hits[0]
    return f"{us / n:.2f} us per launch (profiler, {n} launches)"


def pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q))


# --------------------------------------------------------------------- #
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------- #
def parzen_inputs(c, n, d, n_valid, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(size=(c, d)), rng.uniform(size=(n, d)),
              (np.arange(n) < n_valid).astype(np.float64),
              rng.uniform(0.05, 0.7, size=d))
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def matern_inputs(a, b, d, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(size=(a, d)), rng.uniform(size=(b, d)),
              rng.uniform(0.1, 0.5, size=d))
    return [torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in arrays]


def check_kernels(K) -> dict[str, dict]:
    from repro_torch.core.kernels.matern import matern_cuda
    from repro_torch.core.kernels.parzen import parzen_lse_cuda

    rows = {}
    # Parzen: the service's pool sizes and mixture sizes plus ragged ones
    err = 0.0
    seed = 0
    for c in (64, 96, 128):
        for n in (32, 300, 8192):
            for d in (1, 5, 11):
                n_valid = max(1, n - n // 5)          # masked tail
                x, obs, mask, bw = parzen_inputs(c, n, d, n_valid, seed)
                seed += 1
                out = K.parzen_log_density(x, obs, mask, bw)
                ref = K.parzen_log_density_plain(x, obs, mask, bw)
                torch.cuda.synchronize()
                torch.testing.assert_close(out, ref, **TOL)
                err = max(err, float((out - ref).abs().max()))
    c, n, d = 64, 8192, 5                             # the bad mixture
    args = parzen_inputs(c, n, d, 4975, 1234)
    ms = event_times_ms(lambda: K.parzen_log_density(*args))
    plain_ms = event_times_ms(lambda: K.parzen_log_density_plain(*args))
    x, obs, mask, bw = args
    xa = torch.cat([x / bw, -torch.ones(c, 1, device="cuda")], 1)
    oa = torch.cat([obs / bw, torch.ones(n, 1, device="cuda")], 1)
    nbytes = 4 * (c * d + n * d + n + d + c)
    ops = c * n * (2 * (d + 1) + 3)   # FMAs of the product, sub, exp, add
    rows["parzen_log_density"] = dict(
        name="parzen_log_density", route="cuda",
        source="src/repro_torch/core/kernels/csrc/parzen.cu",
        replaces="src/repro/core/kernels/parzen.py:88",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(nbytes, ops), library_ms=None)
    log(f"parzen_log_density: 27 shapes agree (max |err| {err:.3e}); "
        f"C={c} N={n} D={d}: wrapper {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms; kernel device time "
        f"{kernel_device_us(lambda: parzen_lse_cuda(xa, oa), 'parzen')}")

    # Matérn: K(X, X) and K(cands, X) at the GP cap, plus ragged
    err = 0.0
    for i, (a, b, d) in enumerate([(512, 512, 5), (256, 512, 5),
                                   (1024, 1024, 5), (100, 37, 5),
                                   (100, 37, 1), (100, 37, 11)]):
        xa_, xb_, ls = matern_inputs(a, b, d, 100 + i)
        out = K.matern52_cross(xa_, xb_, ls)
        ref = K.matern52_cross_plain(xa_, xb_, ls)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **TOL)
        err = max(err, float((out - ref).abs().max()))
    a, b, d = 512, 512, 5
    args = matern_inputs(a, b, d, 99)
    ms = event_times_ms(lambda: K.matern52_cross(*args))
    plain_ms = event_times_ms(lambda: K.matern52_cross_plain(*args))
    aa = torch.randn(a, d + 2, device="cuda")
    nbytes = 4 * (a * d + b * d + d + a * b)
    ops = a * b * (2 * (d + 2) + 10)  # FMAs of d², then the Matérn form
    rows["matern52_cross"] = dict(
        name="matern52_cross", route="cuda",
        source="src/repro_torch/core/kernels/csrc/matern.cu",
        replaces="src/repro/core/kernels/matern.py:50",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(nbytes, ops), library_ms=None)
    log(f"matern52_cross: 6 shapes agree (max |err| {err:.3e}); "
        f"A=B={a} D={d}: wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"kernel device time "
        f"{kernel_device_us(lambda: matern_cuda(aa, aa), 'matern')}")
    log("library_ms: null for both; neither function is a single "
        "PyTorch call")
    one = torch.zeros(1, device="cuda")
    log(f"launch floor: one 1-element PyTorch op takes "
        f"{event_times_ms(lambda: one.add_(1)):.4f} ms per call "
        f"(same per-call CUDA-event timing)")
    return rows


def bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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
        K.parzen_log_density.launches = 0
        K.matern52_cross.launches = 0
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
        launches = K.parzen_log_density.launches
        check(launches > 0, "parzen kernel never launched")
        check(launches >= 2 * rounds[0],
              f"{launches} parzen launches for {rounds[0]} rounds")
        check(K.matern52_cross.launches == 0, "matern launched by TPE")
        study = client.study(key)
        n_done = HISTORY + 50 + 160 + 20
        check(study["n_completed"] == n_done,
              f"n_completed {study['n_completed']} != {n_done}")
        check(math.isfinite(study["best_value"]), "best value not finite")
        log(f"tpe: {study['n_completed']} completed, best "
            f"{study['best_value']:.6f}; {rounds[0]} proposal rounds, "
            f"{launches} parzen launches")
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
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    return (f"tpe: {n} profiled ask/tell pairs, wall {wall * 1e3:.1f} ms, "
            f"device busy {busy_us / 1e3:.3f} ms (share "
            f"{busy_us / 1e6 / wall:.4f}); top device events: "
            + "; ".join(f"{k[:40]} x{c} {us:.0f}us"
                        for k, (c, us) in top))


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


def gp_phase(core, K, storage, tokens, space, token):
    servers, runner = start_service(core, storage, tokens)
    try:
        client = core.Client(core.HttpTransport(runner.host, runner.port),
                             token)
        key, _ = client.ensure_study({"name": "smoke-gp",
                                      "properties": PROPS,
                                      "sampler": {"name": "gp"}})
        K.parzen_log_density.launches = 0
        K.matern52_cross.launches = 0
        t0 = time.perf_counter()
        fill(client, space, key, GP_HISTORY, 64)
        log(f"gp: seeded {GP_HISTORY} completed trials in "
            f"{time.perf_counter() - t0:.2f} s")
        ask_s = []
        trials = []
        for _ in range(4):
            t0 = time.perf_counter()
            trials.append(client.ask(key))
            ask_s.append(time.perf_counter() - t0)
            check(in_space(space, trials[-1]["params"]), "gp ask")
        client.tell_batch([{"trial_uid": t["uid"],
                            "value": objective(space, t["params"])}
                           for t in trials])
        launches = K.matern52_cross.launches
        check(launches > 0, "matern kernel never launched")
        study = client.study(key)
        check(math.isfinite(study["best_value"]), "gp best not finite")
        log(f"gp: {study['n_completed']} completed, best "
            f"{study['best_value']:.6f}; {launches} matern launches; ask "
            f"at the cap p50 {pct(ask_s, 50):.3f} ms (n=4)")
    finally:
        runner.stop()
        for s in servers:
            s.close()
    return launches


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
        K.parzen_log_density.launches = 0
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
        check(K.parzen_log_density.launches > 0, "no parzen launches")
        rate = hits / max(1, hits + misses)
        log(f"speculative: {FLEET} threads, {sum(counts)} ask/tell pairs "
            f"in {wall:.2f} s, {rounds} precompute rounds, queue_hit_rate "
            f"{rate:.4f}, {K.parzen_log_density.launches} parzen launches")
    finally:
        runner.stop()
        for s in servers:
            s.close()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    from repro_torch.core import kernels as K
    from repro_torch.core.samplers import tpe as tpe_mod

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
            matern_launches = gp_phase(core, K, storage, tokens, space,
                                       token)
            speculative_phase(core, K, storage, tokens, space, token, key)
        finally:
            storage.close()
    rows["parzen_log_density"]["launches"] = parzen_launches
    rows["matern52_cross"]["launches"] = matern_launches
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
