"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 hopaas_bench/run.py --workload deepseek-7b.hpo_train --seed 7 \
        --seconds 20 --trace 0

Set-up (imports, the kernels' build, the cell's weights, service and
warm-up) is timed as ``setup_s``; then the cell's driver measures for
``--seconds``; then the reference judges what the window produced.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from host spans and a device trace of the
window.  The last lines on standard error give each number compared
beside its limit, as the result line's last key does.

The run needs a CUDA card, the port under ``src/`` beside this folder,
and neither JAX nor the JAX package: both are blocked before any import,
and a run that finds either loaded once its window has closed fails.
"""
from __future__ import annotations

import sys
import time

T_START = time.time_ns()
for _name in ("jax", "jaxlib", "flax", "repro"):
    sys.modules[_name] = None

import argparse  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the kernel caches a library could keep, inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / ".bench_cache" / _dir))


def parse(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(run, trace: bool) -> tuple[dict, dict | None, dict]:
    """The driver's window and check -> (metrics, breakdown, outcome)."""
    from hopaas_bench import harness

    outcome = harness.driver(run.cell.traffic["kind"]).run(run)
    metrics = {}
    if not trace:
        readings = {"setup_s": (run.t_open - run.t_start) / 1e9,
                    **outcome.e2e}
        for m in run.cell.end_to_end:
            metrics[m["name"]] = {"value": readings[m["name"]],
                                  "unit": m["unit"]}
        return metrics, None, outcome
    for m in run.cell.per_layer:
        value = harness.metric_reader(m["name"])(outcome.record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = None
    if run.kernels:
        found, busy_s = harness.breakdown(run.kernels, run.spans, run.t_open,
                                          run.t_close)
        run.device_info.update(busy_s=busy_s, window_s=run.window_s)
    return metrics, found, outcome


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from hopaas_bench import harness
    try:
        import repro_torch  # noqa: F401
        cell = harness.load_cell(args.workload)
    except (ImportError, OSError, KeyError) as e:
        harness.log(f"cannot run {args.workload}: {e!r}")
        return 2
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count()}")
        return 2
    from repro_torch.core.kernels import _backend
    built = _backend.build_all()
    harness.log(f"kernels built: {built or 'none (all current)'}")
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), T_START)
    metrics, found, outcome = measure(run, bool(args.trace))
    from hopaas_bench.reference.compare import judge
    correct, checks = judge(outcome.numbers, cell.limits["numbers"])
    loaded = harness.banned_modules()
    if loaded:
        harness.log(f"refused: the run loaded {loaded}")
        return 3
    for name, c in checks.items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(harness.result_line(correct, outcome.attempted, outcome.failed,
                              metrics, run.device_info, found, checks),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
