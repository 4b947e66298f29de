#!/usr/bin/env python3
"""The port's service under load, with or without the port's runtime
sanitizers, in a process of its own.

    python3 tools/sanitize_probe.py --sanitize none
    python3 tools/sanitize_probe.py --sanitize race
    python3 tools/sanitize_probe.py --sanitize race --device cpu \\
        --history 300 --seconds 2                  # a small run on the CPU

JAX and the JAX package are blocked from import (as ``chip_smoke.py``
blocks them).  ``--sanitize race`` installs the race sanitizer of
``repro_torch.analysis.sanitize`` (and with it the lock-order one)
before ``repro_torch.core`` is imported, so module-level locks such as
the kernel loader's are wrapped too.  Then two
``HopaasServer(speculate_depth=64)`` serve behind
``HttpServiceRunner(backend="evloop")`` on durable storage with group
fsync, and the load runs: a TPE study on ``chip_smoke.PROPS`` filled to
``--history`` completed trials, 64 keep-alive client threads doing
ask/tell pairs for ``--seconds`` (``chip_smoke.py``'s phase 5 load),
then a GP study told 64 trials and 10 ask/tell pairs.  The launch counts are set to 0 just before the load and
read after the servers have stopped.

The last line of the output is one JSON object: pairs/s and ask
p50/p99 of the threaded window, the kernels' launches and the TPE
proposal rounds and GP EI evaluations, the modules of JAX or the JAX
package that were loaded, and in a sanitized run the sanitizer's
report: lock classes created, edges observed, edges not in the static
graph, inversions, stalls, lock creation sites of the core with no
static class, the instrumented classes with their modules, fields
tracked and races.  ``chip_smoke.py``'s phase 17 runs it twice and holds the
sanitized run to its checks.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as S  # noqa: E402  (blocks jax and repro on import)


def foreign_modules() -> list[str]:
    return sorted(k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "jaxlib", "repro"))


def drive(core, runner, token, space, key, clients, seconds):
    """``clients`` threads, each with its own keep-alive transport,
    doing ask/tell pairs for ``seconds``."""
    errors: list[BaseException] = []
    asks: list[list[float]] = [[] for _ in range(clients)]
    stop_at = time.monotonic() + seconds

    def worker(i: int) -> None:
        try:
            client = core.Client(
                core.HttpTransport(runner.host, runner.port), token,
                worker_id=f"w{i}")
            while time.monotonic() < stop_at:
                t0 = time.perf_counter()
                trial = client.ask(key, parallelism=clients)
                asks[i].append(time.perf_counter() - t0)
                client.tell(trial["uid"],
                            S.objective(space, trial["params"]))
        except BaseException as e:  # reported and re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 120)
    wall = time.perf_counter() - t0
    S.check(not any(t.is_alive() for t in threads), "a client hung")
    if errors:
        raise errors[0]
    lat = [x for lane in asks for x in lane]
    return {"pairs": len(lat), "wall_s": wall, "pairs_s": len(lat) / wall,
            "ask_p50_ms": S.pct(lat, 50), "ask_p99_ms": S.pct(lat, 99)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sanitize", choices=("none", "race"), default="none")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--history", type=int, default=1000)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    sanitize = None
    if args.sanitize == "race":
        from repro_torch.analysis import sanitize
        sanitize.install_race()
    import repro_torch.core as core
    from repro_torch.core import kernels as K
    from repro_torch.core.samplers import gp as gp_mod
    from repro_torch.core.samplers import tpe as tpe_mod

    counted = {"rounds": 0, "evals": 0}
    count_lock = threading.Lock()
    propose, gp_ei = tpe_mod._tpe_propose, gp_mod._gp_ei

    def count(name, fn):
        def wrapped(*a, **kw):
            with count_lock:
                counted[name] += 1
            return fn(*a, **kw)
        return wrapped

    tpe_mod._tpe_propose = count("rounds", propose)
    gp_mod._gp_ei = count("evals", gp_ei)
    space = core.SearchSpace.from_properties(S.PROPS)
    t_load = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sanitize-probe-") as root:
        storage = core.DurableStorage(os.path.join(root, "wal"),
                                      fsync="group")
        tokens = core.TokenManager()
        token = tokens.issue("sanitize-probe")
        servers = [core.HopaasServer(storage=storage, tokens=tokens,
                                     worker_name=f"api-{i}",
                                     device=args.device,
                                     speculate_depth=S.FLEET)
                   for i in range(2)]
        runner = core.HttpServiceRunner(servers, backend="evloop").start()
        try:
            client = core.Client(
                core.HttpTransport(runner.host, runner.port), token)
            S.reset_counts(K)
            key, _ = client.ensure_study({"name": "sanitize-tpe",
                                          "properties": S.PROPS,
                                          "sampler": {"name": "tpe"}})
            S.fill(client, space, key, args.history, 256)
            window = drive(core, runner, token, space, key, S.FLEET,
                           args.seconds)
            gp_key, _ = client.ensure_study({"name": "sanitize-gp",
                                             "properties": S.PROPS,
                                             "sampler": {"name": "gp"}})
            S.fill(client, space, gp_key, 64, 64)
            for _ in range(10):
                trial = client.ask(gp_key)
                client.tell(trial["uid"],
                            S.objective(space, trial["params"]))
            n_tpe = client.study(key)["n_completed"]
            n_gp = client.study(gp_key)["n_completed"]
        finally:
            runner.stop()
            for s in servers:
                s.close()
            storage.close()
    out = {"sanitize": args.sanitize, "device": args.device,
           **window, "load_s": time.perf_counter() - t_load,
           "tpe_completed": n_tpe, "gp_completed": n_gp,
           "tpe_rounds": counted["rounds"], "gp_evals": counted["evals"],
           "launches": K.launch_counts(), "foreign": foreign_modules()}
    if sanitize is not None:
        rep = sanitize.cross_check_repo()
        out.update({
            "lock_classes": len(rep["locks_created"]),
            "locks_created": sum(rep["locks_created"].values()),
            "edges": len(rep["edges"]), "unknown": len(rep["unknown"]),
            "unknown_edges": [u["edge"] for u in rep["unknown"]],
            "inversions": rep["inversions"], "stalls": rep["stalls"],
            "unkeyed_core": sorted(k for k in rep["locks_created"]
                                   if k.startswith("src/repro_torch/core/")),
        })
        race = sanitize.race_report()
        out.update({"classes": race["class_modules"],
                    "fields_tracked": race["fields_tracked"],
                    "races": race["violations"]})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
