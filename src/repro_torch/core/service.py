"""HOPAAS service launcher — the INFN-Cloud deployment shape.

Single process by default: N stateless API workers behind the HTTP
frontend (Uvicorn x N + NGINX role) — the selector event loop with
sharded dispatch lanes, ``--frontend threaded`` for the legacy
thread-per-connection server — backed by a durable storage engine
(PostgreSQL role) that survives crashes and restarts, and prints a
fresh API token.

TPE and GP compute on ``--device`` (``cuda``, the default, or ``cpu``);
asking for CUDA where there is none exits with an error.  The
multi-process shard fabric (``--workers N`` with N > 1, ``--replicas``)
is not ported yet and exits with an error naming it.

  PYTHONPATH=src python -m repro_torch.core.service --port 8731 \
      --journal-dir hopaas-data --fsync group --device cuda

``--journal-dir`` selects the snapshot + segmented-WAL engine
(``DurableStorage``); ``--journal FILE`` keeps the legacy single-file
JSONL journal.  ``--fsync`` picks the durability/latency trade-off:
``always`` (ack after fsync, group-committed), ``group`` (one fsync per
commit window), ``off`` (no fsync).  The journal is closed cleanly on
Ctrl-C *and* via ``atexit``, so the buffered WAL tail is never dropped
by a normal shutdown path.
"""
from __future__ import annotations

import argparse
import atexit
import os
import time

from .auth import TokenManager
from .durable import DurableStorage
from .kernels import resolve_device
from .server import HopaasServer
from .storage import InMemoryStorage, JournalStorage
from .transport import HttpServiceRunner


def build_storage(args: argparse.Namespace) -> InMemoryStorage:
    if args.journal_dir:
        return DurableStorage(args.journal_dir, fsync=args.fsync,
                              segment_bytes=args.segment_bytes,
                              auto_compact=not args.no_compaction)
    if args.journal:
        return JournalStorage(args.journal)
    return InMemoryStorage()


def _default_workers() -> int:
    try:
        return max(1, int(os.environ.get("REPRO_WORKERS", "1") or 1))
    except ValueError:
        return 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8731)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--workers", type=int, default=_default_workers(),
                    help="worker processes; > 1 would launch the "
                         "multi-process shard fabric, which is not ported "
                         "(default: $REPRO_WORKERS or 1)")
    ap.add_argument("--api-workers", type=int, default=2,
                    help="stateless API workers sharing one storage "
                         "(single-process mode)")
    ap.add_argument("--journal-dir", default=None,
                    help="storage-engine directory (snapshots + segmented "
                         "WAL + compaction); survives crash-restart")
    ap.add_argument("--journal", default=None,
                    help="legacy single-file JSONL WAL path")
    ap.add_argument("--fsync", choices=("always", "group", "off"),
                    default="group",
                    help="WAL durability: ack-after-fsync / one fsync per "
                         "commit window / never (default: group)")
    ap.add_argument("--segment-bytes", type=int, default=4 * 1024 * 1024,
                    help="rotate the WAL segment past this size")
    ap.add_argument("--no-compaction", action="store_true",
                    help="disable background folding of sealed segments "
                         "into snapshots")
    ap.add_argument("--frontend", choices=("evloop", "threaded"),
                    default=None,
                    help="HTTP frontend: selector event loop with sharded "
                         "dispatch lanes (default) or the legacy "
                         "thread-per-connection server; REPRO_FRONTEND "
                         "overrides the default")
    ap.add_argument("--lanes", type=int, default=None,
                    help="event-loop dispatch lanes (default: 2x cores, "
                         "capped at 8)")
    ap.add_argument("--lease-seconds", type=float, default=60.0)
    ap.add_argument("--token-ttl-hours", type=float, default=24.0)
    ap.add_argument("--replicas", type=int, default=None,
                    help="follower replicas per fabric worker; > 0 "
                         "needs the shard fabric, which is not ported "
                         "(default: $REPRO_REPLICAS or 0)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device the TPE and GP samplers compute on "
                         "(default: cuda; fails if there is no CUDA "
                         "device)")
    ap.add_argument("--speculate-depth", type=int, default=None,
                    help="proposals to precompute off-lock per study "
                         "(constant-liar speculative ask pipeline); 0 "
                         "disables (default: $REPRO_SPECULATE or 0)")
    args = ap.parse_args(argv)

    if args.speculate_depth is not None:
        if args.speculate_depth < 0:
            ap.error("--speculate-depth must be >= 0")
        os.environ["REPRO_SPECULATE"] = str(args.speculate_depth)

    replicas = args.replicas
    if replicas is None:
        try:
            replicas = int(os.environ.get("REPRO_REPLICAS", "0") or 0)
        except ValueError:
            replicas = 0
    if args.workers > 1 or replicas > 0:
        ap.error("--workers > 1 and --replicas > 0 need the multi-process "
                 "shard fabric, which is not ported to repro_torch yet "
                 "(see ROADMAP.md)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    storage = build_storage(args)
    # a missed shutdown path (exception, sys.exit) must still flush the
    # WAL tail; close() is idempotent so the Ctrl-C path below is safe
    atexit.register(storage.close)
    tokens = TokenManager()
    workers = [HopaasServer(storage=storage, tokens=tokens,
                            lease_seconds=args.lease_seconds,
                            worker_name=f"api-{i}", device=device)
               for i in range(args.api_workers)]
    runner = HttpServiceRunner(workers, host=args.host, port=args.port,
                               backend=args.frontend,
                               lanes=args.lanes, workers=1).start()
    token = tokens.issue("cli-user", ttl_seconds=args.token_ttl_hours * 3600)
    backend = storage.storage_stats()["backend"]
    print(f"HOPAAS service at {runner.url}  ({args.api_workers} API "
          f"workers, frontend={runner.backend}, storage={backend}, "
          f"device={device})")
    print(f"API token: {token}")
    print("Ctrl-C to stop.")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        runner.stop()            # also flushes the workers' storage
        storage.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
