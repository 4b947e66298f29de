"""HOPAAS worker node — the paper's client-side story, end to end.

A computing node that (1) connects to a HOPAAS server over the wire
(HTTP), (2) asks for a trial, (3) trains the requested arch with the
suggested hyperparameters on its device, reporting intermediate losses
through ``should_prune``, and (4) tells the final loss.  Run several of
these (different machines / processes) against one server URL to
reproduce the paper's multi-site campaign; the ``--die-after`` flag
simulates the opportunistic-resource failure mode (the server's lease
sweeper requeues the orphaned trial).

  # terminal 1: the service
  PYTHONPATH=src python -m repro_torch.core.service --port 8748

  # terminals 2..N: workers
  PYTHONPATH=src python -m repro_torch.launch.worker \
      --server localhost:8748 --token <token> --study lm-tune \
      --arch deepseek-7b --trials 4 [--device cpu]

``--device`` defaults to cuda and fails without a card.
"""
from __future__ import annotations

import argparse

from ..core.client import Client, Study, suggestions
from ..core.kernels import resolve_device
from ..core.transport import HttpTransport
from ..models import registry
from ..train.trainer import hopaas_objective


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="localhost:8731")
    ap.add_argument("--token", required=True)
    ap.add_argument("--study", default="lm-tune")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--trials", type=int, default=4,
                    help="trials this worker contributes")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--worker-id", default="worker-0")
    ap.add_argument("--die-after", type=int, default=0,
                    help="crash (no tell) after N trials — straggler test")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    host, port = args.server.rsplit(":", 1)
    client = Client(HttpTransport(host, int(port)), args.token,
                    worker_id=args.worker_id)
    print(f"worker {args.worker_id}: server version",
          client.version())

    mcfg = registry.get_config(args.arch, smoke=True)
    objective = hopaas_objective(mcfg, total_steps=args.steps,
                                 device=device)
    study = Study(
        name=args.study,
        properties={"lr": suggestions.loguniform(1e-5, 1e-2),
                    "b1": suggestions.uniform(0.8, 0.99),
                    "weight_decay": suggestions.loguniform(1e-3, 0.3)},
        direction="minimize", sampler={"name": "tpe"},
        pruner={"name": "median", "n_warmup_steps": 10},
        client=client)

    for i in range(args.trials):
        trial = study.ask()
        print(f"  trial {trial.id}: {trial.params}")
        value = objective(trial.params, trial.should_prune)
        if args.die_after and i + 1 >= args.die_after:
            print("  simulating crash: exiting without tell")
            return 0
        study.tell(trial, value=value,
                   state="pruned" if trial.pruned else None)
        print(f"  trial {trial.id} -> {value:.4f}"
              + (" (pruned)" if trial.pruned else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
