"""The readings each cell's limits are set from, at the cell's own size,
in one process: the numbers that sound runs of the program give over
many seeds (the lower readings), the numbers of the control, the
reference computed in fp8 in the program's place (the upper readings),
and those of the planted faults.  The benchmark's own runs never run it.

    python3 hopaas_bench/control.py --workload deepseek-7b.hpo_train \
        --seeds 1-12 --control-seeds 1-3

Training cells: the first trial's checked steps through the trainer,
with the AdamW settings TPE proposes after the seed's history, then the
reference; the control trains in the program's place; ``half_batch``
trains on half the rows (a state left unchanged reads 1 and needs no
run; an altered token is an exact count).  Prefill cells: the sample a
run of ``--requests`` requests checks, served by the program; the
control's first tokens; an altered first token.  One JSON
line a seed on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def train_readings(run, control: bool) -> dict:
    """One seed of a training cell -> {"program", "control",
    "half_batch"} numbers (the last two where ``control``)."""
    import torch
    from repro_torch.data import DataConfig
    from repro_torch.train import trainer as trainer_mod

    from hopaas_bench.drivers import hpo_train as H

    T, conf = run.cell.traffic, run.cell.config
    mcfg = run.model_config("train")
    svc = H.Service(run.device, worker_id="hopaas-bench-control")
    try:                        # the first trial a run's campaign asks for
        trial = H.open_study(run, svc).ask()
    finally:
        svc.stop()
    opt = H.opt_config(trial.params)
    first = {"seed": H.trial_seed(run.seed, trial.id), "opt": opt}
    n = T["checked_steps"]

    def program(faults: frozenset) -> dict:
        checked = H.CheckedTrial(run, mcfg)
        checked.patch(trainer_mod)
        tr = trainer_mod.Trainer(
            mcfg, opt, DataConfig(T["global_batch"], T["seq_len"],
                                  seed=first["seed"]),
            trainer_mod.TrainerConfig(total_steps=n,
                                      microbatches=T["microbatches"],
                                      report_every=1, seed=first["seed"]),
            run.device)
        H.plant(faults, tr)
        checked.watch(tr, n)

        def report(step, loss):
            checked.losses.append(loss)
            checked.after_step(step, opt.b1)
            return False
        tr.run(report)
        checked.measure_change()
        out = {"losses": checked.losses, "first_grad": checked.first_grad,
               "change": checked.change}
        del checked, tr
        torch.cuda.empty_cache()
        return out

    prog = program(frozenset())
    ref = H.reference_readings(run, first)
    out = {"program": H.numbers(prog, ref)}
    if control:
        out["half_batch"] = H.numbers(program(frozenset({"half_batch"})),
                                      ref)
        out["control"] = H.numbers(
            H.reference_readings(run, first, control="fp8"), ref)
    return out


def prefill_readings(run, control: bool, requests: int) -> dict:
    """One seed of a prefill cell -> {"program", "control",
    "altered_token"} widest gaps (the last two where ``control``)."""
    import torch
    from repro_torch.serve.engine import cast_params, make_prefill_step

    from hopaas_bench import harness
    from hopaas_bench.drivers import prefill as P
    from hopaas_bench.reference.compare import widest

    T, conf = run.cell.traffic, run.cell.config
    mcfg = run.model_config("serve")
    lengths = P.deck(run.seed, T, requests)
    picked = P.sample(run.seed, lengths, T["sample"])
    pool = P.prompts(run.seed, requests, T["batch"], max(T["lengths"]),
                     conf["vocab_size"], run.device)
    served = cast_params(harness.make_params(
        mcfg, run.seed, run.device, conf["init"]),
        mcfg, run.device)
    prefill = make_prefill_step(mcfg)
    checks = []
    for i in picked:
        toks = pool[i, :, : lengths[i]]
        checks.append((toks, prefill(served, {"tokens": toks})[:, -1]
                       .argmax(-1).tolist()))
    del served, prefill
    torch.cuda.empty_cache()
    altered: list[float] = []
    gaps, _ = P.reference_gaps(run, checks, altered=altered)
    out = {"program": {"first_token_gap": widest(gaps)}}
    if control:
        out["altered_token"] = {"first_token_gap": widest(altered)}
        gaps, _ = P.reference_gaps(run, checks, control="fp8")
        out["control"] = {"first_token_gap": widest(gaps)}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--requests", type=int, default=400,
                    help="prefill: the requests a run finishes, from "
                         "which its sample is drawn")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from hopaas_bench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    from repro_torch.core.kernels import _backend
    _backend.build_all()
    for seed in args.seeds:
        run = harness.Run(cell, seed, 0.0, False, torch.device("cuda"),
                          time.time_ns())
        t0 = time.perf_counter()
        ctl = seed in args.control_seeds
        if cell.traffic["kind"] == "hpo_train":
            out = train_readings(run, ctl)
        else:
            out = prefill_readings(run, ctl, args.requests)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    for _name in ("jax", "jaxlib", "flax", "repro"):    # as run.py does
        sys.modules[_name] = None
    sys.exit(main())
