"""An HPO campaign in progress: the service, a TPE study with a history,
and one worker that asks for a trial, trains it on the card and tells.

Traffic parameters (``traffic/<mix>.json``): ``space`` (the study's
properties), ``history`` (completed trials made at set-up, their values
from the seed), ``steps_per_trial``, ``global_batch``, ``seq_len``,
``microbatches``, ``checked_steps`` (the first trial's steps that run at
set-up and that the reference follows).

The service is the port's: ``HopaasServer`` workers on the durable
storage engine (its journal under ``TMPDIR``, group fsync) behind the
HTTP frontend, in this process, so that one process holds the card; the
worker speaks HTTP to it through the port's client.  Each trial is the
port's ``Trainer`` with the trial's AdamW settings, fresh weights from
its seed and the synthetic stream; its ``report`` callback ends the trial
in flight only when the window closes.

The first trial takes the benchmark's weights (``harness.make_params``)
and runs ``checked_steps`` steps at set-up through the trainer's own
call and feed; the window opens at the start of its next step.  After
the window, the reference trains the same weights on the same rows, and
the compared numbers are each step's loss, each leaf's norm of the
first gradient as the optimizer got it (worked out from its first
moment after one step) and of the change over the checked steps, the
rows fed against the stream worked out again, and each proposal against
the space.
"""
from __future__ import annotations

import dataclasses
import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import harness
from ..harness import Outcome, Run, log
from ..reference import compare, data as ref_data, model as ref_model
from ..reference import train as ref_train


def trial_seed(seed: int, trial_id: int) -> int:
    return (seed * 1_000_003 + trial_id) % 2**31


def history_values(seed: list[int], params: list[dict]) -> list[float]:
    """The history's results: a smooth bowl over the space plus noise
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for p in params:
        bowl = ((np.log10(p["lr"]) + 3.7) ** 2 + 40 * (p["b1"] - 0.9) ** 2
                + 20 * (p["b2"] - 0.97) ** 2 + 5 * p["weight_decay"] ** 2
                + 0.2 * (p["grad_clip"] - 1.0) ** 2)
        out.append(float(3.0 + bowl + 0.05 * rng.standard_normal()))
    return out


def outside(space: dict, params: dict) -> int:
    """Parameters of one proposal outside the space (or missing)."""
    bad = 0
    for name, spec in space.items():
        v = params.get(name)
        if not isinstance(v, (int, float)) or not (
                spec["low"] <= v <= spec["high"]):
            bad += 1
    return bad


class Service:
    """The port's service in this process (what ``python -m
    repro_torch.core.service --journal-dir ... --fsync group`` builds)
    and a client of it over HTTP."""

    def __init__(self, device, worker_id: str):
        from repro_torch import core
        self.journal = tempfile.mkdtemp(prefix="hopaas-bench-journal-")
        self.storage = core.DurableStorage(self.journal, fsync="group")
        tokens = core.TokenManager()
        servers = [core.HopaasServer(storage=self.storage, tokens=tokens,
                                     worker_name=f"api-{i}", device=device)
                   for i in range(2)]
        self.runner = core.HttpServiceRunner(servers, host="127.0.0.1",
                                             port=0).start()
        self.client = core.Client(
            core.HttpTransport(self.runner.host, self.runner.port),
            tokens.issue("hopaas-bench"), worker_id=worker_id)

    def study(self, name: str, space: dict):
        from repro_torch.core import ClientStudy
        return ClientStudy(name=name, properties=space, direction="minimize",
                           sampler={"name": "tpe"}, client=self.client)

    def stop(self) -> None:
        self.runner.stop()
        self.storage.close()
        shutil.rmtree(self.journal, ignore_errors=True)


class CheckedTrial:
    """The first trial: the benchmark's weights handed to the trainer in
    place of its own init, the rows it fed and the optimizer state it
    left after the first and after the last checked step."""

    def __init__(self, run: Run, mcfg):
        self.run, self.mcfg = run, mcfg
        self.fed: list[dict] = []
        self.first_grad: dict[str, float] = {}
        self.change: dict[str, float] = {}
        self.losses: list[float] = []

    def start_weights(self) -> dict:
        return harness.make_params(self.mcfg, self.run.seed, self.run.device,
                                   self.run.cell.config["init"])

    def patch(self, trainer_mod) -> None:
        from repro_torch.optim import adamw_init
        from repro_torch.train.step import TrainState
        own = trainer_mod.init_train_state

        def init_train_state(cfg, opt, seed=0, device=None):
            trainer_mod.init_train_state = own
            params = self.start_weights()
            self.state = TrainState(params, adamw_init(params, opt))
            return self.state
        trainer_mod.init_train_state = init_train_state

    def watch(self, trainer, n: int) -> None:
        """Keep the rows of the first ``n`` steps as the step got them."""
        inner = trainer._step_fn

        def step(state, batch):
            if len(self.fed) < n:
                self.fed.append({k: v.cpu().numpy().copy()
                                 for k, v in batch.items()})
            return inner(state, batch)
        trainer._step_fn = step

    def after_step(self, step: int, b1: float) -> None:
        st = self.state
        if step == 1:
            omb1 = float(np.float32(1) - np.float32(b1))
            self.first_grad = {k: float(m.norm()) / omb1 for k, m in
                               ref_train.leaves(st.opt_state["m"])}

    def measure_change(self) -> None:
        """The change over the checked steps; then lets the state go (the
        trainer keeps its own reference while the trial lasts)."""
        self.change = ref_train.change_norms(self.state.params,
                                             self.start_weights)
        self.state = None


def spanned(spans, trainer) -> None:
    """Host spans around the trainer's step call."""
    inner = trainer._step_fn

    def step(state, batch):
        with spans.span("step"):
            return inner(state, batch)
    trainer._step_fn = step


def open_study(run: Run, svc: Service):
    """The cell's study on ``svc`` with its history of completed trials,
    their parameters from TPE and their values from the seed."""
    T = run.cell.traffic
    study = svc.study(f"hopaas-bench.{run.cell.name}.{run.seed}", T["space"])
    with run.spans.span("history"):
        for i, at in enumerate(range(0, T["history"], 100)):
            trials = study.ask_batch(min(100, T["history"] - at))
            values = history_values([run.seed, i], [t.params for t in trials])
            study.tell_batch(list(zip(trials, values)))
    return study


def opt_config(params: dict):
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=float(params["lr"]), b1=float(params["b1"]),
                       b2=float(params["b2"]),
                       weight_decay=float(params["weight_decay"]),
                       grad_clip=float(params["grad_clip"]))


def plant(faults: frozenset, trainer) -> None:
    """Faults a test plants in a trainer: ``half_batch`` leaves out the
    second half of each batch's rows and takes the mean over the first
    half (each counted twice, so the microbatches still split),
    ``altered_token`` alters one token of each batch where the stream
    produces it."""
    if "half_batch" in faults:
        inner = trainer._step_fn

        def halved(v):
            h = v[: v.shape[0] // 2]
            return torch.cat([h, h])
        trainer._step_fn = lambda state, batch: inner(
            state, {k: halved(v) for k, v in batch.items()})
    if "altered_token" in faults:
        stream = trainer.dataset.iter_from

        def altered(start):
            for i, batch in stream(start):
                batch["tokens"][0, 0] = (batch["tokens"][0, 0] + 1) % (
                    trainer.model_cfg.vocab_size)
                yield i, batch
        trainer.dataset.iter_from = altered


def run(run: Run) -> Outcome:
    from repro_torch.data import DataConfig
    from repro_torch.train import step as step_mod
    from repro_torch.train import trainer as trainer_mod

    cell, T, spans = run.cell, run.cell.traffic, run.spans
    mcfg = run.model_config("train")
    n_checked = T["checked_steps"]
    tokens_per_step = T["global_batch"] * T["seq_len"]

    # spans around the trainer's init and the step's optimizer (both
    # modules imported them by name, so they are patched there)
    own_init, own_update = (trainer_mod.init_train_state,
                            step_mod.adamw_update)

    def init_train_state(*a, **k):
        with spans.span("init_state"):
            return own_init(*a, **k)
    trainer_mod.init_train_state = init_train_state

    updates = [0]

    def adamw_update(grads, opt_state, params, cfg):
        # faults a test plants: every update a no-op, or the last checked
        # update writing NaN into every leaf
        updates[0] += 1
        if "frozen_state" in run.faults:
            cfg = dataclasses.replace(cfg, lr=0.0, weight_decay=0.0)
        if "nan_update" in run.faults and updates[0] == n_checked:
            cfg = dataclasses.replace(cfg, lr=float("nan"))
        with spans.span("adamw"):
            return own_update(grads, opt_state, params, cfg)
    step_mod.adamw_update = adamw_update

    svc = Service(run.device, worker_id="hopaas-bench-worker")
    try:
        study = open_study(run, svc)
        checked = CheckedTrial(run, mcfg)
        trials: list[dict] = []
        steps: list[dict] = []
        state = {"closed": False}

        def train(trial) -> tuple[float, bool]:
            p = trial.params
            opt = opt_config(p)
            tseed = trial_seed(run.seed, trial.id)
            rec = {"id": trial.id, "seed": tseed, "params": dict(p),
                   "opt": opt, "asked": time.time_ns()}
            trials.append(rec)
            first = len(trials) == 1
            if first:
                checked.patch(trainer_mod)
            tr = trainer_mod.Trainer(
                mcfg, opt, DataConfig(T["global_batch"], T["seq_len"],
                                      seed=tseed),
                trainer_mod.TrainerConfig(
                    total_steps=T["steps_per_trial"],
                    microbatches=T["microbatches"], report_every=1,
                    seed=tseed), run.device)
            plant(run.faults, tr)
            spanned(spans, tr)
            if first:
                checked.watch(tr, n_checked)

            def report(step: int, loss: float) -> bool:
                now = time.time_ns()
                if first and step <= n_checked:
                    checked.losses.append(loss)
                    checked.after_step(step, opt.b1)
                    if step == n_checked:
                        checked.measure_change()
                        run.open_window()
                    return False
                steps.append({"trial": trial.id, "step": step, "end": now,
                              "loss": loss})
                if (now - run.t_open) / 1e9 >= run.seconds:
                    run.close_window()
                    state["closed"] = True
                    return True
                return False

            with spans.span("trial", id=trial.id):
                res = tr.run(report)
            return res.final_loss, res.pruned

        failed = 0
        while not state["closed"]:
            with spans.span("ask"):
                trial = study.ask()
            try:
                value, pruned = train(trial)
                tell = (value, "pruned" if pruned else "completed")
            except FloatingPointError as e:
                log(f"trial {trial.id}: {e}")
                failed += 1
                tell = (None, "failed")
            with spans.span("tell"):
                study.tell(trial, value=tell[0], state=tell[1])
        run.after_window()
    finally:
        step_mod.adamw_update = own_update
        trainer_mod.init_train_state = own_init
        svc.stop()

    bad_proposals = sum(outside(T["space"], t["params"]) for t in trials)
    window_steps = [s for s in steps if run.t_open < s["end"] <= run.t_close]
    span_s = run.window_s
    e2e = {"train_tokens_per_s": len(window_steps) * tokens_per_step / span_s}
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    found = check(run, checked, trials[0])
    found["outside_space"] = float(bad_proposals)
    record = {"run": run, "trials": trials, "steps": window_steps,
              "tokens_per_step": tokens_per_step, "mcfg": mcfg}
    return Outcome(e2e, record, found, attempted=len(window_steps),
                   failed=failed)


def reference_readings(run: Run, first: dict, control: str | None = None
                       ) -> dict:
    """The reference (``control``: its lower-precision control) trained
    from the checked trial's weights on its rows for the checked steps:
    each step's loss, each leaf's first gradient as the optimizer got it
    and as it came, and each leaf's change."""
    T, conf = run.cell.traffic, run.cell.config
    ref_model.fp32_products()
    rows = [ref_data.batch(first["seed"], i, T["global_batch"], T["seq_len"],
                           conf["vocab_size"])
            for i in range(T["checked_steps"])]
    opt = first["opt"]
    make = CheckedTrial(run, run.model_config("train")).start_weights
    params = make()
    t0 = time.perf_counter()
    out = ref_train.adamw_steps(
        conf, params,
        [{k: torch.as_tensor(v, device=run.device) for k, v in r.items()}
         for r in rows],
        {"lr": opt.lr, "b1": opt.b1, "b2": opt.b2, "eps": opt.eps,
         "weight_decay": opt.weight_decay, "grad_clip": opt.grad_clip},
        control=control)
    out["change"] = ref_train.change_norms(params, make)
    out["rows"] = rows
    log(f"reference{' ' + control if control else ''}: "
        f"{len(rows)} steps in {time.perf_counter() - t0:.1f} s, losses "
        f"{out['losses']}")
    return out


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared and beside them the readings the limits
    were chosen among: the gap of the first step's loss and the widest
    of any step's, and the gaps of the first gradient's norm and of the
    change's norm, of the worst leaf and of the median leaf (leaves the
    reference leaves still are not compared)."""
    skip = compare.still_leaves(ref["first_raw_grad"])
    out = {}
    for name, key, left_out in (("grad", "first_grad", frozenset()),
                                ("change", "change", skip)):
        worst, leaf = compare.worst_leaf_gap(prog[key], ref[key], left_out)
        out[f"{name}_norm_gap"] = worst
        out[f"{name}_norm_gap_median"] = compare.median_leaf_gap(
            prog[key], ref[key], left_out)
        log(f"{name}: worst leaf {leaf} ({worst:.4e})")
    if skip:
        log(f"not compared (gradient under a thousandth of the median "
            f"leaf's): {sorted(skip)}")
    n = len(ref["losses"])
    losses = list(prog["losses"][:n]) + [float("nan")] * (
        n - len(prog["losses"]))
    gaps = [abs(a - b) for a, b in zip(losses, ref["losses"])]
    log(f"losses: program {losses}, reference {ref['losses']}")
    out["first_loss_gap"] = gaps[0]
    out["loss_gap"] = compare.widest(gaps)
    return out


def check(run: Run, checked: CheckedTrial, first: dict) -> dict:
    """The reference follows the checked steps; -> the numbers compared,
    with the rows the trainer fed against the stream worked out again."""
    ref = reference_readings(run, first)
    T = run.cell.traffic
    n = T["checked_steps"]
    mismatch = sum(int(np.sum(fed[k] != want[k])) for fed, want in
                   zip(checked.fed, ref["rows"]) for k in ("tokens", "labels"))
    mismatch += abs(len(checked.fed) - n) * T["global_batch"] * T["seq_len"]
    out = numbers({"losses": checked.losses, "first_grad": checked.first_grad,
                   "change": checked.change}, ref)
    out["rows_differing"] = float(mismatch)
    return out
