"""The trainer: the HOPAAS *client workload* (paper sec. 4).

Wires together model init, the train step, the deterministic data
pipeline, checkpoint/restart, and — the paper's integration point — the
HOPAAS ``should_prune`` hook: the trainer reports its loss every
``report_every`` steps and aborts when the service says so.  This is
exactly the "thinnest possible layer in the model training application"
the paper argues for: one callback.

Everything runs on ``device`` (None: CUDA, raising without a card);
each step's batch goes to it once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from .. import spans
from ..checkpoint import CheckpointManager
from ..core.kernels import resolve_device
from ..data import DataConfig, SyntheticLMDataset
from ..models.config import ModelConfig
from ..optim import AdamWConfig
from .step import init_train_state, make_train_step

# report(step, loss) -> True means "prune me" (wired to Trial.should_prune)
ReportFn = Callable[[int, float], bool]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    microbatches: int = 1
    report_every: int = 10
    checkpoint_every: int = 0           # 0 = disabled
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3
    seed: int = 0
    log_every: int = 0


@dataclasses.dataclass
class TrainResult:
    final_loss: float
    losses: list
    steps_run: int
    pruned: bool
    restored_from: int | None
    wall_seconds: float


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 device: Any = None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.dataset = SyntheticLMDataset(data_cfg, model_cfg)
        self._step_fn = make_train_step(model_cfg, opt_cfg, tcfg.microbatches)
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir,
                                       tcfg.keep_checkpoints)
                     if tcfg.checkpoint_dir else None)

    def run(self, report: ReportFn | None = None) -> TrainResult:
        """Train from a fresh state (or the latest checkpoint) to
        ``total_steps``, calling ``report`` every ``report_every`` steps.
        Under a profiler it records ``trainer.run`` over the call and,
        inside it, ``trainer.init``, then a step's ``trainer.batch``,
        ``trainer.step``, ``trainer.sync`` and ``trainer.report``, and
        at the end ``trainer.counts`` with the counters the model added
        to while it ran, where it counted any (``repro_torch.spans``)."""
        t0 = time.time()
        tc = self.tcfg
        with spans.span("trainer.run") as run_attrs:
            with spans.span("trainer.init"):
                state = init_train_state(self.model_cfg, self.opt_cfg,
                                         tc.seed, self.device).tree()
                start_step, restored_from = 0, None
                if self.ckpt is not None:
                    got = self.ckpt.restore_latest(state)
                    if got is not None:
                        state, meta = got
                        start_step = int(meta["step"])
                        restored_from = start_step

            losses, pruned, executed = [], False, 0
            batches = self.dataset.iter_from(start_step)
            for _ in range(start_step, tc.total_steps):
                with spans.span("trainer.batch") as attrs:
                    step, batch = next(batches)
                    batch = {k: torch.from_numpy(v).to(self.device)
                             for k, v in batch.items()}
                    attrs["bytes"] = sum(v.nbytes for v in batch.values())
                with spans.span("trainer.step", step=step,
                                tokens=batch["labels"].numel()):
                    state, metrics = self._step_fn(state, batch)
                with spans.span("trainer.sync"):
                    loss = float(metrics["loss"])
                losses.append(loss)
                executed += 1
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        f"loss diverged at step {step}: {loss}")
                if tc.log_every and step % tc.log_every == 0:
                    print(f"  step {step:5d}  loss {loss:.4f}  "
                          f"gnorm {float(metrics['grad_norm']):.3f}")
                if self.ckpt is not None and tc.checkpoint_every and \
                        (step + 1) % tc.checkpoint_every == 0:
                    self.ckpt.save(step + 1, state)
                if report is not None and (step + 1) % tc.report_every == 0:
                    with spans.span("trainer.report") as attrs:
                        pruned = bool(report(step + 1, loss))
                        attrs["pruned"] = pruned
                    if pruned:
                        break
            if self.ckpt is not None:
                self.ckpt.wait()
            run_attrs["steps"] = executed
            counts = spans.take_counts()
            if counts:
                with spans.span("trainer.counts", **counts):
                    pass
        return TrainResult(
            final_loss=losses[-1] if losses else float("nan"),
            losses=losses, steps_run=executed, pruned=pruned,
            restored_from=restored_from, wall_seconds=time.time() - t0)


def hopaas_objective(model_cfg: ModelConfig, *, total_steps: int = 60,
                     global_batch: int = 8, seq_len: int = 64,
                     report_every: int = 10, device: Any = None
                     ) -> Callable[[dict, ReportFn], float]:
    """Build an objective(trial_params, report) for
    ``repro_torch.core.campaign``: trains ``model_cfg`` on ``device``
    (None: CUDA, raising without a card) with trial-suggested optimizer
    hyperparameters."""
    device = resolve_device(device)

    def objective(params: dict[str, Any], report: ReportFn) -> float:
        opt = AdamWConfig(
            lr=float(params.get("lr", 3e-4)),
            b1=float(params.get("b1", 0.9)),
            b2=float(params.get("b2", 0.95)),
            weight_decay=float(params.get("weight_decay", 0.1)),
            grad_clip=float(params.get("grad_clip", 1.0)))
        dcfg = DataConfig(global_batch=global_batch, seq_len=seq_len,
                          seed=int(params.get("data_seed", 0)))
        tcfg = TrainerConfig(total_steps=total_steps,
                             report_every=report_every,
                             seed=int(params.get("seed", 0)))
        res = Trainer(model_cfg, opt, dcfg, tcfg, device).run(report=report)
        return res.final_loss
    return objective
