"""The port's span recorder (``repro_torch.spans``): it records only
while a profiler runs, nests and roots spans per thread, and the
trainer, the train step, the prefill and the service's ask record the
spans their docstrings name, on the CPU at smoke size."""
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import HopaasServer
from repro_torch.data import DataConfig
from repro_torch.models import transformer
from repro_torch.models.registry import get_config
from repro_torch.optim import AdamWConfig
from repro_torch.serve.engine import make_prefill_step
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True)
def fresh():
    spans.clear()
    yield
    spans.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(got):
    return {s.name: s for s in got}


def test_without_a_profiler_nothing_is_recorded():
    a, b = spans.span("a", n=1), spans.span("b")
    assert a is b
    with a as attrs:
        attrs["x"] = 2
        with b:
            pass
    assert spans.recorded() == []


def test_a_span_entered_before_the_profiler_stays_unrecorded():
    with spans.span("outer"):
        with cpu_profile():
            with spans.span("inner"):
                pass
    got = spans.recorded()
    assert [s.name for s in got] == ["inner"]
    assert got[0].parent is None and got[0].root == got[0].id


def test_nesting_gives_parent_and_root_ids_and_times():
    with cpu_profile():
        t0 = time.time_ns()
        with spans.span("outer", k=1):
            with spans.span("mid") as attrs:
                attrs["late"] = 3
                with spans.span("inner"):
                    pass
        t1 = time.time_ns()
    got = by_name(spans.recorded())
    outer, mid, inner = got["outer"], got["mid"], got["inner"]
    assert outer.parent is None and outer.root == outer.id
    assert mid.parent == outer.id and mid.root == outer.id
    assert inner.parent == mid.id and inner.root == outer.id
    assert outer.attrs == {"k": 1} and mid.attrs == {"late": 3}
    assert t0 <= outer.start <= mid.start <= inner.start
    assert inner.end <= mid.end <= outer.end <= t1
    assert len({outer.thread, mid.thread, inner.thread}) == 1
    spans.clear()
    assert spans.recorded() == []


def test_threads_keep_their_own_stacks():
    ready, release = threading.Event(), threading.Event()

    def other():
        with spans.span("other.outer"):
            ready.set()
            release.wait(10)
            with spans.span("other.inner"):
                pass

    with cpu_profile():
        with spans.span("main.outer"):
            t = threading.Thread(target=other)
            t.start()
            assert ready.wait(10)
            with spans.span("main.inner"):
                release.set()
            t.join(10)
    assert not t.is_alive()
    got = by_name(spans.recorded())
    for side in ("main", "other"):
        outer, inner = got[f"{side}.outer"], got[f"{side}.inner"]
        assert outer.parent is None and outer.root == outer.id
        assert inner.parent == outer.id and inner.root == outer.id
        assert inner.thread == outer.thread
    assert got["main.outer"].thread != got["other.outer"].thread


def test_trainer_records_each_step_under_one_root():
    cfg = get_config("deepseek-7b", smoke=True)
    tr = Trainer(cfg, AdamWConfig(), DataConfig(2, 16, seed=0),
                 TrainerConfig(total_steps=3, report_every=1), "cpu")
    with cpu_profile():
        res = tr.run(lambda step, loss: step == 2)
    assert res.pruned and res.steps_run == 2
    got = spans.recorded()
    (run,) = [s for s in got if s.name == "trainer.run"]
    assert run.attrs == {"steps": 2}
    assert all(s.root == run.id for s in got)
    loop = [s for s in got if s.parent == run.id]
    assert [s.name for s in loop] == ["trainer.init"] + [
        "trainer.batch", "trainer.step", "trainer.sync",
        "trainer.report"] * 2
    assert [s.attrs for s in loop if s.name == "trainer.report"] == [
        {"pruned": False}, {"pruned": True}]
    assert all(a.end <= b.start for a, b in zip(loop, loop[1:]))
    for i, step in enumerate(s for s in loop if s.name == "trainer.step"):
        assert step.attrs == {"step": i, "tokens": 2 * 16}
        phases = [s for s in got if s.parent == step.id]
        assert [s.name for s in phases] == [
            "step.cast", "step.forward", "step.backward", "step.optimizer"]
        assert all(a.end <= b.start for a, b in zip(phases, phases[1:]))
    batch = next(s for s in loop if s.name == "trainer.batch")
    assert batch.attrs == {"bytes": 2 * 2 * 16 * 4}      # tokens and labels


def test_prefill_records_each_block_and_the_head():
    cfg = get_config("deepseek-7b", smoke=True).replace(attn_impl="ref")
    params = transformer.init_params(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), dtype=torch.int32)
    prefill = make_prefill_step(cfg)
    with cpu_profile():
        prefill(params, {"tokens": tokens})
    got = spans.recorded()
    (outer,) = [s for s in got if s.name == "serve.prefill"]
    assert outer.attrs == {"rows": 2, "tokens": 24}
    inner = [s.name for s in got if s.parent == outer.id]
    assert inner == ["model.attention", "model.mlp"] * cfg.n_layers + [
        "model.head"]
    head = next(s for s in got if s.name == "model.head")
    assert head.attrs == {"positions": 12}
    assert all(s.root == outer.id for s in got)


def test_service_ask_records_its_sampler_call():
    server = HopaasServer(device="cpu")
    try:
        _, study = server.op_create_study(
            {"name": "spans", "properties": {
                "x": {"type": "uniform", "low": 0.0, "high": 1.0}},
             "sampler": {"name": "tpe", "n_startup_trials": 2}})
        key = study["key"]
        for _ in range(4):
            (t,) = server.op_ask(key, "w", 1)
            server.op_tell(t["uid"], float(t["params"]["x"]))
        with cpu_profile():
            server.op_ask(key, "w", 1)
    finally:
        server.close()
    (got,) = spans.recorded()
    assert got.name == "sampler.suggest"
    assert got.attrs == {"path": "ask", "proposals": 1, "observations": 4}
