"""``BENCHMARK.json`` against the benchmark's contract, the files each
name in it points to, and the traffic's dependence on the seed."""
import dataclasses
import json
import re

import numpy as np
import pytest
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_config

from hopaas_bench import harness
from hopaas_bench.drivers import hpo_train, prefill
from hopaas_bench.testing import bench_copy, tiny_cell

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(not p.startswith("/") and ".." not in p for p in MAN["paths"])
    assert MAN["command"][1].startswith(MAN["paths"][0] + "/")


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in (
            "lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for k in entry.get("reduced", ()):
        assert NAME.match(k)
    for key in ("why", "layer", "source"):
        text = entry.get(key, "x")
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_name_once_and_every_config_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_each_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert any(m["name"] != "setup_s" for m in c.end_to_end)
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert harness.driver(c.traffic["kind"]).run
    assert c.limits["numbers"]
    conf = next(x for x in MAN["configs"] if x["name"] == c.workload["config"])
    assert conf["reduced"] == c.config["reduced"]
    assert harness.model_config(c.config, "train").n_layers == \
        c.config["n_layers"]


# the published (Hugging Face) keys and the configuration file's own
PUBLISHED = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps"}


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_files_state_the_published_sizes(conf):
    """Every published size the file runs is the published one, but for
    the keys ``reduced`` names, which it runs at ``as_run``'s size; the
    port is built at the file's sizes, and each of its groups at the
    file's keys."""
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    pub = data["published"]
    assert conf["reduced"] == data["reduced"]
    assert set(data["reduced"]) == set(data.get("as_run", {}))
    for key, ours in PUBLISHED.items():
        if key in data["reduced"]:
            assert data[ours] == data["as_run"][key] != pub[key]
        else:
            assert data[ours] == pub[key], key
    assert data["head_dim"] * data["n_heads"] == pub["hidden_size"]
    assert data["init"]["initializer_range"] == pub["initializer_range"]
    for mode in ("train", "serve"):
        cfg = harness.model_config(data, mode)
        for key in harness.SIZE_KEYS:
            if key in data:
                assert getattr(cfg, key) == data[key], key
        for group in harness.config_groups(data, cfg):
            for key, value in data[group].items():
                assert getattr(getattr(cfg, group), key) == value, (group,
                                                                    key)
        assert cfg.tie_embeddings == pub["tie_word_embeddings"]


@dataclasses.dataclass(frozen=True)
class LatentConfig:
    kv_lora_rank: int
    rope_head_dim: int


@dataclasses.dataclass(frozen=True)
class LatentModelConfig(ModelConfig):
    latent: LatentConfig | None = None


def _latent(smoke: bool, rank: int, rope: int):
    base = get_config("deepseek-7b", smoke=smoke)
    return LatentModelConfig(**{f.name: getattr(base, f.name)
                                for f in dataclasses.fields(base)},
                             latent=LatentConfig(rank, rope))


def test_a_port_config_group_reaches_the_port_and_the_smoke_cell(
        tmp_path, monkeypatch):
    """A configuration whose port config carries a group of its own (a
    ``ModelConfig`` subclass, registered under a test-only arch), added
    as a later change adds one, by new files and entries: the port gets
    the file's group, the smoke cell the smoke configuration's, and the
    published sizes' test takes the file as it stands."""
    registry.list_archs()                       # the real archs first
    monkeypatch.setitem(registry._REGISTRY, "test-latent",
                        lambda: _latent(False, 512, 64))
    monkeypatch.setitem(registry._SMOKE, "test-latent",
                        lambda: _latent(True, 8, 4))
    bench = bench_copy(tmp_path, monkeypatch)
    conf = json.loads((bench / "configs" / "deepseek-7b.depth10.json")
                      .read_text())
    conf.update(name="latent.depth10", arch="test-latent",
                latent={"kv_lora_rank": 256, "rope_head_dim": 64})
    (bench / "configs" / "latent.depth10.json").write_text(json.dumps(conf))
    (bench / "limits" / "latent.hpo_train.json").write_text(
        (bench / "limits" / "deepseek-7b.hpo_train.json").read_text())
    man = harness.manifest()
    entry = {**man["configs"][0], "name": "latent.depth10",
             "file": "hopaas_bench/configs/latent.depth10.json"}
    man["configs"].append(entry)
    man["workloads"].append({**man["workloads"][0], "name": "latent.hpo_train",
                             "config": "latent.depth10"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    for mode in ("train", "serve"):
        cfg = harness.model_config(conf, mode)
        assert cfg.latent == LatentConfig(256, 64)
        assert harness.config_groups(conf, cfg) == ["latent"]
    tiny = tiny_cell("latent.hpo_train").config
    assert tiny["latent"] == {"kv_lora_rank": 8, "rope_head_dim": 4}
    assert harness.model_config(tiny, "train").latent == LatentConfig(8, 4)
    test_config_files_state_the_published_sizes(entry)
    # a group the port's arch leaves unset, or a key its group lacks
    with pytest.raises(ValueError, match="group 'moe'"):
        harness.model_config({**conf, "moe": {"top_k": 6}}, "train")
    with pytest.raises(TypeError):
        harness.model_config({**conf, "latent": {"q_lora_rank": 0}}, "train")


def test_prefill_traffic_follows_the_seed():
    t = harness.load_cell("deepseek-7b.prefill_mix").traffic
    a, b = prefill.deck(11, t, 100), prefill.deck(11, t, 100)
    assert a == b and a != prefill.deck(12, t, 100)
    assert sorted(a[:10]) == sorted(prefill.deck(12, t, 10))   # same sizes
    assert a.count(4096) == 10 and a.count(512) == 40
    p1 = prefill.prompts(11, 3, 2, 64, 1000, "cpu")
    assert bool((p1 == prefill.prompts(11, 3, 2, 64, 1000, "cpu")).all())
    assert not bool((p1 == prefill.prompts(12, 3, 2, 64, 1000, "cpu")).all())
    s = prefill.sample(11, a, 8)
    assert s == prefill.sample(11, a, 8) and a.index(4096) in s


def test_campaign_traffic_follows_the_seed():
    params = [{"lr": 1e-4, "b1": 0.9, "b2": 0.95, "weight_decay": 0.1,
               "grad_clip": 1.0}] * 3
    assert hpo_train.history_values([5, 0], params) == \
        hpo_train.history_values([5, 0], params)
    assert hpo_train.history_values([5, 0], params) != \
        hpo_train.history_values([6, 0], params)
    assert hpo_train.trial_seed(5, 3) != hpo_train.trial_seed(6, 3)
    space = harness.load_cell("deepseek-7b.hpo_train").traffic["space"]
    assert hpo_train.outside(space, params[0]) == 0
    assert hpo_train.outside(space, {**params[0], "lr": 0.5}) == 1


def test_campaign_proposals_follow_the_seed():
    """The same seed gives the same trial parameters through the
    service; another seed gives others."""
    def proposals(seed):
        svc = hpo_train.Service("cpu", "test")
        try:
            cell = tiny_cell("deepseek-7b.hpo_train")
            study = svc.study(f"s.{seed}", cell.traffic["space"])
            trials = study.ask_batch(12)
            study.tell_batch(list(zip(trials, hpo_train.history_values(
                [seed, 0], [t.params for t in trials]))))
            return [study.ask().params for _ in range(3)]
        finally:
            svc.stop()
    a = proposals(21)
    assert a == proposals(21) and a != proposals(22)
    assert np.isfinite([v for p in a for v in p.values()]).all()
