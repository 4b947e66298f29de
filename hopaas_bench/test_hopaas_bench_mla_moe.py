"""The DeepSeek-V2-Lite cell's own pieces at the smoke size, on the CPU in
float32: the program's train step against ``reference/mla_moe.py`` (the
loss of 3 AdamW steps, the first gradient and the change, leaf by leaf),
the balance loss entering both sides alike, the frozen FLOP count against
every product of a forward, and the expert-load reader on its planted
record.  Tolerances: fp32 products in another order over 3 layers, 1e-5
of a loss, 1e-4 of a leaf's norm."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hopaas_bench import harness, planted
from hopaas_bench.reference import compare, data
from hopaas_bench.reference import train as ref_train
from hopaas_bench.testing import tiny_cell
from hopaas_bench.work import bounds, flops
from repro_torch.models import transformer
from repro_torch.models.registry import count_active_params, count_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step

CELL = "deepseek-v2-lite.ep8.hpo_train"
SEED = 2**31 + 23
CPU = torch.device("cpu")
OPT = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
           grad_clip=1.0)


def _setup(alpha=None):
    conf = tiny_cell(CELL).config
    if alpha is not None:
        conf["moe"]["aux_alpha"] = alpha
    cfg = harness.model_config(conf, "train")
    batches = [{k: torch.from_numpy(v) for k, v in data.batch(
        SEED, i, 2, 16, conf["vocab_size"]).items()} for i in range(3)]
    return conf, cfg, batches, lambda: harness.make_params(
        cfg, SEED, CPU, conf["init"])


def _program(cfg, batches, make) -> dict:
    params = make()
    flat = dict(ref_train.leaves(params))
    for t in flat.values():
        t.requires_grad_(True)
    loss, _ = transformer.loss_fn(params, cfg, batches[0])
    grads = torch.autograd.grad(loss, list(flat.values()))
    first = {k: float(g.norm()) for k, g in zip(flat, grads)}
    opt = AdamWConfig(**OPT)
    params = make()
    state = {"params": params, "opt_state": adamw_init(params, opt)}
    step, losses = make_train_step(cfg, opt), []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "first_raw_grad": first,
            "change": ref_train.change_norms(state["params"], make)}


def _reference(conf, batches, make) -> dict:
    params = make()
    out = ref_train.adamw_steps(conf, params, batches, OPT)
    out["change"] = ref_train.change_norms(params, make)
    return out


def test_program_follows_the_reference_for_three_steps():
    conf, cfg, batches, make = _setup()
    prog, ref = _program(cfg, batches, make), _reference(conf, batches, make)
    assert prog["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    assert prog["first_raw_grad"].keys() == ref["first_raw_grad"].keys()
    assert {k for k in ref["first_raw_grad"] if "moe" in k} >= {
        "blocks/moe/router", "blocks/moe/up", "blocks/moe/shared/down"}
    worst, leaf = compare.worst_leaf_gap(prog["first_raw_grad"],
                                         ref["first_raw_grad"])
    assert worst < 1e-4, leaf
    still = compare.still_leaves(ref["first_raw_grad"])
    worst, leaf = compare.worst_leaf_gap(prog["change"], ref["change"],
                                         still)
    assert worst < 1e-4, leaf


def test_the_balance_loss_enters_both_sides():
    """At alpha 10 the balance loss moves the first loss and the router's
    gradient; the program and the reference move alike."""
    got = {}
    for alpha in (0.0, 10.0):
        conf, cfg, batches, make = _setup(alpha)
        got[alpha] = (_program(cfg, batches[:1], make),
                      _reference(conf, batches[:1], make))
    (p0, r0), (p1, r1) = got[0.0], got[10.0]
    term = p1["losses"][0] - p0["losses"][0]
    assert term > 1e-2
    assert term == pytest.approx(r1["losses"][0] - r0["losses"][0], rel=1e-4)
    router = "blocks/moe/router"
    assert p1["first_raw_grad"][router] != pytest.approx(
        p0["first_raw_grad"][router], rel=1e-2)
    assert p1["first_raw_grad"][router] == pytest.approx(
        r1["first_raw_grad"][router], rel=1e-4)


def test_forward_flops_count_every_product_of_a_forward():
    """Every product the port's forward runs at the smoke size, which
    holds all its experts: the weight products and the plain core's
    every (q, k) pair, the masked ones too, at q/k width 24 and v width
    16; the count's visible pairs plus the masked ones."""
    conf = tiny_cell(CELL).config
    cfg = harness.model_config(conf, "train").replace(remat=False)
    assert conf["moe"]["experts_held"] == conf["moe"]["n_experts"]
    params = harness.make_params(cfg, 0, CPU, conf["init"])
    b, s = 2, 16
    with FlopCounterMode(display=False) as fc:
        transformer.forward(params, cfg, {"tokens": torch.zeros(
            (b, s), dtype=torch.int32)})
    counted = sum(fc.get_flop_counts()["Global"].values())
    masked = s * s - bounds.visible_pairs(s)
    assert flops.pair_flops(conf) == 2 * (16 + 8 + 16)
    assert counted == flops.forward_flops(conf, b, s) + (
        b * conf["n_layers"] * conf["n_heads"] * flops.pair_flops(conf)
        * masked)


def test_the_cells_count_and_share():
    """At the cell's size: 3.11 B parameters on the card, 8 of 64
    experts a layer, and a train step of 4 x 2048 tokens is 69.4 TFLOP
    of model work."""
    conf = harness.load_cell(CELL).config
    cfg = harness.model_config(conf, "train")
    assert 3.10e9 < count_params(cfg) < 3.12e9
    assert count_active_params(cfg) < count_params(cfg)
    assert flops.pair_flops(conf) == 640
    assert flops.train_flops(conf, 4, 2048) == pytest.approx(69.4e12,
                                                              rel=2e-3)


def test_expert_load_reads_its_planted_record(monkeypatch):
    from repro_torch import spans as port_spans
    make, want = planted.of_metric("expert_load_max.train")
    assert make.__name__ == "moe_record" and want == 1.6
    spans, rec = planted.record(make())
    monkeypatch.setattr(port_spans, "recorded", lambda: list(spans))
    assert harness.metric_reader("expert_load_max.train")(rec) == \
        pytest.approx(80 / 50)


@pytest.mark.chip
def test_grouped_experts_equal_one_product_an_expert(cuda):
    """On the card in bf16 the held experts run as grouped GEMMs over a
    buffer of every pair's row, with no wait on the host; the output and
    the gradients to the tokens, the gates and the experts equal those of
    one product an expert on the held rows alone, to bf16 rounding
    (2e-2 of each tensor's largest value).  The routing is skewed so that
    held experts get no row, one row, or thousands."""
    from repro_torch.models import deepseek_moe
    from repro_torch.models.registry import get_config

    full = get_config("deepseek-v2-lite")
    cfg = full.replace(moe=dataclasses.replace(full.moe, experts_held=8))
    T_, d, f, K = 4096, 2048, 1408, 6
    g = torch.Generator(device=cuda).manual_seed(5)

    def draw(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=cuda)
                ).bfloat16()
    xt = draw(T_, d)
    skew = torch.tensor([0.0, 6.0, -30, 2.0] + [0.0] * 60, device=cuda)
    logits = torch.randn(T_, 64, generator=g, device=cuda) + skew
    gates, ids = torch.topk(torch.softmax(logits, -1), K, dim=-1)
    p = {"up": draw(8, d, f, scale=0.02), "gate": draw(8, d, f, scale=0.02),
         "down": draw(8, f, d, scale=0.02)}
    got = []
    for path in (True, False):
        leaves = [t.clone().requires_grad_() for t in (xt, gates,
                                                       *p.values())]
        with pytest.MonkeyPatch.context() as mp:
            if not path:
                mp.setattr(deepseek_moe, "grouped", lambda xt: False)
            assert deepseek_moe.grouped(xt) == path
            y = deepseek_moe.routed(dict(zip(p, leaves[2:])), cfg,
                                    leaves[0], leaves[1], ids)
            got.append([y, *torch.autograd.grad(y.float().pow(2).sum(),
                                                leaves)])
    for a, b in zip(*got):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 2e-2 * b.abs().max()
