"""The reference's loss: a block's training term (``train_term``) enters
the loss and its gradient as the cross-entropy does, a row at a time over
the number of rows; a block that leaves none computes the cross-entropy
alone, op for op, as before the term had a place."""
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from hopaas_bench import harness
from hopaas_bench.reference import attn, data, train
from hopaas_bench.reference.model import Reference
from hopaas_bench.testing import tiny_cell

SEED = 2**31 + 5
ALPHA = 100.0
OPT = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "grad_clip": 0.0}


def _setup():
    conf = tiny_cell("deepseek-7b.hpo_train").config
    cfg = harness.model_config(conf, "train")
    b = data.batch(SEED, 0, 2, 16, conf["vocab_size"])
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    return conf, lambda: harness.make_params(cfg, SEED, torch.device("cpu"),
                                             conf["init"]), batch


def _term(x):
    """The stand-in's term: a row's mean square embedding, scaled."""
    return ALPHA * x.pow(2).mean()


def _standin_stack(ref, x):
    out = attn.stack(ref, x)
    ref.train_term = _term(x)
    return out


def test_a_blocks_training_term_enters_the_loss_and_gradient(monkeypatch):
    conf, params, batch = _setup()
    standin = types.ModuleType("hopaas_bench.reference.standin")
    standin.stack = _standin_stack
    monkeypatch.setitem(sys.modules, standin.__name__, standin)
    got = train.adamw_steps({**conf, "block": "standin"}, params(), [batch],
                            OPT)
    plain = train.adamw_steps(conf, params(), [batch], OPT)
    # expected: the 2-row batch's mean cross-entropy plus the rows' mean
    # term, in one forward of both rows
    tree = params()
    flat = dict(train.leaves(tree))
    for t in flat.values():
        t.requires_grad_(True)
    ref = Reference(conf, tree)
    x = tree["embed"][batch["tokens"].long()].float()
    terms = [_term(x[i: i + 1]) for i in range(2)]
    loss = ref.loss(batch["tokens"], batch["labels"]) + sum(terms) / 2
    loss.backward()
    assert got["losses"][0] == pytest.approx(float(loss.detach()), rel=1e-6)
    assert got["losses"][0] - plain["losses"][0] == pytest.approx(
        float(sum(terms).detach()) / 2, rel=1e-5)
    want = {k: float(t.grad.norm()) for k, t in flat.items()}
    assert got["first_raw_grad"] == pytest.approx(want, rel=1e-5)
    # the term moves the embedding's gradient, by its share over the rows
    moved = {k for k in want if got["first_raw_grad"][k]
             != pytest.approx(plain["first_raw_grad"][k], rel=1e-3)}
    assert moved == {"embed"}


@pytest.mark.parametrize("control", [None, "fp8"])
def test_attn_loss_is_the_cross_entropy_op_for_op(control):
    conf, params, batch = _setup()
    tree = params()
    flat = [t.requires_grad_(True) for _, t in train.leaves(tree)]
    ref = Reference(conf, tree, control=control)
    toks, labels = batch["tokens"][:1], batch["labels"][:1]
    loss = ref.loss(toks, labels)
    assert ref.train_term is None
    with ref._compute():
        logits = ref.logits(ref.hidden(toks))
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             labels.reshape(-1).long())
    assert torch.equal(loss, ce)
    for a, b in zip(torch.autograd.grad(loss, flat),
                    torch.autograd.grad(ce, flat)):
        assert torch.equal(a, b)
