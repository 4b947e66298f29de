"""The frozen work counts: model FLOPs against PyTorch's FLOP counter on
the products of a forward, and the kernel bounds against the ones that
measured the port's kernels."""
import sys
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hopaas_bench import harness
from hopaas_bench.testing import tiny_cell
from hopaas_bench.work import bounds, flops, flops_attn


def test_bounds_give_back_the_measured_kernels_bounds():
    assert bounds.flash_ms(4, 2048, 32, 32, 128) == pytest.approx(0.1390, abs=5e-5)
    assert bounds.flash_ms(4, 2048, 32, 32, 64) == pytest.approx(0.0695, abs=5e-5)
    assert bounds.ssd_ms(4, 2048, 64, 64, 64) == pytest.approx(0.0423, abs=5e-5)
    assert bounds.wkv6_ms(4, 2048, 64, 64) == pytest.approx(0.1014, abs=5e-5)
    assert bounds.visible_pairs(5) == 15


CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_weight_products_match_the_flop_counter(cell):
    """The 2-D products of a forward (``aten.mm``: every weight product)
    against the count's, at the smoke size; the attention products
    (``aten.bmm``) are the ref path's own algorithm and are checked
    against the count's pairs below."""
    from repro_torch.models import transformer

    conf = tiny_cell(cell).config
    cfg = harness.model_config(conf, "train").replace(remat=False)
    params = harness.make_params(cfg, 0, torch.device("cpu"), conf["init"])
    b, s = 2, 16
    with FlopCounterMode(display=False) as fc:
        transformer.forward(params, cfg, {"tokens": torch.zeros(
            (b, s), dtype=torch.int32)})
    counted = fc.get_flop_counts()["Global"]
    mm = sum(v for k, v in counted.items() if "bmm" not in str(k))
    per_token = (flops.stack(conf).weight_flops(conf)
                 + 2 * conf["d_model"] * conf["vocab_size"])
    assert mm == b * s * per_token
    # the ref path's attention computes every (q, k) pair, the masked
    # ones too: 4 * hd a pair and head, as the count does for the
    # visible ones
    bmm = sum(v for k, v in counted.items() if "bmm" in str(k))
    assert bmm == (b * flops.stack(conf).attention_layers(conf)
                   * conf["n_heads"] * flops.pair_flops(conf) * s * s)


def test_forward_flops_add_attention_pairs_and_scale_with_batch():
    conf = tiny_cell(CELLS[0]).config
    one = flops.forward_flops(conf, 1, 16)
    assert flops.forward_flops(conf, 3, 16) == 3 * one

    def attn(s):
        return (flops.stack(conf).attention_layers(conf) * conf["n_heads"]
                * flops.pair_flops(conf) * bounds.visible_pairs(s))
    assert one - attn(16) == 16 * (flops.forward_flops(conf, 1, 1) - attn(1))
    assert flops.train_flops(conf, 1, 16) == 3 * one


def test_a_blocks_pair_flops_set_the_attention_count(monkeypatch):
    """A block whose query and key heads are wider than its value heads
    (latent attention: 192 and 128) gives its own pair count, and moves
    ``forward_flops`` by exactly that; the dense block's count is as it
    was, so ``mfu.train`` and ``mfu.prefill`` read as before."""
    conf = harness.load_cell("deepseek-7b.hpo_train").config
    assert flops.pair_flops(conf) == 4 * conf["head_dim"] == 512
    assert flops.forward_flops(conf, 4, 2048) == 41_404_155_822_080
    standin = types.ModuleType("hopaas_bench.work.flops_standin")
    standin.weight_flops = flops_attn.weight_flops
    standin.attention_layers = flops_attn.attention_layers
    standin.pair_flops = lambda c: 2 * (192 + 128)
    monkeypatch.setitem(sys.modules, standin.__name__, standin)
    wide = {**conf, "block": "standin"}
    assert flops.pair_flops(wide) == 640
    assert (flops.forward_flops(wide, 4, 2048)
            - flops.forward_flops(conf, 4, 2048)) == (
        4 * conf["n_layers"] * conf["n_heads"] * (640 - 512)
        * bounds.visible_pairs(2048))
