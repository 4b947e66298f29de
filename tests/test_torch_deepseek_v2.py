"""DeepSeek-V2-Lite's blocks in the port (``block="mla_moe"``) at the
smoke size on seeded random weights, on the CPU in float32: latent
attention against a float32 transcription of its equations written here,
YaRN's frequencies against their closed form, the dropless dispatch
against every expert run on every token, the expert-parallel shares
against the uncut layer, the per-sequence balance loss and its gradient
against the formula, the parameter specs, the device counters, the
blocks' recompute, the decode refusal, and the registry's counts.  Tolerances: fp32
products in another order, rtol 1e-5, atol 1e-6 (gradients 1e-5; MLA's
output 1e-4 and 1e-5, ``MLA_TOL``)."""
import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, spans
from repro_torch.data import DataConfig
from repro_torch.models import deepseek_moe, get_config, mla
from repro_torch.models import transformer as T
from repro_torch.models.layers import mlp, yarn_frequencies
from repro_torch.models.registry import (count_active_params, count_params,
                                         leaves)
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig

ARCH = "deepseek-v2-lite"
TOL = dict(rtol=1e-5, atol=1e-6)
# the smoke init scales W_q and W_kvb by 1 / sqrt(4 heads): scores reach
# tens, and the softmax carries their fp32 rounding into the output
MLA_TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


def _cfg(**moe):
    c = get_config(ARCH, smoke=True)
    return c.replace(moe=dataclasses.replace(c.moe, **moe)) if moe else c


def _params(cfg, seed=0):
    return T.init_params(cfg, seed, CPU)


def _x(cfg, b=2, s=12, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, cfg.d_model, generator=g)


# --------------------------------------------------------------------- #
# latent attention and YaRN
# --------------------------------------------------------------------- #
def test_yarn_frequencies_match_the_closed_form():
    """At DeepSeek-V2-Lite's rotary width 64, theta 1e4, factor 40 and
    4096 original positions (beta 32 and 1): the pairs below 10 keep
    theta^(-2i/64), those from 23 on take it over 40, a linear ramp
    between (10 and 23 the correction range's floor and ceiling)."""
    got = yarn_frequencies(64, 10_000.0, 40.0, 32.0, 1.0, 4096)
    i = torch.arange(32, dtype=torch.float32)
    f = 10_000.0 ** (-2 * i / 64)
    m = 1 - torch.clamp((i - 10) / (23 - 10), 0, 1)
    torch.testing.assert_close(got, f / 40 * (1 - m) + f * m)
    torch.testing.assert_close(got[:10], f[:10])
    torch.testing.assert_close(got[23:], f[23:] / 40)
    full = get_config(ARCH)
    assert mla.mscale(40, 0.707) == pytest.approx(0.1 * 0.707 * math.log(40)
                                                  + 1)
    assert mla.softmax_scale(full) == pytest.approx(
        192 ** -0.5 * mla.mscale(40, 0.707) ** 2)


def _mla_by_equations(p, cfg, x):
    """MLA from the equations, head by head, in float32."""
    m = cfg.mla
    b, S, d = x.shape
    H, dn, dr, dv, r = (cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                        m.v_head_dim, m.kv_lora_rank)
    i = torch.arange(dr // 2, dtype=torch.float32)
    f = cfg.rope_theta ** (-2 * i / dr)
    corr = [dr * math.log(m.original_max_position / (t * 2 * math.pi))
            / (2 * math.log(cfg.rope_theta))
            for t in (m.beta_fast, m.beta_slow)]
    lo, hi = math.floor(corr[0]), math.ceil(corr[1])
    keep = 1 - torch.clamp((i - lo) / (hi - lo), 0, 1)
    freq = f / m.rope_factor * (1 - keep) + f * keep
    ang = torch.arange(S, dtype=torch.float32)[:, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rot(t):                         # (S, dr), halves as pairs
        a, c = t[:, : dr // 2], t[:, dr // 2:]
        return torch.cat([a * cos - c * sin, c * cos + a * sin], -1)
    ms = 0.1 * m.mscale_all_dim * math.log(m.rope_factor) + 1
    scale = ms * ms / math.sqrt(dn + dr)
    out = torch.zeros(b, S, d)
    mask = torch.ones(S, S).tril().bool()
    for bi in range(b):
        xb = x[bi]
        lat = xb @ p["wkv_a"]
        c = lat[:, :r]
        c = c / torch.sqrt(c.pow(2).mean(-1, keepdim=True) + cfg.norm_eps) \
            * p["kv_norm"]
        k_pe = rot(lat[:, r:])
        for h in range(H):
            q = xb @ p["wq"][:, h]
            kv = c @ p["wkv_b"][:, h]
            qh = torch.cat([q[:, :dn], rot(q[:, dn:])], -1)
            kh = torch.cat([kv[:, :dn], k_pe], -1)
            s = (qh @ kh.T * scale).masked_fill(~mask, float("-inf"))
            out[bi] += torch.softmax(s, -1) @ kv[:, dn:] @ p["wo"][h]
    return out


def test_mla_matches_its_equations():
    cfg = _cfg()
    p = T.layer(_params(cfg)["blocks"]["attn"], 0)
    x = _x(cfg)
    got = mla.attention(p, cfg, x, torch.arange(x.shape[1]))
    torch.testing.assert_close(got, _mla_by_equations(p, cfg, x), **MLA_TOL)


def test_mla_refuses_a_kernel_core():
    cfg = _cfg().replace(attn_impl="flash")
    p = T.layer(_params(_cfg())["blocks"]["attn"], 0)
    with pytest.raises(NotImplementedError, match="plain core"):
        mla.attention(p, cfg, _x(cfg), torch.arange(12))


# --------------------------------------------------------------------- #
# DeepSeekMoE
# --------------------------------------------------------------------- #
def _every_expert(p, cfg, xt, offset=0):
    """Every held expert on every token, combined by the router's gate
    (0 for an expert the token did not choose), plus the shared ones."""
    m = cfg.moe
    probs = torch.softmax(xt @ p["router"], -1)
    gates, ids = torch.topk(probs, m.top_k, -1)
    weight = torch.zeros_like(probs).scatter(1, ids, gates)
    y = torch.zeros_like(xt)
    for e in range(m.held):
        h = (xt @ p["up"][e]) * F.silu(xt @ p["gate"][e])
        y = y + weight[:, offset + e, None] * (h @ p["down"][e])
    return y, y + (xt @ p["shared"]["up"]) * F.silu(
        xt @ p["shared"]["gate"]) @ p["shared"]["down"]


def test_dropless_dispatch_matches_every_expert_on_every_token():
    cfg = _cfg()
    p = T.layer(_params(cfg)["blocks"]["moe"], 0)
    x = _x(cfg)
    got, _ = deepseek_moe.moe_ffn(p, cfg, x)
    _, want = _every_expert(p, cfg, x.reshape(-1, cfg.d_model))
    torch.testing.assert_close(got.reshape(-1, cfg.d_model), want, **TOL)


def test_the_shares_add_up_to_the_uncut_layer():
    """Eight devices of an EP-8 deployment, each holding one of the smoke
    layer's 8 experts: their routed parts, plus the shared experts once,
    add up to the layer with every expert held."""
    cfg = _cfg()
    p = T.layer(_params(cfg)["blocks"]["moe"], 0)
    x = _x(cfg)
    whole, _ = deepseek_moe.moe_ffn(p, cfg, x)
    xt = x.reshape(-1, cfg.d_model)
    total = torch.zeros_like(xt)
    for e in range(cfg.moe.n_experts):
        share = _cfg(experts_held=1, expert_offset=e)
        sp = {**p, **{k: p[k][e: e + 1] for k in ("up", "gate", "down")}}
        gates, ids, _ = deepseek_moe.route(sp, share, xt, 2)
        total = total + deepseek_moe.routed(sp, share, xt, gates, ids)
    total = total + mlp(p["shared"], xt)
    torch.testing.assert_close(total.reshape(x.shape), whole, **TOL)


def test_a_share_counts_only_its_experts_pairs():
    cfg = _cfg(experts_held=2, expert_offset=4)
    p = T.layer(_params(_cfg())["blocks"]["moe"], 0)
    sp = {**p, **{k: p[k][4:6] for k in ("up", "gate", "down")}}
    x = _x(cfg)
    got, _ = deepseek_moe.moe_ffn(sp, cfg, x)
    xt = x.reshape(-1, cfg.d_model)
    routed, _ = _every_expert(sp, cfg, xt, offset=4)
    want = routed + mlp(p["shared"], xt)
    torch.testing.assert_close(got.reshape(-1, cfg.d_model), want, **TOL)


def _segments(a, b, offs):
    """Each segment of a's rows against its expert's b; the rows past the
    last segment NaN, as a grouped GEMM leaves them unwritten."""
    ends = offs.tolist()
    parts = [a[s:e] @ b[i] for i, (s, e) in enumerate(zip([0] + ends, ends))]
    return torch.cat(parts + [torch.full((a.shape[0] - ends[-1],
                                          b.shape[-1]), float("nan"))])


class _GroupedMM(torch.autograd.Function):
    """A stand-in for ``torch._grouped_mm`` on the CPU that leaves NaN in
    the rows past the segments, forward and in the rows' gradient."""

    @staticmethod
    def forward(ctx, a, b, offs):
        ctx.save_for_backward(a, b, offs)
        return _segments(a, b, offs)

    @staticmethod
    def backward(ctx, g):
        a, b, offs = ctx.saved_tensors
        ends = offs.tolist()
        gb = torch.stack([a[s:e].T @ g[s:e]
                          for s, e in zip([0] + ends, ends)])
        return _segments(g, b.transpose(1, 2), offs), gb, None


@pytest.mark.parametrize("picks", ["routed", "none_held"])
def test_grouped_dispatch_never_lets_an_unwritten_row_in(picks):
    """The sync-free grouped path (CUDA's), with a grouped GEMM that
    leaves NaN in every row past the held pairs, forward and backward:
    its output and its gradients to the tokens, the gates and the
    experts equal the expert-by-expert path's, and are finite; also
    where no token picks an expert held here."""
    cfg = _cfg(experts_held=3, expert_offset=2)
    p = T.layer(_params(_cfg())["blocks"]["moe"], 0)
    p = {k: p[k][2:5] for k in ("up", "gate", "down")}
    xt = _x(cfg).reshape(-1, cfg.d_model)
    gates, ids, _ = deepseek_moe.route(
        T.layer(_params(_cfg())["blocks"]["moe"], 0), cfg, xt, 2)
    if picks == "none_held":
        ids = torch.where(ids < 2, ids, ids % 3 + 5)
        assert not ((ids >= 2) & (ids < 5)).any()
    got = []
    for path in (True, False):
        leaves = [t.clone().requires_grad_() for t in (xt, gates,
                                                       *p.values())]
        tree = dict(zip(p, leaves[2:]))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(deepseek_moe, "grouped", lambda xt: path)
            mp.setattr(torch, "_grouped_mm", _GroupedMM.apply,
                       raising=False)
            y = deepseek_moe.routed(tree, cfg, leaves[0], leaves[1], ids)
            got.append([y, *torch.autograd.grad(y.pow(2).sum(), leaves)])
    for a, b in zip(*got):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **TOL)


def test_balance_loss_and_its_gradient_match_the_formula():
    """Per row b: sum_i f_bi P_bi, f_bi = count_bi E / (S K), P_bi the
    row's mean probability of expert i; the mean over the rows.  Its
    gradient reaches the router through P alone."""
    cfg = _cfg()
    m = cfg.moe
    p = T.layer(_params(cfg)["blocks"]["moe"], 0)
    router = p["router"].clone().requires_grad_()
    x = _x(cfg, b=3, s=10)
    xt = x.reshape(-1, cfg.d_model)
    _, ids, got = deepseek_moe.route({"router": router}, cfg, xt, 3)
    want = 0.0
    probs = torch.softmax(xt @ router, -1).reshape(3, 10, m.n_experts)
    for b in range(3):
        counts = torch.bincount(ids.reshape(3, -1)[b], minlength=m.n_experts)
        f = counts.float() * m.n_experts / (10 * m.top_k)
        want = want + (f * probs[b].mean(0)).sum() / 3
    torch.testing.assert_close(got, want, **TOL)
    g_got, = torch.autograd.grad(got, router, retain_graph=True)
    g_want, = torch.autograd.grad(want, router)
    torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-5)


def test_loss_adds_the_balance_loss_at_the_configs_alpha():
    cfg = _cfg()
    params = _params(cfg)
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (2, 12), generator=g)}
    loss, parts = T.loss_fn(params, cfg, batch)
    assert T.aux_coef(cfg) == cfg.moe.aux_alpha == 0.001
    assert float(parts["moe_aux"]) > 0
    assert float(loss) == pytest.approx(
        float(parts["ce"]) + 0.001 * float(parts["moe_aux"]), rel=1e-6)
    assert T.aux_coef(get_config("qwen2-moe-a2.7b", smoke=True)) == \
        T.MOE_AUX_COEF == 0.01


# --------------------------------------------------------------------- #
# the stack, specs, counters, registry
# --------------------------------------------------------------------- #
def test_stack_runs_a_dense_layer_then_moe_layers():
    cfg = _cfg()
    params = _params(cfg)
    assert "mlp" in params["dense_blocks"] and "moe" in params["blocks"]
    assert params["dense_blocks"]["norm1"].shape[0] == cfg.first_dense == 1
    assert params["blocks"]["norm1"].shape[0] == cfg.n_layers - 1
    assert params["blocks"]["moe"]["router"].shape[-1] == cfg.moe.n_experts
    held = _cfg(experts_held=2)
    assert _params(held)["blocks"]["moe"]["up"].shape[1] == 2


def test_param_specs_cover_every_leaf():
    cfg = get_config(ARCH)
    specs = T.param_specs(cfg)
    shapes = T.init_params(cfg, device="meta")

    def walk(a, b, path=""):
        assert a.keys() == b.keys(), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert len(a[k]) == b[k].dim(), f"{path}/{k}"
    walk(specs, shapes)


def test_decode_and_its_cache_are_refused():
    cfg = _cfg()
    params = _params(cfg)
    with pytest.raises(NotImplementedError, match="latent"):
        T.decode_step(params, cfg, {}, torch.zeros(2, 1, dtype=torch.long), 0)
    with pytest.raises(NotImplementedError, match="latent"):
        T.init_cache(cfg, 2, 16, device="cpu")


def test_the_arch_is_registered_outside_the_cell_matrix():
    assert ARCH not in configs.ARCHS
    assert get_config(ARCH).block == "mla_moe"


def test_active_params_count_moe_layers_and_held_experts():
    """Experts sit only in the 26 MoE layers (not the dense layer 0), and
    a card counts only the experts it holds: a token's 6 picks fall on
    them 6 x 8 / 64 times on average."""
    full = get_config(ARCH)
    assert 15.6e9 < count_params(full) < 15.8e9
    assert 2.6e9 < count_active_params(full) < 2.7e9
    expert = 3 * 2048 * 1408
    for held in (64, 8):
        cfg = full.replace(moe=dataclasses.replace(full.moe,
                                                   experts_held=held))
        total = count_params(cfg)
        assert count_active_params(cfg) == (
            total - 26 * held * expert + 26 * 6 * held * expert // 64)
    cut = full.replace(moe=dataclasses.replace(full.moe, experts_held=8))
    assert 3.10e9 < count_params(cut) < 3.12e9


def test_trainer_counts_each_held_experts_pairs_once_a_forward():
    """Under a profiler the trainer records the counters once, at its
    end, in ``trainer.counts``: per MoE layer the held experts'
    ``moe.pairs`` sum to steps x tokens x top_k (the recompute in the
    backward does not count again); with no profiler it records
    nothing and leaves no counter."""
    cfg = _cfg()
    tr = Trainer(cfg, AdamWConfig(lr=1e-3),
                 DataConfig(global_batch=2, seq_len=16, seed=0),
                 TrainerConfig(total_steps=3, report_every=1), device=CPU)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.run()
    counts = [s for s in spans.recorded() if s.name == "trainer.counts"]
    spans.clear()
    assert len(counts) == 1 and list(counts[0].attrs) == [deepseek_moe.PAIRS]
    pairs = counts[0].attrs[deepseek_moe.PAIRS]
    assert len(pairs) == cfg.n_layers - cfg.first_dense
    assert all(len(row) == cfg.moe.held and sum(row) == 3 * 32 * 3
               for row in pairs)
    tr.run()
    assert spans.recorded() == [] and spans.take_counts() == {}


def test_take_counts_drains_every_counter_by_name():
    """Each counter sums what was added at a key while a profiler ran;
    ``take_counts`` gives every counter's values in the order of their
    keys and leaves none behind."""
    one = torch.tensor([1, 2])
    spans.count("a", 1, one)               # no profiler: dropped
    with profile(activities=[ProfilerActivity.CPU]):
        for key, name in ((1, "a"), (0, "a"), (1, "a"), (0, "b")):
            spans.count(name, key, one * (key + 1))
    assert spans.take_counts() == {"a": [[1, 2], [4, 8]], "b": [[1, 2]]}
    assert spans.take_counts() == {}


# --------------------------------------------------------------------- #
# the block's recompute
# --------------------------------------------------------------------- #
def _grads(cfg, params, batch):
    flat = [t.clone().requires_grad_() for t in leaves(params)]
    it = iter(flat)
    tree = _rebuild(params, it)
    loss, _ = T.loss_fn(tree, cfg, batch)
    return loss, torch.autograd.grad(loss, flat)


def _rebuild(like, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it)
            for k, v in like.items()}


def _batch(cfg, b=2, s=16, seed=3):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (b, s), generator=g)
            for k in ("tokens", "labels")}


def test_recompute_changes_no_gradient():
    """The blocks recomputed in the backward (``remat``, policy
    "nothing") give the loss and every gradient of the graph kept
    whole."""
    cfg = _cfg()
    params, batch = _params(cfg), _batch(cfg)
    loss0, g0 = _grads(cfg.replace(remat=False), params, batch)
    loss1, g1 = _grads(cfg.replace(remat=True), params, batch)
    torch.testing.assert_close(loss1, loss0, rtol=0, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, **TOL)


def test_a_block_keeps_only_its_inputs_for_the_backward():
    """Under ``remat`` each layer's forward keeps its input and its
    weights for the backward and nothing else: one more MoE layer adds
    exactly those to what autograd saves."""
    def saved(cfg):
        n = [0]

        def pack(t):
            n[0] += 1
            return t
        params = _params(cfg)
        for t in leaves(params):
            t.requires_grad_()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            T.loss_fn(params, cfg, _batch(cfg))
        return n[0], params
    cfg = _cfg()
    n, _ = saved(cfg)
    n_more, params = saved(cfg.replace(n_layers=cfg.n_layers + 1))
    assert n_more - n == 1 + len(list(leaves(T.layer(params["blocks"], 0))))


@pytest.mark.parametrize("miss", ["fp32", "no_grouped_mm"])
def test_cuda_takes_the_grouped_path_or_refuses(monkeypatch, miss):
    """On CUDA the held experts run grouped, with no wait on the host;
    without bf16 or ``torch._grouped_mm`` the layer refuses rather than
    wait on the host in every layer.  Off CUDA it takes one product an
    expert."""
    class OnCard:
        is_cuda = True
        dtype = torch.float32 if miss == "fp32" else torch.bfloat16
    monkeypatch.setattr(torch, "_grouped_mm", lambda *a, **k: None,
                        raising=False)
    if miss == "no_grouped_mm":
        monkeypatch.delattr(torch, "_grouped_mm")
    with pytest.raises(NotImplementedError, match="grouped"):
        deepseek_moe.grouped(OnCard())
    assert deepseek_moe.grouped(torch.zeros(2, dtype=torch.bfloat16)) is False
