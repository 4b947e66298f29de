"""The port's Mixture-of-Experts against the JAX reference.

``repro_torch.models.moe`` against ``repro.models.moe`` layer by layer
(both dispatch branches, drops, ``scan_groups``, shared experts on and
off, the top-k renormalisation on and off), the kept (token, expert,
slot) set against the reference's one-hot dispatch exactly, and the MoE
models (qwen2-moe and mixtral smoke configs) through ``forward``,
``decode_step``, ``ServeEngine.generate``, ``loss_fn`` and its gradients
and one train step.  The reference's parameters are carried across with
``params_from_jax``; inputs are seeded with numpy.  Tolerances: fp32 at
rtol = atol = 1e-4 (gradients: atol scaled to the leaf's largest
magnitude, as in ``tests/test_torch_train.py``); the port's dispatch
against its one-hot form in bf16 at 2e-2.

The reference's models import the missing ``repro.dist``: they are
imported under the ``reference`` fixture of
``tests/test_torch_models.py``, which removes them again on teardown.
"""
import dataclasses
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.models import count_params, get_config, moe  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import count_active_params  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import (ServeEngine, make_decode_step,  # noqa: E402
                               make_prefill_step)
from repro_torch.serve.engine import FP32_LEAVES, cast_params  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig,  # noqa: E402
                               make_train_step)
from test_torch_models import reference  # noqa: E402,F401  (the stub)
from test_torch_train import (_batch, _close_leaf,  # noqa: E402
                              _exact_grads, _items, _torch_batch)

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
CPU = torch.device("cpu")
# name -> (arch, MoEConfig overrides): the smoke configs' layer widths
ARCHS = {"qwen2-moe": ("qwen2-moe-a2.7b", {}),
         "qwen2-moe-unshared": ("qwen2-moe-a2.7b", {"n_shared": 0}),
         "mixtral": ("mixtral-8x7b", {})}
GROUPED = {"dense_dispatch": False, "group_size": 8}
# T = 14 tokens: group_size 8 decrements to Tg 7, G 2
CASES = {"dense": {},
         "dense-unnormed": {"router_norm_topk": False},
         "grouped": GROUPED,
         "drops": {**GROUPED, "capacity_factor": 0.5},
         "drops-unnormed": {**GROUPED, "capacity_factor": 0.5,
                            "router_norm_topk": False},
         "scan2": {**GROUPED, "scan_groups": 2},
         "scan2-drops": {**GROUPED, "scan_groups": 2,
                         "capacity_factor": 0.5}}
# whole models: name -> (arch, MoEConfig overrides)
MODELS = {f"{a}-{b}": (arch, over)
          for a, arch in (("qwen2-moe", "qwen2-moe-a2.7b"),
                          ("mixtral", "mixtral-8x7b"))
          for b, over in (("dense", {}), ("grouped", GROUPED))}
DROPS = {**GROUPED, "capacity_factor": 0.5}


@pytest.fixture(scope="module")
def ref(reference):
    return types.SimpleNamespace(
        **vars(reference), moe=importlib.import_module("repro.models.moe"),
        optim=importlib.import_module("repro.optim"),
        step=importlib.import_module("repro.train.step"))


def _with_moe(cfg, over: dict):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **over))


def _cfgs(ref, arch: str, over: dict):
    return (_with_moe(ref.registry.get_config(arch, smoke=True), over),
            _with_moe(get_config(arch, smoke=True), over))


@pytest.fixture(scope="module")
def layers(ref):
    """name -> (reference cfg, port cfg, reference layer-0 MoE params,
    port's), from the reference's init, built once per name."""
    built = {}

    def get(arch_name, case):
        key = (arch_name, case)
        if key not in built:
            arch, over = ARCHS[arch_name]
            rcfg, pcfg = _cfgs(ref, arch, {**over, **CASES[case]})
            rparams, _ = ref.transformer.init_params(rcfg, jax.random.key(0))
            rp = {k: v[0] for k, v in rparams["blocks"]["moe"].items()}
            built[key] = (rcfg, pcfg, rp, params_from_jax(rp, CPU))
        return built[key]
    return get


@pytest.fixture(scope="module")
def models(ref):
    built = {}

    def get(name, over=None):
        key = (name, tuple(sorted((over or {}).items())))
        if key not in built:
            arch, base = MODELS[name]
            rcfg, pcfg = _cfgs(ref, arch, {**base, **(over or {})})
            rparams, _ = ref.transformer.init_params(rcfg, jax.random.key(0))
            built[key] = (rcfg, pcfg, rparams, params_from_jax(rparams, CPU))
        return built[key]
    return get


def _x(cfg, seed: int = 0, shape=(2, 7)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _reference_dispatch(ref, monkeypatch, rp, rcfg, x) -> set:
    """The (token, expert, slot) assignments the reference's grouped
    dispatch keeps: the nonzeros of its ``dispatch`` tensor, read off
    the einsum that gathers the tokens.  With ``scan_groups`` > 1 that
    einsum runs traced inside ``lax.scan``, so the groups are read from
    the unscanned call, which computes each group alike."""
    rcfg = _with_moe(rcfg, {"scan_groups": 1})
    seen = []
    einsum = jnp.einsum

    def spy(spec, *ops, **kw):
        if spec == "gtd,gtec->gecd":
            seen.append(np.asarray(ops[1]))
        return einsum(spec, *ops, **kw)

    with monkeypatch.context() as patch:
        patch.setattr(ref.moe.jnp, "einsum", spy)
        ref.moe.moe_ffn(rp, rcfg, jnp.asarray(x))
    (dispatch,) = seen
    g, t, e, c = np.nonzero(dispatch)
    Tg = dispatch.shape[1]
    return set(zip((g * Tg + t).tolist(), e.tolist(), c.tolist()))


def _kept(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """The assignments the port's grouped dispatch keeps, as rows
    (token, k, expert, slot) in token-major order."""
    xt = x.reshape(-1, x.shape[-1])
    _, expert_idx, _ = moe.route(p, cfg, xt)
    slot, keep, _, _ = moe.slots(expert_idx, cfg.moe)
    tok, k = torch.nonzero(keep, as_tuple=True)
    return torch.stack([tok, k, expert_idx[tok, k], slot[tok, k]], dim=1)


def _onehot_kept(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """``_kept`` read off the nonzeros of the port's one-hot dispatch."""
    xt = x.reshape(-1, x.shape[-1])
    _, expert_idx, _ = moe.route(p, cfg, xt)
    g, t, k, e, c = torch.nonzero(
        moe.onehot_dispatch(expert_idx, cfg.moe, torch.float32),
        as_tuple=True)
    Tg, _ = moe.group_capacity(cfg.moe, expert_idx.shape[0])
    return torch.stack([g * Tg + t, k, e, c], dim=1)


# --------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch_name", list(ARCHS))
def test_moe_ffn_matches_reference(ref, layers, arch_name, case):
    rcfg, pcfg, rp, pp = layers(arch_name, case)
    x = _x(pcfg)
    want, want_aux = ref.moe.moe_ffn(rp, rcfg, jnp.asarray(x))
    got, aux = moe.moe_ffn(pp, pcfg, torch.from_numpy(x))
    assert got.shape == x.shape and aux.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("case", [c for c in CASES if "dense" not in c])
@pytest.mark.parametrize("arch_name", list(ARCHS))
def test_kept_set_matches_reference_dispatch(ref, layers, monkeypatch,
                                             arch_name, case):
    rcfg, pcfg, rp, pp = layers(arch_name, case)
    x = _x(pcfg)
    want = _reference_dispatch(ref, monkeypatch, rp, rcfg, x)
    kept = _kept(pp, pcfg, torch.from_numpy(x))
    assert {(t, e, c) for t, _, e, c in kept.tolist()} == want
    assert torch.equal(kept, _onehot_kept(pp, pcfg, torch.from_numpy(x)))
    T, K = x.shape[0] * x.shape[1], pcfg.moe.top_k
    if pcfg.moe.capacity_factor < 1:            # an expert overflows
        assert len(want) < T * K


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch_name", list(ARCHS))
def test_moe_ffn_matches_its_onehot_form(layers, arch_name, case):
    _, pcfg, _, pp = layers(arch_name, case)
    x = torch.from_numpy(_x(pcfg, seed=1))
    got, aux = moe.moe_ffn(pp, pcfg, x)
    want, want_aux = moe.moe_ffn_onehot(pp, pcfg, x)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(aux, want_aux, **TOL)


@pytest.mark.parametrize("case", ["dense", "drops", "scan2-drops"])
@pytest.mark.parametrize("arch_name", list(ARCHS))
def test_moe_ffn_matches_its_onehot_form_in_bf16(layers, arch_name, case):
    _, pcfg, _, pp = layers(arch_name, case)
    cfg = pcfg.replace(dtype=torch.bfloat16)
    x = torch.from_numpy(_x(cfg, seed=2)).bfloat16()
    got, aux = moe.moe_ffn(pp, cfg, x)
    want, want_aux = moe.moe_ffn_onehot(pp, cfg, x)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(aux, want_aux, **BF16_TOL)


def test_slots_count_token_major():
    """Hand-computed slots: expert 1 is token 0's first choice, then
    tokens 1 and 2's second, then token 3's first.  Token-major order
    gives it slots 0, 1, 2, 3 and drops tokens 2 and 3 at a capacity of
    2; a k-major count would keep token 3 instead of token 1."""
    idx = torch.tensor([[1, 0], [2, 1], [0, 1], [1, 2]])
    m = MoEConfig(n_experts=3, top_k=2, d_expert=4, capacity_factor=0.75,
                  group_size=4)
    slot, keep, Tg, cap = moe.slots(idx, m)
    assert (Tg, cap) == (4, 2)
    assert slot.tolist() == [[0, 0], [0, 1], [1, 2], [3, 1]]
    assert keep.tolist() == [[True, True], [True, True], [True, False],
                             [False, True]]


@pytest.mark.parametrize("T,group_size,want", [(14, 8, (7, 2)),
                                               (13, 8, (1, 2)),
                                               (4096, 1024, (1024, 320)),
                                               (4, 1024, (4, 2))])
def test_group_capacity_by_hand(T, group_size, want):
    """(Tg, cap) at 8 experts, top-2, capacity factor 1.25: Tg steps down
    until it divides T (13 is prime: groups of one token), cap =
    int(1.25 * 2 * Tg / 8), at least top_k (mixtral's prefill groups and
    its decode step at B = 4)."""
    m = MoEConfig(n_experts=8, top_k=2, d_expert=4, group_size=group_size)
    assert moe.group_capacity(m, T) == want


# --------------------------------------------------------------------- #
# the MoE models
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_reference(ref, models, name, impl):
    rcfg, pcfg, rparams, pparams = models(name)
    toks = _tokens(pcfg, (2, 16), seed=1)
    want, want_aux = ref.transformer.forward(
        rparams, rcfg.replace(attn_impl=impl), {"tokens": jnp.asarray(toks)})
    before = flash_attention.launches
    got, aux = pt.forward(pparams, pcfg.replace(attn_impl=impl),
                          {"tokens": torch.from_numpy(toks).long()})
    assert flash_attention.launches == before       # CPU: the plain version
    assert got.shape == (2, 16, pcfg.vocab_size) and float(aux) > 0
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_matches_reference(ref, models, name):
    """20 decode steps with the reference's cache (mixtral's window of 16
    makes its cache a ring that wraps), logits at every step and the KV
    cache at the end."""
    rcfg, pcfg, rparams, pparams = models(name)
    max_len = ref.engine.cache_max_len(rcfg, 24)
    rcache, _ = ref.transformer.init_cache_arrays(rcfg, 2, max_len)
    pcache = pt.init_cache_arrays(pcfg, 2, max_len, CPU)
    rdecode = jax.jit(ref.engine.make_decode_step(rcfg))
    pdecode = make_decode_step(pcfg)
    toks = _tokens(pcfg, (2, 20), seed=3)
    for t in range(20):
        want, rcache = rdecode(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
        got, pcache = pdecode(pparams, pcache,
                              torch.from_numpy(toks[:, t:t + 1]).long(), t)
        _close(got, want)
    for k in ("k", "v"):
        _close(pcache["kv"][k], rcache["kv"][k])


@pytest.mark.parametrize("name", ["qwen2-moe-grouped", "mixtral-grouped"])
def test_decode_logits_match_prefill_when_nothing_drops(models, name):
    """Prefill groups the prompt's tokens and decode each step's B: the
    two agree where no capacity drops (``capacity_factor = E / top_k``
    gives every expert a slot for every token of its group)."""
    _, pcfg, _, pparams = models(name)
    m = pcfg.moe
    cfg = _with_moe(pcfg, {"capacity_factor": m.n_experts / m.top_k})
    toks = torch.from_numpy(_tokens(cfg, (2, 16), seed=4)).long()
    x = torch.from_numpy(_x(cfg, seed=4, shape=(2, 16)))
    p0 = pt.layer(pparams["blocks"], 0)["moe"]
    assert len(_kept(p0, cfg, x)) == 2 * 16 * m.top_k
    prefill = make_prefill_step(cfg.replace(attn_impl="flash"))(
        pparams, {"tokens": toks})
    decode = make_decode_step(cfg)
    cache = pt.init_cache(cfg, 2, 16, CPU)
    for t in range(16):
        logits, cache = decode(pparams, cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits[:, 0], prefill[:, -1], **TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_generate_matches_reference(ref, models, name):
    rcfg, pcfg, rparams, pparams = models(name)
    prompts = _tokens(pcfg, (2, 6), seed=5)
    want = ref.engine.ServeEngine(rcfg, rparams, max_len=16).generate(
        prompts, 8)
    got = ServeEngine(pcfg, pparams, max_len=16, device="cpu").generate(
        prompts, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["qwen2-moe-grouped", "mixtral-grouped"])
def test_engine_casts_the_moe_leaves_once(models, name):
    """bf16 compute: the router, shared router and expert leaves are
    cast to bf16 once (no MoE leaf joins ``FP32_LEAVES``), and decode and
    prefill give the per-use cast's logits bit for bit."""
    _, pcfg, _, pparams = models(name)
    cfg = pcfg.replace(dtype=torch.bfloat16)
    cast = cast_params(pparams, cfg, CPU)
    assert not set(cast["blocks"]["moe"]) & FP32_LEAVES
    assert all(v.dtype == torch.bfloat16
               for v in cast["blocks"]["moe"].values())
    toks = torch.from_numpy(_tokens(cfg, (2, 8), seed=6)).long()
    decode = make_decode_step(cfg)
    caches = [pt.init_cache(cfg, 2, 8, CPU) for _ in range(2)]
    for t in range(8):
        a, caches[0] = decode(pparams, caches[0], toks[:, t:t + 1], t)
        b, caches[1] = decode(cast, caches[1], toks[:, t:t + 1], t)
        assert torch.equal(a, b), t
    prefill = make_prefill_step(cfg)
    assert torch.equal(prefill(pparams, {"tokens": toks}),
                       prefill(cast, {"tokens": toks}))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b",
                                  "deepseek-7b", "zamba2-1.2b", "rwkv6-7b"])
def test_param_dtype_init_gives_the_cast_tree(arch):
    """A tree initialised in bf16 (``param_dtype=cfg.dtype``, as serving
    draws it) and cast by the engine equals the float32 init cast
    afterwards, bit for bit: each draw is made in float32 and rounded,
    and the leaves kept in float32 are zeros and ones."""
    cfg = get_config(arch, smoke=True).replace(dtype=torch.bfloat16)
    want = cast_params(pt.init_params(cfg, seed=3, device=CPU), cfg, CPU)
    drawn = pt.init_params(cfg.replace(param_dtype=cfg.dtype), seed=3,
                           device=CPU)
    got = cast_params(drawn, cfg, CPU)
    w, g = dict(_items(want)), dict(_items(got))
    assert w.keys() == g.keys()
    assert any(k.split("/")[-1] in FP32_LEAVES
               and g[k].dtype == torch.float32 for k in g)
    for key in w:
        assert g[key].dtype == w[key].dtype and torch.equal(g[key], w[key])


# --------------------------------------------------------------------- #
# loss, gradients, train step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["qwen2-moe-grouped", "mixtral-grouped"])
def test_loss_and_gradients_match_reference(ref, models, name):
    """Grouped dispatch with drops: loss, ce, moe_aux and the gradient of
    every leaf (router, experts, shared experts, attention) against
    ``jax.grad``."""
    rcfg, pcfg, rparams, _ = models(name, DROPS)
    batch = _batch(pcfg)
    (rloss, rparts), rgrads = jax.value_and_grad(
        lambda p: ref.transformer.loss_fn(p, rcfg, jax.tree.map(
            jnp.asarray, batch)), has_aux=True)(rparams)
    pparams = params_from_jax(rparams, CPU)
    leaves = dict(_items(pparams))
    for t in leaves.values():
        t.requires_grad_()
    loss, parts = pt.loss_fn(pparams, pcfg, _torch_batch(batch))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    _close_leaf(loss, rloss, what="loss")
    _close_leaf(parts["ce"], rparts["ce"], what="ce")
    _close_leaf(parts["moe_aux"], rparts["moe_aux"], what="moe_aux")
    assert float(parts["moe_aux"].detach()) > 0
    want = dict(_items(rgrads))
    assert grads.keys() == want.keys()
    assert any(key.startswith("blocks/moe/router") for key in grads)
    for key, g in grads.items():
        _close_leaf(g, want[key], what=key)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(ref, models, micro):
    """One AdamW step on qwen2-moe smoke, grouped with drops: metrics
    (microbatched, the reference's parts: ``ce`` is the loss and
    ``moe_aux`` 0) at 1e-4, and the updated parameters at 1e-4 plus the
    gradients' tolerance carried through Adam's first-step slope, as
    ``tests/test_torch_train.py``'s train-step test bounds them."""
    rcfg, pcfg, rparams, _ = models("qwen2-moe-grouped", DROPS)
    lr = 3e-4
    ropt = ref.optim.AdamWConfig(lr=lr)
    rstate = {"params": rparams,
              "opt_state": ref.optim.adamw_init(rparams, ropt)}
    pstate = params_from_jax(rstate, CPU)
    batch = _batch(pcfg, b=4)
    jbatch = jax.tree.map(jnp.asarray, batch)
    rgrads = dict(_items(jax.grad(lambda p: ref.transformer.loss_fn(
        p, rcfg, jbatch)[0])(rparams)))
    rstate, rm = jax.jit(ref.step.make_train_step(rcfg, ropt, micro))(
        rstate, jbatch)
    pstate, pm = make_train_step(pcfg, AdamWConfig(lr=lr), micro)(
        pstate, _torch_batch(batch))
    assert pm.keys() == rm.keys()
    for k in rm:
        _close_leaf(pm[k], rm[k], what=k)
    if micro > 1:
        assert float(pm["moe_aux"]) == 0.0
        assert float(pm["ce"]) == float(pm["loss"])
    else:
        assert float(pm["moe_aux"]) > 0
    got, eps = dict(_items(pstate["params"])), ropt.eps
    clip = min(1.0, ropt.grad_clip / float(rm["grad_norm"]))
    for key, want in _items(rstate["params"]):
        want = np.asarray(want)
        g = clip * np.abs(np.asarray(rgrads[key]))
        carried = np.minimum(2 * lr, lr * eps * 1e-4 * g.max() / (g + eps) ** 2)
        np.testing.assert_array_less(
            np.abs(got[key].float().numpy() - want),
            1e-4 * (np.abs(want) + np.abs(want).max()) + carried + 1e-30,
            err_msg=key)


@pytest.mark.parametrize("name", ["qwen2-moe-grouped", "mixtral-grouped"])
def test_bf16_moe_split_gives_the_mean_of_the_halves(ref, models, name):
    """What phase 18 of ``chip_smoke.py`` holds qwen2-moe-a2.7b to on the
    card, exactly on the CPU: a 2-microbatch bf16 step's gradients (read
    from the first moments) are the fp32 mean of the two half-batch
    steps' (rows 0, 2 and 1, 3, the strided split), bit for bit.  With
    groups of 32 tokens, two rows of 16, each half regroups its rows, so
    the kept sets and the aux loss's load fractions are the halves' own
    and the split's gradients differ from the unsplit step's."""
    rcfg, pcfg, rparams, _ = models(name, {**DROPS, "group_size": 32})
    pcfg = pcfg.replace(dtype=torch.bfloat16)
    rstate = {"params": rparams, "opt_state": ref.optim.adamw_init(
        rparams, ref.optim.AdamWConfig())}
    batch = _batch(pcfg, b=4)
    whole = _exact_grads(pcfg, rstate, batch, 1)
    halves = [_exact_grads(pcfg, rstate,
                           {k: v[j::2] for k, v in batch.items()}, 1)
              for j in range(2)]
    split = _exact_grads(pcfg, rstate, batch, 2)
    assert split.keys() == whole.keys()
    for key, g in split.items():
        assert torch.equal(g, (halves[0][key] + halves[1][key]) * 0.5), key
    assert not all(torch.equal(g, whole[k]) for k, g in split.items())


def test_trainer_loss_decreases_on_an_moe_model():
    """``Trainer`` on qwen2-moe smoke (grouped, with drops; the
    reference trainer test's sizes): 40 AdamW steps, every loss finite,
    the last five below the first five, as for the dense model."""
    cfg = _with_moe(get_config("qwen2-moe-a2.7b", smoke=True), DROPS)
    res = Trainer(cfg.replace(n_layers=2, vocab_size=128),
                  AdamWConfig(lr=3e-3, weight_decay=0.0),
                  DataConfig(global_batch=8, seq_len=32, seed=0),
                  TrainerConfig(total_steps=40, report_every=5),
                  device=CPU).run()
    assert res.steps_run == 40 and np.isfinite(res.losses).all()
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.1


# --------------------------------------------------------------------- #
# counts, conversion, launcher
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_counts_match_reference(ref, arch):
    rcfg = ref.registry.get_config(arch)
    cfg = get_config(arch)
    assert count_params(cfg) == ref.registry.count_params(rcfg)
    assert count_active_params(cfg) == ref.registry.count_active_params(rcfg)
    shapes = pt.init_params(cfg, device="meta")
    assert sum(t.numel() for _, t in _items(shapes)) == count_params(cfg)


def test_published_sizes():
    q = get_config("qwen2-moe-a2.7b")
    assert 14.3e9 < count_params(q) < 14.4e9
    assert 2.6e9 < count_active_params(q) < 2.8e9
    m = get_config("mixtral-8x7b")
    assert 46.6e9 < count_params(m) < 46.8e9


@pytest.mark.parametrize("name", ["qwen2-moe-grouped", "mixtral-grouped"])
def test_params_from_jax_carries_the_moe_tree(models, name):
    _, pcfg, rparams, pparams = models(name)
    want = dict(_items(rparams))
    got = dict(_items(pparams))
    meta = dict(_items(pt.init_params(pcfg, device="meta")))
    assert want.keys() == got.keys() == meta.keys()
    keys = {k for k in want if k.startswith("blocks/moe/")}
    expect = {"router", "up", "gate", "down"}
    if pcfg.moe.n_shared:
        expect |= {"shared_up", "shared_gate", "shared_down",
                   "shared_router"}
    assert {k.rsplit("/", 1)[1] for k in keys} == expect
    for key in want:
        assert tuple(got[key].shape) == want[key].shape == tuple(
            meta[key].shape)
        assert got[key].dtype == torch.float32 == meta[key].dtype
        assert np.asarray(want[key]).dtype == np.float32


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.init_params(get_config("qwen2-moe-a2.7b", smoke=True))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_launcher_serves_moe_archs_on_the_cpu(capsys, arch):
    assert port_launch.main(["--arch", arch, "--smoke", "--batch", "2",
                             "--prompt-len", "4", "--new-tokens", "3",
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}-smoke: generated 2x3 tokens" in out
