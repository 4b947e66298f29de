"""The port's models and serving engine against the JAX reference.

The reference's parameters (``repro.models.transformer.init_params``)
are carried across with ``params_from_jax``, so both packages compute
the same function; logits, caches and greedy tokens are compared in fp32
on the CPU at rtol = atol = 1e-4 (the same arithmetic in two frameworks,
with different summation orders).  Each ``attn_impl`` is compared with
the reference's own (flash in Pallas interpret mode), since the
reference's ``ref`` path casts probabilities to ``cfg.dtype`` before PV
where flash keeps them in fp32.  Likewise each ``ssm_impl``: the port's
``pallas`` path (the SSD and WKV6 plain recurrences on the CPU) against
the reference's interpret-mode kernels, ``ref`` against ``ref``.

``repro.models`` imports the missing ``repro.dist`` package.  The
``reference`` fixture stubs it in ``sys.modules`` for this module only
and afterwards removes the stub and every ``repro.*`` module imported
under it, so that no other test file in the same worker can import the
reference models through a leftover stub.
"""
import importlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ssd  # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6  # noqa: E402
from repro_torch.launch import serve as port_launch  # noqa: E402
from repro_torch.models import count_params, get_config  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import leaves  # noqa: E402
from repro_torch.serve import (ServeEngine, make_decode_step,  # noqa: E402
                               make_prefill_step)
from repro_torch.serve.engine import cast_params  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
# name -> (arch, overrides); all smoke configs, fp32
PALLAS = {"ssm_impl": "pallas"}
MAMBA2 = {"block": "mamba2"}
SSM_MODELS = {"zamba2": ("zamba2-1.2b", {}),
              "zamba2-pallas": ("zamba2-1.2b", PALLAS),
              "mamba2": ("zamba2-1.2b", MAMBA2),
              "mamba2-pallas": ("zamba2-1.2b", {**MAMBA2, **PALLAS}),
              "rwkv6": ("rwkv6-7b", {}),
              "rwkv6-pallas": ("rwkv6-7b", PALLAS)}
MODELS = {"deepseek": ("deepseek-7b", {}),
          "qwen3": ("qwen3-32b", {}),
          "deepseek-swa8": ("deepseek-7b", {"sliding_window": 8}),
          **SSM_MODELS}
# leaves the reference reads in float32 (rmsnorm weights, the SSM decay
# parameters, RWKV6's bonus u in decode): named here, not taken from the
# engine, so that a leaf the engine wrongly casts is caught
REFERENCE_FP32 = {"norm1", "norm2", "final_norm", "q_norm", "k_norm",
                  "norm", "ln_x", "a_log", "dt_bias", "w0", "u"}


def _is_reference(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


@pytest.fixture(scope="module")
def reference():
    """The reference's model stack, imported through a stub of the
    missing ``repro.dist`` (identity ``constrain_batch``,
    ``constrain_seq`` and ``constrain_attn_seq``, empty ``sharding``);
    ``sys.modules`` and the parent packages' attributes are restored
    afterwards."""
    before = {n for n in sys.modules if _is_reference(n)}
    dist = types.ModuleType("repro.dist")
    context = types.ModuleType("repro.dist.context")
    context.constrain_batch = lambda x, exact=False: x
    context.constrain_seq = lambda x: x
    context.constrain_attn_seq = lambda q, k, v: (q, k, v, None)
    sharding = types.ModuleType("repro.dist.sharding")
    dist.context, dist.sharding = context, sharding
    sys.modules.update({"repro.dist": dist, "repro.dist.context": context,
                        "repro.dist.sharding": sharding})
    try:
        yield types.SimpleNamespace(
            registry=importlib.import_module("repro.models.registry"),
            transformer=importlib.import_module("repro.models.transformer"),
            engine=importlib.import_module("repro.serve.engine"),
            configs=importlib.import_module("repro.configs"),
            mamba2=importlib.import_module("repro.models.mamba2"),
            rwkv6=importlib.import_module("repro.models.rwkv6"))
    finally:
        for name in sorted(n for n in sys.modules
                           if _is_reference(n) and n not in before):
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if getattr(sys.modules.get(parent), child, None) is mod:
                delattr(sys.modules[parent], child)


@pytest.fixture(scope="module")
def models(reference):
    """name -> (reference cfg, port cfg, reference params, port params),
    built once per name for this module."""
    built = {}

    def get(name):
        if name not in built:
            arch, over = MODELS[name]
            rcfg = reference.registry.get_config(arch, smoke=True).replace(
                **over)
            pcfg = get_config(arch, smoke=True).replace(**over)
            rparams, _ = reference.transformer.init_params(
                rcfg, jax.random.key(0))
            built[name] = (rcfg, pcfg, rparams,
                           params_from_jax(rparams, CPU))
        return built[name]
    return get


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _flat(tree: dict, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _launches() -> tuple[int, int, int]:
    return flash_attention.launches, ssd.launches, wkv6.launches


@pytest.mark.parametrize("impl", ["ref", "flash", "blocked"])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_reference(reference, models, name, impl):
    rcfg, pcfg, rparams, pparams = models(name)
    toks = _tokens(pcfg, (2, 32), seed=1)
    want, _ = reference.transformer.forward(
        rparams, rcfg.replace(attn_impl=impl), {"tokens": jnp.asarray(toks)})
    got, aux = pt.forward(pparams, pcfg.replace(attn_impl=impl),
                          {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 32, pcfg.vocab_size) and float(aux) == 0.0
    _close(got, want)


def test_prefill_step_on_the_cpu_launches_no_kernel(models):
    _, pcfg, _, pparams = models("qwen3")
    toks = torch.from_numpy(_tokens(pcfg, (2, 32), seed=2)).long()
    before = flash_attention.launches
    flash = make_prefill_step(pcfg.replace(attn_impl="flash"))(
        pparams, {"tokens": toks})
    ref = make_prefill_step(pcfg.replace(attn_impl="ref"))(
        pparams, {"tokens": toks})
    assert flash_attention.launches == before
    torch.testing.assert_close(flash, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_decode_matches_reference(reference, models, name, kv_quant):
    """12 decode steps (past the ring of 8 slots for the SWA model),
    logits at every step and every cache leaf at the end (KV caches, SSM
    and conv states, WKV states and token-shift carries)."""
    rcfg, pcfg, rparams, pparams = models(name)
    rcfg, pcfg = (c.replace(kv_quant=kv_quant) for c in (rcfg, pcfg))
    max_len = reference.engine.cache_max_len(rcfg, 16)
    rcache, _ = reference.transformer.init_cache_arrays(rcfg, 2, max_len)
    pcache = pt.init_cache_arrays(pcfg, 2, max_len, CPU)
    rdecode = jax.jit(reference.engine.make_decode_step(rcfg))
    pdecode = make_decode_step(pcfg)
    toks = _tokens(pcfg, (2, 12), seed=3)
    for t in range(12):
        want, rcache = rdecode(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
        got, pcache = pdecode(pparams, pcache,
                              torch.from_numpy(toks[:, t:t + 1]).long(), t)
        _close(got, want)
    want_leaves, got_leaves = dict(_flat(rcache)), dict(_flat(pcache))
    assert set(want_leaves) == set(got_leaves)
    for path, want in want_leaves.items():
        got = got_leaves[path]
        assert tuple(got.shape) == want.shape
        if kv_quant and path[-1] in ("k", "v"):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want)


def test_decode_logits_match_prefill(models):
    """The last prompt position's logits from token-by-token decode
    equal the prefill's."""
    _, pcfg, _, pparams = models("qwen3")
    toks = torch.from_numpy(_tokens(pcfg, (2, 16), seed=4)).long()
    prefill = make_prefill_step(pcfg.replace(attn_impl="flash"))(
        pparams, {"tokens": toks})
    decode = make_decode_step(pcfg)
    cache = pt.init_cache(pcfg, 2, 16, CPU)
    for t in range(16):
        logits, cache = decode(pparams, cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits[:, 0], prefill[:, -1], **TOL)


@pytest.mark.parametrize("name", ["zamba2-pallas", "mamba2-pallas",
                                  "rwkv6-pallas"])
def test_ssm_decode_logits_match_prefill(models, name):
    """Token-by-token decode (the single-step recurrences) ends on the
    logits of the prefill (the chunked scans, whose ops on CPU tensors
    take their plain versions and launch no kernel)."""
    _, pcfg, _, pparams = models(name)
    toks = torch.from_numpy(_tokens(pcfg, (2, 16), seed=4)).long()
    before = _launches()
    prefill = make_prefill_step(pcfg.replace(attn_impl="flash"))(
        pparams, {"tokens": toks})
    assert _launches() == before
    decode = make_decode_step(pcfg)
    cache = pt.init_cache(pcfg, 2, 16, CPU)
    for t in range(16):
        logits, cache = decode(pparams, cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits[:, 0], prefill[:, -1], **TOL)


@pytest.mark.parametrize("name", ["zamba2", "mamba2", "rwkv6"])
def test_decode_continues_from_a_converted_reference_cache(reference, models,
                                                           name):
    """The reference's decode state after 6 tokens, carried across with
    ``params_from_jax``, lets the port continue with the same logits."""
    rcfg, pcfg, rparams, pparams = models(name)
    rcache, _ = reference.transformer.init_cache_arrays(rcfg, 2, 12)
    rdecode = jax.jit(reference.engine.make_decode_step(rcfg))
    toks = _tokens(pcfg, (2, 12), seed=7)
    for t in range(6):
        _, rcache = rdecode(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
    pcache = params_from_jax(rcache, CPU)
    pdecode = make_decode_step(pcfg)
    for t in range(6, 12):
        want, rcache = rdecode(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
        got, pcache = pdecode(pparams, pcache,
                              torch.from_numpy(toks[:, t:t + 1]).long(), t)
        _close(got, want)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_rwkv6_seq_carries_state_like_the_reference(reference, models, impl):
    """The time-mix with a carried token shift and WKV state, returning
    its own, against the reference under each ``ssm_impl`` (``pallas``
    hands the state to the op, which takes it itself)."""
    rcfg, pcfg, rparams, _ = models("rwkv6")
    rcfg, pcfg = (c.replace(ssm_impl=impl) for c in (rcfg, pcfg))
    nh, hd = pcfg.d_model // pcfg.rwkv.head_dim, pcfg.rwkv.head_dim
    rng = np.random.default_rng(8)
    p = {k: np.asarray(v[0]) for k, v in rparams["blocks"]["tmix"].items()}
    p["u"] = (0.5 * rng.standard_normal((nh, hd))).astype(np.float32)
    p["w0"] = (0.5 * rng.standard_normal((nh, hd))).astype(np.float32)
    x, shift = (rng.standard_normal((2, n, pcfg.d_model)).astype(np.float32)
                for n in (16, 1))
    S0 = (0.5 * rng.standard_normal((2, nh, hd, hd))).astype(np.float32)
    want, want_state = reference.rwkv6.rwkv6_seq(
        {k: jnp.asarray(v) for k, v in p.items()}, rcfg, jnp.asarray(x),
        jnp.asarray(shift), jnp.asarray(S0), return_state=True)
    got, got_state = rwkv6.rwkv6_seq(
        params_from_jax(p, CPU), pcfg, torch.from_numpy(x),
        torch.from_numpy(shift), torch.from_numpy(S0), return_state=True)
    _close(got, want)
    for g, w in zip(got_state, want_state):
        _close(g, w)


@pytest.mark.parametrize("name", list(MODELS))
def test_generate_matches_reference(reference, models, name):
    rcfg, pcfg, rparams, pparams = models(name)
    prompts = _tokens(pcfg, (2, 6), seed=5)
    want = reference.engine.ServeEngine(rcfg, rparams, max_len=16).generate(
        prompts, 8)
    got = ServeEngine(pcfg, pparams, max_len=16, device="cpu").generate(
        prompts, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def _fill_fp32_leaves(tree: dict, rng: np.random.Generator) -> dict:
    """A copy of ``tree`` whose ``REFERENCE_FP32`` leaves hold values that
    bf16 cannot represent (at their 0/1 init a bf16 copy is exact, and a
    leaf wrongly cast to bf16 would go unseen)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill_fp32_leaves(v, rng)
        elif k in REFERENCE_FP32:
            vals = 1.0 + 0.1 * rng.standard_normal(tuple(v.shape))
            out[k] = torch.from_numpy(vals.astype(np.float32))
            assert not torch.equal(out[k], out[k].bfloat16().float())
        else:
            out[k] = v
    return out


def test_engine_cast_once_gives_the_per_use_cast_numbers(models):
    """bf16 compute: weights cast once (the leaves the reference reads in
    fp32 kept in fp32) give the same logits, bit for bit, as casting at
    every use: decode for the dense, hybrid and RWKV6 models, and the
    prefill of both ``ssm_impl`` paths for the last two."""
    rng = np.random.default_rng(6)
    for name in ("qwen3", "zamba2", "rwkv6"):
        _, pcfg, _, pparams = models(name)
        cfg = pcfg.replace(dtype=torch.bfloat16)
        params = _fill_fp32_leaves(pparams, rng)
        cast = cast_params(params, cfg, CPU)
        kept = [(path, leaf) for path, leaf in _flat(cast)
                if path[-1] in REFERENCE_FP32]
        assert kept and all(leaf.dtype == torch.float32 for _, leaf in kept)
        assert all(leaf.dtype == torch.bfloat16 for path, leaf in _flat(cast)
                   if path[-1] not in REFERENCE_FP32)
        toks = torch.from_numpy(_tokens(cfg, (2, 8), seed=6)).long()
        decode = make_decode_step(cfg)
        caches = [pt.init_cache(cfg, 2, 8, CPU) for _ in range(2)]
        for t in range(8):
            a, caches[0] = decode(params, caches[0], toks[:, t:t + 1], t)
            b, caches[1] = decode(cast, caches[1], toks[:, t:t + 1], t)
            assert torch.equal(a, b), (name, t)
        if name == "qwen3":
            continue
        for impl in ("ref", "pallas"):
            prefill = make_prefill_step(cfg.replace(ssm_impl=impl))
            assert torch.equal(prefill(params, {"tokens": toks}),
                               prefill(cast, {"tokens": toks})), (name, impl)


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-32b",
                                  "deepseek-67b", "qwen1.5-32b",
                                  "zamba2-1.2b", "rwkv6-7b",
                                  "qwen2-moe-a2.7b", "mixtral-8x7b",
                                  "hubert-xlarge", "pixtral-12b"])
def test_count_params_matches_reference(reference, arch):
    """Full-size counts: meta-device init against JAX abstract init."""
    want = reference.registry.count_params(
        reference.registry.get_config(arch))
    cfg = get_config(arch)
    assert count_params(cfg) == want == cfg.n_params()


def test_deepseek_7b_is_the_published_size():
    cfg = get_config("deepseek-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
                30, 4096, 32, 32, 128, 11008, 102400)
    assert 6.8e9 < count_params(cfg) < 7.0e9
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32


def test_params_from_jax_keeps_keys_layouts_and_cache_types(reference,
                                                            models):
    rcfg, pcfg, rparams, pparams = models("qwen3")
    assert pparams["blocks"]["attn"]["wq"].shape == (2, 64, 8, 16)
    shapes = pt.init_params(pcfg, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    assert len(flat) == sum(1 for _ in leaves(pparams))
    for path, leaf in flat:
        keys = [p.key for p in path]
        node, meta = pparams, shapes
        for k in keys:
            node, meta = node[k], meta[k]
        assert tuple(node.shape) == leaf.shape == tuple(meta.shape)
    cache, _ = reference.transformer.init_cache_arrays(
        rcfg.replace(kv_quant=True), 2, 8)
    pc = params_from_jax(cache, CPU)
    assert pc["kv"]["k"].dtype == torch.int8
    assert pc["kv"]["k_scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["zamba2", "rwkv6"])
def test_params_from_jax_carries_the_ssm_trees(reference, models, name):
    """zamba2's mamba_groups / mamba_tail / shared and rwkv6's tmix /
    cmix leaves, and the SSM cache trees, carry across with the
    reference's keys, shapes and types."""
    rcfg, pcfg, rparams, pparams = models(name)
    shapes = pt.init_params(pcfg, device="meta")
    want = {path: leaf for path, leaf in _flat(rparams)}
    assert set(want) == {path for path, _ in _flat(pparams)} == {
        path for path, _ in _flat(shapes)}
    meta = dict(_flat(shapes))
    for path, leaf in _flat(pparams):
        assert tuple(leaf.shape) == want[path].shape == tuple(
            meta[path].shape)
    groups = {path[0] for path in want}
    assert groups >= ({"mamba_groups", "mamba_tail", "shared"}
                      if name == "zamba2" else {"blocks"})
    rcache, _ = reference.transformer.init_cache_arrays(rcfg, 2, 8)
    pcache = params_from_jax(rcache, CPU)
    mine = pt.init_cache(pcfg, 2, 8, CPU)
    assert {p for p, _ in _flat(pcache)} == {p for p, _ in _flat(mine)}
    for path, leaf in _flat(mine):
        other = dict(_flat(pcache))[path]
        assert leaf.shape == other.shape and leaf.dtype == other.dtype


def test_default_device_raises_without_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pcfg, _, pparams = models("deepseek")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(pcfg, pparams)
    with pytest.raises(RuntimeError, match="cuda"):
        pt.init_params(pcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        port_launch.main(["--arch", "deepseek-7b", "--smoke"])


def test_launcher_serves_on_the_cpu(capsys):
    assert port_launch.main(["--arch", "deepseek-7b", "--smoke", "--batch",
                             "2", "--prompt-len", "4", "--new-tokens", "3",
                             "--device", "cpu", "--kv-quant"]) == 0
    out = capsys.readouterr().out
    assert "deepseek-7b-smoke: generated 2x3 tokens" in out


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_launcher_serves_ssm_archs_on_the_cpu(capsys, arch):
    assert port_launch.main(["--arch", arch, "--smoke", "--batch", "2",
                             "--prompt-len", "4", "--new-tokens", "3",
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}-smoke: generated 2x3 tokens" in out


@pytest.mark.parametrize("arch", ["hubert-xlarge", "pixtral-12b"])
def test_frontend_families_init_on_the_cpu(arch):
    """The audio and vision families build (tests/test_torch_frontends.py
    holds them against the reference): hubert's frontend takes the
    embedding's place, pixtral adds its adapter."""
    cfg = get_config(arch, smoke=True)
    params = pt.init_params(cfg, device="cpu")
    assert ("frontend" in params) != ("embed" in params)
    assert ("adapter" in params) == (cfg.frontend == "vision")
    assert sum(t.numel() for t in leaves(params)) == count_params(cfg)


@pytest.mark.parametrize("impl", ["ref", "flash", "blocked"])
def test_sequence_parallel_attention_without_a_mesh_is_the_reference(
        reference, models, impl):
    """``attn_sp`` outside a mesh context (plain tensors): the port's
    constraints are identities, as the reference's stub makes its own,
    and both forwards agree."""
    rcfg, pcfg, rparams, pparams = models("deepseek")
    toks = _tokens(pcfg, (2, 32), seed=4)
    want, _ = reference.transformer.forward(
        rparams, rcfg.replace(attn_impl=impl, attn_sp=True),
        {"tokens": jnp.asarray(toks)})
    got, _ = pt.forward(pparams, pcfg.replace(attn_impl=impl, attn_sp=True),
                        {"tokens": torch.from_numpy(toks).long()})
    _close(got, want)
