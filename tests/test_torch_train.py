"""The port's training stack against the JAX reference.

Optimizer, schedules, compression, data pipeline, loss and gradients,
remat, train step, checkpoints and trainer of ``repro_torch`` against
``repro``'s on the same inputs, on the CPU at smoke size.  The
reference's parameters and train state are carried across with
``params_from_jax``.  Tolerances: schedules 1e-7; AdamW 1e-6; data and
int8 payloads exact; losses, gradients (atol scaled to the leaf's
largest magnitude) and train steps 1e-4; remat policies against no remat
1e-6; resumed losses 1e-4; a bf16 train step's loss and grad norm 3e-4,
its gradients 0.2 of a leaf's largest (``BF16_LOSS_TOL``,
``BF16_GRAD_TOL``), and its bf16 gradients and fp32 accumulation exact.

``repro.data``, ``repro.train`` and the reference's models import the
missing ``repro.dist``; they are imported under the ``reference``
fixture of ``tests/test_torch_models.py``, which removes them again on
teardown.
"""
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.checkpoint import (CheckpointManager, restore_tree,  # noqa: E402
                                    save_tree)
from repro_torch.core import (Client, HopaasServer,  # noqa: E402
                              HttpServiceRunner, HttpTransport)
from repro_torch.data import (DataConfig, SyntheticLMDataset,  # noqa: E402
                              make_batch_specs)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch import worker as worker_launch  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import mamba2 as pmamba2  # noqa: E402
from repro_torch.models import rwkv6 as prwkv6  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, compress_int8, constant,
                               cosine_warmup, decompress_int8, global_norm,
                               linear_warmup)
from repro_torch.optim import compression  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig,  # noqa: E402
                               hopaas_objective, init_train_state,
                               make_train_step)
from test_torch_models import reference  # noqa: E402,F401  (the stub)

torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
# name -> (arch, overrides); smoke configs, fp32, ssm_impl="ref"
MODELS = {"deepseek": ("deepseek-7b", {}),
          "qwen3": ("qwen3-32b", {}),
          "deepseek-swa8": ("deepseek-7b", {"sliding_window": 8}),
          "zamba2": ("zamba2-1.2b", {}),
          "rwkv6": ("rwkv6-7b", {})}


@pytest.fixture(scope="module")
def ref(reference):
    """The ``reference`` fixture's modules and the reference's training
    stack, imported under its stub."""
    return types.SimpleNamespace(
        **vars(reference),
        optim=importlib.import_module("repro.optim"),
        compression=importlib.import_module("repro.optim.compression"),
        data=importlib.import_module("repro.data"),
        checkpoint=importlib.import_module("repro.checkpoint"),
        step=importlib.import_module("repro.train.step"),
        trainer=importlib.import_module("repro.train.trainer"))


# --------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------- #
def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _items(tree: dict, prefix: str = ""):
    """(``/``-joined path, leaf) pairs of a nested dict, sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _close_leaf(got, want, tol: float = TOL, what: str = "") -> None:
    """rtol = tol, atol = tol times the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(scale, 1e-30), err_msg=what)


def _close_trees(got: dict, want: dict, tol: float = TOL) -> None:
    g, w = dict(_items(got)), dict(_items(want))
    assert g.keys() == w.keys()
    for key in w:
        _close_leaf(g[key], w[key], tol, key)


def _cfgs(ref, name: str, **over):
    arch, base = MODELS[name]
    rcfg = ref.registry.get_config(arch, smoke=True).replace(**base, **over)
    pcfg = get_config(arch, smoke=True).replace(**base, **over)
    return rcfg, pcfg


def _ref_params(ref, rcfg, seed: int = 0) -> dict:
    return ref.transformer.init_params(rcfg, jax.random.key(seed))[0]


def _batch(pcfg, b: int = 2, s: int = 16, seed: int = 0) -> dict:
    return SyntheticLMDataset(DataConfig(b, s, seed=seed), pcfg)[0]


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _port_grads(pcfg, pparams: dict, batch: dict):
    leaves = dict(_items(pparams))
    for t in leaves.values():
        t.requires_grad_()
    loss, parts = pt.loss_fn(pparams, pcfg, _torch_batch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, parts, dict(zip(leaves, grads))


def _small(micro: int = 1, total_steps: int = 30, ckpt_dir=None,
           ckpt_every: int = 0, package=None):
    """The reference's trainer test configuration, in either package."""
    if package is None:
        mcfg = get_config("deepseek-7b", smoke=True)
        opt_cls, data_cls, tcfg_cls = AdamWConfig, DataConfig, TrainerConfig
    else:
        mcfg = package.registry.get_config("deepseek-7b", smoke=True)
        opt_cls = package.optim.AdamWConfig
        data_cls = package.data.DataConfig
        tcfg_cls = package.trainer.TrainerConfig
    mcfg = mcfg.replace(n_layers=2, d_model=64, d_ff=128, vocab_size=128)
    return (mcfg, opt_cls(lr=3e-3, weight_decay=0.0),
            data_cls(global_batch=8, seq_len=32, seed=0),
            tcfg_cls(total_steps=total_steps, microbatches=micro,
                     report_every=5, checkpoint_every=ckpt_every,
                     checkpoint_dir=ckpt_dir))


# --------------------------------------------------------------------- #
# schedules, AdamW, compression
# --------------------------------------------------------------------- #
SCHEDULES = {"constant": ((3e-4,), {}),
             "linear_warmup": ((1e-3, 10), {}),
             "cosine_warmup": ((1e-3, 10, 100), {"floor": 0.1})}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(ref, name):
    args, kw = SCHEDULES[name]
    mine = getattr(sys.modules["repro_torch.optim.schedules"], name)(*args,
                                                                    **kw)
    theirs = getattr(ref.optim, name)(*args, **kw)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = np.float32(theirs(jnp.int32(s)))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = mine(step)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-7,
                                       atol=1e-12)


def _opt_tree(seed: int, huge: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    f = 1e3 if huge else 1.0
    return {"w": (rng.standard_normal((6, 5)) * f).astype(np.float32),
            "blk": {"m": (rng.standard_normal((2, 4, 3)) * f
                          ).astype(np.float32),
                    "b": (rng.standard_normal((4,)) * f).astype(np.float32)},
            "s": (rng.standard_normal(()) * f).astype(np.float32)}


ADAMW_CASES = {
    "clipped": dict(lr=1e-2, grad_clip=1.0, huge=True),
    "unclipped": dict(lr=1e-2, grad_clip=0.0, huge=False),
    "decay-and-schedule": dict(lr="cosine", grad_clip=1.0, huge=False,
                               weight_decay=0.5),
}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_matches_reference(ref, case):
    """Three updates on identical grads, state and params: clipping, no
    decay on vectors and scalars, the schedule read at the new step."""
    c = dict(ADAMW_CASES[case])
    huge = c.pop("huge")
    lr = c.pop("lr")
    rcfg = ref.optim.AdamWConfig(
        lr=ref.optim.cosine_warmup(1e-2, 2, 10) if lr == "cosine" else lr,
        **c)
    pcfg = AdamWConfig(lr=cosine_warmup(1e-2, 2, 10) if lr == "cosine"
                       else lr, **c)
    rp = jax.tree.map(jnp.asarray, _opt_tree(0))
    pp = params_from_jax(_opt_tree(0), CPU)
    ropt, popt = ref.optim.adamw_init(rp, rcfg), adamw_init(pp, pcfg)
    for i in range(3):
        g = _opt_tree(10 + i, huge)
        gt = params_from_jax(g, CPU)
        rp, ropt, rm = ref.optim.adamw_update(jax.tree.map(jnp.asarray, g),
                                              ropt, rp, rcfg)
        pp, popt, pm = adamw_update(gt, popt, pp, pcfg)
        np.testing.assert_array_equal(_np(gt["w"]), g["w"])  # not modified
        for key, want in _items(rp):
            np.testing.assert_allclose(_np(dict(_items(pp))[key]), want,
                                       rtol=1e-6, atol=1e-6, err_msg=key)
        for part in ("m", "v"):
            for key, want in _items(ropt[part]):
                np.testing.assert_allclose(
                    _np(dict(_items(popt[part]))[key]), want, rtol=1e-6,
                    atol=1e-6, err_msg=f"{part}/{key}")
        assert int(popt["step"]) == int(ropt["step"]) == i + 1
        assert popt["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=1e-6)


def test_global_norm_matches_reference(ref):
    tree = _opt_tree(3)
    np.testing.assert_allclose(
        float(global_norm(params_from_jax(tree, CPU))),
        float(ref.optim.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=1e-6)


@pytest.mark.parametrize("shape", [(7,), (8, 32), (2, 3, 16)])
def test_int8_round_trip_equals_reference(ref, shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 3).astype(
        np.float32)
    x.flat[0] = 0.5 * np.abs(x).max()         # a tie at the scale's half
    q, s = compress_int8(torch.from_numpy(x))
    rq, rs = ref.optim.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == rs.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(decompress_int8(q, s).numpy(),
                                  np.asarray(ref.optim.decompress_int8(rq,
                                                                       rs)))


def test_compression_tree_and_error_feedback_match_reference(ref):
    tree = _opt_tree(4)
    mine = compression.decompress_tree(compression.compress_tree(
        params_from_jax(tree, CPU)))
    theirs = ref.compression.decompress_tree(ref.compression.compress_tree(
        jax.tree.map(jnp.asarray, tree)))
    for key, want in _items(theirs):
        np.testing.assert_array_equal(_np(dict(_items(mine))[key]),
                                      np.asarray(want))
    g, r = tree["w"], _opt_tree(5)["w"] * 1e-2
    got = compression.error_feedback_compress(torch.from_numpy(g),
                                              torch.from_numpy(r))
    want = ref.compression.error_feedback_compress(jnp.asarray(g),
                                                   jnp.asarray(r))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# behaviours of tests/substrate/test_optim.py, on the port
def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    opt = adamw_init(params, cfg)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    l0 = float(loss(params))
    for _ in range(200):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        params, opt, _ = adamw_update(g, opt, params, cfg)
    assert float(loss(params)) < 1e-3 * l0


def test_grad_clip_bounds_update():
    params = {"w": torch.ones((4, 4))}
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    opt = adamw_init(params, cfg)
    _, _, metrics = adamw_update({"w": torch.full((4, 4), 1e6)}, opt,
                                 params, cfg)
    assert float(metrics["grad_norm"]) > 1e5       # reported pre-clip


def test_weight_decay_only_on_matrices():
    params = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    cfg = AdamWConfig(lr=0.1, weight_decay=1.0, grad_clip=0.0)
    opt = adamw_init(params, cfg)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    new_p, _, _ = adamw_update(zero_g, opt, params, cfg)
    assert float(new_p["w"].abs().max()) < 1.0     # decayed
    assert torch.equal(new_p["b"], torch.ones((2,)))  # not decayed


def test_bf16_moments_follow_the_reference_update(ref):
    """Moments stored in bf16: the update reads the unrounded fp32
    moments, as the reference's does."""
    rcfg = ref.optim.AdamWConfig(lr=1e-2, moment_dtype=jnp.bfloat16)
    pcfg = AdamWConfig(lr=1e-2, moment_dtype=torch.bfloat16)
    rp = jax.tree.map(jnp.asarray, _opt_tree(0))
    pp = params_from_jax(_opt_tree(0), CPU)
    ropt, popt = ref.optim.adamw_init(rp, rcfg), adamw_init(pp, pcfg)
    for i in range(2):
        g = _opt_tree(20 + i)
        rp, ropt, _ = ref.optim.adamw_update(jax.tree.map(jnp.asarray, g),
                                             ropt, rp, rcfg)
        pp, popt, _ = adamw_update(params_from_jax(g, CPU), popt, pp, pcfg)
    assert popt["m"]["w"].dtype == torch.bfloat16
    _close_trees(pp, rp, 1e-6)
    _close_trees(popt["m"], ropt["m"], 1e-2)


def test_schedules_shape():
    f = cosine_warmup(1.0, warmup=10, total=100)
    lrs = [float(f(s)) for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert abs(max(lrs) - 1.0) < 0.01
    assert lrs[-1] <= 0.2                           # decayed to ~floor
    assert float(linear_warmup(2.0, 4)(2)) == 1.0
    assert float(constant(0.5)(torch.tensor(7))) == 0.5


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.floats(0.01, 100.0))
def test_int8_compression_roundtrip_error_bounded(seed, scale):
    """Property: |x - dec(enc(x))| <= max|row| / 127 elementwise."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((8, 32)) * scale).astype(
        np.float32))
    q, s = compress_int8(x)
    err = (decompress_int8(q, s) - x).abs()
    bound = x.abs().amax(dim=-1, keepdim=True) / 127.0
    assert bool((err <= bound + 1e-6).all())
    assert q.dtype == torch.int8


def test_global_norm():
    t = {"a": torch.ones((3,)), "b": torch.full((4,), 2.0)}
    assert abs(float(global_norm(t)) - np.sqrt(3 + 16)) < 1e-5


# --------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_batches_equal_the_reference_bit_for_bit(ref, seed):
    rcfg, pcfg = _cfgs(ref, "deepseek")
    for dc in (dict(global_batch=4, seq_len=32, seed=seed),
               dict(global_batch=4, seq_len=16, seed=seed, host_index=1,
                    host_count=2)):
        mine = SyntheticLMDataset(DataConfig(**dc), pcfg)
        theirs = ref.data.SyntheticLMDataset(ref.data.DataConfig(**dc), rcfg)
        for i in (0, 5, 1000):
            a, b = mine[i], theirs[i]
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["hubert-xlarge", "pixtral-12b"])
def test_frontend_batches_equal_the_reference(ref, arch):
    pcfg = get_config(arch, smoke=True)
    rcfg = ref.registry.get_config(arch, smoke=True)
    mine = SyntheticLMDataset(DataConfig(2, 8, seed=3), pcfg)[4]
    theirs = ref.data.SyntheticLMDataset(ref.data.DataConfig(2, 8, seed=3),
                                         rcfg)[4]
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])


@pytest.mark.parametrize("arch", ["deepseek-7b", "hubert-xlarge",
                                  "pixtral-12b"])
def test_batch_specs_match_reference(ref, arch):
    mine = make_batch_specs(get_config(arch, smoke=True), 4, 16)
    theirs = ref.data.make_batch_specs(ref.registry.get_config(
        arch, smoke=True), 4, 16)
    assert mine.keys() == theirs.keys()
    for k, spec in mine.items():
        assert spec.shape == theirs[k].shape
        assert str(spec.dtype).split(".")[-1] == str(theirs[k].dtype)


# behaviours of tests/substrate/test_data_checkpoint.py, on the port
def test_batches_deterministic():
    mcfg = get_config("deepseek-7b", smoke=True)
    d1 = SyntheticLMDataset(DataConfig(8, 32, seed=7), mcfg)
    d2 = SyntheticLMDataset(DataConfig(8, 32, seed=7), mcfg)
    for i in (0, 5, 1000):
        np.testing.assert_array_equal(d1[i]["tokens"], d2[i]["tokens"])
    assert not np.array_equal(d1[0]["tokens"], d1[1]["tokens"])


def test_host_sharding_partitions_global_batch():
    mcfg = get_config("deepseek-7b", smoke=True)
    full = SyntheticLMDataset(DataConfig(8, 16, seed=3), mcfg)
    h0 = SyntheticLMDataset(DataConfig(8, 16, seed=3, host_index=0,
                                       host_count=2), mcfg)
    h1 = SyntheticLMDataset(DataConfig(8, 16, seed=3, host_index=1,
                                       host_count=2), mcfg)
    assert h0[0]["tokens"].shape == (4, 16)
    assert full[0]["tokens"].shape == (8, 16)
    assert not np.array_equal(h0[0]["tokens"], h1[0]["tokens"])


def test_labels_are_shifted_tokens():
    ds = SyntheticLMDataset(DataConfig(4, 32, seed=1),
                            get_config("deepseek-7b", smoke=True))
    b = ds[0]
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_audio_batch_shapes():
    cfg = get_config("hubert-xlarge", smoke=True)
    b = SyntheticLMDataset(DataConfig(4, 16, seed=0), cfg)[0]
    assert b["features"].shape == (4, 16, cfg.frontend_dim)
    assert b["frame_mask"].dtype == bool
    assert b["labels"].max() < cfg.vocab_size


# --------------------------------------------------------------------- #
# loss, gradients, remat
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_gradients_match_reference(ref, name):
    rcfg, pcfg = _cfgs(ref, name)
    rparams = _ref_params(ref, rcfg)
    batch = _batch(pcfg)
    (rloss, rparts), rgrads = jax.value_and_grad(
        lambda p: ref.transformer.loss_fn(p, rcfg, jax.tree.map(
            jnp.asarray, batch)), has_aux=True)(rparams)
    loss, parts, grads = _port_grads(pcfg, params_from_jax(rparams, CPU),
                                     batch)
    _close_leaf(loss, rloss, what="loss")
    _close_leaf(parts["ce"], rparts["ce"], what="ce")
    # no arch of MODELS has an MoE layer (tests/test_torch_moe.py checks
    # the aux loss of those that do)
    assert float(parts["moe_aux"]) == float(rparts["moe_aux"]) == 0.0
    want = dict(_items(rgrads))
    assert grads.keys() == want.keys()
    for key, g in grads.items():
        assert g.dtype == torch.float32
        _close_leaf(g, want[key], what=key)


def test_masked_loss_matches_reference(ref):
    rcfg, pcfg = _cfgs(ref, "deepseek")
    rparams = _ref_params(ref, rcfg)
    batch = dict(_batch(pcfg))
    batch["loss_mask"] = np.random.default_rng(0).random(
        batch["labels"].shape) < 0.5
    rloss, _ = ref.transformer.loss_fn(rparams, rcfg, jax.tree.map(
        jnp.asarray, batch))
    loss, _, grads = _port_grads(pcfg, params_from_jax(rparams, CPU), batch)
    _close_leaf(loss, rloss)
    batch["loss_mask"] = np.zeros_like(batch["loss_mask"])   # max(sum, 1)
    loss, _ = pt.loss_fn(params_from_jax(rparams, CPU), pcfg,
                         _torch_batch(batch))
    assert float(loss) == 0.0


def test_cross_entropy_takes_int32_labels():
    from repro_torch.models.layers import cross_entropy
    logits = torch.randn(2, 3, 7, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 7),
                                             labels.reshape(-1).long())
    torch.testing.assert_close(cross_entropy(logits, labels), want)


@pytest.mark.parametrize("name", ["deepseek", "zamba2", "rwkv6"])
@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_changes_no_gradient(ref, name, policy):
    _, pcfg = _cfgs(ref, name)
    params = pt.init_params(pcfg, seed=1, device=CPU)
    batch = _batch(pcfg, seed=2)
    fresh = lambda: {k: v.clone() for k, v in _items(params)}  # noqa: E731

    def grads(cfg):
        tree = _unflatten(params, fresh())
        loss, _, g = _port_grads(cfg, tree, batch)
        return loss, g

    loss0, g0 = grads(pcfg.replace(remat=False))
    loss1, g1 = grads(pcfg.replace(remat=True, remat_policy=policy))
    _close_leaf(loss1, _np(loss0), 1e-6)
    for key in g0:
        _close_leaf(g1[key], _np(g0[key]), 1e-6, key)


def _unflatten(like: dict, flat: dict, prefix: str = "") -> dict:
    return {k: _unflatten(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in like.items()}


class _CountProducts(TorchDispatchMode):
    """Counts the products computed under it (a product that selective
    checkpointing returns from its cache never reaches this mode)."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_the_reference_does(ref):
    """The backward recomputes every product of a block under
    ``nothing``, only the batched (attention) products under ``dots``."""
    _, pcfg = _cfgs(ref, "deepseek")
    params = pt.init_params(pcfg, seed=1, device=CPU)
    batch = _torch_batch(_batch(pcfg))
    counts = {}
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        cfg = pcfg.replace(remat=remat, remat_policy=policy)
        tree = {k: v.clone().requires_grad_() for k, v in _items(params)}
        loss, _ = pt.loss_fn(_unflatten(params, tree), cfg, batch)
        with _CountProducts() as mode:
            loss.backward()
        counts[remat, policy] = mode.n
    plain = counts[False, "nothing"]
    assert counts[True, "nothing"]["mm"] > plain["mm"]
    assert counts[True, "nothing"]["bmm"] > plain["bmm"]
    assert counts[True, "dots"] == {"mm": plain["mm"],
                                    "bmm": counts[True, "nothing"]["bmm"]}


def test_unstack_gives_the_layers(ref):
    _, pcfg = _cfgs(ref, "deepseek")
    blocks = pt.init_params(pcfg, device=CPU)["blocks"]
    for i, tree in enumerate(pt.unstack(blocks, pcfg.n_layers)):
        for (k1, a), (k2, b) in zip(_items(tree),
                                    _items(pt.layer(blocks, i))):
            assert k1 == k2 and torch.equal(a, b)


@pytest.mark.parametrize("name,impl", [("deepseek", {"attn_impl": "flash"}),
                                       ("zamba2", {"ssm_impl": "pallas"}),
                                       ("rwkv6", {"ssm_impl": "pallas"})])
def test_kernel_impls_raise_under_training(ref, name, impl):
    """No Pallas kernel defines a VJP: the ops raise under autograd rather
    than route to the plain version."""
    _, pcfg = _cfgs(ref, name, **impl)
    state = init_train_state(pcfg, AdamWConfig(), device=CPU).tree()
    step = make_train_step(pcfg, AdamWConfig())
    with pytest.raises(RuntimeError, match="forward-only|backward|grad"):
        step(state, _torch_batch(_batch(pcfg)))
    flash_attention.launches = 0


# --------------------------------------------------------------------- #
# train step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,micro", [("deepseek", 1), ("deepseek", 2),
                                        ("zamba2", 1), ("rwkv6", 2),
                                        ("rwkv6", 4)])
def test_train_step_matches_reference(ref, name, micro):
    """One step's metrics and updated parameters, then the next step's
    loss and grad norm, at 1e-4.  Adam's first step moves a parameter by
    lr * g / (|g| + eps) (g after clipping), whose slope in g is
    lr * eps / (|g| + eps)^2: near g = 0 it turns a gradient difference
    far inside the gradients' tolerance into a parameter difference of up
    to 2 * lr (zamba2: an element of -2e-8 against the leaf's largest
    1.05 moved one parameter 2.6e-4 apart).  So each parameter's
    tolerance adds the gradients' (1e-4 of the leaf's largest, clipped)
    carried through that slope, capped at 2 * lr, the most one step can
    move it."""
    rcfg, pcfg = _cfgs(ref, name)
    lr = 3e-4
    ropt = ref.optim.AdamWConfig(lr=lr)
    rparams = _ref_params(ref, rcfg)
    rstate = {"params": rparams,
              "opt_state": ref.optim.adamw_init(rparams, ropt)}
    pstate = params_from_jax(rstate, CPU)
    batch = _batch(pcfg, b=4)
    jbatch = jax.tree.map(jnp.asarray, batch)
    rgrads = dict(_items(jax.grad(lambda p: ref.transformer.loss_fn(
        p, rcfg, jbatch)[0])(rparams)))
    rstep = jax.jit(ref.step.make_train_step(rcfg, ropt, micro))
    pstep = make_train_step(pcfg, AdamWConfig(lr=lr), micro)
    rstate, rm = rstep(rstate, jbatch)
    pstate, pm = pstep(pstate, _torch_batch(batch))
    assert pm.keys() == rm.keys()
    for k in rm:
        _close_leaf(pm[k], rm[k], what=k)
    got, eps = dict(_items(pstate["params"])), ropt.eps
    clip = min(1.0, ropt.grad_clip / float(rm["grad_norm"]))
    for key, want in _items(rstate["params"]):
        want = np.asarray(want)
        g = clip * np.abs(np.asarray(rgrads[key]))      # what Adam reads
        carried = np.minimum(2 * lr, lr * eps * TOL * g.max() / (g + eps) ** 2)
        np.testing.assert_array_less(
            np.abs(_np(got[key]) - want),
            TOL * (np.abs(want) + np.abs(want).max()) + carried + 1e-30,
            err_msg=key)
    assert int(pstate["opt_state"]["step"]) == 1
    rstate, rm = rstep(rstate, jbatch)
    pstate, pm = pstep(pstate, _torch_batch(batch))
    for k in ("loss", "grad_norm"):
        _close_leaf(pm[k], rm[k], what=f"second step: {k}")


def test_train_step_casts_matrices_and_keeps_state_dtypes(ref):
    _, pcfg = _cfgs(ref, "deepseek", dtype=torch.bfloat16)
    state = init_train_state(pcfg, AdamWConfig(), seed=0, device=CPU).tree()
    before = {k: (v.dtype, v.data_ptr()) for k, v in
              _items(state["params"])}
    state2, metrics = make_train_step(pcfg, AdamWConfig())(
        state, _torch_batch(_batch(pcfg)))
    assert sorted(metrics) == ["ce", "grad_norm", "loss", "lr", "moe_aux"]
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = {k: (v.dtype, v.data_ptr()) for k, v in
             _items(state2["params"])}
    assert after == before                  # fp32 masters, updated in place
    from repro_torch.train.step import cast_weights
    cast = dict(_items(cast_weights(pcfg, state["params"])))
    assert cast["blocks/attn/wq"].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.bfloat16
    # stacked norms are 2-D, so the reference casts them too
    assert cast["blocks/norm1"].dtype == torch.bfloat16
    assert cast["final_norm"].dtype == torch.float32
    assert all(t.requires_grad and t.is_leaf for t in cast.values())


# bf16 tolerances, from readings of the deepseek smoke step (batch 4 x 16,
# lr 3e-4) on the CPU: the port against the reference in bf16 differs by
# 1.6e-4 in the loss and at most 0.096 of a leaf's largest gradient
# (blocks/attn/wk); the same step computed in fp32 differs from the
# reference's bf16 one by 5.4e-4 in the loss and by 0.29-1.03 of the leaf's
# largest on eight leaves, so these tolerances reject an fp32 step
BF16_LOSS_TOL, BF16_GRAD_TOL = 3e-4, 0.2


def _bf16_cfgs(ref):
    rcfg = ref.registry.get_config("deepseek-7b", smoke=True)
    pcfg = get_config("deepseek-7b", smoke=True)
    return (rcfg.replace(dtype=jnp.bfloat16),
            pcfg.replace(dtype=torch.bfloat16))


@pytest.mark.parametrize("micro", [1, 2])
def test_bf16_train_step_matches_reference(ref, micro):
    """One bf16 step (the reference's cast copy, bf16 matrix gradients,
    fp32 accumulation over microbatches) against the reference's: loss
    and grad norm at ``BF16_LOSS_TOL``, the first moments (0.1 x the
    clipped gradients) at ``BF16_GRAD_TOL`` of each leaf's largest, and
    each updated parameter within what Adam's first step can make of a
    gradient anywhere inside that tolerance: lr * g / (|g| + eps) is
    monotone in g, so the bound is its change over g +- the tolerance
    (tight where |g| is large, up to 2 * lr near 0)."""
    rcfg, pcfg = _bf16_cfgs(ref)
    lr, b1 = 3e-4, 0.9
    ropt = ref.optim.AdamWConfig(lr=lr, b1=b1)
    rparams = _ref_params(ref, rcfg)
    rstate = {"params": rparams,
              "opt_state": ref.optim.adamw_init(rparams, ropt)}
    pstate = params_from_jax(rstate, CPU)
    batch = _batch(pcfg, b=4)
    rstate, rm = jax.jit(ref.step.make_train_step(rcfg, ropt, micro))(
        rstate, jax.tree.map(jnp.asarray, batch))
    pstate, pm = make_train_step(pcfg, AdamWConfig(lr=lr, b1=b1), micro)(
        pstate, _torch_batch(batch))
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                   rtol=BF16_LOSS_TOL, err_msg=k)
    got_m = dict(_items(pstate["opt_state"]["m"]))
    got_p, want_p = dict(_items(pstate["params"])), dict(_items(
        rstate["params"]))
    for key, want_m in _items(rstate["opt_state"]["m"]):
        _close_leaf(got_m[key], want_m, BF16_GRAD_TOL, key)
        g = np.asarray(want_m, np.float64) / (1 - b1)   # clipped gradient
        t = BF16_GRAD_TOL * np.abs(g).max()

        def u(x):
            return lr * x / (np.abs(x) + ropt.eps)
        band = np.maximum(np.abs(u(g + t) - u(g)), np.abs(u(g - t) - u(g)))
        want = np.asarray(want_p[key], np.float32)
        np.testing.assert_array_less(
            np.abs(_np(got_p[key]) - want),
            1e-6 * np.abs(want) + band + 1e-12, err_msg=key)


def _exact_grads(pcfg, rstate, batch, micro: int) -> dict:
    """The train step's gradients, read exactly from the first moments:
    with b1 0 and no clipping, m = 0 * 0 + 1 * g; lr 0 keeps the
    parameters."""
    state = params_from_jax(rstate, CPU)
    opt = AdamWConfig(lr=0.0, b1=0.0, grad_clip=0.0)
    state, _ = make_train_step(pcfg, opt, micro)(state, _torch_batch(batch))
    return dict(_items(state["opt_state"]["m"]))


def test_bf16_step_gradients_are_bf16_and_accumulate_in_fp32(ref):
    """What the reference's step does and a tolerance cannot see: every
    leaf of the cast copy gets a bf16 gradient (the embedding's
    scatter-add and the stacked norms included), and two microbatches
    give exactly (g0 + g1) / 2 in fp32 of the bf16 gradients of rows
    0, 2, ... and 1, 3, ... (the strided split)."""
    rcfg, pcfg = _bf16_cfgs(ref)
    rparams = _ref_params(ref, rcfg)
    rstate = {"params": rparams, "opt_state": ref.optim.adamw_init(
        rparams, ref.optim.AdamWConfig())}
    batch = _batch(pcfg, b=4)
    whole = _exact_grads(pcfg, rstate, batch, 1)
    for key, g in whole.items():
        assert g.dtype == torch.float32
        if g.dim() >= 2:                # the leaves cast_weights casts
            assert torch.equal(g, g.bfloat16().float()), key
    halves = [_exact_grads(pcfg, rstate,
                           {k: v[j::2] for k, v in batch.items()}, 1)
              for j in range(2)]
    split = _exact_grads(pcfg, rstate, batch, 2)
    for key, g in split.items():
        want = (halves[0][key] + halves[1][key]) * 0.5
        assert torch.equal(g, want), key


# name -> (arch, stacked group, block, module): layer 0 of the
# reference's smoke tree
BLOCKS = {"mamba2_seq": ("zamba2-1.2b", "mamba_tail", "mamba", "mamba2"),
          "rwkv6_seq": ("rwkv6-7b", "blocks", "tmix", "rwkv6"),
          "channel_mix": ("rwkv6-7b", "blocks", "cmix", "rwkv6")}


def _block_grads(ref, name: str, rp: dict, x: np.ndarray, cot: np.ndarray,
                 bf16: bool) -> tuple[dict, dict]:
    """The block's gradients in the reference (``jax.vjp``, op by op) and
    the port (autograd) for the cotangent ``cot`` at ``x``: in bf16 (the
    matrices cast as ``cast_weights`` casts them, the input in bf16) or
    in fp32; each leaf's gradient as fp32 numpy."""
    arch, _, _, mod = BLOCKS[name]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    rcfg = ref.registry.get_config(arch, smoke=True).replace(dtype=jdt)
    pcfg = get_config(arch, smoke=True).replace(dtype=tdt)
    rcast = {k: v.astype(jdt) if v.ndim >= 2 else v for k, v in rp.items()}
    fn = getattr(getattr(ref, mod), name)
    y, vjp = jax.vjp(lambda p: fn(p, rcfg, jnp.asarray(x).astype(jdt)),
                     rcast)
    (rgrads,) = vjp(jnp.asarray(cot).astype(y.dtype))
    pp = {k: (v.to(tdt) if v.dim() >= 2 else v).requires_grad_()
          for k, v in params_from_jax(rp, CPU).items()}
    port = pmamba2 if mod == "mamba2" else prwkv6
    out = getattr(port, name)(pp, pcfg, torch.from_numpy(x).to(tdt))
    pgrads = torch.autograd.grad(out, list(pp.values()),
                                 torch.from_numpy(cot).to(out.dtype))
    return ({k: _np(v) for k, v in rgrads.items()},
            {k: _np(g) for k, g in zip(pp, pgrads)})


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_bf16_block_rounding_is_no_worse_than_the_reference(ref, name):
    """One SSM block, layer 0 of the reference's smoke tree, on a seeded
    input of 4 x 16 tokens and a seeded cotangent, in bf16 and in fp32
    through both packages: each leaf's bf16-vs-fp32 gradient error (max
    |g16 - g32| over the leaf's largest |g32|) in the port is at most
    1.5x the reference's plus 1e-3.  Readings (reference / port, over the
    leaves): mamba2_seq 0.0094-0.0444 / 0.0077-0.0475 (largest port over
    reference 1.29, dt_bias); rwkv6_seq 0.0065-0.0187 / 0.0060-0.0127
    (1.27, wv); channel_mix 0.0058-0.0189 / 0.0054-0.0079 (0.94, wk).
    So the blocks round as the reference's do: the smoke model's larger
    bf16 gradient gap is its init amplifying the noise (ROADMAP note
    J), not a block fault."""
    arch, group, block, _ = BLOCKS[name]
    rcfg = ref.registry.get_config(arch, smoke=True)
    rparams, _ = ref.transformer.init_params(rcfg, jax.random.key(0))
    rp = {k: v[0] for k, v in rparams[group][block].items()}
    rng = np.random.default_rng(0)
    x, cot = (rng.standard_normal((4, 16, rcfg.d_model)).astype(np.float32)
              for _ in range(2))
    r16, p16 = _block_grads(ref, name, rp, x, cot, bf16=True)
    r32, p32 = _block_grads(ref, name, rp, x, cot, bf16=False)
    assert p16.keys() == r16.keys() == set(rp)
    for key in rp:
        scale = max(float(np.abs(r32[key]).max()), 1e-30)
        ref_err = float(np.abs(r16[key] - r32[key]).max()) / scale
        port_err = float(np.abs(p16[key] - p32[key]).max()) / max(
            float(np.abs(p32[key]).max()), 1e-30)
        assert 0 < port_err <= 1.5 * ref_err + 1e-3, (key, port_err,
                                                      ref_err)


# --------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------- #
def _ckpt_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"blocks": {"wq": rng.standard_normal((2, 4, 3))
                                  .astype(np.float32)},
                       "norm": rng.standard_normal(4).astype(np.float32),
                       "half": rng.standard_normal((3, 2)).astype(
                           np.float32)},
            "opt_state": {"step": np.int32(7)}}


def test_reference_checkpoint_restores_in_the_port(ref, tmp_path):
    tree = _ckpt_tree(0)
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["params"]["half"] = jtree["params"]["half"].astype(jnp.bfloat16)
    path = str(tmp_path / "ref.npz")
    ref.checkpoint.save_tree(path, jtree, {"step": 7})
    like = params_from_jax(tree, CPU)
    like["params"]["half"] = like["params"]["half"].to(torch.bfloat16)
    got = restore_tree(path, like)
    assert got["params"]["half"].dtype == torch.bfloat16
    assert got["opt_state"]["step"].dtype == torch.int32
    for key, want in _items(jtree):
        np.testing.assert_array_equal(_np(dict(_items(got))[key]),
                                      np.asarray(want, np.float32))


def test_port_checkpoint_restores_in_the_reference(ref, tmp_path):
    tree = params_from_jax(_ckpt_tree(1), CPU)
    tree["params"]["half"] = tree["params"]["half"].to(torch.bfloat16)
    path = str(tmp_path / "port.npz")
    save_tree(path, tree, {"step": 7})
    like = jax.tree.map(jnp.asarray, _ckpt_tree(2))
    like["params"]["half"] = like["params"]["half"].astype(jnp.bfloat16)
    got = ref.checkpoint.restore_tree(path, like)
    assert got["params"]["half"].dtype == jnp.bfloat16
    for key, want in _items(tree):
        np.testing.assert_array_equal(np.asarray(dict(_items(got))[key],
                                                 np.float32), _np(want))
    with np.load(path) as zf:
        assert sorted(zf.files) == ["opt_state/step", "params/blocks/wq",
                                    "params/half", "params/norm"]


def test_restore_checks_shapes(tmp_path):
    path = str(tmp_path / "a.npz")
    save_tree(path, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        restore_tree(path, {"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="v"):
        restore_tree(path, {"v": torch.zeros(3)})


def test_async_save_copies_before_returning(tmp_path):
    """A CPU tensor updated in place after ``save`` returns does not reach
    the checkpoint being written."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    w = torch.ones(1000)
    mgr.save(1, {"w": w})
    w.mul_(5.0)
    mgr.wait()
    out, _ = mgr.restore(1, {"w": torch.zeros(1000)})
    assert torch.equal(out["w"], torch.ones(1000))


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    p = str(tmp_path / "ck.npz")
    save_tree(p, tree, {"step": 3})
    like = {"a": torch.zeros((2, 3)),
            "b": {"c": torch.zeros((4,), dtype=torch.bfloat16)}}
    out = restore_tree(p, like)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16


def test_manager_latest_prune_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((3,), float(s))}, blocking=True)
    assert mgr.all_steps() == [3, 4]                 # pruned to keep=2
    out, meta = mgr.restore_latest({"w": torch.zeros((3,))})
    assert meta["step"] == 4
    assert torch.equal(out["w"], torch.full((3,), 4.0))


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(7, {"w": torch.ones((2,))}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_crash_mid_save_leaves_no_corruption(tmp_path):
    """A stray .tmp file (simulated crash) is invisible to the manager."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"w": torch.ones((2,))}, blocking=True)
    with open(os.path.join(str(tmp_path), "step_00000002.npz.tmp"),
              "wb") as f:
        f.write(b"garbage")
    assert mgr.latest_step() == 1
    out, _ = mgr.restore_latest({"w": torch.zeros((2,))})
    assert torch.equal(out["w"], torch.ones((2,)))


def test_both_packages_resume_a_reference_checkpoint(ref, tmp_path):
    """The reference trains 5 steps and checkpoints; each package resumes
    from that directory for 5 more steps: the same losses."""
    d = str(tmp_path / "ck")
    rtrainer = ref.trainer.Trainer(*_small(total_steps=5, ckpt_dir=d,
                                           ckpt_every=5, package=ref))
    rtrainer.run()
    theirs = ref.trainer.Trainer(*_small(total_steps=10, ckpt_dir=d,
                                         ckpt_every=0, package=ref)).run()
    mine = Trainer(*_small(total_steps=10, ckpt_dir=d, ckpt_every=0),
                   device=CPU).run()
    assert theirs.restored_from == mine.restored_from == 5
    assert mine.steps_run == theirs.steps_run == 5
    np.testing.assert_allclose(mine.losses, theirs.losses, rtol=TOL)


# --------------------------------------------------------------------- #
# trainer (tests/substrate/test_trainer_serve.py, on the port)
# --------------------------------------------------------------------- #
def test_loss_decreases():
    res = Trainer(*_small(total_steps=40), device=CPU).run()
    assert res.steps_run == 40
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    assert last < first - 0.1, (first, last)


def test_prune_hook_stops_training():
    calls = []

    def report(step, loss):
        calls.append(step)
        return step >= 10          # prune at the 2nd report

    res = Trainer(*_small(total_steps=100), device=CPU).run(report=report)
    assert res.pruned
    assert res.steps_run == 10
    assert calls == [5, 10]


def test_checkpoint_restart_resumes_exactly(tmp_path):
    """Train 20; kill; restart -> the final loss of an uninterrupted
    20-step run (deterministic pipeline + state restore)."""
    d1 = str(tmp_path / "a")
    r_full = Trainer(*_small(total_steps=20), device=CPU).run()
    Trainer(*_small(total_steps=10, ckpt_dir=d1, ckpt_every=10),
            device=CPU).run()
    r_resumed = Trainer(*_small(total_steps=20, ckpt_dir=d1, ckpt_every=10),
                        device=CPU).run()
    assert r_resumed.restored_from == 10
    assert r_resumed.steps_run == 10
    np.testing.assert_allclose(r_resumed.final_loss, r_full.final_loss,
                               rtol=1e-4)


def test_microbatched_trainer_runs():
    res = Trainer(*_small(total_steps=6, micro=4), device=CPU).run()
    assert res.steps_run == 6
    assert np.isfinite(res.final_loss)


def test_diverging_loss_raises():
    mcfg, _, dcfg, tcfg = _small(total_steps=5)
    with pytest.raises(FloatingPointError, match="diverged"):
        Trainer(mcfg, AdamWConfig(lr=float("nan")), dcfg, tcfg,
                device=CPU).run()


def test_hopaas_objective_trains_and_reports():
    mcfg = get_config("deepseek-7b", smoke=True)
    objective = hopaas_objective(mcfg, total_steps=6, global_batch=4,
                                 seq_len=16, report_every=3, device=CPU)
    seen = []
    value = objective({"lr": 1e-3, "weight_decay": 0.01},
                      lambda step, loss: seen.append(step) or False)
    assert seen == [3, 6] and np.isfinite(value)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mcfg, opt, dcfg, tcfg = _small()
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(mcfg, opt, dcfg, tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        hopaas_objective(mcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(mcfg, opt)
    with pytest.raises(RuntimeError, match="cuda"):
        train_launch.main(["--arch", "deepseek-7b", "--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        worker_launch.main(["--token", "t"])


# --------------------------------------------------------------------- #
# launchers
# --------------------------------------------------------------------- #
def test_train_launcher_runs_on_the_cpu(capsys, tmp_path):
    assert train_launch.main(["--arch", "deepseek-7b", "--smoke", "--steps",
                              "4", "--batch", "2", "--seq", "16",
                              "--device", "cpu", "--checkpoint-dir",
                              str(tmp_path), "--checkpoint-every",
                              "2"]) == 0
    out = capsys.readouterr().out
    assert "done: 4 steps" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]


def test_worker_trains_two_trials_against_the_port_service(capsys):
    server = HopaasServer(device="cpu")
    runner = HttpServiceRunner(server, backend="evloop").start()
    try:
        token = server.tokens.issue("worker")
        assert worker_launch.main([
            "--server", f"{runner.host}:{runner.port}", "--token", token,
            "--study", "lm-tune", "--trials", "2", "--steps", "4",
            "--device", "cpu"]) == 0
        client = Client(HttpTransport(runner.host, runner.port), token)
        (study,) = [s for s in client.studies() if s["name"] == "lm-tune"]
        assert study["n_completed"] + study.get("n_pruned", 0) == 2
    finally:
        runner.stop()
        server.close()
    assert capsys.readouterr().out.count(" -> ") == 2


NEW_MODULES = ["repro_torch.optim", "repro_torch.data",
               "repro_torch.checkpoint", "repro_torch.train",
               "repro_torch.launch.train", "repro_torch.launch.worker"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_without_jax(module):
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; import importlib; "
            f"importlib.import_module({module!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


def test_train_probe_cpu_mode_gives_the_train_steps_norm(tmp_path):
    """``tools/train_probe.py --device cpu`` (in a fresh process, with JAX
    and the JAX package blocked as ``chip_smoke.py`` blocks them) prints
    the gradient norm at init by depth at smoke width; at the smoke
    config's own depth it is the first train step's grad norm on the same
    init (seed 0) and batch."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "train_probe.py"), str(ROOT),
         "--device", "cpu", "--arch", "rwkv6-7b", "--depths", "1,2"],
        capture_output=True, text=True, check=True, timeout=300,
        cwd=tmp_path)
    norms = json.loads(out.stdout.strip().splitlines()[-1])["rwkv6-7b"]
    assert sorted(norms) == ["1", "2"]
    assert all(np.isfinite(g) and g > 0 for g in norms.values())
    cfg = get_config("rwkv6-7b", smoke=True).replace(dtype=torch.bfloat16)
    assert cfg.n_layers == 2
    state = init_train_state(cfg, AdamWConfig(), seed=0, device=CPU).tree()
    _, metrics = make_train_step(cfg, AdamWConfig())(
        state, _torch_batch(_batch(cfg, b=2, s=64)))
    np.testing.assert_allclose(norms["2"], float(metrics["grad_norm"]),
                               rtol=1e-5)


def test_no_tool_imports_jax_or_the_reference():
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    bad = [str(f) for f in (ROOT / "tools").glob("*.py")
           if pat.search(f.read_text())]
    assert not bad


def test_no_port_file_imports_jax_or_the_reference():
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad
