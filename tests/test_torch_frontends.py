"""The port's frontends, head-padding surgery and cell matrix against the
JAX reference.

hubert-xlarge (audio: precomputed conv features through a projection,
masked frames replaced by a learned embedding, no token embedding) and
pixtral-12b (vision: 256 patch embeddings through an adapter, prepended
to the tokens' embeddings) run on the reference's parameters carried
across with ``params_from_jax``; logits (the image positions included),
loss, ``ce`` and every gradient are compared in fp32 on the CPU at
rtol = atol = 1e-4.  ``models.surgery`` pads qwen1.5's and zamba2's
attention heads; ``launch.shapes`` is the reference's per-cell
configuration.  The reference's models import through the ``reference``
fixture of ``tests/test_torch_models.py`` (its ``repro.dist`` stub).
"""
import dataclasses
import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import (BatchSpec, DataConfig,  # noqa: E402
                              SyntheticLMDataset)
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import frontends, get_config, surgery  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import ParamInit  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from test_torch_models import reference  # noqa: E402,F401  (the stub)

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
FRONTENDS = ["hubert-xlarge", "pixtral-12b"]


@pytest.fixture(scope="module")
def ref(reference):
    """The ``reference`` fixture's modules plus the reference's surgery
    and cell matrix, imported under its stub."""
    return types.SimpleNamespace(
        **vars(reference),
        surgery=importlib.import_module("repro.models.surgery"),
        shapes=importlib.import_module("repro.launch.shapes"),
        serve_launch=importlib.import_module("repro.launch.serve"))


def _flat(tree: dict, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _close(got, want, what: str = "", scaled: bool = False) -> None:
    """rtol = atol = 1e-4; ``scaled``: atol 1e-4 times the largest
    magnitude of ``want`` (a gradient summed over many positions, as
    ``tests/test_torch_train.py`` compares them)."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    atol = TOL["atol"] * (float(np.abs(want).max()) if scaled else 1.0)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=atol,
                               err_msg=what)


def _batch(cfg, seed: int = 3) -> dict:
    """One synthetic batch of 2 x 8 (audio frames or tokens; pixtral adds
    its 256 patches), numpy, bit for bit the reference's pipeline."""
    return SyntheticLMDataset(DataConfig(2, 8, seed=seed), cfg)[0]


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _build(ref, arch: str, **over):
    rcfg = ref.registry.get_config(arch, smoke=True).replace(**over)
    pcfg = get_config(arch, smoke=True).replace(**over)
    rparams, _ = ref.transformer.init_params(rcfg, jax.random.key(0))
    return rcfg, pcfg, rparams


# --------------------------------------------------------------------- #
# the frontends
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FRONTENDS)
def test_forward_matches_reference(ref, arch):
    """Logits at every position: hubert's frames, pixtral's 256 image
    positions and then its text positions."""
    rcfg, pcfg, rparams = _build(ref, arch)
    batch = _batch(pcfg)
    want, _ = ref.transformer.forward(rparams, rcfg,
                                      jax.tree.map(jnp.asarray, batch))
    got, aux = pt.forward(params_from_jax(rparams, CPU), pcfg,
                          _torch(batch))
    n_img = 256 if arch == "pixtral-12b" else 0
    assert got.shape == want.shape == (2, n_img + 8, pcfg.vocab_size)
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", FRONTENDS)
def test_loss_and_gradients_match_reference(ref, arch):
    """loss, ``ce`` and every gradient against ``jax.grad``: pixtral's
    loss over the text positions only, hubert's over the masked frames
    (``frame_mask``).  The adapter's gradient sums 512 patch rows, so the
    gradients take ``_close``'s scaled atol."""
    rcfg, pcfg, rparams = _build(ref, arch)
    batch = _batch(pcfg)
    (rloss, rparts), rgrads = jax.value_and_grad(
        lambda p: ref.transformer.loss_fn(p, rcfg, jax.tree.map(
            jnp.asarray, batch)), has_aux=True)(rparams)
    params = params_from_jax(rparams, CPU)
    leaves = dict(_flat(params))
    for t in leaves.values():
        t.requires_grad_()
    loss, parts = pt.loss_fn(params, pcfg, _torch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _close(loss, rloss, "loss")
    _close(parts["ce"], rparts["ce"], "ce")
    want = dict(_flat(rgrads))
    assert want.keys() == leaves.keys()
    for path, g in zip(leaves, grads):
        _close(g, want[path], "/".join(path), scaled=True)
    # the leaves only the frontends have are trained too
    key = ("frontend", "mask_emb") if arch == "hubert-xlarge" else (
        "adapter", "proj")
    assert float(np.abs(want[key]).max()) > 0


def test_hubert_full_width_gradients_match_reference(ref):
    """hubert-xlarge at its full width (d 1280, 16 heads of 80, GELU MLP
    5120, 512-wide frames), depth cut to 2 layers, fp32, one batch of 64
    frames: the loss at 1e-4 and every gradient against ``jax.grad`` at
    1e-3 of its leaf's largest magnitude (fp32 sums of 1280 to 5120 terms
    in other orders, through the init's saturated softmax)."""
    rcfg = ref.registry.get_config("hubert-xlarge").replace(
        n_layers=2, dtype=jnp.float32)
    pcfg = get_config("hubert-xlarge").replace(n_layers=2,
                                               dtype=torch.float32)
    rparams, _ = ref.transformer.init_params(rcfg, jax.random.key(0))
    batch = SyntheticLMDataset(DataConfig(1, 64, seed=0), pcfg)[0]
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: ref.transformer.loss_fn(p, rcfg, jax.tree.map(
            jnp.asarray, batch)), has_aux=True)(rparams)
    params = params_from_jax(rparams, CPU)
    leaves = dict(_flat(params))
    for t in leaves.values():
        t.requires_grad_()
    loss, _ = pt.loss_fn(params, pcfg, _torch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _close(loss, rloss, "loss")
    want = dict(_flat(rgrads))
    for path, g in zip(leaves, grads):
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-3, atol=1e-3 * float(np.abs(w).max()),
            err_msg="/".join(path))


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the reference's
    fp32 upcasts (rmsnorm, attention scores, cross-entropy) widened."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("n_layers", [4, 8])
def test_hubert_full_width_fp64_gradients_match_reference(
        ref, monkeypatch, n_layers):
    """hubert-xlarge at its full width, depth cut to 4 and 8 layers, on
    the reference's init carried across, one batch of 32 frames, in
    float64 on both sides (each side's fp32 upcasts widened too): loss,
    global gradient norm (the trainer's clip input, which grows with
    depth under this init and overflows at 48 layers) and every
    gradient equal the reference's at 1e-6.  In fp32 the two do not
    agree at this depth: the rounding error grows with depth as the
    gradient does, so only float64 can show that the growth is the
    reference's own."""
    rcfg = ref.registry.get_config("hubert-xlarge").replace(
        n_layers=n_layers, dtype=jnp.float32)
    pcfg = get_config("hubert-xlarge").replace(n_layers=n_layers,
                                               dtype=torch.float64)
    batch = SyntheticLMDataset(DataConfig(1, 32, seed=0), pcfg)[0]
    batch["features"] = batch["features"].astype(np.float64)
    with jax.enable_x64(True):
        rparams, _ = ref.transformer.init_params(rcfg, jax.random.key(0))
        rparams = jax.tree.map(lambda x: x.astype(jnp.float64), rparams)
        for name in ("layers", "attention", "transformer", "frontends"):
            monkeypatch.setattr(importlib.import_module(
                f"repro.models.{name}"), "jnp", _Float64Numpy())
        (rloss, _), rgrads = jax.jit(jax.value_and_grad(
            lambda p: ref.transformer.loss_fn(
                p, rcfg.replace(dtype=jnp.float64),
                jax.tree.map(jnp.asarray, batch)), has_aux=True))(rparams)
        params = params_from_jax(rparams, CPU)
        del rparams
        want = {k: np.asarray(v) for k, v in _flat(rgrads)}
        del rgrads
    assert all(w.dtype == np.float64 for w in want.values())
    upcast = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: (
        t if t.dtype == torch.float64 else upcast(t, *a, **k)))
    leaves = dict(_flat(params))
    for t in leaves.values():
        t.requires_grad_()
    loss, _ = pt.loss_fn(params, pcfg, _torch(batch))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-6)
    norm = np.sqrt(sum(np.sum(np.square(w)) for w in want.values()))
    got = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
    np.testing.assert_allclose(got, norm, rtol=1e-6)
    assert want.keys() == grads.keys()
    for path, g in grads.items():     # in place: the leaves are ~0.4 GB
        w = torch.from_numpy(np.array(want.pop(path)))
        assert g.dtype == w.dtype == torch.float64
        err = (g - w).abs_()
        err -= w.abs().mul_(1e-6).add_(1e-6 * float(w.abs().max()))
        assert float(err.max()) <= 0, "/".join(path)


def test_audio_loss_scores_only_the_masked_frames(ref):
    """hubert's loss is the mean over ``frame_mask``; with no frame
    masked it is 0 (``max(sum, 1)``), as the reference's."""
    rcfg, pcfg, rparams = _build(ref, "hubert-xlarge")
    batch = _batch(pcfg)
    params = params_from_jax(rparams, CPU)
    logits, _ = pt.forward(params, pcfg, _torch(batch))
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, pcfg.vocab_size),
        torch.from_numpy(batch["labels"]).long().reshape(-1),
        reduction="none")
    mask = torch.from_numpy(batch["frame_mask"]).reshape(-1)
    loss, _ = pt.loss_fn(params, pcfg, _torch(batch))
    _close(loss, nll[mask].mean().numpy())
    batch["frame_mask"] = np.zeros_like(batch["frame_mask"])
    loss, _ = pt.loss_fn(params, pcfg, _torch(batch))
    rloss, _ = ref.transformer.loss_fn(rparams, rcfg,
                                       jax.tree.map(jnp.asarray, batch))
    assert float(loss) == float(rloss) == 0.0


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_init_keys_and_shapes_match_reference(ref, arch, tie):
    """The key set, shapes and dtypes of ``init``: audio has a
    ``frontend`` and no ``embed`` and keeps its ``lm_head`` when
    embeddings are tied; vision adds ``adapter``."""
    rcfg = ref.registry.get_config(arch, smoke=True).replace(
        tie_embeddings=tie)
    pcfg = get_config(arch, smoke=True).replace(tie_embeddings=tie)
    want = dict(_flat(ref.transformer.init_params(rcfg, None)[0]))
    for device in ("meta", "cpu"):
        got = dict(_flat(pt.init_params(pcfg, seed=0, device=device)))
        assert got.keys() == want.keys()
        for path, leaf in got.items():
            assert tuple(leaf.shape) == want[path].shape, path
            assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype)
    groups = {path[0] for path in want}
    if arch == "hubert-xlarge":
        assert "embed" not in groups and {"frontend", "lm_head"} <= groups
    else:
        assert {"embed", "adapter"} <= groups
        assert ("lm_head" in groups) == (not tie)


def test_frontend_init_draws_the_reference_scales():
    """``mask_emb`` at scale 0.02, the biases zero, the projections at
    1/sqrt(frontend_dim), as the reference's ``mk``."""
    cfg = get_config("hubert-xlarge", smoke=True).replace(
        frontend_dim=4096, d_model=4096)
    mk = ParamInit(0, CPU)
    audio = frontends.init_audio_frontend(mk, cfg)
    vision = frontends.init_vision_adapter(mk, cfg)
    for p in (audio, vision):
        assert p["proj"].shape == (4096, 4096)
        assert abs(float(p["proj"].std()) - 4096 ** -0.5) < 1e-4
        assert float(p["proj_b"].abs().max()) == 0.0
    assert abs(float(audio["mask_emb"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("arch", FRONTENDS)
def test_bf16_embed_inputs_match_the_reference(ref, arch):
    """In bf16 the frontends' outputs (pixtral's: the adapter's patches
    before the token embeddings, joined in ``cfg.dtype``) and the
    positions over the whole sequence are the reference's, within one
    bf16 rounding (2**-8 relative)."""
    rcfg, pcfg, rparams = _build(ref, arch, dtype=jnp.bfloat16)
    pcfg = pcfg.replace(dtype=torch.bfloat16)
    batch = _batch(pcfg)
    want, wpos = ref.transformer.embed_inputs(
        rparams, rcfg, jax.tree.map(jnp.asarray, batch))
    got, pos = pt.embed_inputs(params_from_jax(rparams, CPU), pcfg,
                               _torch(batch))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -8,
                               atol=2 ** -8)


def test_pixtral_generates_the_reference_tokens(ref):
    """Decode is token-only in both packages: greedy continuations of a
    pixtral prompt agree token for token."""
    rcfg, pcfg, rparams = _build(ref, "pixtral-12b")
    prompts = np.random.default_rng(5).integers(
        0, pcfg.vocab_size, (2, 6)).astype(np.int32)
    want = ref.engine.ServeEngine(rcfg, rparams, max_len=16).generate(
        prompts, 5)
    got = ServeEngine(pcfg, params_from_jax(rparams, CPU), max_len=16,
                      device="cpu").generate(prompts, 5)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_engine_refuses_an_encoder_only_model():
    cfg = get_config("hubert-xlarge", smoke=True)
    params = pt.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        pt.decode_step(params, cfg, {}, torch.zeros((1, 1), dtype=torch.long),
                       0)


# --------------------------------------------------------------------- #
# checkpoint surgery: head padding
# --------------------------------------------------------------------- #
# name -> (arch, overrides, divisor); smoke configs, fp32
PADDED = {"qwen1.5": ("qwen1.5-32b", {}, 3),
          "qwen1.5-flash": ("qwen1.5-32b", {"attn_impl": "flash"}, 3),
          "zamba2": ("zamba2-1.2b", {}, 3)}


@pytest.mark.parametrize("name", sorted(PADDED))
def test_padded_forward_equals_unpadded_and_reference(ref, name):
    """The padded tree's forward equals the unpadded one's (zero heads
    add nothing through ``wo``'s zero rows) and the reference's on its
    own padded tree; qwen1.5's stacked blocks with QKV bias, zamba2's
    unstacked ``shared`` block."""
    arch, over, divisor = PADDED[name]
    rcfg, pcfg, rparams = _build(ref, arch, **over)
    rnew = ref.surgery.pad_heads_config(rcfg, divisor)
    pnew = surgery.pad_heads_config(pcfg, divisor)
    assert (pnew.n_heads, pnew.n_kv_heads) == (rnew.n_heads,
                                               rnew.n_kv_heads) == (6, 6)
    params = params_from_jax(rparams, CPU)
    padded = surgery.pad_heads_params(params, pcfg, pnew)
    toks = np.random.default_rng(1).integers(
        0, pcfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    want, _ = pt.forward(params, pcfg, batch)
    got, _ = pt.forward(padded, pnew, batch)
    _close(got, want.numpy())
    rgot, _ = ref.transformer.forward(
        ref.surgery.pad_heads_params(rparams, rcfg, rnew), rnew,
        {"tokens": jnp.asarray(toks)})
    _close(got, rgot)


@pytest.mark.parametrize("name", ["qwen1.5", "zamba2"])
def test_pad_heads_params_matches_the_reference_padded_tree(ref, name):
    """The port's padding of a carried-across tree equals the reference's
    padded tree carried across, leaf for leaf; the shapes are the padded
    config's init; every leaf but the attention's is shared."""
    arch, over, divisor = PADDED[name]
    rcfg, pcfg, rparams = _build(ref, arch, **over)
    if rcfg.qkv_bias:       # drawn as zeros: give them values to place
        attn = dict(rparams["blocks"]["attn"])
        for i, b in enumerate(("bq", "bk", "bv")):
            attn[b] = jax.random.normal(jax.random.key(i + 1),
                                        attn[b].shape)
        rparams = {**rparams, "blocks": {**rparams["blocks"],
                                         "attn": attn}}
    pnew = surgery.pad_heads_config(pcfg, divisor)
    params = params_from_jax(rparams, CPU)
    padded = surgery.pad_heads_params(params, pcfg, pnew)
    want = dict(_flat(params_from_jax(ref.surgery.pad_heads_params(
        rparams, rcfg, ref.surgery.pad_heads_config(rcfg, divisor)), CPU)))
    meta = dict(_flat(pt.init_params(pnew, device="meta")))
    got, before = dict(_flat(padded)), dict(_flat(params))
    assert got.keys() == want.keys() == meta.keys()
    changed = set()
    for path, leaf in got.items():
        assert torch.equal(leaf, want[path]), path
        assert leaf.shape == meta[path].shape, path
        if leaf is not before[path]:
            changed.add(path)
    attn = "blocks" if name == "qwen1.5" else "shared"
    names = {"wq", "wk", "wv", "wo"} | (
        {"bq", "bk", "bv"} if name == "qwen1.5" else set())
    assert changed == {(attn, "attn", n) for n in names}


def test_padding_by_a_divisor_of_the_heads_changes_nothing():
    cfg = get_config("qwen1.5-32b", smoke=True)
    new = surgery.pad_heads_config(cfg, 2)
    params = pt.init_params(cfg, seed=0, device="cpu")
    padded = surgery.pad_heads_params(params, cfg, new)
    assert new == cfg
    for (_, a), (_, b) in zip(_flat(padded), _flat(params)):
        assert a is b


def test_full_size_padding_is_the_prefill_cell():
    """qwen1.5-32b's prefill cell pads 40/40 heads to 48/48 (divisor
    16): 20,974,592 more parameters a layer."""
    cfg = get_config("qwen1.5-32b")
    new = shapes.configure_for_cell(cfg, shapes.SHAPES["prefill_32k"])
    assert (new.n_heads, new.n_kv_heads) == (48, 48)
    assert new == surgery.pad_heads_config(
        cfg.replace(param_dtype=torch.bfloat16, attn_impl="blocked",
                    attn_sp=True), 16)
    one = cfg.replace(n_layers=1)
    padded = surgery.pad_heads_params(pt.init_params(one, device="meta"),
                                      one, new.replace(n_layers=1))
    extra = sum(t.numel() for _, t in _flat(padded)) - one.n_params()
    assert extra == 20_974_592


# --------------------------------------------------------------------- #
# the cell matrix
# --------------------------------------------------------------------- #
def _plain(v):
    """A config field in a form both packages share: dtypes by name,
    nested configs as dicts."""
    if dataclasses.is_dataclass(v):
        return {k: _plain(x) for k, x in dataclasses.asdict(v).items()}
    if isinstance(v, torch.dtype):
        return str(v).split(".")[-1]
    if isinstance(v, type):                         # jnp.bfloat16, ...
        return np.dtype(v).name
    return v


def test_cells_equal_the_reference(ref):
    assert shapes.cells() == ref.shapes.cells()
    assert len(shapes.cells()) == 32
    assert shapes.cells(["hubert-xlarge"]) == [
        ("hubert-xlarge", "train_4k"), ("hubert-xlarge", "prefill_32k")]


@pytest.mark.parametrize("arch", ARCHS)
def test_configure_for_cell_equals_the_reference(ref, arch):
    """Field by field, on every shape of ``arch`` (skipped ones too), with
    the skip reasons, microbatches, ``no_tp`` and decode cache length."""
    assert shapes.microbatches_for(arch) == ref.shapes.microbatches_for(arch)
    assert shapes.no_tp(arch) == ref.shapes.no_tp(arch)
    pbase = get_config(arch)
    rbase = ref.registry.get_config(arch)
    for name, shape in shapes.SHAPES.items():
        rshape = ref.shapes.SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(rshape)
        assert shapes.cell_is_skipped(pbase, shape) == \
            ref.shapes.cell_is_skipped(rbase, rshape)
        got = shapes.configure_for_cell(pbase, shape)
        want = ref.shapes.configure_for_cell(rbase, rshape)
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            assert _plain(getattr(got, f.name)) == _plain(
                getattr(want, f.name)), (arch, name, f.name)
        assert shapes.decode_cache_len(got, shape) == \
            ref.shapes.decode_cache_len(want, rshape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(ref, arch):
    """Shapes and dtypes of every input of every cell of ``arch``; none is
    an allocated tensor."""
    for a, name in shapes.cells([arch]):
        got = shapes.input_specs(a, name)
        want = ref.shapes.input_specs(a, name)
        want.pop("cache_logical", None)          # logical axes: no port
        assert got.keys() == want.keys()
        flat_got, flat_want = dict(_flat(got)), dict(_flat(want))
        assert flat_got.keys() == flat_want.keys(), (a, name)
        for path, spec in flat_got.items():
            assert isinstance(spec, BatchSpec) or spec.is_meta, path
            assert tuple(spec.shape) == tuple(flat_want[path].shape), path
            assert _plain(spec.dtype) == str(flat_want[path].dtype), path


# --------------------------------------------------------------------- #
# launchers and imports
# --------------------------------------------------------------------- #
def test_serve_launcher_serves_pixtral_on_the_cpu(capsys):
    assert serve_launch.main(["--arch", "pixtral-12b", "--smoke", "--batch",
                              "2", "--prompt-len", "4", "--new-tokens", "3",
                              "--device", "cpu"]) == 0
    assert "pixtral-12b-smoke: generated 2x3 tokens" in capsys.readouterr(
        ).out


def test_serve_launcher_refuses_hubert_as_the_reference_does(
        ref, capsys, monkeypatch):
    argv = ["--arch", "hubert-xlarge", "--smoke"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    assert ref.serve_launch.main() == 1
    want = capsys.readouterr().out
    assert serve_launch.main([*argv, "--device", "cpu"]) == 1
    assert capsys.readouterr().out == want == (
        "hubert-xlarge-smoke is encoder-only: no decode step\n")


@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_launcher_trains_the_frontend_families(capsys, arch):
    assert train_launch.main(["--arch", arch, "--smoke", "--steps", "3",
                              "--batch", "2", "--seq", "8", "--microbatches",
                              "2", "--log-every", "1",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"training {arch}-smoke" in out and "done: 3 steps" in out


@pytest.mark.parametrize("module", ["repro_torch.models.frontends",
                                    "repro_torch.models.surgery",
                                    "repro_torch.launch.shapes"])
def test_new_modules_import_without_jax(module):
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; import importlib; "
            f"importlib.import_module({module!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
