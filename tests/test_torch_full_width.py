"""Full-width readings of the port's training step against the reference's,
on the CPU.

The H100 training runs of ``chip_smoke.py``'s phase 18 show two things the
smoke-width tests cannot: rwkv6-7b's first AdamW step raises the next
batch's loss (11.64 -> 19.13 at 8 layers), and zamba2-1.2b's bf16
gradients lie far from its fp32 ones (relative L2 error up to 1.16 at 8
layers).  These tests give the reference's reading beside the port's at
full width on the same weights (the reference's init, key 0, carried with
``params_from_jax``) and the same batches, depth and sequence cut so that
a run fits in host memory:

- rwkv6-7b at 2 layers, one row of ``SEQ`` tokens a step, bf16 compute:
  three AdamW steps at lr 3e-4 through each package's train step.  Both
  packages' losses must agree, and in both a later step's loss must rise
  above the first's (here after the second update: 11.51, 10.95, 16.51).
- zamba2-1.2b at 8 layers, one row of ``SEQ`` tokens: the train step's
  gradients in bf16 and in fp32 compute from one set of fp32 masters, read
  exactly from the first moments (lr 0, b1 0, no clipping); each leaf
  group's relative L2 error in the port must be at most 1.5x the
  reference's plus 1e-3, as the block-level test holds each leaf.

They print their readings (``-s``).  Each needs up to ~20 GiB of host
memory and a few minutes, so they run only when ``REPRO_TORCH_FULL_WIDTH=1``
is set, one test at a time:

    REPRO_TORCH_FULL_WIDTH=1 JAX_PLATFORMS=cpu PYTHONPATH=src \\
        python -m pytest -q -s tests/test_torch_full_width.py
"""
import gc
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from test_torch_models import reference  # noqa: E402,F401  (the stub)
from test_torch_train import (CPU, _batch, _items,  # noqa: E402,F401
                              _torch_batch, ref)

pytestmark = pytest.mark.skipif(
    os.environ.get("REPRO_TORCH_FULL_WIDTH") != "1",
    reason="full-width readings need ~20 GiB of host memory and minutes; "
           "REPRO_TORCH_FULL_WIDTH=1 runs them")

torch.backends.cuda.matmul.allow_tf32 = False

SEQ = 256
LR = 3e-4
# the rwkv6 step losses of the two packages, relative: the first step's is
# the bf16 loss of one set of weights (3e-4, test_torch_train's
# BF16_LOSS_TOL); after an update, Adam's first step moves each parameter
# by lr * g / (|g| + eps), so a gradient that rounds to another sign in one
# package moves its parameter 2 * lr apart: 2e-3 after an update.  Readings
# over two runs (the port's bf16 products on the CPU vary between runs, the
# reference's did not): 2.5e-6 and 1.2e-5, 1.0e-4 and 2.3e-5, 8.4e-5 and
# 2.8e-4
STEP_LOSS_TOL = (3e-4, 2e-3, 2e-3)
# the leaf groups of chip_smoke.py's bf16 reading, by path prefix
LEAF_GROUPS = ("embed", "mamba_groups/mamba", "mamba_groups/norm",
               "mamba_tail/mamba", "mamba_tail/norm", "shared/attn",
               "shared/mlp", "shared/norm", "final_norm", "lm_head")


def _cfgs(ref, arch: str, layers: int, **over):
    return (ref.registry.get_config(arch).replace(n_layers=layers, **over),
            get_config(arch).replace(n_layers=layers, **over))


def _init(ref, rcfg) -> dict:
    return ref.transformer.init_params(rcfg, jax.random.key(0))[0]


def _free() -> None:
    gc.collect()
    jax.clear_caches()


def test_rwkv6_adamw_steps_overshoot_in_both_packages(ref):
    """rwkv6-7b at full width, 2 layers, bf16: three AdamW steps (lr
    3e-4, the reference's defaults otherwise) on the synthetic stream's
    batches 0, 1, 2 of 1 x ``SEQ`` tokens.  Each step's loss agrees
    between the packages within ``STEP_LOSS_TOL``, and in both a later
    step's loss is above the first's: Adam's early steps move every
    parameter by ~lr whatever its gradient's size."""
    rcfg, pcfg = _cfgs(ref, "rwkv6-7b", 2)
    data = SyntheticLMDataset(DataConfig(1, SEQ, seed=0), pcfg)
    batches = [data[i] for i in range(3)]

    popt = AdamWConfig(lr=LR)
    params = params_from_jax(_init(ref, rcfg), CPU)
    _free()
    state = {"params": params, "opt_state": adamw_init(params, popt)}
    step = make_train_step(pcfg, popt)
    port = []
    for b in batches:
        state, m = step(state, _torch_batch(b))
        port.append((float(m["loss"]), float(m["grad_norm"])))
    del state, params, step
    gc.collect()

    ropt = ref.optim.AdamWConfig(lr=LR)
    rparams = _init(ref, rcfg)
    rstate = {"params": rparams,
              "opt_state": ref.optim.adamw_init(rparams, ropt)}
    del rparams
    rstep = jax.jit(ref.step.make_train_step(rcfg, ropt), donate_argnums=0)
    want = []
    for b in batches:
        rstate, m = rstep(rstate, jax.tree.map(jnp.asarray, b))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    del rstate, rstep
    _free()

    for i, ((pl, pn), (rl, rn)) in enumerate(zip(port, want)):
        print(f"rwkv6-7b, 2 layers, 1 x {SEQ}, bf16, lr {LR}: step {i + 1} "
              f"loss {rl:.6f} (reference) / {pl:.6f} (port), grad norm "
              f"{rn:.6f} / {pn:.6f}")
    for i, tol in enumerate(STEP_LOSS_TOL):
        assert math.isfinite(port[i][0]) and math.isfinite(want[i][0])
        np.testing.assert_allclose(port[i][0], want[i][0], rtol=tol,
                                   err_msg=f"step {i + 1}")
    for losses in (port, want):
        assert max(x for x, _ in losses[1:]) > losses[0][0], (port, want)


def _group_errors(g16: dict, g32: dict) -> dict:
    """Leaf group -> (relative L2 error ||g16 - g32|| / ||g32||, cosine),
    summed in float64."""
    groups = {g: [k for k in g32 if k.startswith(g)] for g in LEAF_GROUPS}
    assert all(groups.values())
    assert sorted(sum(groups.values(), [])) == sorted(g32)
    out = {}
    for name, keys in groups.items():
        diff = n32 = n16 = dot = 0.0
        for k in keys:
            a = np.asarray(g16[k], np.float64)
            c = np.asarray(g32[k], np.float64)
            diff += float(np.sum((a - c) ** 2))
            n32 += float(np.sum(c * c))
            n16 += float(np.sum(a * a))
            dot += float(np.sum(a * c))
        out[name] = (math.sqrt(diff / n32), dot / math.sqrt(n16 * n32))
    return out


def test_zamba2_bf16_gradient_error_at_full_width(ref):
    """zamba2-1.2b at full width, 8 layers, one row of ``SEQ`` tokens:
    the train step's gradients with bf16 and with fp32 compute from the
    same fp32 masters, in both packages; by leaf group, the port's
    relative L2 error is at most 1.5x the reference's plus 1e-3."""
    rcfg, pcfg = _cfgs(ref, "zamba2-1.2b", 8)
    batch = _batch(pcfg, b=1, s=SEQ, seed=0)
    ropt = ref.optim.AdamWConfig(lr=0.0, b1=0.0, grad_clip=0.0)
    popt = AdamWConfig(lr=0.0, b1=0.0, grad_clip=0.0)
    rparams = _init(ref, rcfg)
    params = params_from_jax(rparams, CPU)
    state = {"params": params, "opt_state": adamw_init(params, popt)}

    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        rstate = {"params": rparams,
                  "opt_state": ref.optim.adamw_init(rparams, ropt)}
        rstate, _ = jax.jit(ref.step.make_train_step(
            rcfg.replace(dtype=dt), ropt))(rstate, jax.tree.map(
                jnp.asarray, batch))
        want[dt] = {k: np.asarray(v, np.float32)
                    for k, v in _items(rstate["opt_state"]["m"])}
        del rstate
        _free()
    del rparams
    _free()
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        state, _ = make_train_step(pcfg.replace(dtype=dt), popt)(
            state, _torch_batch(batch))
        got[dt] = {k: v.numpy().copy()
                   for k, v in _items(state["opt_state"]["m"])}
    del state
    gc.collect()

    r = _group_errors(want[jnp.bfloat16], want[jnp.float32])
    p = _group_errors(got[torch.bfloat16], got[torch.float32])
    for g in LEAF_GROUPS:
        print(f"zamba2-1.2b, 8 layers, 1 x {SEQ}, bf16 vs fp32: {g}: "
              f"relative L2 error {r[g][0]:.4e} (reference) / "
              f"{p[g][0]:.4e} (port), cosine {r[g][1]:.6f} / "
              f"{p[g][1]:.6f}")
    for g in LEAF_GROUPS:
        assert p[g][0] <= 1.5 * r[g][0] + 1e-3, (g, p[g], r[g])
