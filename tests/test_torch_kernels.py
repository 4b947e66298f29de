"""The port's acquisition kernels against the JAX reference.

On the CPU each wrapper takes its plain PyTorch version; the same seeded
numpy inputs go through ``repro.core.kernels`` (``backend="jnp"``, and
the Pallas kernels in interpret mode on the small cases) and through
``repro_torch.core.kernels``.  Tolerance rtol = atol = 2e-4, the
reference's own for its kernels (fp32 with different summation orders).
The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds them against these plain versions there.

TF32 is switched off for both matmuls and cuDNN so that any float32
product taken in this process is full float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.kernels import matern52_cross as ref_matern  # noqa: E402
from repro.core.kernels import parzen_log_density as ref_parzen  # noqa: E402
from repro_torch.core.kernels import (matern52_cross,  # noqa: E402
                                      matern52_cross_plain,
                                      parzen_log_density,
                                      parzen_log_density_plain,
                                      resolve_device)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-4, atol=2e-4)

# the reference kernel tests' cases, then the service's main-path shapes
# (C = max(64, pow2(4k)), 32 good / 8192 bad rows at a 5k history, D = 5)
PARZEN_SMALL = [(64, 8, 1, 3), (64, 32, 5, 20), (128, 256, 3, 256),
                (256, 512, 11, 300)]
PARZEN_MAIN = [(64, 32, 5, 25), (128, 32, 5, 25), (64, 8192, 5, 4975),
               (128, 8192, 5, 4975)]
MATERN_SMALL = [(8, 8, 2), (64, 32, 5), (256, 128, 7)]
MATERN_MAIN = [(512, 512, 5), (256, 512, 5)]


def _parzen_case(c, n, d, n_valid, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(c, d)).astype(np.float32)
    obs = rng.uniform(size=(n, d)).astype(np.float32)
    mask = (np.arange(n) < n_valid).astype(np.float32)
    bw = rng.uniform(0.05, 0.7, size=d).astype(np.float32)
    return x, obs, mask, bw


def _matern_case(a, b, d, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(a, d)).astype(np.float32),
            rng.uniform(size=(b, d)).astype(np.float32),
            rng.uniform(0.1, 0.5, size=d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("backend_name,case", [
    *[("jnp", c) for c in PARZEN_SMALL + PARZEN_MAIN],
    *[("pallas_interpret", c) for c in PARZEN_SMALL]])
def test_parzen_matches_reference(backend_name, case):
    x, obs, mask, bw = _parzen_case(*case)
    ref = ref_parzen(*map(jnp.asarray, (x, obs, mask, bw)),
                     backend=backend_name)
    out = parzen_log_density(*_t(x, obs, mask, bw))
    assert out.dtype == torch.float32 and out.shape == (case[0],)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("backend_name,case", [
    *[("jnp", c) for c in MATERN_SMALL + MATERN_MAIN],
    *[("pallas_interpret", c) for c in MATERN_SMALL]])
def test_matern_matches_reference(backend_name, case):
    a, b, ls = _matern_case(*case)
    ref = ref_matern(*map(jnp.asarray, (a, b, ls)), backend=backend_name)
    out = matern52_cross(*_t(a, b, ls))
    assert out.dtype == torch.float32 and out.shape == case[:2]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, obs, mask, bw = _t(*_parzen_case(64, 32, 5, 20))
    a, b, ls = _t(*_matern_case(64, 32, 5))
    before = (parzen_log_density.launches, matern52_cross.launches)
    torch.testing.assert_close(parzen_log_density(x, obs, mask, bw),
                               parzen_log_density_plain(x, obs, mask, bw),
                               rtol=0, atol=0)
    torch.testing.assert_close(matern52_cross(a, b, ls),
                               matern52_cross_plain(a, b, ls),
                               rtol=0, atol=0)
    assert (parzen_log_density.launches, matern52_cross.launches) == before


def test_plain_parzen_fully_masked_row_is_minus_inf():
    x, obs, _, bw = _t(*_parzen_case(64, 8, 3, 0))
    out = parzen_log_density_plain(x, obs, torch.zeros(8), bw)
    assert torch.isneginf(out).all()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_resolve_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot "
                    "be provoked")
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(dev)


def test_cuda_wrappers_reject_cpu_operands_of_the_raw_kernels():
    """The raw launchers take only CUDA float32 operands; they raise
    before loading any library, so this holds without a card too."""
    from repro_torch.core.kernels.matern import matern_cuda
    from repro_torch.core.kernels.parzen import parzen_lse_cuda
    xa = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        parzen_lse_cuda(xa, xa)
    with pytest.raises(ValueError, match="CUDA"):
        matern_cuda(xa, xa)
