"""The port's samplers against the JAX reference, on the CPU.

* TPE: the reference's proposal order for a fixed key, scored by the
  port's ``_tpe_score`` on the same float32 buffers, is non-increasing
  (within 2e-4 of ties, the kernels' tolerance).  The two draw their
  candidates from different generators (``jax.random`` vs
  ``torch.Generator``), so proposals are held by scoring and quality.
* GP: ``_gp_ei`` against the reference at rtol = atol = 1e-3 — looser
  than the kernels' 2e-4 because the float32 Cholesky solves go through
  two different libraries — and ``GPSampler.suggest`` picks the same
  point (its candidates are numpy Halton points on both sides).
* The fused TPE score's plain version against the reference's two
  ``log_parzen`` sides (its Parzen op, ``jnp`` and Pallas in interpret
  mode, plus the prior), and the masked Matérn op's plain version
  against the reference's K and Ks, at 2e-4.
* The numpy samplers give identical proposals.
* A seeded TPE study's regret is no worse than twice the reference's
  (or 0.05).

TF32 is switched off for both matmuls and cuDNN so that any float32
product taken in this process is full float32.
"""
import math
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.kernels import matern52_cross as ref_matern  # noqa: E402
from repro.core.kernels import parzen_log_density as ref_parzen  # noqa: E402
from repro.core.samplers import make_sampler as ref_make_sampler  # noqa: E402
from repro.core.samplers import gp as ref_gp  # noqa: E402
from repro.core.samplers import tpe as ref_tpe  # noqa: E402
from repro.core.space import SearchSpace as RefSpace  # noqa: E402
from repro.core.types import Direction as RefDirection  # noqa: E402
from repro.core.types import Trial as RefTrial  # noqa: E402
from repro.core.types import TrialState as RefState  # noqa: E402
from repro_torch.core.kernels import _backend  # noqa: E402
from repro_torch.core.kernels import matern52_masked_plain  # noqa: E402
from repro_torch.core.kernels import tpe_score_plain  # noqa: E402
from repro_torch.core.samplers import make_sampler  # noqa: E402
from repro_torch.core.samplers import gp as port_gp  # noqa: E402
from repro_torch.core.samplers import tpe as port_tpe  # noqa: E402
from repro_torch.core.space import SearchSpace  # noqa: E402
from repro_torch.core.types import Direction, Trial, TrialState  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SPACE = {"x": {"type": "uniform", "low": -5, "high": 5},
         "y": {"type": "uniform", "low": -5, "high": 5},
         "n": {"type": "int", "low": 2, "high": 9},
         "c": {"type": "categorical", "choices": ["a", "b", "c"]}}
# the 5-parameter space of benchmarks/bench_ask_latency.py
SPACE5 = {"lr": {"type": "loguniform", "low": 1e-5, "high": 1e-1},
          "wd": {"type": "loguniform", "low": 1e-6, "high": 1e-2},
          "width": {"type": "int", "low": 32, "high": 1024},
          "act": {"type": "categorical", "choices": ["relu", "gelu", "silu"]},
          "dropout": {"type": "uniform", "low": 0.0, "high": 0.5}}


def _split_buffers(ng, nb, d, n_good, n_bad, seed=0):
    """Padded float32 good/bad buffers, as ``_split_xy`` makes them."""
    rng = np.random.default_rng(seed)
    xg = np.zeros((ng, d), np.float32)
    xg[:n_good] = rng.uniform(0.3, 0.5, size=(n_good, d))
    mg = (np.arange(ng) < n_good).astype(np.float32)
    xb = np.zeros((nb, d), np.float32)
    xb[:n_bad] = rng.uniform(size=(n_bad, d))
    mb = (np.arange(nb) < n_bad).astype(np.float32)
    return xg, mg, xb, mb


@pytest.mark.parametrize("ng,nb,d,n_good,n_bad,pool", [
    (8, 16, 2, 3, 12, 64),
    (32, 64, 5, 25, 60, 64),
    (32, 8192, 5, 25, 4975, 128),
])
def test_tpe_score_orders_reference_proposals(ng, nb, d, n_good, n_bad,
                                              pool):
    bufs = _split_buffers(ng, nb, d, n_good, n_bad)
    ref = np.asarray(ref_tpe._tpe_propose(
        *map(jnp.asarray, bufs), jax.random.PRNGKey(7), pool))
    xg, mg, xb, mb = map(torch.from_numpy, bufs)
    gen = torch.Generator().manual_seed(0)
    _, bw, bw_b = port_tpe._tpe_candidates(xg, mg, xb, mb, gen, pool)
    score = port_tpe._tpe_score(torch.from_numpy(ref.copy()), xg, mg, xb, mb,
                                bw, bw_b).numpy()
    assert np.isfinite(score).all()
    assert np.all(np.diff(score) <= 2e-4), np.diff(score).max()


def _ref_log_parzen(x, obs, mask, bw, backend):
    """The reference's ``log_parzen`` (``repro.core.samplers.tpe``): its
    Parzen op on ``backend`` plus the uniform prior, in jnp."""
    logk = ref_parzen(x, obs, mask, bw, backend=backend)
    zp = x - 0.5
    logp = (-0.5 * zp * zp - jnp.log(math.sqrt(2 * math.pi))).sum(-1)
    n = jnp.maximum(mask.sum(), 1.0)
    return jnp.logaddexp(logk, logp) - jnp.log(n + 1.0)


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("ng,nb,d,n_good,n_bad,pool", [
    (8, 16, 2, 3, 12, 64),
    (32, 64, 5, 25, 60, 64),
    (32, 8192, 5, 25, 4975, 128),
])
def test_tpe_score_plain_matches_reference(backend, ng, nb, d, n_good, n_bad,
                                           pool):
    """The fused op's plain version (the CPU route of ``_tpe_score``)
    against the reference's two ``log_parzen`` sides; 2e-4."""
    bufs = _split_buffers(ng, nb, d, n_good, n_bad)
    rng = np.random.default_rng(pool)
    cands = rng.uniform(size=(pool, d)).astype(np.float32)
    bw = rng.uniform(0.05, 0.5, size=d).astype(np.float32)
    bw_b = rng.uniform(0.08, 0.7, size=d).astype(np.float32)
    xg, mg, xb, mb = map(jnp.asarray, bufs)
    ref = (_ref_log_parzen(jnp.asarray(cands), xg, mg, jnp.asarray(bw),
                           backend)
           - _ref_log_parzen(jnp.asarray(cands), xb, mb, jnp.asarray(bw_b),
                             backend))
    out = tpe_score_plain(*map(torch.from_numpy,
                               (cands, *bufs, bw, bw_b)))
    assert out.dtype == torch.float32 and out.shape == (pool,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_tpe_candidates_shape_and_mix():
    xg, mg, xb, mb = map(torch.from_numpy, _split_buffers(8, 16, 3, 3, 12))
    gen = torch.Generator().manual_seed(3)
    cands, bw, bw_b = port_tpe._tpe_candidates(xg, mg, xb, mb, gen, 64)
    assert cands.shape == (64, 3) and cands.dtype == torch.float32
    assert ((cands >= 0) & (cands <= 1)).all()
    assert ((bw >= 0.05) & (bw <= 0.5)).all()
    assert ((bw_b >= 0.08) & (bw_b <= 0.7)).all()
    # from l(x): near a valid good row (never a padding row at 0)
    from_l = cands[torch.arange(64) % 4 != 3]
    dist = torch.cdist(from_l, xg[:3]).min(1).values
    assert (dist < 4 * bw.max() * math.sqrt(3)).all()


def test_tpe_propose_is_sorted_by_its_own_score():
    bufs = [torch.from_numpy(b) for b in _split_buffers(8, 32, 4, 5, 20)]
    out = port_tpe._tpe_propose(*bufs, 11, 64)
    gen = torch.Generator().manual_seed(11)
    cands, bw, bw_b = port_tpe._tpe_candidates(*bufs, gen, 64)
    score = port_tpe._tpe_score(cands, *bufs, bw, bw_b)
    order = torch.argsort(-score, stable=True)
    np.testing.assert_array_equal(out, cands[order].numpy())


def _gp_inputs(n_obs, cap, d, n_cands, seed=0):
    rng = np.random.default_rng(seed)
    X = np.zeros((cap, d), np.float32)
    X[:n_obs] = rng.uniform(size=(n_obs, d))
    y = np.zeros(cap, np.float32)
    y[:n_obs] = ((X[:n_obs] - 0.4) ** 2).sum(1) + 0.05 * rng.normal(
        size=n_obs)
    mask = (np.arange(cap) < n_obs).astype(np.float32)
    cands = rng.uniform(size=(n_cands, d)).astype(np.float32)
    ls = np.full(d, 0.25, np.float32)
    return X, y, mask, cands, ls


@pytest.mark.parametrize("n_obs,cap,d,n_cands", [
    (8, 16, 2, 64), (40, 64, 5, 256), (300, 512, 5, 256)])
def test_gp_ei_matches_reference(n_obs, cap, d, n_cands):
    inputs = _gp_inputs(n_obs, cap, d, n_cands)
    ref = np.asarray(ref_gp._gp_ei(*map(jnp.asarray, inputs)))
    out = port_gp._gp_ei(*map(torch.from_numpy, inputs))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_obs,cap,d,n_cands", [
    (8, 16, 2, 64), (40, 64, 5, 256), (300, 512, 5, 256)])
def test_matern_masked_plain_matches_reference_gp_covariances(n_obs, cap, d,
                                                              n_cands):
    """K and Ks as the reference's ``_gp_ei`` forms them (its Matérn op,
    then the masks and the jitter diagonal in jnp) against the masked
    op's plain version; 2e-4, the kernels' tolerance."""
    X, _, mask, cands, ls = _gp_inputs(n_obs, cap, d, n_cands)
    Xj, mj, cj, lj = map(jnp.asarray, (X, mask, cands, ls))
    K = ref_matern(Xj, Xj, lj)
    K = jnp.where(mj[:, None] * mj[None, :] > 0, K, 0.0)
    K = K + jnp.diag(jnp.where(mj > 0, 1e-6 + 1e-3, 1.0))
    Ks = ref_matern(cj, Xj, lj) * mj[None, :]
    Xt, mt, ct, lt = map(torch.from_numpy, (X, mask, cands, ls))
    K_out = matern52_masked_plain(Xt, Xt, lt, mt, mt, jitter=1e-6 + 1e-3)
    Ks_out = matern52_masked_plain(ct, Xt, lt, col_mask=mt)
    np.testing.assert_allclose(K_out.numpy(), np.asarray(K), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(Ks_out.numpy(), np.asarray(Ks), rtol=2e-4,
                               atol=2e-4)
    # padded rows and columns are exactly 0 off the diagonal, 1 on it
    pad = mask == 0
    assert (K_out.numpy()[pad][:, ~pad] == 0).all()
    assert (np.diag(K_out.numpy())[pad] == 1.0).all()
    assert (Ks_out.numpy()[:, pad] == 0).all()


def _history(trial_cls, state, space, n, seed=0):
    rng = np.random.default_rng(seed)
    trials = []
    for i in range(n):
        u = rng.uniform(size=space.dim)
        params = space.from_unit_vector(u)
        trials.append(trial_cls(
            trial_id=i, uid=f"s:{i}", study_key="s", params=params,
            state=state.COMPLETED, value=float(((u - 0.3) ** 2).sum())))
    return trials


def test_gp_suggest_matches_reference():
    ref_space = RefSpace.from_properties(SPACE5)
    space = SearchSpace.from_properties(SPACE5)
    ref_trials = _history(RefTrial, RefState, ref_space, 30)
    trials = _history(Trial, TrialState, space, 30)
    ref = ref_make_sampler({"name": "gp"}).suggest(
        ref_space, ref_trials, RefDirection.MINIMIZE,
        np.random.default_rng(5))
    out = make_sampler({"name": "gp"}, device="cpu").suggest(
        space, trials, Direction.MINIMIZE, np.random.default_rng(5))
    assert out == ref


def test_gp_sampler_on_cuda_loads_linalg_first(monkeypatch):
    """A GP sampler on the card loads PyTorch's CUDA linalg library when
    it is made, before a request lane and the speculative worker can
    make the first linalg call at once (the card's fault)."""
    loaded = []
    monkeypatch.setattr(port_gp, "load_cuda_linalg", loaded.append)
    port_gp.GPSampler(device="cpu")
    assert loaded == []                     # the CPU makes no such call
    monkeypatch.setattr(port_gp, "resolve_device",
                        lambda device: torch.device("cuda"))
    port_gp.GPSampler(device="cuda")
    assert loaded == [torch.device("cuda")]


def test_load_cuda_linalg_makes_one_call_across_threads(monkeypatch):
    """Eight threads load at once: one first linalg call is made, and the
    others wait for it (PyTorch's lazy loader raises on a second
    concurrent first call; the stand-in below does the same)."""
    calls, inside, errors = [], [], []

    def first_call(x):
        if inside:
            raise RuntimeError("lazy wrapper should be called at most once")
        inside.append(1)
        time.sleep(0.2)
        calls.append(x.device)
        return x

    monkeypatch.setattr(_backend, "_linalg_loaded", False)
    monkeypatch.setattr(torch.linalg, "cholesky", first_call)
    start = threading.Barrier(8)

    def load():
        start.wait()
        try:
            _backend.load_cuda_linalg(torch.device("cpu"))
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert errors == [] and calls == [torch.device("cpu")]
    _backend.load_cuda_linalg(torch.device("cpu"))
    assert len(calls) == 1


def _drive(make, space, trial_cls, state, direction, n, batch=1):
    """Sequential ask/tell with the sampler's own rng; returns params."""
    sampler = make()
    rng = np.random.default_rng(0)
    trials, out = [], []
    while len(trials) < n:
        if batch == 1:
            props = [sampler.suggest(space, trials, direction, rng)]
        else:
            props = sampler.suggest_batch(space, trials, direction, rng,
                                          batch)
        for p in props:
            v = float((p["x"] - 1) ** 2 + p["y"] ** 2 + 0.1 * p["n"]
                      + (p["c"] == "b"))
            trials.append(trial_cls(
                trial_id=len(trials), uid=f"s:{len(trials)}",
                study_key="s", params=p, state=state.COMPLETED, value=v,
                values=[v, -p["x"]]))
            out.append(p)
    return out


@pytest.mark.parametrize("spec", [
    {"name": "random"}, {"name": "grid"}, {"name": "halton"},
    {"name": "quasirandom", "seed": 2}, {"name": "cmaes", "seed": 1},
    {"name": "nsga2", "population": 6}])
@pytest.mark.parametrize("batch", [1, 4])
def test_numpy_samplers_identical(spec, batch):
    ref = _drive(lambda: ref_make_sampler(dict(spec)),
                 RefSpace.from_properties(SPACE), RefTrial, RefState,
                 RefDirection.MINIMIZE, 24, batch)
    out = _drive(lambda: make_sampler(dict(spec)),
                 SearchSpace.from_properties(SPACE), Trial, TrialState,
                 Direction.MINIMIZE, 24, batch)
    assert out == ref


def test_tpe_startup_phase_identical():
    spec = {"name": "tpe", "n_startup_trials": 10}
    ref = _drive(lambda: ref_make_sampler(dict(spec)),
                 RefSpace.from_properties(SPACE), RefTrial, RefState,
                 RefDirection.MINIMIZE, 10)
    out = _drive(lambda: make_sampler(dict(spec), device="cpu"),
                 SearchSpace.from_properties(SPACE), Trial, TrialState,
                 Direction.MINIMIZE, 10)
    assert out == ref


def test_make_sampler_device():
    assert make_sampler({"name": "tpe"}, device="cpu").device.type == "cpu"
    assert make_sampler({"name": "gp"}, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="server setting"):
        make_sampler({"name": "tpe", "device": "cpu"}, device="cpu")
    if not torch.cuda.is_available():
        for name in ("tpe", "gp"):
            with pytest.raises(RuntimeError, match="cuda"):
                make_sampler({"name": name})


def _sphere_regret(make, space_cls, trial_cls, state, direction, seed,
                   n=60):
    """Best value of a seeded study on a shifted sphere over [-5, 5]^3
    (optimum 0 at (1.5, -2, 0.5))."""
    props = {k: {"type": "uniform", "low": -5, "high": 5} for k in "abc"}
    space = space_cls.from_properties(props)
    sampler = make()
    rng = np.random.default_rng(seed)
    trials, best = [], math.inf
    for i in range(n):
        p = sampler.suggest(space, trials, direction, rng)
        v = (p["a"] - 1.5) ** 2 + (p["b"] + 2) ** 2 + (p["c"] - 0.5) ** 2
        trials.append(trial_cls(trial_id=i, uid=f"s:{i}", study_key="s",
                                params=p, state=state.COMPLETED, value=v))
        best = min(best, v)
    return best


def test_tpe_quality_matches_reference():
    """Median regret over five seeded 60-trial studies: one study's best
    value varies several-fold with the candidate draws, which the two
    generators make differently."""
    seeds = range(5)
    ref = np.median([_sphere_regret(
        lambda: ref_make_sampler({"name": "tpe"}), RefSpace, RefTrial,
        RefState, RefDirection.MINIMIZE, s) for s in seeds])
    out = np.median([_sphere_regret(
        lambda: make_sampler({"name": "tpe"}, device="cpu"), SearchSpace,
        Trial, TrialState, Direction.MINIMIZE, s) for s in seeds])
    assert out <= max(2 * ref, 0.05), (out, ref)
