"""The port's acquisition kernels against the JAX reference.

On the CPU each wrapper takes its plain PyTorch version; the same seeded
numpy inputs go through ``repro.core.kernels`` (``backend="jnp"``, and
the Pallas kernels in interpret mode on the small cases) and through
``repro_torch.core.kernels``.  Tolerance rtol = atol = 2e-4, the
reference's own for its kernels (fp32 with different summation orders).
The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds them against these plain versions there.  The Parzen kernel's
blocking (candidate tiles, row slices per cluster rank, tiles of rows
per thread, shuffle, block and cluster merges, log2-domain sums) is
mirrored here in float64 and held against the plain versions.

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
                                      matern52_cross_plain, matern52_masked,
                                      matern52_masked_plain,
                                      parzen_log_density,
                                      parzen_log_density_plain,
                                      resolve_device, tpe_score,
                                      tpe_score_plain)
from repro_torch.core.kernels import parzen as port_parzen  # noqa: E402

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
    _, xb, mb, bw_b = _t(*_parzen_case(64, 300, 5, 250, seed=1))
    a, b, ls = _t(*_matern_case(64, 32, 5))
    ops = (parzen_log_density, tpe_score, matern52_cross, matern52_masked)
    before = [op.launches for op in ops]
    torch.testing.assert_close(parzen_log_density(x, obs, mask, bw),
                               parzen_log_density_plain(x, obs, mask, bw),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        tpe_score(x, obs, mask, xb, mb, bw, bw_b),
        tpe_score_plain(x, obs, mask, xb, mb, bw, bw_b), rtol=0, atol=0)
    torch.testing.assert_close(matern52_cross(a, b, ls),
                               matern52_cross_plain(a, b, ls),
                               rtol=0, atol=0)
    cm = (torch.arange(32) < 20).float()
    torch.testing.assert_close(matern52_masked(a, b, ls, col_mask=cm),
                               matern52_masked_plain(a, b, ls, col_mask=cm),
                               rtol=0, atol=0)
    assert [op.launches for op in ops] == before


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
    from repro_torch.core.kernels.matern import _matern_cuda
    from repro_torch.core.kernels.parzen import _parzen_cuda
    x = torch.zeros(4, 3)
    mix = (torch.zeros(8, 3), torch.ones(8), torch.ones(3))
    with pytest.raises(ValueError, match="CUDA"):
        _parzen_cuda(x, [mix])
    with pytest.raises(ValueError, match="CUDA"):
        _parzen_cuda(x, [mix, mix])
    with pytest.raises(ValueError, match="CUDA"):
        _matern_cuda(x, x, torch.ones(3), None, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        _matern_cuda(x, x, torch.ones(3), torch.ones(4), torch.ones(4),
                     1e-3)


# ------------------------------------------------------------------ #
# float64 mirror of the Parzen kernel's blocking (csrc/parzen.cu)
# ------------------------------------------------------------------ #
LOG2E = 1.0 / np.log(2.0)


def _merge(m, l, m2, l2):
    """The kernel's merge of (max, sum) pairs; (-inf, 0) is empty."""
    bigger = m2 > m
    with np.errstate(invalid="ignore"):
        up = torch.where(bigger, l * torch.exp2((m - m2) * LOG2E) + l2,
                         l + l2 * torch.exp2((m2 - m) * LOG2E))
    m_new, l_new = torch.maximum(m, m2), up
    m_new = torch.where(m == -np.inf, m2, m_new)
    l_new = torch.where(m == -np.inf, l2, l_new)
    m_new = torch.where(m2 == -np.inf, m, m_new)
    l_new = torch.where(m2 == -np.inf, l, l_new)
    return m_new, l_new


def _rank_partials(xc, obs, mask, bw, lo, hi, start, tile):
    """One block's (m, l, mask sum) for candidates ``xc`` over rows
    [lo, hi) of one mixture, whose row 0 is row ``start`` of the block's
    slice of [good; bad]: thread i % 256 of each ``tile`` of the slice
    takes its row i in order, online log2-domain sums, a butterfly of
    shuffles in each warp, then the 8 warps in order."""
    threads = port_parzen.THREADS
    cb = xc.shape[0]
    m = torch.full((cb, threads), -np.inf, dtype=torch.float64)
    l = torch.zeros((cb, threads), dtype=torch.float64)
    nsum = torch.zeros(threads, dtype=torch.float64)
    rows = torch.arange(lo, max(lo, hi))
    if len(rows):
        xs = xc / bw
        os_ = obs[rows] / bw
        so = 0.5 * (os_ * os_).sum(-1) + torch.log(
            bw * np.sqrt(2 * np.pi)).sum()
        s = xs @ os_.T - so                                     # (cb, R)
        # row i of tile j goes to thread i % 256 as its k-th row
        i, j = (rows + start) % tile, (rows + start) // tile
        thread = i % threads
        k = j * -(-tile // threads) + i // threads
        steps = int(k.max()) + 1
        grid = torch.full((cb, threads, steps), -np.inf, dtype=torch.float64)
        valid = torch.zeros((threads, steps), dtype=torch.bool)
        grid[:, thread, k] = s
        valid[thread, k] = mask[rows] > 0
        nsum.index_add_(0, thread, mask[rows])
        for step in range(steps):
            sr, v = grid[:, :, step], valid[:, step]
            grow = v & (sr > m)
            with np.errstate(invalid="ignore"):
                l = torch.where(grow, l * torch.exp2((m - sr) * LOG2E) + 1.0,
                                torch.where(v, l + torch.exp2(
                                    (sr - m) * LOG2E), l))
            m = torch.where(grow, sr, m)
    lane = torch.arange(threads)
    for off in (16, 8, 4, 2, 1):
        partner = lane ^ off
        m, l = _merge(m, l, m[:, partner], l[:, partner])
        nsum = nsum + nsum[partner]
    mm = torch.full((cb,), -np.inf, dtype=torch.float64)
    ll = torch.zeros(cb, dtype=torch.float64)
    for w in range(threads // 32):
        mm, ll = _merge(mm, ll, m[:, 32 * w], l[:, 32 * w])
    return mm, ll, float(sum(nsum[32 * w] for w in range(threads // 32)))


def _parzen_mirror(x, mixtures):
    """The kernel's algorithm in float64: ``plan``'s candidate tiles and
    cluster slices, per-block partials, the cluster merge in rank order,
    then logk, or the TPE score for two mixtures."""
    c, d = x.shape
    sizes = [obs.shape[0] for obs, _, _ in mixtures]
    cb, slice_, tile = port_parzen.plan(c, d, sum(sizes))
    out = torch.empty(c, dtype=torch.float64)
    for c0 in range(0, c, cb):
        xc = x[c0:c0 + cb]
        sides = []
        for mi, (obs, mask, bw) in enumerate(mixtures):
            base = sum(sizes[:mi])
            mm = torch.full((len(xc),), -np.inf, dtype=torch.float64)
            ll = torch.zeros(len(xc), dtype=torch.float64)
            nn = 0.0
            for rank in range(port_parzen.CLUSTER):
                r_lo = min(sum(sizes), rank * slice_)
                r_hi = min(sum(sizes), r_lo + slice_)
                lo = max(r_lo, base) - base
                hi = min(r_hi, base + sizes[mi]) - base
                pm, pl, pn = _rank_partials(xc, obs, mask, bw, lo, hi,
                                            base - r_lo, tile)
                mm, ll = _merge(mm, ll, pm, pl)
                nn += pn
            xs = xc / bw
            logk = torch.where(mm == -np.inf, -np.inf, mm + torch.log(ll)) \
                - 0.5 * (xs * xs).sum(-1)
            if len(mixtures) == 1:
                sides.append(logk)
                continue
            zp = xc - 0.5
            logp = (-0.5 * zp * zp - np.log(np.sqrt(2 * np.pi))).sum(-1)
            sides.append(torch.logaddexp(logk, logp) - np.log(max(nn, 1) + 1))
        out[c0:c0 + cb] = sides[0] if len(sides) == 1 else sides[0] - sides[1]
    return out


def _mixture(n, d, valid, seed):
    """(obs, mask, bw) in float64; ``valid``: the indices of valid rows."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(n)
    mask[valid] = 1.0
    return (torch.from_numpy(rng.uniform(size=(n, d))), torch.from_numpy(mask),
            torch.from_numpy(rng.uniform(0.05, 0.7, size=d)))


# (label, C, D, [(rows, valid rows) of each mixture]); float64 on both
# sides, so the mirror and the plain version agree to rounding: 1e-9
MIRROR_CASES = [
    ("service shape, two mixtures", 64, 5,
     [(32, slice(0, 25)), (8192, slice(0, 4975))]),
    ("one mixture", 64, 5, [(8192, slice(0, 4975))]),
    ("padding-only slices", 64, 5, [(32, slice(0, 25)), (8192, slice(0, 100))]),
    ("one valid row in the last slice", 48, 3, [(3000, slice(2999, 3000))]),
    ("one valid row in the last slice, two mixtures", 40, 3,
     [(8, slice(0, 1)), (1000, slice(999, 1000))]),
    ("fewer rows than ranks, ragged C", 100, 4, [(3, slice(0, 2)),
                                                 (5, slice(0, 5))]),
    ("tiles smaller than a slice", 256, 100, [(32, slice(0, 30)),
                                              (4096, slice(0, 3000))]),
]


@pytest.mark.parametrize("label,c,d,mixes", MIRROR_CASES,
                         ids=[case[0] for case in MIRROR_CASES])
def test_parzen_blocking_mirror_matches_plain(label, c, d, mixes):
    rng = np.random.default_rng(c * 31 + d)
    x = torch.from_numpy(rng.uniform(size=(c, d)))
    mixtures = [_mixture(n, d, valid, seed=i)
                for i, (n, valid) in enumerate(mixes)]
    out = _parzen_mirror(x, mixtures)
    if len(mixtures) == 1:
        ref = parzen_log_density_plain(x, *mixtures[0])
    else:
        ref = tpe_score_plain(x, *mixtures[0][:2], *mixtures[1][:2],
                              mixtures[0][2], mixtures[1][2])
    torch.testing.assert_close(out, ref, rtol=1e-9, atol=1e-9)


def test_parzen_blocking_mirror_fully_masked_mixture_is_minus_inf():
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(16, 3)))
    mixture = _mixture(600, 3, slice(0, 0), seed=0)
    out = _parzen_mirror(x, [mixture])
    assert torch.isneginf(out).all()
    assert torch.isneginf(parzen_log_density_plain(x, *mixture)).all()


@pytest.mark.parametrize("c,d,n_rows,want", [
    (64, 5, 8224, (4, 1028, 1824)), (128, 5, 8224, (8, 1028, 1792)),
    (256, 5, 8224, (16, 1028, 1792)), (4096, 5, 8224, (16, 1028, 1792)),
    (96, 11, 300, (8, 38, 896)), (1, 1, 3, (1, 1, 2048)),
    (64, 200, 100, (4, 13, 224))])
def test_parzen_plan(c, d, n_rows, want):
    assert port_parzen.plan(c, d, n_rows) == want
