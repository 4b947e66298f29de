"""Float64 mirrors of the blocked algorithms of the bf16 scan kernels.

The bf16 WKV6 and SSD kernels (``csrc/wkv6.cu``, ``csrc/ssd.cu``) run
their chunk products on tensor cores, which the CPU cannot run.  Their
algorithms are written out here in float64 PyTorch, step for step, and
held against the JAX package's recurrences (``ref.wkv6_ref``,
``ref.ssd_ref``) and its Pallas kernels in interpret mode at 2e-4:

- WKV6 factors the per-channel decay over sub-blocks of 16 rows: for t
  in sub-block i (first row b_i) and s before it,
  exp(W_{t-1} - W_s) = exp(W_{t-1} - W_{b_i-1}) * exp(W_{b_i-1} - W_s),
  so the off-diagonal pairs are one product r~ k~^T.  Inside a diagonal
  16 x 16 sub-block the same factoring at W_{b_i+7} covers its
  lower-left 8 x 8 quadrant; only the two diagonal 8 x 8 quadrants keep
  one exponential per (t, s, d) term.
- SSD's four chunk products: C B^T, (C B^T * L) x, C h^T scaled by
  exp(cum_t), and (x * tail)^T B into the state.

Every exponent a mirror evaluates is recorded; none may be positive
(the overflow the reference's kernel warns of).  With ``bf16=True`` a
mirror rounds every tensor-core operand to bf16 where the kernel does,
and must stay within the reference's bf16 tolerances (6e-2 WKV6, 5e-2
SSD) at the model's chunk 64 and head dim 64.  One bf16 copy of each
operand is not enough there: over the model's 3.4e7 outputs the
rounding of any one of them sends a few outputs near 0, whose terms are
large, past the tolerance.  So every operand that is not an input goes
to the tensor cores as two bf16 parts, hi + lo, in two or three
products; only the inputs (bf16 already) and x * dt (rounded to bf16,
as the plain version rounds it) go as one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.mamba2_ssd import ops as ref_ssd_ops  # noqa: E402
from repro.kernels.mamba2_ssd import ref as ref_ssd_ref  # noqa: E402
from repro.kernels.rwkv6_scan import ops as ref_wkv_ops  # noqa: E402
from repro.kernels.rwkv6_scan import ref as ref_wkv_ref  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = {"ssd": dict(rtol=5e-2, atol=5e-2), "wkv6": dict(rtol=6e-2, atol=6e-2)}
SUB = 16                                 # rows of a WKV6 sub-block
QUAD = 8                                 # rows of its diagonal quadrants


class _Exp:
    """torch.exp that records the largest argument it was given."""

    def __init__(self):
        self.max = -np.inf

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        finite = a[torch.isfinite(a)]
        if finite.numel():
            self.max = max(self.max, float(finite.max()))
        return torch.exp(a)


def _round(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A tensor-core operand: bf16 in the kernel, exact here otherwise."""
    return t.to(torch.bfloat16).double() if bf16 else t


def _split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t as two bf16 parts, hi + lo."""
    hi = _round(t, True)
    return hi, _round(t - hi, True)


def _mm(a: torch.Tensor, b: torch.Tensor, bf16: bool, *,
        split_a: bool = True, split_b: bool = True) -> torch.Tensor:
    """a @ b as the kernel computes it: a split operand is hi + lo; of
    the four partial products the kernel drops lo @ lo."""
    if not bf16:
        return a @ b
    ah, al = _split(a) if split_a else (_round(a, True), None)
    bh, bl = _split(b) if split_b else (_round(b, True), None)
    out = ah @ bh
    if bl is not None:
        out = out + ah @ bl
    if al is not None:
        out = out + al @ bh
    return out


def wkv6_blocked(r, k, v, logw, u, S0=None, *, chunk, bf16=False):
    """The bf16 WKV6 kernel's algorithm.  r, k, v, logw (b, S, nh, hd),
    u (nh, hd), S0 (b, nh, hd, hd) or None.  -> (o, S_final, largest
    exponent evaluated)."""
    ex = _Exp()
    r, k, v, logw = (t.double().transpose(1, 2) for t in (r, k, v, logw))
    b, nh, S, hd = r.shape
    u = u.double()[None, :, None, :]
    St = (torch.zeros(b, nh, hd, hd, dtype=torch.float64) if S0 is None
          else S0.double())
    strict = torch.ones(QUAD, QUAD).tril(-1).bool()
    outs = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lc = (t[:, :, c0:c0 + chunk] for t in (r, k, v, logw))
        W = lc.cumsum(2)                              # W_t
        Wm1 = W - lc                                  # W_{t-1}, W_{-1} = 0
        Q = W.shape[2]
        scores = torch.zeros(b, nh, Q, Q, dtype=torch.float64)
        o = torch.zeros(b, nh, Q, hd, dtype=torch.float64)
        for i0 in range(0, Q, SUB):
            rows = slice(i0, min(i0 + SUB, Q))
            n = rows.stop - i0
            base = Wm1[:, :, i0:i0 + 1]               # W_{b_i - 1}
            r_t = rc[:, :, rows] * ex(Wm1[:, :, rows] - base)
            # inter-chunk: (r * exp(W_{t-1})) . S
            o[:, :, rows] = _mm(r_t * ex(base), St, bf16)
            if i0:                                    # earlier sub-blocks
                k_t = kc[:, :, :i0] * ex(base - W[:, :, :i0])
                scores[:, :, rows, :i0] = _mm(r_t, k_t.mT, bf16)
            # the diagonal sub-block: its two diagonal 8 x 8 quadrants
            # exact, one exponential per strict term ...
            for q0 in range(i0, rows.stop, QUAD):
                qr = slice(q0, min(q0 + QUAD, rows.stop))
                nq = qr.stop - q0
                expo = Wm1[:, :, qr, None] - W[:, :, None, qr]
                dec = ex(expo.masked_fill(~strict[:nq, :nq, None],
                                          -torch.inf))
                scores[:, :, qr, qr] = torch.einsum(
                    "bhtd,bhsd,bhtsd->bhts", rc[:, :, qr], kc[:, :, qr], dec)
            # ... its lower-left quadrant factored at W_{b_i+7}
            if n > QUAD:
                tq, sq = slice(i0 + QUAD, rows.stop), slice(i0, i0 + QUAD)
                base_q = Wm1[:, :, i0 + QUAD:i0 + QUAD + 1]  # W_{b_i+7}
                r_q = rc[:, :, tq] * ex(Wm1[:, :, tq] - base_q)
                k_q = kc[:, :, sq] * ex(base_q - W[:, :, sq])
                scores[:, :, tq, sq] = _mm(r_q, k_q.mT, bf16)
            idx = torch.arange(i0, rows.stop)
            scores[:, :, idx, idx] = (rc[:, :, rows] * u
                                      * kc[:, :, rows]).sum(-1)  # u bonus
        o = o + _mm(scores, vc, bf16, split_b=False)
        W_last = W[:, :, -1:]
        k_hat = kc * ex(W_last - W)
        St = ex(W_last).mT * St + _mm(k_hat.mT, vc, bf16, split_b=False)
        outs.append(_round(o, bf16))                  # o in the input type
    return torch.cat(outs, 2).transpose(1, 2), St, ex.max


def ssd_blocked(x, dt, a_log, B, C, *, chunk, bf16=False):
    """The bf16 SSD kernel's algorithm.  x (b, S, nh, hd), dt (b, S, nh),
    a_log (nh,), B and C (b, S, ds).  -> (y, h_final, largest exponent
    evaluated)."""
    ex = _Exp()
    A = -torch.exp(a_log.double())
    xw = _round(x.double() * dt.double()[..., None], bf16).transpose(1, 2)
    la = (dt.double() * A).transpose(1, 2)           # (b, nh, S)
    B, C = B.double()[:, None], C.double()[:, None]  # (b, 1, S, ds)
    b, nh, S, hd = xw.shape
    h = torch.zeros(b, nh, hd, B.shape[-1], dtype=torch.float64)
    ys = []
    for c0 in range(0, S, chunk):
        xc, cum = xw[:, :, c0:c0 + chunk], la[:, :, c0:c0 + chunk].cumsum(-1)
        Bc, Cc = B[:, :, c0:c0 + chunk], C[:, :, c0:c0 + chunk]
        Q = cum.shape[-1]
        causal = torch.ones(Q, Q).tril().bool()
        L = ex((cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~causal, -torch.inf))
        y = (_mm((Cc @ Bc.mT) * L, xc, bf16, split_b=False)
             + ex(cum)[..., None] * _mm(Cc, h.mT, bf16, split_a=False))
        tail = ex(cum[..., -1:] - cum)[..., None]
        h = (ex(cum[..., -1])[..., None, None] * h
             + _mm((xc * tail).mT, Bc, bf16, split_b=False))
        ys.append(_round(y, bf16))
    return torch.cat(ys, 2).transpose(1, 2), h, ex.max


# ------------------------------------------------------------------ #
# inputs, as numpy from a seed
# ------------------------------------------------------------------ #
def _wkv_inputs(seed, b, S, nh, hd, strong=False):
    """r, k, v (b,S,nh,hd); logw < 0, down to about -30 a step when
    ``strong``; u (nh,hd); S0 (b,nh,hd,hd)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, S, nh, hd)) for _ in range(3))
    if strong:
        logw = -np.exp(rng.uniform(np.log(1e-3), np.log(30.0),
                                   (b, S, nh, hd)))
    else:
        logw = -np.exp(rng.standard_normal((b, S, nh, hd)) * 0.8 - 0.5)
    u = rng.standard_normal((nh, hd)) * 0.5
    S0 = rng.standard_normal((b, nh, hd, hd)) * 0.5
    return [a.astype(np.float32) for a in (r, k, v, logw, u, S0)]


def _ssd_inputs(seed, b, S, nh, hd, ds, strong=False):
    """x (b,S,nh,hd); dt (b,S,nh) > 0; a_log (nh,); B, C (b,S,ds).  With
    ``strong``, dt up to 10 and A down to -5: dt * A down to -50."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, nh, hd))
    if strong:
        dt = rng.uniform(0.01, 10.0, (b, S, nh))
        a_log = np.linspace(-1.0, np.log(5.0), nh)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, S, nh))))
        a_log = rng.standard_normal(nh) * 0.5
    B = rng.standard_normal((b, S, ds))
    C = rng.standard_normal((b, S, ds))
    return [a.astype(np.float32) for a in (x, dt, a_log, B, C)]


def _bf16_np(a):
    """numpy float32 -> the float32 values of its bf16 rounding."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _close(got, want, **tol):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), **(tol or F32))


# ------------------------------------------------------------------ #
# WKV6
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_blocking_matches_reference(chunk, hd):
    arrays = _wkv_inputs(chunk + hd, 1, 128, 2, hd)
    r, k, v, logw, u, S0 = (torch.from_numpy(a) for a in arrays)
    o, S, top = wkv6_blocked(r, k, v, logw, u, chunk=chunk)
    assert top <= 0.0
    ref_args = [jnp.asarray(a) for a in arrays[:5]]
    for want_o, want_S in (ref_wkv_ref.wkv6_ref(*ref_args),
                           ref_wkv_ops.wkv6(*ref_args, chunk=chunk,
                                            interpret=True)):
        _close(o, want_o)
        _close(S, want_S)
    # a carried state
    o, S, top = wkv6_blocked(r, k, v, logw, u, S0, chunk=chunk)
    assert top <= 0.0
    want_o, want_S = ref_wkv_ref.wkv6_ref(*ref_args, S0=jnp.asarray(S0))
    _close(o, want_o)
    _close(S, want_S)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_blocking_strong_decay(chunk, hd):
    """logw down to about -30 a step: W falls by hundreds in a chunk,
    and still no exponent is positive and nothing overflows.  Held
    against the sequential recurrence: the Pallas kernel's float32
    in-chunk cumsum loses about 5e-4 at these decays (W_{t-1} - W_s is
    a difference of two sums of hundreds), above the 2e-4 tolerance,
    while this float64 mirror agrees with a float64 recurrence to 1e-13."""
    arrays = _wkv_inputs(7 + chunk + hd, 1, 128, 2, hd, strong=True)
    o, S, top = wkv6_blocked(*(torch.from_numpy(a) for a in arrays[:5]),
                             chunk=chunk)
    assert top <= 0.0
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(S).all())
    want_o, want_S = ref_wkv_ref.wkv6_ref(*[jnp.asarray(a)
                                            for a in arrays[:5]])
    _close(o, want_o)
    _close(S, want_S)


@pytest.mark.parametrize("strong", [False, True])
def test_wkv6_blocking_bf16_operands_hold(strong):
    """Every tensor-core operand rounded to bf16, as the kernel rounds
    it: within the reference's bf16 tolerance at chunk 64 and hd 64, over
    enough outputs (5e5) for the rare ones near 0 to show."""
    arrays = _wkv_inputs(11, 1, 2048, 4, 64, strong=strong)
    arrays = [_bf16_np(a) for a in arrays[:5]] + [arrays[5]]
    r, k, v, logw, u, S0 = (torch.from_numpy(a) for a in arrays)
    o, S, top = wkv6_blocked(r, k, v, logw, u, S0, chunk=64, bf16=True)
    assert top <= 0.0
    want_o, want_S = ref_wkv_ref.wkv6_ref(
        *[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:5]],
        S0=jnp.asarray(S0))
    _close(o, want_o, **BF16["wkv6"])
    _close(S, want_S, **BF16["wkv6"])


# ------------------------------------------------------------------ #
# SSD
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_blocking_matches_reference(chunk, hd, strong):
    """Ordinary decays and dt * A down to -50 a step."""
    arrays = _ssd_inputs(chunk + hd + strong, 1, 128, 2, hd, 32,
                         strong=strong)
    y, h, top = ssd_blocked(*(torch.from_numpy(a) for a in arrays),
                            chunk=chunk)
    assert top <= 0.0
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    ref_args = [jnp.asarray(a) for a in arrays]
    for want_y, want_h in (ref_ssd_ref.ssd_ref(*ref_args),
                           ref_ssd_ops.ssd(*ref_args, chunk=chunk,
                                           interpret=True)):
        _close(y, want_y)
        _close(h, want_h)


@pytest.mark.parametrize("strong", [False, True])
def test_ssd_blocking_bf16_operands_hold(strong):
    """Every tensor-core operand rounded to bf16, as the kernel rounds
    it: within the reference's bf16 tolerance at chunk 64, hd = ds = 64,
    over enough outputs (5e5) for the rare ones near 0 to show."""
    arrays = [_bf16_np(a) if i != 2 else a for i, a in enumerate(
        _ssd_inputs(13, 1, 2048, 4, 64, 64, strong=strong))]
    y, h, top = ssd_blocked(*(torch.from_numpy(a) for a in arrays),
                            chunk=64, bf16=True)
    assert top <= 0.0
    # the Pallas op, which rounds x * dt to bf16 as the kernel and the
    # port's plain version do (under XLA's fusion ``ref.ssd_ref`` keeps
    # that product in float32, 0.9-1.6 of the tolerance away from both)
    want_y, want_h = ref_ssd_ops.ssd(
        *[jnp.asarray(a).astype(jnp.float32 if i == 2 else jnp.bfloat16)
          for i, a in enumerate(arrays)], chunk=64, interpret=True)
    _close(y, want_y, **BF16["ssd"])
    _close(h, want_h, **BF16["ssd"])
