"""The port's SSD and WKV6 scans against the JAX reference.

On the CPU ``ssd`` and ``wkv6`` take their plain versions (the
sequential recurrences).  The same seeded numpy inputs go through the
reference's ops (the Pallas kernels in interpret mode, as the
reference's own tests run them on the CPU), its recurrences
(``ref.ssd_ref``, ``ref.wkv6_ref``) and its model's chunked forms, and
through the port.  Tolerances are the reference's own
(``tests/kernels/test_ssd_wkv.py``): 2e-4 in fp32, 5e-2 (SSD) and 6e-2
(WKV6) in bf16.  The CUDA kernels run only on the card:
``chip_smoke.py`` holds them against the plain versions there.

The reference's model modules import the missing ``repro.dist``; the
tests that need them take the ``reference`` fixture of
``test_torch_models.py``, which stubs it and restores ``sys.modules``.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.mamba2_ssd import ops as ref_ssd_ops  # noqa: E402
from repro.kernels.mamba2_ssd import ref as ref_ssd_ref  # noqa: E402
from repro.kernels.rwkv6_scan import ops as ref_wkv_ops  # noqa: E402
from repro.kernels.rwkv6_scan import ref as ref_wkv_ref  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ssd  # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6  # noqa: E402
from repro_torch.models import mamba2, rwkv6  # noqa: E402
from test_torch_models import reference  # noqa: E402,F401  (the stub)

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = {"ssd": dict(rtol=5e-2, atol=5e-2), "wkv6": dict(rtol=6e-2, atol=6e-2)}


def _ssd_inputs(seed, b, S, nh, hd, ds):
    """x (b,S,nh,hd), dt (b,S,nh) > 0, a_log (nh,), B and C (b,S,ds)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, nh, hd), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, nh)))).astype(np.float32)
    a_log = (rng.standard_normal(nh) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, S, ds), dtype=np.float32)
    C = rng.standard_normal((b, S, ds), dtype=np.float32)
    return x, dt, a_log, B, C


def _wkv_inputs(seed, b, S, nh, hd):
    """r, k, v, logw (b,S,nh,hd) with logw < 0, u (nh,hd), S0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, S, nh, hd), dtype=np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, S, nh, hd)) * 0.8 - 0.5)
    u = rng.standard_normal((nh, hd)) * 0.5
    S0 = rng.standard_normal((b, nh, hd, hd)) * 0.5
    return (r, k, v, logw.astype(np.float32), u.astype(np.float32),
            S0.astype(np.float32))


def _port(arrays, dtype=torch.float32, n_cast=None):
    """numpy -> torch; the first ``n_cast`` arrays in ``dtype``."""
    n_cast = len(arrays) if n_cast is None else n_cast
    return [torch.from_numpy(a).to(dtype if i < n_cast else torch.float32)
            for i, a in enumerate(arrays)]


def _ref(arrays, dtype=jnp.float32, n_cast=None):
    n_cast = len(arrays) if n_cast is None else n_cast
    return [jnp.asarray(a).astype(dtype if i < n_cast else jnp.float32)
            for i, a in enumerate(arrays)]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or F32))


def _ssd_port_args(arrays, dtype=torch.float32):
    x, dt, a_log, B, C = _port(arrays, dtype)
    return x, dt, a_log.float(), B, C


def _ssd_ref_args(arrays, dtype=jnp.float32):
    x, dt, a_log, B, C = _ref(arrays, dtype)
    return x, dt, a_log.astype(jnp.float32), B, C


# ------------------------------------------------------------------ #
# Mamba2 SSD
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_matches_reference(chunk):
    arrays = _ssd_inputs(chunk, 2, 64, 3, 16, 8)
    before = ssd.launches
    y, h = ssd(*_ssd_port_args(arrays), chunk=chunk)
    assert ssd.launches == before                   # CPU: no kernel launch
    assert y.dtype == torch.float32 and y.shape == (2, 64, 3, 16)
    assert h.dtype == torch.float32 and h.shape == (2, 3, 16, 8)
    y_k, h_k = ref_ssd_ops.ssd(*_ssd_ref_args(arrays), chunk=chunk,
                               interpret=True)
    y_r, h_r = ref_ssd_ref.ssd_ref(*_ssd_ref_args(arrays))
    for want_y, want_h in ((y_k, h_k), (y_r, h_r)):
        _close(y, want_y)
        _close(h, want_h)


def test_ssd_bf16_matches_reference():
    arrays = _ssd_inputs(1, 1, 32, 2, 8, 4)
    y, h = ssd(*_ssd_port_args(arrays, torch.bfloat16), chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_k, _ = ref_ssd_ops.ssd(*_ssd_ref_args(arrays, jnp.bfloat16), chunk=16,
                             interpret=True)
    _close(y, y_k, **BF16["ssd"])


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_reference(reference, chunk):
    """The port's chunked form against the reference's, with and without
    a carried state, and against the reference's kernel."""
    arrays = _ssd_inputs(10 + chunk, 2, 64, 2, 16, 8)
    h0 = np.random.default_rng(chunk).standard_normal(
        (2, 2, 16, 8)).astype(np.float32)
    y, h = mamba2.ssd_chunked(*_ssd_port_args(arrays), chunk=chunk)
    y_m, h_m = reference.mamba2.ssd_chunked(*_ssd_ref_args(arrays),
                                            chunk=chunk)
    y_k, h_k = ref_ssd_ops.ssd(*_ssd_ref_args(arrays), chunk=chunk,
                               interpret=True)
    for want_y, want_h in ((y_m, h_m), (y_k, h_k)):
        _close(y, want_y)
        _close(h, want_h)
    y, h = mamba2.ssd_chunked(*_ssd_port_args(arrays), chunk=chunk,
                              h0=torch.from_numpy(h0))
    y_m, h_m = reference.mamba2.ssd_chunked(*_ssd_ref_args(arrays),
                                            chunk=chunk, h0=jnp.asarray(h0))
    _close(y, y_m)
    _close(h, h_m)


def test_ssd_step_matches_reference(reference):
    x, dt, a_log, B, C = _ssd_inputs(3, 2, 1, 3, 16, 8)
    h0 = np.random.default_rng(3).standard_normal(
        (2, 3, 16, 8)).astype(np.float32)
    port = [torch.from_numpy(a) for a in (x[:, 0], dt[:, 0], a_log,
                                          B[:, 0], C[:, 0], h0)]
    want_y, want_h = reference.mamba2.ssd_step(
        *[jnp.asarray(a) for a in (x[:, 0], dt[:, 0], a_log, B[:, 0],
                                   C[:, 0], h0)])
    y, h = mamba2.ssd_step(*port)
    _close(y, want_y)
    _close(h, want_h)


@settings(max_examples=8, deadline=None)
@given(S=st.sampled_from([16, 32, 48]), nh=st.sampled_from([1, 2, 4]),
       hd=st.sampled_from([8, 16]), ds=st.sampled_from([4, 8]),
       chunk=st.sampled_from([8, 16]))
def test_ssd_property_sweep(S, nh, hd, ds, chunk):
    arrays = _ssd_inputs(S * nh + hd, 1, S, nh, hd, ds)
    y, h = ssd(*_ssd_port_args(arrays), chunk=chunk)
    y_r, h_r = ref_ssd_ref.ssd_ref(*_ssd_ref_args(arrays))
    _close(y, y_r)
    _close(h, h_r)
    y, h = mamba2.ssd_chunked(*_ssd_port_args(arrays), chunk=chunk)
    _close(y, y_r)
    _close(h, h_r)


# ------------------------------------------------------------------ #
# RWKV6 WKV
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_wkv6_matches_reference(chunk):
    r, k, v, logw, u, _ = _wkv_inputs(chunk, 2, 64, 2, 16)
    before = wkv6.launches
    o, S = wkv6(*_port((r, k, v, logw, u)), chunk=chunk)
    assert wkv6.launches == before                  # CPU: no kernel launch
    assert o.dtype == torch.float32 and o.shape == (2, 64, 2, 16)
    assert S.dtype == torch.float32 and S.shape == (2, 2, 16, 16)
    o_k, S_k = ref_wkv_ops.wkv6(*_ref((r, k, v, logw, u)), chunk=chunk,
                                interpret=True)
    o_r, S_r = ref_wkv_ref.wkv6_ref(*_ref((r, k, v, logw, u)))
    for want_o, want_S in ((o_k, S_k), (o_r, S_r)):
        _close(o, want_o)
        _close(S, want_S)


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_with_initial_state_matches_reference(reference, chunk):
    """A carried state: the reference's op hands it to its chunked form;
    the port's op (and, on the card, its kernel) takes it itself."""
    arrays = _wkv_inputs(100 + chunk, 2, 128, 2, 16)
    o, S = wkv6(*_port(arrays[:5]), chunk=chunk,
                S0=torch.from_numpy(arrays[5]))
    ref_args = _ref(arrays[:5])
    o_k, S_k = ref_wkv_ops.wkv6(*ref_args, chunk=chunk,
                                S0=jnp.asarray(arrays[5]), interpret=True)
    o_r, S_r = ref_wkv_ref.wkv6_ref(*ref_args, S0=jnp.asarray(arrays[5]))
    for want_o, want_S in ((o_k, S_k), (o_r, S_r)):
        _close(o, want_o)
        _close(S, want_S)


def test_wkv6_bf16_matches_reference():
    r, k, v, logw, u, _ = _wkv_inputs(2, 1, 32, 2, 8)
    o, S = wkv6(*_port((r, k, v, logw, u), torch.bfloat16, n_cast=4),
                chunk=16)
    assert o.dtype == torch.bfloat16 and S.dtype == torch.float32
    o_k, _ = ref_wkv_ops.wkv6(*_ref((r, k, v, logw, u), jnp.bfloat16,
                                    n_cast=4), chunk=16, interpret=True)
    _close(o, o_k, **BF16["wkv6"])


@pytest.mark.parametrize("chunk", [8, 64])
def test_wkv6_chunked_matches_reference(reference, chunk):
    """The port's chunked form against the reference's (with and without
    a carried state) and against the reference's kernel."""
    arrays = _wkv_inputs(20 + chunk, 1, 64, 2, 16)
    y, S = rwkv6.wkv6_chunked(*_port(arrays[:5]), chunk=chunk)
    y_m, S_m = reference.rwkv6.wkv6_chunked(*_ref(arrays[:5]), chunk=chunk)
    y_k, S_k = ref_wkv_ops.wkv6(*_ref(arrays[:5]), chunk=chunk,
                                interpret=True)
    for want_y, want_S in ((y_m, S_m), (y_k, S_k)):
        _close(y, want_y)
        _close(S, want_S)
    y, S = rwkv6.wkv6_chunked(*_port(arrays[:5]), chunk=chunk,
                              S0=torch.from_numpy(arrays[5]))
    y_m, S_m = reference.rwkv6.wkv6_chunked(*_ref(arrays[:5]), chunk=chunk,
                                            S0=jnp.asarray(arrays[5]))
    _close(y, y_m)
    _close(S, S_m)


def test_wkv6_step_matches_reference(reference):
    r, k, v, logw, u, S0 = _wkv_inputs(4, 2, 1, 3, 16)
    one = [a[:, 0] for a in (r, k, v, logw)] + [u, S0]
    o, S = rwkv6.wkv6_step(*[torch.from_numpy(a) for a in one])
    want_o, want_S = reference.rwkv6.wkv6_step(*[jnp.asarray(a)
                                                 for a in one])
    _close(o, want_o)
    _close(S, want_S)


@settings(max_examples=8, deadline=None)
@given(S=st.sampled_from([16, 32]), nh=st.sampled_from([1, 3]),
       hd=st.sampled_from([8, 16]), chunk=st.sampled_from([8, 16, 64]))
def test_wkv6_property_sweep(S, nh, hd, chunk):
    arrays = _wkv_inputs(S + nh * hd, 1, S, nh, hd)
    o, S_fin = wkv6(*_port(arrays[:5]), chunk=chunk)
    o_r, S_r = ref_wkv_ref.wkv6_ref(*_ref(arrays[:5]))
    _close(o, o_r)
    _close(S_fin, S_r)
    o, S_fin = rwkv6.wkv6_chunked(*_port(arrays[:5]), chunk=chunk)
    _close(o, o_r)
    _close(S_fin, S_r)


# ------------------------------------------------------------------ #
# the wrappers' own rules
# ------------------------------------------------------------------ #
def _op_args(op):
    if op == "ssd":
        return ssd, _ssd_port_args(_ssd_inputs(5, 1, 24, 2, 8, 4))
    return wkv6, _port(_wkv_inputs(5, 1, 24, 2, 8)[:5])


@pytest.mark.parametrize("op", ["ssd", "wkv6"])
def test_op_raises_where_the_reference_asserts(op):
    fn, args = _op_args(op)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        fn(*args, chunk=16)                          # S = 24
    with pytest.raises(ValueError):
        fn(*[a[:, :0] if a.dim() > 1 else a for a in args], chunk=8)
    with pytest.raises(ValueError):
        fn(args[0], args[1][..., :1], *args[2:], chunk=8)  # dt / k shape


@pytest.mark.parametrize("op", ["ssd", "wkv6"])
def test_op_is_forward_only(op):
    fn, args = _op_args(op)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*args, chunk=8)
    with torch.no_grad():
        out, _ = fn(*args, chunk=8)
    assert out.shape == args[0].shape


# ------------------------------------------------------------------ #
# strong decays
# ------------------------------------------------------------------ #
def _strong_wkv_inputs(seed, b, S, nh, hd):
    """As ``_wkv_inputs`` with logw log-uniform in [-30, -1e-3] a step."""
    r, k, v, _, u, S0 = _wkv_inputs(seed, b, S, nh, hd)
    rng = np.random.default_rng(seed + 1)
    logw = -np.exp(rng.uniform(np.log(1e-3), np.log(30.0), r.shape))
    return r, k, v, logw.astype(np.float32), u, S0


def _strong_ssd_inputs(seed, b, S, nh, hd, ds):
    """As ``_ssd_inputs`` with dt up to 10 and A down to -5: dt * A
    reaches -50 a step."""
    x, _, _, B, C = _ssd_inputs(seed, b, S, nh, hd, ds)
    rng = np.random.default_rng(seed + 1)
    dt = rng.uniform(0.01, 10.0, (b, S, nh)).astype(np.float32)
    a_log = np.linspace(-1.0, np.log(5.0), nh).astype(np.float32)
    return x, dt, a_log, B, C


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_strong_decay_matches_reference(reference, chunk):
    """logw down to -30 a step: the port's plain version against the
    reference's recurrence, and the port's chunked form against the
    reference's, with and without a carried state."""
    arrays = _strong_wkv_inputs(30 + chunk, 2, 128, 2, 16)
    o, S = wkv6(*_port(arrays[:5]), chunk=chunk)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(S).all())
    o_r, S_r = ref_wkv_ref.wkv6_ref(*_ref(arrays[:5]))
    _close(o, o_r)
    _close(S, S_r)
    for S0 in (None, arrays[5]):
        y, S = rwkv6.wkv6_chunked(
            *_port(arrays[:5]), chunk=chunk,
            S0=None if S0 is None else torch.from_numpy(S0))
        y_m, S_m = reference.rwkv6.wkv6_chunked(
            *_ref(arrays[:5]), chunk=chunk,
            S0=None if S0 is None else jnp.asarray(S0))
        assert bool(torch.isfinite(y).all())
        _close(y, y_m)
        _close(S, S_m)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_strong_decay_matches_reference(reference, chunk):
    """dt * A down to -50 a step: the port's plain version and chunked
    form against the reference's recurrence and chunked form."""
    arrays = _strong_ssd_inputs(40 + chunk, 2, 128, 3, 16, 8)
    y, h = ssd(*_ssd_port_args(arrays), chunk=chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y_r, h_r = ref_ssd_ref.ssd_ref(*_ssd_ref_args(arrays))
    _close(y, y_r)
    _close(h, h_r)
    y, h = mamba2.ssd_chunked(*_ssd_port_args(arrays), chunk=chunk)
    y_m, h_m = reference.mamba2.ssd_chunked(*_ssd_ref_args(arrays),
                                            chunk=chunk)
    assert bool(torch.isfinite(y).all())
    _close(y, y_m)
    _close(h, h_m)
    _close(y, y_r)
    _close(h, h_r)


# ------------------------------------------------------------------ #
# which kernel a CUDA call launches
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype,hd,symbol", [
    ("bfloat16", 64, "wkv6_mma_kernel<64>"),
    ("bfloat16", 32, "wkv6_mma_kernel<32>"),
    ("bfloat16", 16, "wkv6_mma_kernel<16>"),
    ("bfloat16", 128, "wkv6_fwd_kernel<__nv_bfloat16, 128>"),
    ("float32", 64, "wkv6_fwd_kernel<float, 64>"),
    ("float32", 128, "wkv6_fwd_kernel<float, 128>"),
])
def test_wkv6_kernel_symbol_follows_type_and_head_dim(dtype, hd, symbol):
    """The kernel a CUDA call launches depends on its type and head dim
    alone; ``chip_smoke.py`` reads its device time and checks the served
    prefill's launches by this name."""
    from repro_torch.kernels.rwkv6_scan import ops
    assert ops.kernel_symbol(getattr(torch, dtype), hd) == symbol


@pytest.mark.parametrize("dtype,hd,ds,symbol", [
    ("bfloat16", 64, 64, "ssd_mma_kernel<64, 64>"),
    ("bfloat16", 32, 16, "ssd_mma_kernel<32, 16>"),
    ("bfloat16", 16, 32, "ssd_mma_kernel<16, 32>"),
    ("bfloat16", 64, 128, "ssd_fwd_kernel<__nv_bfloat16, 64, 128>"),
    ("bfloat16", 128, 64, "ssd_fwd_kernel<__nv_bfloat16, 128, 64>"),
    ("float32", 64, 64, "ssd_fwd_kernel<float, 64, 64>"),
])
def test_ssd_kernel_symbol_follows_type_and_dims(dtype, hd, ds, symbol):
    from repro_torch.kernels.mamba2_ssd import ops
    assert ops.kernel_symbol(getattr(torch, dtype), hd, ds) == symbol


def test_aligned_rows_copies_only_views_off_16_byte_rows():
    """The tensor-core scans load rows with 16-byte ``cp.async`` copies:
    a view whose rows start off such a boundary is copied, any other
    tensor is passed through."""
    from repro_torch.core.kernels._backend import aligned_rows
    view = torch.zeros((2, 8, 4, 72), dtype=torch.bfloat16)[..., :64]
    assert aligned_rows(view) is view          # rows 144 bytes apart
    fused = torch.randn((2, 8, 4, 65)).to(torch.bfloat16)
    for odd in (fused[..., :64], fused[..., 1:]):  # 130-byte rows; offset
        copy = aligned_rows(odd)
        assert copy is not odd and copy.is_contiguous()
        assert torch.equal(copy, odd)
