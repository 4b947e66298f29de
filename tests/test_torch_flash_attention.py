"""The port's flash attention op against the JAX reference.

On the CPU the op takes its plain PyTorch version; the same seeded numpy
inputs go through the reference's ``ops.flash_attention`` (the Pallas
kernel in interpret mode, as the reference's own tests run it on the
CPU) and through ``repro_torch.kernels.flash_attention``.  Tolerances
are the reference's own: 2e-4 in fp32, 2e-2 in bf16.  The CUDA kernel
itself runs only on the card: ``chip_smoke.py`` holds it against the
plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro.kernels.flash_attention import ref as ref_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention, ops, ref)

torch.backends.cuda.matmul.allow_tf32 = False

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# (B, Hq, Hkv, S, T, hd, dtype, causal, window)
CASES = {
    "fp32-causal": (2, 4, 4, 128, 128, 64, "float32", True, None),
    "fp32-full": (2, 4, 4, 128, 128, 64, "float32", False, None),
    "bf16-causal": (2, 4, 4, 128, 128, 64, "bfloat16", True, None),
    "bf16-full": (2, 4, 4, 128, 128, 64, "bfloat16", False, None),
    "gqa-8-2": (1, 8, 2, 128, 128, 32, "float32", True, None),
    "window-32": (1, 2, 2, 256, 256, 32, "float32", True, 32),
    "window-64": (1, 2, 2, 256, 256, 32, "float32", True, 64),
    "s96": (1, 2, 2, 96, 96, 32, "float32", True, None),
    "s100-hd16": (2, 4, 2, 100, 100, 16, "float32", True, None),
    "hd128-gqa-bf16": (1, 8, 2, 64, 64, 128, "bfloat16", True, None),
    # full window of 8 over T = 8 keys: rows 15.. see no key -> 0
    "fully-masked-rows": (1, 2, 2, 32, 8, 16, "float32", False, 8),
    # the edges of the card's 128 x 128 tiles at hd 64 and 128: S and T
    # not multiples of 128, GQA 8:1, windows that are not tile multiples
    "gqa-8-1-hd128-s200-bf16": (1, 8, 1, 200, 200, 128, "bfloat16", True,
                                None),
    "window-40-hd64-s300": (1, 4, 4, 300, 300, 64, "float32", True, 40),
    "window-200-hd64-s260-bf16": (1, 2, 2, 260, 260, 64, "bfloat16", True,
                                  200),
    "full-hd128-s136-t264-bf16": (1, 4, 2, 136, 264, 128, "bfloat16", False,
                                  None),
    "causal-hd64-s130-t260-bf16": (2, 2, 1, 130, 260, 64, "bfloat16", True,
                                   None),
}


def _inputs(B, Hq, Hkv, S, T, hd, seed):
    """Model-layout numpy inputs: q (B, S, Hq, hd), k/v (B, T, Hkv, hd)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, hd), dtype=np.float32),
            rng.standard_normal((B, T, Hkv, hd), dtype=np.float32),
            rng.standard_normal((B, T, Hkv, hd), dtype=np.float32))


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _reference(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


@pytest.mark.parametrize("name", list(CASES))
def test_flash_op_matches_reference(name):
    B, Hq, Hkv, S, T, hd, dtype, causal, window = CASES[name]
    arrays = _inputs(B, Hq, Hkv, S, T, hd, seed=len(name))
    want = ref_ops.flash_attention(*_reference(arrays, dtype), causal=causal,
                                   window=window, interpret=True)
    before = flash_attention.launches
    got = flash_attention(*_port(arrays, dtype), causal=causal,
                          window=window)
    assert flash_attention.launches == before       # CPU: no kernel launch
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, Hq, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_fully_masked_rows_are_zero():
    B, Hq, Hkv, S, T, hd, dtype, causal, window = CASES["fully-masked-rows"]
    arrays = _inputs(B, Hq, Hkv, S, T, hd, seed=7)
    got = flash_attention(*_port(arrays, dtype), causal=causal,
                          window=window)
    # row s sees keys k > s - 8, and T = 8: rows 15.. see none
    assert torch.all(got[:, 15:] == 0)
    assert torch.all(got[:, :15].abs().sum(-1) > 0)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16), (False, 16)])
def test_plain_version_matches_reference_oracle(causal, window):
    """``ref.attention_ref`` against the reference's oracle, kernel
    layout (B, H, S, hd), T != S."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 6, 48, 32), dtype=np.float32)
    k = rng.standard_normal((2, 2, 40, 32), dtype=np.float32)
    v = rng.standard_normal((2, 2, 40, 32), dtype=np.float32)
    want = ref_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window)
    got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)),
                            causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    model_layout = attention_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal, window=window)
    np.testing.assert_allclose(model_layout.transpose(1, 2).numpy(),
                               got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("offset", [0, 64, 37])
def test_query_offset_gives_the_rows_of_the_whole_sequence(offset, window):
    """Queries at positions ``offset ..`` (a shard of a sequence-parallel
    q; 37 is off every tile grid): the plain version and the op on the
    CPU equal those rows of the reference's plain path over the whole
    sequence, GQA 8:2, fp32 within 1e-5."""
    S, S_l = 256, 64
    q, k, v = _inputs(2, 8, 2, S, S, 32, seed=offset + 1)
    want = np.asarray(ref_ops.attention_ref(
        *_reference((q, k, v), "float32"), causal=True, window=window))
    q_l = q[:, offset:offset + S_l]
    got = attention_ref(*_port((q_l, k, v), "float32"), causal=True,
                        window=window, q_offset=offset)
    np.testing.assert_allclose(got.numpy(), want[:, offset:offset + S_l],
                               rtol=1e-5, atol=1e-5)
    op = flash_attention(*_port((q_l, k, v), "float32"), causal=True,
                         window=window, q_offset=offset)
    np.testing.assert_array_equal(op.numpy(), got.numpy())


def test_op_raises_when_autograd_would_reach_it():
    q, k, v = _port(_inputs(1, 2, 2, 16, 16, 16, seed=0), "float32")
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, k, v)
    with torch.no_grad():                      # inference is fine
        assert flash_attention(q, k, v).shape == q.shape


@pytest.mark.parametrize("hd", [8, 80, 256])
def test_op_raises_on_unsupported_head_dim(hd):
    q, k, v = _port(_inputs(1, 2, 2, 16, 16, hd, seed=0), "float32")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)


def test_op_raises_on_bad_shapes_and_window():
    q, k, v = _port(_inputs(1, 4, 3, 16, 16, 16, seed=0), "float32")
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        flash_attention(q, k, v)
    q, k, v = _port(_inputs(1, 2, 2, 16, 16, 16, seed=0), "float32")
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)


@pytest.mark.parametrize("dtype,hd,symbol", [
    ("bfloat16", 128, "flash_fwd_wgmma_kernel<128>"),
    ("bfloat16", 64, "flash_fwd_wgmma_kernel<64>"),
    ("bfloat16", 32, "flash_fwd_mma_kernel<32>"),
    ("bfloat16", 16, "flash_fwd_mma_kernel<16>"),
    ("float32", 128, "flash_fwd_kernel<128>"),
    ("float32", 64, "flash_fwd_kernel<64>"),
])
def test_kernel_symbol_follows_type_and_head_dim(dtype, hd, symbol):
    """The kernel a CUDA call launches depends on its type and head dim
    alone; ``chip_smoke.py`` reads each one's device time by this name."""
    assert ops.kernel_symbol(getattr(torch, dtype), hd) == symbol
