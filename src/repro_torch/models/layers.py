"""Shared neural building blocks (plain functions over dicts of tensors).

Parameters are nested dicts of tensors with the reference's keys and
layouts.  Every leaf is made by a ``ParamInit`` call that names its
logical sharding axes (``axes=("embed", "mlp")``), the counterpart of
the reference's ``Leaf``/``split_tree``: the same init run with
``LogicalAxes`` in place of ``ParamInit`` returns the tree of axes
(``transformer.param_specs``), which ``repro_torch.dist.sharding`` maps
onto a device mesh.  Random parameters come from a ``torch.Generator``:
the same seed gives other numbers than ``jax.random``, so parity tests
carry the reference's parameters across (``repro_torch.models.convert``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..dist import shard_ops


# --------------------------------------------------------------------- #
# parameter init
# --------------------------------------------------------------------- #
class ParamInit:
    """Makes parameters on one device from one generator.  On the
    ``meta`` device it makes shapes only (no allocation, no draws): the
    port's abstract init, for counting a 67B-parameter model."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = (None if device.type == "meta"
                    else torch.Generator(device=device).manual_seed(seed))

    def __call__(self, shape: tuple[int, ...], dtype: Any,
                 axes: tuple[str | None, ...] | None = None,
                 scale: float | None = None, init: str = "normal"
                 ) -> torch.Tensor:
        """One leaf of ``shape``; ``axes`` names its logical axes (one
        a dim), which ``LogicalAxes`` returns in place of the tensor."""
        if axes is not None and len(axes) != len(shape):
            raise ValueError(f"axes {axes} do not match shape {shape}")
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return w.mul_(scale).to(dtype)


class LogicalAxes(ParamInit):
    """A ``ParamInit`` that makes no tensor: each leaf is its logical
    axes tuple, so an init run with it gives the specs tree."""

    def __init__(self):
        self.device, self.gen = torch.device("meta"), None

    def __call__(self, shape: tuple[int, ...], dtype: Any,
                 axes: tuple[str | None, ...] | None = None,
                 scale: float | None = None, init: str = "normal"
                 ) -> tuple[str | None, ...]:
        if axes is None or len(axes) != len(shape):
            raise ValueError(f"axes {axes} do not match shape {shape}")
        return tuple(axes)


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def init_rmsnorm(mk: ParamInit, d: int, dtype: Any,
                 stacked: int | None = None) -> torch.Tensor:
    if stacked is None:
        return mk((d,), dtype, ("embed",), init="ones")
    return mk((stacked, d), dtype, ("layers", "embed"), init="ones")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """On DTensors on each device's rows (``dist.shard_ops.rowwise``);
    where the normed dim is itself sharded (a block's inner width over
    its heads), on each device's shard of it, with one all-reduce of the
    sum of squares."""
    dims = shard_ops.mesh_dims(x, -1)
    if dims:
        return _rmsnorm_sharded(x, w, eps, dims)
    return shard_ops.rowwise(functools.partial(_rmsnorm, eps=eps), x, w)


def _rmsnorm_sharded(x: torch.Tensor, w: torch.Tensor, eps: float,
                     dims: list[int]) -> torch.Tensor:
    from torch.distributed.tensor import Replicate
    mesh, n = x.device_mesh, x.shape[-1]
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    wl = shard_ops.layout(mesh.ndim, {i: 0 for i in dims})

    def fn(x, w):
        dt = x.dtype
        x = x.float()
        ss = shard_ops.sum_over(torch.sum(x * x, dim=-1, keepdim=True),
                                mesh, dims)
        return (x * torch.rsqrt(ss / n + eps) * w.float()).to(dt)
    return shard_ops.local_map(fn, (x, w), (pl, wl), pl)


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# --------------------------------------------------------------------- #
# MLP (SwiGLU / plain)
# --------------------------------------------------------------------- #
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
}


def init_mlp(mk: ParamInit, d_model: int, d_ff: int, dtype: Any, glu: bool,
             stacked: int | None = None) -> dict:
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    p = {"up": mk((*L, d_model, d_ff), dtype, (*A, "embed", "mlp")),
         "down": mk((*L, d_ff, d_model), dtype, (*A, "mlp", "embed"))}
    if glu:
        p["gate"] = mk((*L, d_model, d_ff), dtype, (*A, "embed", "mlp"))
    return p


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Products in the activation dtype, as the reference's
    ``preferred_element_type=dt`` einsums."""
    fn = ACTIVATIONS[act]
    dt = x.dtype
    if "gate" in p:
        x, xg = shard_ops.fan_out(x, 2)
    else:
        (x,) = shard_ops.fan_out(x, 1)
    h = shard_ops.matmul(x, p["up"].to(dt))
    if "gate" in p:
        h = h * fn(shard_ops.matmul(xg, p["gate"].to(dt)))
    else:
        h = fn(h)
    return shard_ops.matmul(h, p["down"].to(dt))


# --------------------------------------------------------------------- #
# rotary position embeddings
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_correction_range(dim: int, theta: float, beta_fast: float,
                          beta_slow: float, original_max_position: int
                          ) -> tuple[int, int]:
    """The rotary pairs YaRN leaves whole and those it interpolates
    fully: the floor and the ceiling of the pair index that turns
    ``beta_fast`` and ``beta_slow`` times over the original context,
    clamped to the pairs (DeepSeek-V2's ``yarn_find_correction_range``)."""
    def pair(turns: float) -> float:
        return (dim * math.log(original_max_position / (turns * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(pair(beta_fast)), 0),
            min(math.ceil(pair(beta_slow)), dim - 1))


def yarn_frequencies(head_dim: int, theta: float, factor: float,
                     beta_fast: float, beta_slow: float,
                     original_max_position: int,
                     device: torch.device | None = None) -> torch.Tensor:
    """YaRN's inverse frequencies (arXiv:2309.00071): f / ``factor`` (1 -
    m) + f m, f the plain ones, m 1 below the correction range, 0 above
    it and a linear ramp between.  cos and sin are not rescaled here:
    DeepSeek-V2's two mscales are equal, so their ratio is 1."""
    lo, hi = yarn_correction_range(head_dim, theta, beta_fast, beta_slow,
                                   original_max_position)
    f = rope_frequencies(head_dim, theta, device)
    i = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    ramp = torch.clamp((i - lo) / max(hi - lo, 1e-3), 0.0, 1.0)
    m = 1.0 - ramp
    return f / factor * (1.0 - m) + f * m


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               inv_freq: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) int.  ``inv_freq`` (hd/2,): the
    inverse frequencies, where not the plain ones of ``theta`` (YaRN's)."""
    hd = x.shape[-1]
    freqs = (rope_frequencies(hd, theta, x.device) if inv_freq is None
             else inv_freq)                                     # (hd/2,)
    angles = positions[:, None, None].float() * freqs            # (S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1f, x2f = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------- #
# embeddings / LM head
# --------------------------------------------------------------------- #
def init_embedding(mk: ParamInit, vocab: int, d_model: int, dtype: Any
                   ) -> torch.Tensor:
    return mk((vocab, d_model), dtype, ("vocab", "embed"), scale=0.02)


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; a DTensor table on each device's rows
    (``dist.shard_ops.embedding``)."""
    return shard_ops.embedding(table, ids)


def init_lm_head(mk: ParamInit, d_model: int, vocab: int, dtype: Any
                 ) -> torch.Tensor:
    return mk((d_model, vocab), dtype, ("embed", "vocab"))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL in fp32.  logits (..., V); labels (...) int32 or
    int64 (gathered as int64); ``mask`` (...) weights the tokens."""
    logits = logits.float()
    nll = shard_ops.nll(logits, labels.long())
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
