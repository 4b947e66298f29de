"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434), without
query compression, for training and prefill over the full sequence.

Per layer, with d the model width, H heads, dn/dr the query and key
heads' content and rotary widths, dv the value width and r the latent:

    q = x W_q                      (H, dn + dr): [q_nope, q_pe]
    [c, k_pe] = x W_kva            r + dr; k_pe one vector for all heads
    [k_nope, v] = RMSNorm(c) W_kvb (H, dn + dv)
    q_pe, k_pe rotated by YaRN's frequencies (``layers.yarn_frequencies``)
    out = causal softmax([q_nope, q_pe] . [k_nope, k_pe] * s) v W_o

with s = (dn + dr)^-1/2 mscale^2, mscale = 0.1 mscale_all_dim ln(factor)
+ 1.  The rotary dims are rotated as two halves (``layers.apply_rope``);
DeepSeek's code rotates interleaved pairs, which is a fixed relabelling
of W_q's and W_kva's rotary columns.  The core is the plain one
(``attention._ref_core``: the scores materialised, softmax in fp32).

Layouts: ``wq`` (d, H, dn + dr), ``wkv_a`` (d, r + dr), ``kv_norm``
(r,), ``wkv_b`` (r, H, dn + dv), ``wo`` (H, dv, d).  Under a profiler
the projections record ``mla.project`` and the core ``mla.core``
(``repro_torch.spans``).
"""
from __future__ import annotations

import functools
import math

import torch

from .. import spans
from ..dist import shard_ops
from . import attention as attn_mod
from .config import ModelConfig
from .layers import ParamInit, apply_rope, rmsnorm, yarn_frequencies


def init_mla(mk: ParamInit, cfg: ModelConfig, stacked: int | None = None
             ) -> dict:
    m = cfg.mla
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.param_dtype
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": mk((*L, d, h, dq), dt, (*A, "embed", "heads", "head_dim")),
        "wkv_a": mk((*L, d, m.kv_lora_rank + m.qk_rope_head_dim), dt,
                    (*A, "embed", None)),
        "kv_norm": mk((*L, m.kv_lora_rank), dt, (*A, None), init="ones"),
        "wkv_b": mk((*L, m.kv_lora_rank, h,
                     m.qk_nope_head_dim + m.v_head_dim), dt,
                    (*A, None, "heads", "head_dim")),
        "wo": mk((*L, h, m.v_head_dim, d), dt,
                 (*A, "heads", "head_dim", "embed"))}


def mscale(factor: float, m: float) -> float:
    """YaRN's attention temperature (DeepSeek-V2's ``yarn_get_mscale``)."""
    return 0.1 * m * math.log(factor) + 1.0


def softmax_scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    s = mscale(m.rope_factor, m.mscale_all_dim)
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5 * s * s


def inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    """YaRN's inverse frequencies of ``cfg``, made once a device."""
    m = cfg.mla
    return _yarn(m.qk_rope_head_dim, cfg.rope_theta, m.rope_factor,
                 m.beta_fast, m.beta_slow, m.original_max_position,
                 torch.device(device))


@functools.lru_cache(maxsize=16)
def _yarn(*args) -> torch.Tensor:
    return yarn_frequencies(*args)


def project(p: dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q, k (B, S, H, dn + dr), v (B, S, H, dv), products
    in ``cfg.dtype``."""
    m, dt = cfg.mla, cfg.dtype
    B, S, d = x.shape
    H, dn, dr, r = (cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                    m.kv_lora_rank)
    mm = shard_ops.matmul
    xq, xkv = shard_ops.fan_out(x, 2)
    q = mm(xq, p["wq"].to(dt).reshape(d, -1)).unflatten(-1, (H, dn + dr))
    c, k_pe = mm(xkv, p["wkv_a"].to(dt)).split([r, dr], dim=-1)
    dv = m.v_head_dim
    kv = mm(rmsnorm(c, p["kv_norm"], cfg.norm_eps),
            p["wkv_b"].to(dt).reshape(r, -1)).unflatten(-1, (H, dn + dv))
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    # the query's heads and the shared key rotated in one call
    q_pe, k_pe = apply_rope(torch.cat([q_pe, k_pe[:, :, None]], dim=2),
                            positions, cfg.rope_theta,
                            inv_freq(cfg, x.device)).split([H, 1], dim=2)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, S, H, dr)], dim=-1)
    return q, k, v


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal MLA (train / prefill) -> (B, S, d)."""
    if cfg.attn_impl != "ref":
        raise NotImplementedError(
            f"{cfg.name}: MLA runs the plain core only (attn_impl 'ref'); "
            f"no flash kernel takes query and key heads of "
            f"{cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim} and "
            f"value heads of {cfg.mla.v_head_dim}")
    with spans.span("mla.project"):
        q, k, v = project(p, cfg, x, positions)
    with spans.span("mla.core"):
        out = attn_mod._ref_core(cfg, q, k, v, positions, positions,
                                 scale=softmax_scale(cfg))
    return attn_mod._out_proj(out, p["wo"], cfg.dtype)
