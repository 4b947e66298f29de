"""Grouped-query attention with the flavor flags of the assigned archs:
QKV bias (qwen1.5), qk-norm (qwen3), sliding window (mixtral), GQA (all),
encoder mode (hubert).  ``attn_impl='flash'`` routes the sequence path
through the CUDA flash kernel (its plain version on the CPU); ``'ref'``
materialises the scores; ``'blocked'`` streams kv blocks with an online
softmax in plain PyTorch.

Layouts are the reference's: activations (B, S, H, hd), ``wq`` (d, H,
hd), ``wo`` (H, hd, d), caches (B, Smax, Hkv, hd).  Positions are 1-D.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import ops as fa_ops
from .config import ModelConfig
from .layers import ParamInit, apply_rope, rmsnorm

NEG = -1e30


def init_attention(mk: ParamInit, cfg: ModelConfig,
                   stacked: int | None = None) -> dict:
    L = () if stacked is None else (stacked,)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    p = {"wq": mk((*L, d, h, hd), dt),
         "wk": mk((*L, d, kv, hd), dt),
         "wv": mk((*L, d, kv, hd), dt),
         "wo": mk((*L, h, hd, d), dt)}
    if cfg.qkv_bias:
        p["bq"] = mk((*L, h, hd), dt, init="zeros")
        p["bk"] = mk((*L, kv, hd), dt, init="zeros")
        p["bv"] = mk((*L, kv, hd), dt, init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = mk((*L, hd), dt, init="ones")
        p["k_norm"] = mk((*L, hd), dt, init="ones")
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """(B, S, d) x (d, H, hd) -> (B, S, H, hd), product in ``dtype``."""
    d, h, hd = w.shape
    return (x @ w.to(dtype).reshape(d, h * hd)).unflatten(-1, (h, hd))


def _out_proj(out: torch.Tensor, wo: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """(B, S, H, hd) x (H, hd, d) -> (B, S, d)."""
    h, hd, d = wo.shape
    return out.reshape(*out.shape[:2], h * hd) @ wo.to(dtype).reshape(
        h * hd, d)


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _proj(x, p["wq"], cfg.dtype)
    k = _proj(x, p["wk"], cfg.dtype)
    v = _proj(x, p["wv"], cfg.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cfg.dtype)
        k = k + p["bk"].to(cfg.dtype)
        v = v + p["bv"].to(cfg.dtype)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if not cfg.encoder_only:           # hubert uses learned conv pos (stubbed)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ref_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, q_positions: torch.Tensor,
              kv_positions: torch.Tensor, kv_len: int | None = None,
              k_scale: torch.Tensor | None = None,
              v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Reference GQA attention.  q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd).
    Masking from absolute positions ((S,) and (T,)); ``kv_len`` bounds
    valid cache entries.  ``k_scale``/``v_scale`` (B,T): int8-quantized
    KV, the scale folded into scores/probs so no dequantized cache copy
    materializes."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, S, Hkv, g, hd)
    kc = k.to(cfg.dtype) if k.dtype == torch.int8 else k
    scores = torch.einsum("bskgh,btkh->bkgst", qg, kc).float()
    scores = scores / math.sqrt(hd)
    if k_scale is not None:
        scores = scores * k_scale.float()[:, None, None, None, :]

    qpos = q_positions[:, None]                 # (S,1)
    kpos = kv_positions[None, :]                # (1,T)
    if cfg.encoder_only:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    else:
        mask = kpos <= qpos
    if cfg.sliding_window is not None:
        mask = mask & (kpos > qpos - cfg.sliding_window)
    mask = mask & (kpos >= 0)                   # ring slots not yet written
    if kv_len is not None:
        mask = mask & (kv_positions < kv_len)[None, :]
    scores = scores.masked_fill(~mask, NEG)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.float()[:, None, None, None, :]
    probs = probs.to(cfg.dtype)
    vc = v.to(cfg.dtype) if v.dtype == torch.int8 else v
    out = torch.einsum("bkgst,btkh->bskgh", probs, vc)
    return out.reshape(B, S, Hq, hd)


def _blocked_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, block_k: int = 512, q_chunks: int = 4
                  ) -> torch.Tensor:
    """Memory-bounded attention: online softmax streamed over kv blocks
    (never materializes the S x T score matrix).  For causal attention
    the q dim is split into ``q_chunks`` chunks so kv blocks entirely
    above the diagonal (or left of the window) are not computed."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    causal = not cfg.encoder_only
    window = cfg.sliding_window

    def run_chunk(qc: torch.Tensor, q0: int, kv_lo: int, kv_hi: int
                  ) -> torch.Tensor:
        Sc = qc.shape[1]
        qf = qc.float() * scale
        qpos = q0 + torch.arange(Sc, device=q.device)
        m = torch.full((B, Sc, Hq), NEG, device=q.device)
        l = torch.zeros((B, Sc, Hq), device=q.device)
        acc = torch.zeros((B, Sc, Hq, hd), device=q.device)
        for lo in range(kv_lo, kv_hi, min(block_k, kv_hi - kv_lo)):
            hi = min(lo + block_k, kv_hi)
            kblk, vblk = k[:, lo:hi].float(), v[:, lo:hi].float()
            if g > 1:                       # expand kv heads per block
                kblk = kblk.repeat_interleave(g, dim=2)
                vblk = vblk.repeat_interleave(g, dim=2)
            kpos = torch.arange(lo, hi, device=q.device)
            s = torch.einsum("bshd,bthd->bsht", qf, kblk)
            msk = torch.ones((Sc, hi - lo), dtype=torch.bool,
                             device=q.device)
            if causal:
                msk = msk & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                msk = msk & (kpos[None, :] > qpos[:, None] - window)
            msk = msk[None, :, None, :]
            s = s.masked_fill(~msk, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]).masked_fill(~msk, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bsht,bthd->bshd",
                                                        p, vblk)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.to(cfg.dtype)

    if not causal:
        return run_chunk(q, 0, 0, T)
    nq = q_chunks if S % q_chunks == 0 and S >= q_chunks else 1
    Sc = S // nq
    outs = []
    for i in range(nq):
        lo = 0 if window is None else max(0, i * Sc - window)
        outs.append(run_chunk(q[:, i * Sc: (i + 1) * Sc], i * Sc, lo,
                              min(T, (i + 1) * Sc)))
    return torch.cat(outs, dim=1)


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    if cfg.attn_sp:
        raise NotImplementedError(
            "attn_sp (sequence-parallel attention) needs the distributed "
            "layer, which is not ported: ROADMAP Queue 1 item 3 "
            "(distributed tooling, after repro.dist)")
    q, k, v = _project_qkv(p, cfg, x, positions)
    if cfg.attn_impl == "flash" and not cfg.encoder_only:
        out = fa_ops.flash_attention(q, k, v, causal=True,
                                     window=cfg.sliding_window)
    elif cfg.attn_impl == "blocked":
        out = _blocked_core(cfg, q, k, v)
    else:
        out = _ref_core(cfg, q, k, v, positions, positions)
    return _out_proj(out, p["wo"], cfg.dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device, stacked: int | None = None) -> dict:
    """``cfg.kv_quant`` stores K/V int8 with a per-(batch, slot) bf16 scale
    (shared over heads and head_dim); scores contract against the int8
    values with the scale folded in afterwards."""
    L = () if stacked is None else (stacked,)
    shape = (*L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if cfg.kv_quant else cfg.dtype
    out = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
           "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if cfg.kv_quant:
        s_shape = (*L, batch, max_len)
        out["k_scale"] = torch.zeros(s_shape, dtype=torch.bfloat16,
                                     device=device)
        out["v_scale"] = torch.zeros(s_shape, dtype=torch.bfloat16,
                                     device=device)
    return out


def _quantize_token(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t: (B, 1, Hkv, hd) -> (int8, scale (B, 1) bf16).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    tf = t.float()
    scale = tf.abs().amax(dim=(1, 2, 3))[:, None] / 127.0
    scale = torch.clamp(scale, min=1e-8)                # (B, 1)
    q = torch.clamp(torch.round(tf / scale[:, :, None, None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def decode_attention(p: dict, cfg: ModelConfig, x: torch.Tensor, kv: dict,
                     cache_len: int) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B,1,d); kv: {"k","v"[,"k_scale","v_scale"]}
    with k/v (B,Smax,Hkv,hd); cache_len: tokens already in the cache.
    Returns (out (B,1,d), kv).  The new token is written into ``kv``'s
    tensors in place (the reference returns updated copies).

    SWA archs use a *ring* cache: ``Smax`` may be just the window, slot
    ``t % Smax`` holds token ``t``, and slot positions are reconstructed
    from ``cache_len``."""
    Smax = kv["k"].shape[1]
    dev = x.device
    positions = torch.full((1,), cache_len, dtype=torch.long, device=dev)
    q, k, v = _project_qkv(p, cfg, x, positions)
    ring = cfg.sliding_window is not None and Smax <= cfg.sliding_window
    idx = torch.arange(Smax, device=dev)
    if ring:
        slot = cache_len % Smax
        # slot i holds the largest position p <= cache_len, p % Smax == i
        kv_positions = cache_len - torch.remainder(cache_len - idx, Smax)
        kv_len = None            # every slot's position is already <= qpos
    else:
        slot = cache_len
        kv_positions = idx
        kv_len = cache_len + 1
    if cfg.kv_quant:
        kq, ks = _quantize_token(k)
        vq, vs = _quantize_token(v)
        kv["k"][:, slot] = kq[:, 0]
        kv["v"][:, slot] = vq[:, 0]
        kv["k_scale"][:, slot] = ks[:, 0]
        kv["v_scale"][:, slot] = vs[:, 0]
        out = _ref_core(cfg, q, kv["k"], kv["v"], q_positions=positions,
                        kv_positions=kv_positions, kv_len=kv_len,
                        k_scale=kv["k_scale"], v_scale=kv["v_scale"])
    else:
        kv["k"][:, slot] = k[:, 0]
        kv["v"][:, slot] = v[:, 0]
        out = _ref_core(cfg, q, kv["k"], kv["v"], q_positions=positions,
                        kv_positions=kv_positions, kv_len=kv_len)
    return _out_proj(out, p["wo"], cfg.dtype), kv
