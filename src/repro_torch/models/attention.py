"""Grouped-query attention with the flavor flags of the assigned archs:
QKV bias (qwen1.5), qk-norm (qwen3), sliding window (mixtral), GQA (all),
encoder mode (hubert).  ``attn_impl='flash'`` routes the sequence path
through the CUDA flash kernel (its plain version on the CPU); ``'ref'``
materialises the scores; ``'blocked'`` streams kv blocks with an online
softmax in plain PyTorch.

Layouts are the reference's: activations (B, S, H, hd), ``wq`` (d, H,
hd), ``wo`` (H, hd, d), caches (B, Smax, Hkv, hd).  Positions are 1-D.

On DTensors (``repro_torch.dist``) each device runs the core on its own
queries against all the keys they see (``_local_core``): the flash
kernel on its local q, k and v, the ``blocked`` and ``ref`` cores too,
with the shard's query positions.  ``cfg.attn_sp`` makes the attention
sequence-parallel over the axis that ``dist.context.attention_seq_axis``
names, as the reference's does; outside such a context it changes
nothing.  Decode runs on the shards too; over a head_dim-sharded cache
(GQA kv heads that do not divide the mesh) each device takes partial
scores over its slice of the head dim and one all-reduce sums them
(``_decode_hd``), and the cache is never gathered.
"""
from __future__ import annotations

import math

import torch

from ..dist import shard_ops
from ..dist.context import (constrain_attn_seq, constrain_batch,
                            constrain_seq, is_dtensor)
from ..kernels.flash_attention import ops as fa_ops
from .config import ModelConfig
from .layers import ParamInit, apply_rope, rmsnorm

NEG = -1e30


def init_attention(mk: ParamInit, cfg: ModelConfig,
                   stacked: int | None = None) -> dict:
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    q_ax, kv_ax = (*A, "heads", "head_dim"), (*A, "kv_heads", "head_dim")
    p = {"wq": mk((*L, d, h, hd), dt, (*A, "embed", "heads", "head_dim")),
         "wk": mk((*L, d, kv, hd), dt, (*A, "embed", "kv_heads", "head_dim")),
         "wv": mk((*L, d, kv, hd), dt, (*A, "embed", "kv_heads", "head_dim")),
         "wo": mk((*L, h, hd, d), dt, (*A, "heads", "head_dim", "embed"))}
    if cfg.qkv_bias:
        p["bq"] = mk((*L, h, hd), dt, q_ax, init="zeros")
        p["bk"] = mk((*L, kv, hd), dt, kv_ax, init="zeros")
        p["bv"] = mk((*L, kv, hd), dt, kv_ax, init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = mk((*L, hd), dt, (*A, "head_dim"), init="ones")
        p["k_norm"] = mk((*L, hd), dt, (*A, "head_dim"), init="ones")
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """(B, S, d) x (d, H, hd) -> (B, S, H, hd), product in ``dtype``.  A
    DTensor weight whose head_dim is sharded (its heads do not divide
    the mesh axis) is gathered along it first: folding a sharded head_dim
    into the heads is not a layout every PyTorch's DTensor can make."""
    d, h, hd = w.shape
    if is_dtensor(w) and any(p.is_shard(2) for p in w.placements):
        from torch.distributed.tensor import Replicate
        w = w.redistribute(w.device_mesh, [
            Replicate() if p.is_shard(2) else p for p in w.placements])
    return shard_ops.matmul(x, w.to(dtype).reshape(d, h * hd)).unflatten(
        -1, (h, hd))


def _out_proj(out: torch.Tensor, wo: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """(B, S, H, hd) x (H, hd, d) -> (B, S, d).  A DTensor whose
    sequence is sharded (``attn_sp``) is projected batched over B: a
    plain product would fold B and S into one dim, which DTensor cannot
    do to a sharded S in every PyTorch version."""
    h, hd, d = wo.shape
    if shard_ops.mesh_dims(out, 3):
        return _out_proj_hd(out, wo, dtype)
    if is_dtensor(wo) and any(p.is_shard(1) for p in wo.placements):
        from torch.distributed.tensor import Replicate     # as in _proj
        wo = wo.redistribute(wo.device_mesh, [
            Replicate() if p.is_shard(1) else p for p in wo.placements])
    x, w = out.reshape(*out.shape[:2], h * hd), wo.to(dtype).reshape(h * hd, d)
    if is_dtensor(x) and any(p.is_shard(1) for p in x.placements):
        return torch.bmm(x, w.expand(x.shape[0], h * hd, d))
    return shard_ops.matmul(x, w)


def _out_proj_hd(out: torch.Tensor, wo: torch.Tensor, dtype: torch.dtype
                 ) -> torch.Tensor:
    """``_out_proj`` of a head_dim-sharded ``out`` (a decode over a
    head_dim-sharded cache): each device's slice against its rows of
    ``wo``, a partial sum over the slices (the row-parallel product)."""
    from torch.distributed.tensor import Partial
    mesh, hd_dims = out.device_mesh, shard_ops.mesh_dims(out, 3)
    rows = shard_ops.mesh_dims(out, 0)
    lay_o = shard_ops.layout(mesh.ndim, {**{i: 0 for i in rows},
                                         **{i: 3 for i in hd_dims}})
    lay_w = shard_ops.layout(mesh.ndim, {i: 1 for i in hd_dims})
    lay_y = [Partial() if i in hd_dims else p
             for i, p in enumerate(shard_ops.layout(
                 mesh.ndim, {i: 0 for i in rows}))]

    def fn(o, w):
        h, hd_l, d = w.shape
        return o.reshape(*o.shape[:2], h * hd_l) @ w.reshape(h * hd_l, d)
    return shard_ops.local_map(fn, (out, wo.to(dtype)), (lay_o, lay_w),
                               lay_y)


def _laid_out_as(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A bias or norm weight over ``x``'s trailing dims, gathered on every
    mesh dim where ``x`` does not shard the same dim (``_proj`` gathers a
    head_dim-sharded weight, so q comes out whole there): then the add
    or product is local, where DTensor would otherwise pick a layout."""
    if not (is_dtensor(w) and is_dtensor(x)):
        return w
    from torch.distributed.tensor import Replicate, Shard
    off = x.ndim - w.ndim
    pl = [p if p.is_shard() and x.placements[i] == Shard(p.dim + off)
          else Replicate() for i, p in enumerate(w.placements)]
    return w if pl == list(w.placements) else w.redistribute(
        w.device_mesh, pl)


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    xq, xk, xv = shard_ops.fan_out(x, 3)
    q = _proj(xq, p["wq"], cfg.dtype)
    k = _proj(xk, p["wk"], cfg.dtype)
    v = _proj(xv, p["wv"], cfg.dtype)
    if cfg.qkv_bias:
        q = q + _laid_out_as(p["bq"], q).to(cfg.dtype)
        k = k + _laid_out_as(p["bk"], k).to(cfg.dtype)
        v = v + _laid_out_as(p["bv"], v).to(cfg.dtype)
    if cfg.qk_norm:
        q = rmsnorm(q, _laid_out_as(p["q_norm"], q), cfg.norm_eps)
        k = rmsnorm(k, _laid_out_as(p["k_norm"], k), cfg.norm_eps)
    if not cfg.encoder_only:           # hubert uses learned conv pos (stubbed)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ref_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, q_positions: torch.Tensor,
              kv_positions: torch.Tensor, kv_len: int | None = None,
              k_scale: torch.Tensor | None = None,
              v_scale: torch.Tensor | None = None,
              head_dim: int | None = None,
              reduce_scores=None, scale: float | None = None
              ) -> torch.Tensor:
    """Reference GQA attention.  q, k: (B,S,Hq,hd), (B,T,Hkv,hd); v:
    (B,T,Hkv,hv), hv hd but for latent attention's narrower values; the
    output is v's width.  The scores are scaled by ``scale``, or divided
    by the root of the head dim.
    Masking from absolute positions ((S,) and (T,)); ``kv_len`` bounds
    valid cache entries.  ``k_scale``/``v_scale`` (B,T): int8-quantized
    KV, the scale folded into scores/probs so no dequantized cache copy
    materializes.  A slice of the head dim (``head_dim`` the whole one)
    gives partial scores, which ``reduce_scores`` sums over the slices;
    the output is then the slice's own."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, S, Hkv, g, hd)
    kc = k.to(cfg.dtype) if k.dtype == torch.int8 else k
    scores = torch.einsum("bskgh,btkh->bkgst", qg, kc)
    if reduce_scores is not None:
        scores = reduce_scores(scores)
    if scale is None:
        scores = scores.float() / math.sqrt(head_dim or hd)
    else:
        scores = scores.float() * scale
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
    return out.reshape(B, S, Hq, v.shape[-1])


def _blocked_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, block_k: int = 512, q_chunks: int = 4,
                  q_offset: int = 0) -> torch.Tensor:
    """Memory-bounded attention: online softmax streamed over kv blocks
    (never materializes the S x T score matrix).  For causal attention
    the q dim is split into ``q_chunks`` chunks so kv blocks entirely
    above the diagonal (or left of the window) are not computed.  The
    queries sit at positions ``q_offset`` on (a shard of the sequence)."""
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
        return run_chunk(q, q_offset, 0, T)
    nq = q_chunks if S % q_chunks == 0 and S >= q_chunks else 1
    Sc = S // nq
    outs = []
    for i in range(nq):
        q0 = q_offset + i * Sc
        lo = 0 if window is None else max(0, q0 - window)
        outs.append(run_chunk(q[:, i * Sc: (i + 1) * Sc], q0, lo,
                              min(T, q0 + Sc)))
    return torch.cat(outs, dim=1)


def _on_shards(q, k, v, core, scales=()) -> torch.Tensor:
    """``core(q_l, k_l, v_l, s0, *scales_l)`` on each device's shards of
    the DTensors q, k and v, its output laid out as q: q keeps its batch,
    sequence or heads sharding (any other is gathered); k and v (and the
    int8 cache's (B, T) ``scales``) keep a batch sharding like q's, and
    k and v heads sharded with q's whole groups; the rest is gathered,
    so that every device holds all the keys its queries see and the
    scores never leave it; the gradients of k and v gathered over a
    mesh dim on which q is sharded are partial sums over its shards.
    ``s0`` is the shard's first query position."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    tq, tkv = [], []
    for n, pq in zip(mesh.shape, q.placements):
        pq = pq if pq.is_shard() and pq.dim < 3 else Replicate()
        tq.append(pq)
        whole_groups = pq.is_shard(2) and Hkv % n == 0
        tkv.append(pq if pq.is_shard(0) or whole_groups else Replicate())
    rows = [p if p.is_shard(0) else Replicate() for p in tkv]
    q = q.redistribute(mesh, tq)
    gkv = [Partial() if b.is_replicate() and a.is_shard() else b
           for a, b in zip(tq, tkv)]
    k_l, v_l = (t.redistribute(mesh, tkv).to_local(grad_placements=gkv)
                for t in (k, v))
    scales_l = [t.redistribute(mesh, rows).to_local() for t in scales]
    q_l = q.to_local()
    _, (_, s0, h0, _) = compute_local_shape_and_global_offset(
        q.shape, mesh, tq)
    if q_l.shape[2] != Hq and k_l.shape[2] == Hkv:
        # q's heads sharded, k and v whole: each local q head's kv head
        idx = (h0 + torch.arange(q_l.shape[2], device=q_l.device)) // (
            Hq // Hkv)
        k_l, v_l = k_l[:, :, idx], v_l[:, :, idx]
    out = core(q_l, k_l, v_l, s0, *scales_l)
    return shard_ops.wrap(out.contiguous(), mesh, tq, q.shape)


def _local_core(cfg: ModelConfig, q, k, v, positions: torch.Tensor,
                impl: str) -> torch.Tensor:
    """The full-sequence core (``impl``: the flash kernel, ``blocked`` or
    ``ref``) on DTensors, each device on its own queries
    (``_on_shards``), with the shard's query positions: the flash kernel
    takes the shard's first one as its query offset."""

    def core(q_l, k_l, v_l, s0):
        S_l = q_l.shape[1]
        if impl == "flash":
            return fa_ops.flash_attention(q_l, k_l, v_l, causal=True,
                                          window=cfg.sliding_window,
                                          q_offset=s0)
        if impl == "blocked":
            return _blocked_core(cfg, q_l, k_l, v_l, q_offset=s0)
        return _ref_core(cfg, q_l, k_l, v_l, positions[s0:s0 + S_l],
                         positions)
    return _on_shards(q, k, v, core)


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    if cfg.attn_sp:
        # sequence-parallel attention (context-provided axis): q seq
        # sharded, kv replicated on that axis -> scores stay local
        q, k, v, _ = constrain_attn_seq(q, k, v)
    flash = cfg.attn_impl == "flash" and not cfg.encoder_only
    if is_dtensor(q):
        out = _local_core(cfg, q, k, v, positions,
                          "flash" if flash else cfg.attn_impl)
    elif flash:
        out = fa_ops.flash_attention(q, k, v, causal=True,
                                     window=cfg.sliding_window)
    elif cfg.attn_impl == "blocked":
        out = _blocked_core(cfg, q, k, v)
    else:
        out = _ref_core(cfg, q, k, v, positions, positions)
    if cfg.attn_sp:
        # leave the seq-parallel region at the block boundary, as the
        # reference does, so that the MLP sees batch-sharded rows
        out = constrain_seq(out)
        return constrain_batch(_out_proj(out, p["wo"], cfg.dtype),
                               exact=True)
    return _out_proj(out, p["wo"], cfg.dtype)



def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  mk: ParamInit, stacked: int | None = None) -> dict:
    """A zero cache made by ``mk``.  ``cfg.kv_quant`` stores K/V int8
    with a per-(batch, slot) bf16 scale (shared over heads and
    head_dim); scores contract against the int8 values with the scale
    folded in afterwards."""
    L = () if stacked is None else (stacked,)
    A = () if stacked is None else ("layers",)
    shape = (*L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    axes = (*A, "batch", None, "kv_heads", "head_dim")
    kv_dtype = torch.int8 if cfg.kv_quant else cfg.dtype
    out = {"k": mk(shape, kv_dtype, axes, init="zeros"),
           "v": mk(shape, kv_dtype, axes, init="zeros")}
    if cfg.kv_quant:
        s_shape, s_axes = (*L, batch, max_len), (*A, "batch", None)
        out["k_scale"] = mk(s_shape, torch.bfloat16, s_axes, init="zeros")
        out["v_scale"] = mk(s_shape, torch.bfloat16, s_axes, init="zeros")
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
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        writes = {"k": k, "v": v}
    hd_dims = shard_ops.mesh_dims(kv["k"], 3)
    if hd_dims:
        # a head_dim-sharded cache: written and read on each device's
        # slice, never gathered (``_decode_hd``)
        out = _decode_hd(cfg, q, kv, writes, slot, hd_dims,
                         dict(q_positions=positions,
                              kv_positions=kv_positions, kv_len=kv_len))
        return _out_proj(out, p["wo"], cfg.dtype), kv
    for name, t in writes.items():
        kv[name][:, slot] = t[:, 0]
    scales = (kv["k_scale"], kv["v_scale"]) if cfg.kv_quant else ()

    def core(q_l, k_l, v_l, s0, *scales_l):
        return _ref_core(cfg, q_l, k_l, v_l, q_positions=positions,
                         kv_positions=kv_positions, kv_len=kv_len,
                         **dict(zip(("k_scale", "v_scale"), scales_l)))
    if is_dtensor(q):
        # each device on its own rows and heads
        out = _on_shards(q, kv["k"], kv["v"], core, scales)
    else:
        out = core(q, kv["k"], kv["v"], 0, *scales)
    return _out_proj(out, p["wo"], cfg.dtype), kv


def _decode_hd(cfg: ModelConfig, q, kv: dict, writes: dict, slot: int,
               hd_dims: list[int], masks: dict):
    """Decode over a cache whose head dim is sharded over the mesh dims
    ``hd_dims`` (GQA kv heads that do not divide them), as XLA lays the
    reference's out: each device writes the new token's slice into its
    shard of the cache, takes the partial scores q_l . k_l^T over its
    head_dim slice, sums them with one all-reduce over ``hd_dims``, runs
    the softmax itself and gives p . v_l, its own slice of the output (no
    second reduction).  The int8 cache's (B, T) scales apply after the
    sum.  The cache is never gathered.  -> out (B,1,Hq,hd), head_dim
    sharded as the cache."""
    mesh, hd = q.device_mesh, q.shape[3]
    names = ("k", "v", *(("k_scale", "v_scale") if cfg.kv_quant else ()))
    # each cache tensor taken as it is laid out (no copy: the writes land
    # in its shards), the new token's values laid out the same
    lays = [list(kv[n].placements) for n in names]

    def fn(q_l, *ts):
        new, cached = ts[:len(names)], ts[len(names):]
        for c, t in zip(cached, new):
            c[:, slot] = t[:, 0]
        return _ref_core(
            cfg, q_l, cached[0], cached[1], **masks,
            **dict(zip(("k_scale", "v_scale"), cached[2:])),
            head_dim=hd,
            reduce_scores=lambda s: shard_ops.sum_over(s, mesh, hd_dims))
    with torch.no_grad():
        return shard_ops.local_map(
            fn, (q, *(writes[n] for n in names), *(kv[n] for n in names)),
            (lays[0], *lays, *lays), lays[0])
