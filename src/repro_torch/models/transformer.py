"""The model stack: embedding -> N blocks -> norm -> LM head.

Covers, through ``cfg.block``:
  * ``attn``   — pre-norm attention + (MLP | MoE)  [dense, moe, vlm, audio]
  * ``rwkv6``  — time-mix + channel-mix                  [ssm: rwkv6-7b]
  * ``mamba2`` — pure SSD stack                          [ssm]
  * ``zamba2`` — SSD backbone + weight-tied shared attention block every
                 ``shared_attn_period`` layers           [hybrid]
  * ``mla_moe`` — latent attention (``mla``) + a dense MLP in the first
                 ``first_dense`` layers (``dense_blocks``), DeepSeekMoE
                 (``deepseek_moe``) in the rest (``blocks``)
                 [DeepSeek-V2; training and prefill, no decode yet]

Layers are stacked along a leading ``layers`` dim, as in the reference,
and walked with a Python loop over one ``torch.unbind`` of each stacked
leaf.  Under autograd each block is checkpointed when ``cfg.remat``
(``torch.utils.checkpoint``, non-reentrant; ``mla_moe``'s blocks by
``_Recompute``): ``remat_policy="nothing"`` keeps only the block's
inputs, ``"dots"`` also keeps the outputs of the 2-D projection and MLP
products.  An MoE block returns its aux loss
beside its output, and the stack sums it over the layers.  The audio
frontend (hubert) takes the place of the token embedding; the vision
adapter (pixtral) prepends its patch embeddings to the tokens', and the
loss scores the text positions only.  Decode is token-only, as the
reference's is.  Under a profiler the attention block records
``model.attention`` and ``model.mlp`` and the head ``model.head``
(``repro_torch.spans``; a checkpointed block records them again when
its backward recomputes it).

On DTensors (``repro_torch.dist``) each block re-asserts the
activations' batch layout where the reference does (``constrain_batch``),
gathers its weights over the batch axis where it uses them (FSDP) and
sums its row-parallel partial sums at the residual adds; outside a mesh
context these are identities.
"""
from __future__ import annotations

import functools
import itertools
from typing import Any, Callable

import torch
from torch.utils import checkpoint as ckpt

from .. import spans
from ..core.kernels import resolve_device
from ..dist import shard_ops
from ..dist.context import constrain_batch, gather_weights, reduce_partial
from . import attention as attn_mod
from . import deepseek_moe, frontends, mamba2, mla, moe as moe_mod, rwkv6
from .config import ModelConfig
from .layers import (LogicalAxes, ParamInit, cross_entropy, embed_rows,
                     init_embedding, init_lm_head, init_mlp, init_rmsnorm,
                     mlp, rmsnorm)
from .registry import leaves

MOE_AUX_COEF = 0.01
BLOCKS = ("attn", "rwkv6", "mamba2", "zamba2", "mla_moe")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an unknown block."""
    if cfg.block not in BLOCKS:
        raise ValueError(f"{cfg.name}: unknown block {cfg.block!r}")


def _device(device: Any) -> torch.device:
    """``"meta"`` (shapes only) or ``resolve_device``'s device."""
    return (torch.device("meta") if str(device) == "meta"
            else resolve_device(device))


# ===================================================================== #
# init
# ===================================================================== #
def _init_attn_block(mk: ParamInit, cfg: ModelConfig,
                     stacked: int | None, dense: bool = False) -> dict:
    """An attention block; ``mla_moe``'s has MLA, and a dense MLP where
    ``dense`` (its leading layers) or else DeepSeekMoE."""
    latent = cfg.block == "mla_moe"
    p = {"norm1": init_rmsnorm(mk, cfg.d_model, cfg.param_dtype, stacked),
         "attn": (mla.init_mla if latent else attn_mod.init_attention)(
             mk, cfg, stacked),
         "norm2": init_rmsnorm(mk, cfg.d_model, cfg.param_dtype, stacked)}
    if latent and not dense:
        p["moe"] = deepseek_moe.init_moe(mk, cfg, stacked)
    elif cfg.moe is not None and not latent:
        p["moe"] = moe_mod.init_moe(mk, cfg, stacked)
    else:
        p["mlp"] = init_mlp(mk, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                            cfg.glu, stacked)
    return p


def _init_rwkv_block(mk: ParamInit, cfg: ModelConfig,
                     stacked: int | None) -> dict:
    return {"norm1": init_rmsnorm(mk, cfg.d_model, cfg.param_dtype, stacked),
            "tmix": rwkv6.init_rwkv6(mk, cfg, stacked),
            "norm2": init_rmsnorm(mk, cfg.d_model, cfg.param_dtype, stacked),
            "cmix": rwkv6.init_channel_mix(mk, cfg, stacked)}


def _init_mamba_block(mk: ParamInit, cfg: ModelConfig,
                      stacked: int | None) -> dict:
    return {"norm": init_rmsnorm(mk, cfg.d_model, cfg.param_dtype, stacked),
            "mamba": mamba2.init_mamba2(mk, cfg, stacked)}


def _zamba_split(cfg: ModelConfig) -> tuple[int, int, int]:
    period = cfg.shared_attn_period
    n_groups = cfg.n_layers // period
    tail = cfg.n_layers - n_groups * period
    return n_groups, period, tail


def init(cfg: ModelConfig, seed: int = 0, device: Any = None,
         mk: ParamInit | None = None) -> dict:
    """The parameter tree, in ``cfg.param_dtype``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (None: CUDA,
    raising without a card).  ``device="meta"`` gives shapes only; an
    ``mk`` given makes the leaves in place of one built from ``seed``
    and ``device`` (``LogicalAxes``: the logical axes)."""
    check_ported(cfg)
    mk = mk or ParamInit(seed, _device(device))
    p: dict[str, Any] = {}
    if cfg.frontend == "audio":
        p["frontend"] = frontends.init_audio_frontend(mk, cfg)
    else:
        p["embed"] = init_embedding(mk, cfg.vocab_size, cfg.d_model,
                                    cfg.param_dtype)
    if cfg.frontend == "vision":
        p["adapter"] = frontends.init_vision_adapter(mk, cfg)
    if cfg.block == "attn":
        p["blocks"] = _init_attn_block(mk, cfg, cfg.n_layers)
    elif cfg.block == "mla_moe":
        if cfg.first_dense:
            p["dense_blocks"] = _init_attn_block(mk, cfg, cfg.first_dense,
                                                 dense=True)
        p["blocks"] = _init_attn_block(mk, cfg,
                                       cfg.n_layers - cfg.first_dense)
    elif cfg.block == "rwkv6":
        p["blocks"] = _init_rwkv_block(mk, cfg, cfg.n_layers)
    elif cfg.block == "mamba2":
        p["blocks"] = _init_mamba_block(mk, cfg, cfg.n_layers)
    else:                                           # zamba2
        n_groups, period, tail = _zamba_split(cfg)
        p["mamba_groups"] = _init_mamba_block(mk, cfg, n_groups * period)
        if tail:
            p["mamba_tail"] = _init_mamba_block(mk, cfg, tail)
        p["shared"] = _init_attn_block(mk, cfg, None)     # weight-tied copy
    p["final_norm"] = init_rmsnorm(mk, cfg.d_model, cfg.param_dtype)
    if not cfg.tie_embeddings or cfg.frontend == "audio":     # no embed
        p["lm_head"] = init_lm_head(mk, cfg.d_model, cfg.vocab_size,
                                    cfg.param_dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device: Any = None
                ) -> dict:
    """-> params alone (the reference returns ``(params, logical_specs)``;
    the port's specs are ``param_specs(cfg)``)."""
    return init(cfg, seed, device)


def param_specs(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``init_params(cfg)``, a tree of
    the same keys (the reference's ``split_tree`` specs)."""
    return init(cfg, mk=LogicalAxes())


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree stacked along its leading dim (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a tree stacked along its leading dim, from one
    ``torch.unbind`` a leaf.  Under autograd its backward is one
    ``stack`` a leaf, where indexing each layer (``layer``) would add a
    zero tensor the size of the whole stack for every layer."""
    cols = {k: unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs) -> ckpt.CheckpointPolicy:
    """Selective checkpoint of ``remat_policy="dots"``: keep the outputs
    of the 2-D products (projections, MLP, as the reference's
    ``dots_with_no_batch_dims_saveable``); recompute the rest, attention's
    batched products included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` checkpointed per ``cfg.remat_policy`` when ``cfg.remat``
    and autograd records (serving runs ``fn`` as it is)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy == "nothing":
        context_fn = ckpt.noop_context_fn
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return lambda *args, **kw: ckpt.checkpoint(
        fn, *args, use_reentrant=False, context_fn=context_fn, **kw)


def _like(tree: dict, values) -> dict:
    """``tree``'s nesting with the next of ``values`` at each leaf, in
    ``registry.leaves``'s order."""
    return {k: _like(v, values) if isinstance(v, dict) else next(values)
            for k, v in tree.items()}


class _Recompute(torch.autograd.Function):
    """A block ``fn(p, x) -> (x, aux)`` that keeps only its inputs: the
    forward builds no graph, and the backward runs the block again under
    autograd and takes its inputs' gradients from that graph.

    ``remat_policy="nothing"`` for ``mla_moe``.  For each tensor a block
    saves, ``torch.utils.checkpoint`` (non-reentrant) keeps a holder, its
    dict, a weak reference and a size alive from the forward to the
    backward, all tracked by the interpreter's collector.  Over MLA's and
    DeepSeekMoE's many small operations that is ~6,400 objects promoted
    into the collector's oldest generation a step (27 layers), so a full
    collection of the whole heap, longer than the card's queue of
    launches lasts, comes every few steps.  This keeps one object a
    block."""

    @staticmethod
    def forward(ctx, fn, x, *weights):
        ctx.fn = fn
        ctx.save_for_backward(x, *weights)
        return fn(x, weights)

    @staticmethod
    def backward(ctx, *grads):
        ins = [t.detach().requires_grad_(t.requires_grad)
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.fn(ins[0], ins[1:])
        used = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wrt = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in used], wrt,
                                       [g for _, g in used],
                                       allow_unused=True))
        return (None, *(next(got) if t.requires_grad else None
                        for t in ins))


def _recompute(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn(p, x, **kw)`` run through ``_Recompute`` where ``cfg.remat``
    and autograd records, with ``remat_policy="nothing"``; else
    ``_remat``'s."""
    if not (cfg.remat and torch.is_grad_enabled()) or \
            cfg.remat_policy != "nothing":
        return _remat(fn, cfg)

    def run(p: dict, x: torch.Tensor, **kw):
        nest = _like(p, itertools.repeat(None))
        return _Recompute.apply(
            lambda y, ws: fn(_like(nest, iter(ws)), x=y, **kw), x,
            *leaves(p))
    return run


# ===================================================================== #
# forward
# ===================================================================== #
def _ffn(p: dict, cfg: ModelConfig, h: torch.Tensor, layer: int = 0
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP or MoE on the normed input -> (y, aux loss);
    ``layer`` keys an MoE layer's counters."""
    if "moe" in p:
        if cfg.block == "mla_moe":
            return deepseek_moe.moe_ffn(p["moe"], cfg, h, layer)
        return moe_mod.moe_ffn(p["moe"], cfg, h)
    return mlp(p["mlp"], h, cfg.act), torch.zeros((), device=h.device)


def _attn_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, layer: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    x = constrain_batch(x)          # re-assert DP sharding at block entry
    p = gather_weights(p)
    attention = mla.attention if cfg.block == "mla_moe" else \
        attn_mod.attention
    with spans.span("model.attention"):
        x = x + reduce_partial(attention(
            p["attn"], cfg, rmsnorm(x, p["norm1"], cfg.norm_eps), positions))
    with spans.span("model.mlp"):
        y, aux = _ffn(p, cfg, rmsnorm(x, p["norm2"], cfg.norm_eps), layer)
        x = x + reduce_partial(y)
    return x, aux


def _rwkv_block(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = constrain_batch(x)
    p = gather_weights(p)
    x = x + reduce_partial(rwkv6.rwkv6_seq(
        p["tmix"], cfg, rmsnorm(x, p["norm1"], cfg.norm_eps)))
    return x + reduce_partial(rwkv6.channel_mix(
        p["cmix"], cfg, rmsnorm(x, p["norm2"], cfg.norm_eps)))


def _mamba_block(p: dict, cfg: ModelConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    x = constrain_batch(x)
    p = gather_weights(p)
    return x + reduce_partial(mamba2.mamba2_seq(
        p["mamba"], cfg, rmsnorm(x, p["norm"], cfg.norm_eps)))


def _stack(cfg: ModelConfig, params: dict, x: torch.Tensor,
           positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run all blocks -> (x, the MoE aux loss summed over the layers; a
    float32 zero without MoE)."""
    check_ported(cfg)
    attn_block = _remat(functools.partial(_attn_block, cfg=cfg,
                                          positions=positions), cfg)
    mamba_block = _remat(functools.partial(_mamba_block, cfg=cfg), cfg)
    aux = torch.zeros((), device=x.device)
    if cfg.block == "attn":
        for p in unstack(params["blocks"], cfg.n_layers):
            x, a = attn_block(p, x=x)
            aux = aux + a
    elif cfg.block == "mla_moe":
        layers = (unstack(params["dense_blocks"], cfg.first_dense)
                  if cfg.first_dense else []) + unstack(
            params["blocks"], cfg.n_layers - cfg.first_dense)
        block = _recompute(functools.partial(
            _attn_block, cfg=cfg, positions=positions), cfg)
        for i, p in enumerate(layers):
            x, a = block(p, x=x, layer=i)
            aux = aux + a
    elif cfg.block in ("rwkv6", "mamba2"):
        fn = (_remat(functools.partial(_rwkv_block, cfg=cfg), cfg)
              if cfg.block == "rwkv6" else mamba_block)
        for p in unstack(params["blocks"], cfg.n_layers):
            x = fn(p, x=x)
    else:                                           # zamba2
        n_groups, period, tail = _zamba_split(cfg)
        group_layers = unstack(params["mamba_groups"], n_groups * period)
        for g in range(n_groups):
            for p in group_layers[g * period: (g + 1) * period]:
                x = mamba_block(p, x=x)
            x, _ = attn_block(params["shared"], x=x)
        if tail:
            for p in unstack(params["mamba_tail"], tail):
                x = mamba_block(p, x=x)
    return x, aux


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (x (B,S,d), positions (S,)).  Audio: the frontend's frames.
    Otherwise the token embeddings (rows gathered before the cast to
    ``cfg.dtype``: the same numbers as casting the whole table), after
    the vision adapter's patch embeddings when there are images; the
    positions then run over the image prefix too."""
    if cfg.frontend == "audio":
        x = frontends.audio_frontend(gather_weights(params["frontend"]), cfg,
                                     batch["features"],
                                     batch.get("frame_mask"))
    else:
        x = embed_rows(gather_weights(params["embed"]),
                       batch["tokens"]).to(cfg.dtype)
        if cfg.frontend == "vision":
            img = frontends.vision_adapter(gather_weights(params["adapter"]),
                                           cfg, batch["patch_embeds"])
            x = torch.cat([img, x], dim=1)
    return constrain_batch(x), torch.arange(x.shape[1], device=x.device)


def logits_fn(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    # the stack's output as a value (the reference's scan carry is one)
    with spans.span("model.head", positions=x.shape[-2]):
        x = constrain_batch(x)
        (x,) = shard_ops.fan_out(rmsnorm(
            x, gather_weights(params["final_norm"]), cfg.norm_eps), 1)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return shard_ops.matmul(x, gather_weights(head).to(cfg.dtype))


def forward(params: dict, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits, moe_aux): the MoE layers' aux
    loss summed over the layers (a float32 zero without MoE)."""
    x, positions = embed_inputs(params, cfg, batch)
    x, aux = _stack(cfg, params, x, positions)
    return logits_fn(params, cfg, x), aux


def loss_fn(params: dict, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """-> (loss, {"ce", "moe_aux"}): mean token cross-entropy in fp32
    over ``batch["labels"]``, weighted by ``batch["loss_mask"]`` when
    given (audio: by ``batch["frame_mask"]``, the masked frames; vision:
    over the text positions only, after the image prefix); ``moe_aux``
    is ``forward``'s, added at ``aux_coef(cfg)``."""
    logits, aux = forward(params, cfg, batch)
    if cfg.frontend == "vision":
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    mask = batch.get("frame_mask" if cfg.frontend == "audio"
                     else "loss_mask")
    ce = cross_entropy(logits, batch["labels"], mask)
    loss = ce + aux_coef(cfg) * aux
    return loss, {"ce": ce, "moe_aux": aux}


def aux_coef(cfg: ModelConfig) -> float:
    """The MoE aux loss's weight in the loss: the config's (DeepSeekMoE's
    ``aux_alpha``), else ``MOE_AUX_COEF``."""
    return getattr(cfg.moe, "aux_alpha", MOE_AUX_COEF)


# ===================================================================== #
# decode (serve_step)
# ===================================================================== #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = None) -> dict:
    """Per-layer decode state, stacked along layers: the KV cache of the
    attention layers, the SSM state and conv tail of the Mamba2 layers,
    the WKV state and token-shift carries of the RWKV6 layers, on
    ``device`` (None: CUDA; ``"meta"``: shapes only)."""
    return _init_cache(cfg, batch, max_len, ParamInit(0, _device(device)))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The logical axes of every leaf of ``init_cache``, a tree of the
    same keys."""
    return _init_cache(cfg, batch, max_len, LogicalAxes())


def _no_latent_cache(cfg: ModelConfig) -> None:
    if cfg.block == "mla_moe":
        raise NotImplementedError(
            f"{cfg.name}: no decode for latent attention yet (its cache "
            f"would hold the {cfg.mla.kv_lora_rank}-wide latent and the "
            f"shared rotary key); training and prefill run")


def _init_cache(cfg: ModelConfig, batch: int, max_len: int,
                mk: ParamInit) -> dict:
    check_ported(cfg)
    _no_latent_cache(cfg)
    if cfg.block == "attn":
        return {"kv": attn_mod.init_kv_cache(cfg, batch, max_len, mk,
                                             stacked=cfg.n_layers)}
    if cfg.block == "rwkv6":
        return {"rwkv": rwkv6.init_rwkv6_state(cfg, batch, mk,
                                               stacked=cfg.n_layers)}
    if cfg.block == "mamba2":
        return {"ssm": mamba2.init_mamba2_state(cfg, batch, mk,
                                                stacked=cfg.n_layers)}
    n_groups, period, tail = _zamba_split(cfg)
    c = {"ssm": mamba2.init_mamba2_state(cfg, batch, mk,
                                         stacked=n_groups * period),
         "shared_kv": attn_mod.init_kv_cache(cfg, batch, max_len, mk,
                                             stacked=n_groups)}
    if tail:
        c["ssm_tail"] = mamba2.init_mamba2_state(cfg, batch, mk,
                                                 stacked=tail)
    return c


def init_cache_arrays(cfg: ModelConfig, batch: int, max_len: int,
                      device: Any = None) -> dict:
    """The cache alone (the reference returns ``(cache, specs)``; the
    port's specs are ``cache_specs``)."""
    return init_cache(cfg, batch, max_len, device)


def _decode_attn_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       kv: dict, cache_len: int
                       ) -> tuple[torch.Tensor, dict]:
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    o, kv = attn_mod.decode_attention(p["attn"], cfg, h, kv, cache_len)
    x = x + reduce_partial(o)
    y, _ = _ffn(p, cfg, rmsnorm(x, p["norm2"], cfg.norm_eps))
    return x + reduce_partial(y), kv


def _decode_mamba_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        state: dict) -> torch.Tensor:
    return x + reduce_partial(mamba2.mamba2_decode(
        p["mamba"], cfg, rmsnorm(x, p["norm"], cfg.norm_eps), state))


def _decode_rwkv_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       state: dict) -> torch.Tensor:
    hn = rmsnorm(x, p["norm1"], cfg.norm_eps)
    x = x + reduce_partial(rwkv6.rwkv6_decode(
        p["tmix"], cfg, hn, {"S": state["S"], "shift": state["shift_t"]}))
    hn = rmsnorm(x, p["norm2"], cfg.norm_eps)
    x = x + reduce_partial(rwkv6.channel_mix(p["cmix"], cfg, hn,
                                             state["shift_c"]))
    state["shift_c"].copy_(hn)
    return x


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, cache_len: int
                ) -> tuple[torch.Tensor, dict]:
    """One new token with existing state.  tokens: (B,1) int; cache_len:
    tokens already in the cache.  Returns (logits (B,1,V), cache): the
    new token's keys and values and the new SSM, WKV, conv and shift
    states are written into ``cache``'s tensors in place (the reference
    returns an updated copy)."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    check_ported(cfg)
    _no_latent_cache(cfg)
    x = embed_rows(params["embed"], tokens).to(cfg.dtype)
    cache_len = int(cache_len)
    if cfg.block == "attn":
        for i in range(cfg.n_layers):
            x, _ = _decode_attn_block(layer(params["blocks"], i), cfg, x,
                                      layer(cache["kv"], i), cache_len)
    elif cfg.block == "rwkv6":
        for i in range(cfg.n_layers):
            x = _decode_rwkv_block(layer(params["blocks"], i), cfg, x,
                                   layer(cache["rwkv"], i))
    elif cfg.block == "mamba2":
        for i in range(cfg.n_layers):
            x = _decode_mamba_block(layer(params["blocks"], i), cfg, x,
                                    layer(cache["ssm"], i))
    else:                                           # zamba2
        n_groups, period, tail = _zamba_split(cfg)
        for g in range(n_groups):
            for i in range(g * period, (g + 1) * period):
                x = _decode_mamba_block(layer(params["mamba_groups"], i),
                                        cfg, x, layer(cache["ssm"], i))
            x, _ = _decode_attn_block(params["shared"], cfg, x,
                                      layer(cache["shared_kv"], g),
                                      cache_len)
        for i in range(tail):
            x = _decode_mamba_block(layer(params["mamba_tail"], i), cfg, x,
                                    layer(cache["ssm_tail"], i))
    return logits_fn(params, cfg, x), dict(cache)
