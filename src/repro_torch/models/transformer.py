"""The model stack: embedding -> N blocks -> norm -> LM head.

The port covers ``cfg.block == "attn"`` without MoE or a frontend: the
dense family (deepseek, qwen1.5, qwen3).  Layers are stacked along a
leading ``layers`` dim, as in the reference, and walked with a Python
loop.  The other blocks (rwkv6, mamba2, zamba2), MoE and the audio and
vision frontends raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

from typing import Any

import torch

from ..core.kernels import resolve_device
from . import attention as attn_mod
from .config import ModelConfig
from .layers import (ParamInit, init_embedding, init_lm_head, init_mlp,
                     init_rmsnorm, mlp, rmsnorm)

_UNPORTED = "not ported yet: ROADMAP Queue 1 item 2, slice"


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run."""
    if cfg.block != "attn":
        slice_ = {"mamba2": "2 (SSD scan)", "zamba2": "2 (SSD scan)",
                  "rwkv6": "3 (WKV6 scan)"}.get(cfg.block, "?")
        raise NotImplementedError(
            f"{cfg.name}: block {cfg.block!r} is {_UNPORTED} {slice_}")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE is {_UNPORTED} 1 (MoE serving)")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is {_UNPORTED} 5 "
            "(frontends)")


# ===================================================================== #
# init
# ===================================================================== #
def _init_attn_block(mk: ParamInit, cfg: ModelConfig,
                     stacked: int | None) -> dict:
    return {"norm1": init_rmsnorm(mk, cfg.d_model, cfg.param_dtype, stacked),
            "attn": attn_mod.init_attention(mk, cfg, stacked),
            "norm2": init_rmsnorm(mk, cfg.d_model, cfg.param_dtype, stacked),
            "mlp": init_mlp(mk, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                            cfg.glu, stacked)}


def init(cfg: ModelConfig, seed: int = 0, device: Any = None) -> dict:
    """The parameter tree, in ``cfg.param_dtype``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (None: CUDA,
    raising without a card).  ``device="meta"`` gives shapes only."""
    check_ported(cfg)
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    mk = ParamInit(seed, dev)
    p: dict[str, Any] = {
        "embed": init_embedding(mk, cfg.vocab_size, cfg.d_model,
                                cfg.param_dtype),
        "blocks": _init_attn_block(mk, cfg, cfg.n_layers),
        "final_norm": init_rmsnorm(mk, cfg.d_model, cfg.param_dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = init_lm_head(mk, cfg.d_model, cfg.vocab_size,
                                    cfg.param_dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device: Any = None
                ) -> dict:
    """-> params alone (the reference returns ``(params, logical_specs)``;
    the port does not shard, so it has no specs)."""
    return init(cfg, seed, device)


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree stacked along its leading dim (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ===================================================================== #
# forward
# ===================================================================== #
def _attn_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    x = x + attn_mod.attention(p["attn"], cfg,
                               rmsnorm(x, p["norm1"], cfg.norm_eps),
                               positions)
    return x + mlp(p["mlp"], rmsnorm(x, p["norm2"], cfg.norm_eps), cfg.act)


def _stack(cfg: ModelConfig, params: dict, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Run all blocks (MoE is not ported, so there is no aux loss)."""
    check_ported(cfg)
    for i in range(cfg.n_layers):
        x = _attn_block(layer(params["blocks"], i), cfg, x, positions)
    return x


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (x (B,S,d), positions (S,)).  Rows are gathered before the cast
    to ``cfg.dtype``: the same numbers as casting the whole table."""
    tokens = batch["tokens"]
    x = params["embed"][tokens].to(cfg.dtype)
    return x, torch.arange(x.shape[1], device=x.device)


def logits_fn(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(cfg.dtype)


def forward(params: dict, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits, moe_aux); moe_aux is 0 (no MoE)."""
    x, positions = embed_inputs(params, cfg, batch)
    x = _stack(cfg, params, x, positions)
    return logits_fn(params, cfg, x), torch.zeros((), device=x.device)


# ===================================================================== #
# decode (serve_step)
# ===================================================================== #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = None) -> dict:
    """Per-layer decode state, stacked along layers."""
    check_ported(cfg)
    return {"kv": attn_mod.init_kv_cache(cfg, batch, max_len,
                                         resolve_device(device),
                                         stacked=cfg.n_layers)}


def init_cache_arrays(cfg: ModelConfig, batch: int, max_len: int,
                      device: Any = None) -> dict:
    """The cache alone (the reference returns ``(cache, specs)``)."""
    return init_cache(cfg, batch, max_len, device)


def _decode_attn_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       kv: dict, cache_len: int
                       ) -> tuple[torch.Tensor, dict]:
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    o, kv = attn_mod.decode_attention(p["attn"], cfg, h, kv, cache_len)
    x = x + o
    return x + mlp(p["mlp"], rmsnorm(x, p["norm2"], cfg.norm_eps),
                   cfg.act), kv


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, cache_len: int
                ) -> tuple[torch.Tensor, dict]:
    """One new token with existing state.  tokens: (B,1) int; cache_len:
    tokens already in the cache.  Returns (logits (B,1,V), cache): the
    new token's keys and values are written into ``cache``'s tensors in
    place (the reference returns an updated copy)."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    check_ported(cfg)
    x = params["embed"][tokens].to(cfg.dtype)
    for i in range(cfg.n_layers):
        x, _ = _decode_attn_block(layer(params["blocks"], i), cfg, x,
                                  layer(cache["kv"], i), int(cache_len))
    return logits_fn(params, cfg, x), dict(cache)
