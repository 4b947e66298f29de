"""Modality frontends (copied from the reference, on tensors).

The audio and vision archs specify the transformer backbone only; the
modality frontend provides precomputed frame or patch embeddings
(``data.make_batch_specs``).  Here are only the thin trainable adapters
that map those features into the backbone width (HuBERT's conv feature
extractor and Pixtral's ViT run upstream and are not part of the
configs).
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import ParamInit


def init_audio_frontend(mk: ParamInit, cfg: ModelConfig) -> dict:
    """HuBERT-style: precomputed conv features (B, S, frontend_dim) ->
    d_model, plus the learned [MASK] frame embedding for masked
    prediction."""
    dt = cfg.param_dtype
    return {"proj": mk((cfg.frontend_dim, cfg.d_model), dt, (None, "embed")),
            "proj_b": mk((cfg.d_model,), dt, ("embed",), init="zeros"),
            "mask_emb": mk((cfg.d_model,), dt, ("embed",), scale=0.02)}


def audio_frontend(p: dict, cfg: ModelConfig, features: torch.Tensor,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """features: (B, S, frontend_dim); mask: (B, S) bool, True for a
    masked frame, whose embedding becomes ``mask_emb``."""
    dt = cfg.dtype
    x = features.to(dt) @ p["proj"].to(dt) + p["proj_b"].to(dt)
    if mask is not None:
        x = torch.where(mask[..., None], p["mask_emb"].to(dt), x)
    return x


def init_vision_adapter(mk: ParamInit, cfg: ModelConfig) -> dict:
    """Pixtral-style: precomputed patch embeddings -> backbone width."""
    dt = cfg.param_dtype
    return {"proj": mk((cfg.frontend_dim, cfg.d_model), dt, (None, "embed")),
            "proj_b": mk((cfg.d_model,), dt, ("embed",), init="zeros")}


def vision_adapter(p: dict, cfg: ModelConfig, patches: torch.Tensor
                   ) -> torch.Tensor:
    """patches: (B, N, frontend_dim) -> (B, N, d_model) in ``cfg.dtype``."""
    dt = cfg.dtype
    return patches.to(dt) @ p["proj"].to(dt) + p["proj_b"].to(dt)
