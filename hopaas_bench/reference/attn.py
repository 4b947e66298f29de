"""The dense decoder stack (``block: "attn"``): in every layer a
pre-norm attention and a pre-norm gated MLP, each added to the residual
stream (LLaMA's layout, which DeepSeek LLM follows, arXiv:2401.02954)."""
from __future__ import annotations

import torch

from .model import Reference, layer


def stack(ref: Reference, x: torch.Tensor) -> torch.Tensor:
    for i in range(ref.c["n_layers"]):
        x = ref.run_block(ref.attn_block, layer(ref.p["blocks"], i), x)
    return x
