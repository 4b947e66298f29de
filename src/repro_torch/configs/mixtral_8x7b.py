"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
(per-expert) vocab=32000, 8 experts top-2, sliding-window attention
(4096).  [arXiv:2401.04088]

SWA makes attention sub-quadratic -> runs long_500k with a window-bounded
KV cache."""
import torch

from ..models.config import ModelConfig, MoEConfig
from ..models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000, head_dim=128,
        sliding_window=4096, rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336,
                      router_norm_topk=True))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16, sliding_window=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128,
                      router_norm_topk=True, dense_dispatch=True),
        dtype=torch.float32)


register("mixtral-8x7b", full, smoke)
