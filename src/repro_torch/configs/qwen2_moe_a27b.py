"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408
(per-expert) vocab=151936, MoE 60 routed top-4 + 4 shared experts
(shared width 4x1408 = 5632).  [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
import torch

from ..models.config import ModelConfig, MoEConfig
from ..models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=151936, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408, n_shared=4,
                      router_norm_topk=True))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=256, head_dim=16, qkv_bias=True,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=96, n_shared=2,
                      router_norm_topk=True, dense_dispatch=True),
        dtype=torch.float32)


register("qwen2-moe-a2.7b", full, smoke)
