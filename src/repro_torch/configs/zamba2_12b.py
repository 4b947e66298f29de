"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000, ssm_state=64.  Mamba2 backbone + weight-tied shared attention
block every ``shared_attn_period`` layers.  [arXiv:2411.15242]

Runs long_500k: the Mamba2 state is O(1) per layer and the shared
attention blocks' KV caches shard over the model axis."""
import torch

from ..models.config import ModelConfig, SSMConfig
from ..models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000, head_dim=64,
        block="zamba2", shared_attn_period=6,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=64))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        block="zamba2", shared_attn_period=2,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8),
        dtype=torch.float32)


register("zamba2-1.2b", full, smoke)
