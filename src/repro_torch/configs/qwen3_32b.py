"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-8B family]

Qwen3 decouples head_dim (128) from d_model/n_heads and RMS-normalizes
q and k per head before RoPE."""
import torch

from ..models.config import ModelConfig
from ..models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        d_ff=25600, vocab_size=151936, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        qk_norm=True, dtype=torch.float32)


register("qwen3-32b", full, smoke)
