"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]

40 heads % 16 (model axis) != 0 -> TP shards head_dim=128 instead (the
divisibility-fallback rule of the reference's sharding)."""
import torch

from ..models.config import ModelConfig
from ..models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab_size=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        qkv_bias=True, dtype=torch.float32)


register("qwen1.5-32b", full, smoke)
