"""rwkv6-7b "Finch" [ssm] — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536, data-dependent per-channel decay.  [arXiv:2404.05892]

Attention-free linear recurrence -> O(1) decode state -> runs long_500k."""
import torch

from ..models.config import ModelConfig, RWKVConfig
from ..models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab_size=65536, head_dim=64,
        block="rwkv6", rwkv=RWKVConfig(head_dim=64, decay_lora=64))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        block="rwkv6", rwkv=RWKVConfig(head_dim=16, decay_lora=8),
        dtype=torch.float32)


register("rwkv6-7b", full, smoke)
