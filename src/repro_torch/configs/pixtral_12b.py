"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072.  Pixtral-ViT frontend is a STUB (precomputed patch
embeddings, 1024-dim as in the Pixtral vision encoder) + a trainable
adapter; backbone is the mistral-nemo transformer.
[hf:mistralai/Pixtral-12B-2409]"""
import torch

from ..models.config import ModelConfig
from ..models.registry import register

N_PATCHES = 256          # stub image: 16x16 patch grid per image


def full() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=131072, head_dim=128,
        frontend="vision", frontend_dim=1024, rope_theta=1_000_000_000.0)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        frontend="vision", frontend_dim=32, dtype=torch.float32)


register("pixtral-12b", full, smoke)
