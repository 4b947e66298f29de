"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (k-means cluster targets), encoder-only, same arch as
wav2vec2.  [arXiv:2106.07447]

Frontend is a STUB: precomputed conv-feature frames (512-dim) enter a
trainable projection.  Encoder-only -> no decode shapes; objective is
masked-frame cluster prediction (CE over 504 targets on masked frames).
vocab=504 % 16 != 0 -> LM head replicates (divisibility fallback)."""
import torch

from ..models.config import ModelConfig
from ..models.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab_size=504, head_dim=80,
        encoder_only=True, frontend="audio", frontend_dim=512,
        glu=False, act="gelu")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=32, head_dim=16,
        encoder_only=True, frontend="audio", frontend_dim=24,
        glu=False, act="gelu", dtype=torch.float32)


register("hubert-xlarge", full, smoke)
