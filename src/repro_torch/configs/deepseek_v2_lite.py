"""deepseek-v2-lite [moe] — 27L d_model=2048 16H, MLA (kv_lora_rank 512,
q/k heads 128 + 64 rotary, v heads 128, no query compression, YaRN
factor 40), layer 0 a dense SwiGLU of 10944, layers 1-26 DeepSeekMoE: 64
routed experts of 1408, top-6 by softmax (not renormalised), 2 ungated
shared experts, per-sequence balance loss at 0.001; vocab=102400.
[hf:deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434]

Registered, but not in ``configs.ARCHS``: the dry run and the
comparisons with the JAX package, which has no such block, walk that
list."""
import torch

from ..models.config import DeepSeekMoEConfig, MLAConfig, MLAModelConfig
from ..models.registry import register


def full() -> MLAModelConfig:
    return MLAModelConfig(
        name="deepseek-v2-lite", family="moe", block="mla_moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab_size=102400, head_dim=128,
        rope_theta=10_000.0, norm_eps=1e-6, first_dense=1,
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        moe=DeepSeekMoEConfig(n_experts=64, top_k=6, d_expert=1408,
                              n_shared=2, router_norm_topk=False,
                              experts_held=64))


def smoke() -> MLAModelConfig:
    return MLAModelConfig(
        name="deepseek-v2-lite-smoke", family="moe", block="mla_moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=256, head_dim=16, norm_eps=1e-6,
        first_dense=1,
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=DeepSeekMoEConfig(n_experts=8, top_k=3, d_expert=32,
                              n_shared=2, router_norm_topk=False,
                              experts_held=8),
        dtype=torch.float32)


register("deepseek-v2-lite", full, smoke)
