"""Assigned-architecture configs.  Importing this package registers every
arch (full + smoke variants) into ``repro_torch.models.registry``."""
from . import (deepseek_67b, deepseek_7b, deepseek_v2_lite,  # noqa: F401
               hubert_xlarge, mixtral_8x7b, pixtral_12b, qwen15_32b,
               qwen2_moe_a27b, qwen3_32b, rwkv6_7b, zamba2_12b)

# the architectures of the cell matrix, which the dry run and the
# comparisons with the JAX package walk (deepseek-v2-lite is registered
# but not among them: the JAX package has no latent attention)
ARCHS = ["qwen1.5-32b", "deepseek-67b", "deepseek-7b", "qwen3-32b",
         "zamba2-1.2b", "pixtral-12b", "qwen2-moe-a2.7b", "mixtral-8x7b",
         "rwkv6-7b", "hubert-xlarge"]
