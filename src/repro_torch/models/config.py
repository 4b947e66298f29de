"""Model configuration — one dataclass covers all 10 assigned families
(copied from the reference, with torch dtypes)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN width
    n_shared: int = 0              # always-on shared experts (qwen2-moe)
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize gates over the chosen top-k
    dense_dispatch: bool = False   # tiny smoke configs: run all experts
    group_size: int = 1024        # GShard-style dispatch group (tokens);
    #                               capacity is per-group — global capacity
    #                               makes the one-hot dispatch tensors
    #                               O(T^2/E) (verified: 1.4 TB/device at 32k
    #                               prefill)
    scan_groups: int = 1          # >1: lax.scan over group blocks, bounding
    #                               live dispatch buffers to 1/scan_groups
    #                               (long-sequence prefill)


@dataclasses.dataclass(frozen=True)
class DeepSeekMoEConfig(MoEConfig):
    """DeepSeekMoE (arXiv:2401.06066, as DeepSeek-V2 runs it): a router
    in fp32, top-k by softmax, ungated shared experts, no token dropped,
    and a per-sequence balance loss at ``aux_alpha``.  A device holds
    ``experts_held`` of the router's ``n_experts`` routed experts, from
    ``expert_offset`` on (expert parallelism: each device computes its
    own experts' part of the layer)."""
    experts_held: int = 0          # 0 -> all n_experts
    expert_offset: int = 0
    aux_alpha: float = 0.001

    @property
    def held(self) -> int:
        return self.experts_held or self.n_experts


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434) with no
    query compression: per head a ``qk_nope_head_dim`` content part and
    a ``qk_rope_head_dim`` rotary part of query and key, the key's rotary
    part one vector for all heads, keys and values from an RMS-normed
    ``kv_lora_rank`` latent; rotary angles by YaRN."""
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_factor: float = 40.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    # the scores' YaRN temperature; cos and sin keep scale 1, as
    # DeepSeek-V2's other mscale equals this one and their ratio scales them
    mscale_all_dim: float = 0.707


@dataclasses.dataclass(frozen=True)
class SSMConfig:                   # Mamba2 / SSD
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64                # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RWKVConfig:                  # RWKV6 "Finch"
    head_dim: int = 64
    decay_lora: int = 64           # rank of the data-dependent decay LoRA
    gate_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | hybrid | vlm | moe | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # attention flavor
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10_000.0
    # block pattern
    block: str = "attn"            # attn | mamba2 | rwkv6 | zamba2
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    shared_attn_period: int = 6    # zamba2: shared attn block every N mamba
    # structure
    encoder_only: bool = False     # hubert: no causal mask, no decode
    frontend: str | None = None    # audio | vision (stub embeddings)
    frontend_dim: int = 0          # raw feature dim entering the stub
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"              # mlp nonlinearity (hubert uses gelu)
    glu: bool = True               # SwiGLU-style gated MLP (False -> plain)
    # numerics / implementation
    dtype: Any = torch.bfloat16   # activation/compute dtype
    param_dtype: Any = torch.float32
    attn_impl: str = "ref"         # ref | flash (CUDA kernel) | blocked (torch online-softmax)
    ssm_impl: str = "ref"          # ref | pallas (SSD and WKV6 CUDA kernels)
    kv_quant: bool = False         # int8 KV cache (serving)
    attn_sp: bool = False          # sequence-parallel attention (q seq
    #                                sharded over the context mesh axis;
    #                                for archs whose head counts cannot
    #                                shard over the model axis)
    remat: bool = True             # checkpoint each layer under autograd
    remat_policy: str = "nothing"  # nothing | dots (save projection/mlp dot
    #                                outputs: skips recomputing ~95% of layer
    #                                FLOPs in backward for ~L x 40MB HBM)
    scan_layers: bool = True       # reference only: lax.scan over the
    #                                layer stack (the port loops in Python)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads:
            raise ValueError("GQA group size must divide: n_heads "
                             f"{self.n_heads}, n_kv_heads {self.n_kv_heads}")

    @property
    def is_attention_free(self) -> bool:
        return self.block in ("mamba2", "rwkv6")

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists: SSM/linear blocks, hybrids, or SWA."""
        return self.block in ("mamba2", "rwkv6", "zamba2") or (
            self.sliding_window is not None)

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    def n_params(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline bookkeeping)."""
        from . import registry
        return registry.count_params(self)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MLAModelConfig(ModelConfig):
    """``block="mla_moe"``: MLA in every layer, a dense SwiGLU MLP in the
    first ``first_dense`` layers and DeepSeekMoE (``moe``, a
    ``DeepSeekMoEConfig``) in the rest."""
    mla: MLAConfig | None = None
    first_dense: int = 0
