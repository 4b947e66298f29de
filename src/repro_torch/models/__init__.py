"""The workload's models in PyTorch: the reference's parameter trees and
functions, with flash attention on the CUDA kernel."""
from . import moe, transformer
from .config import ModelConfig, MoEConfig, RWKVConfig, SSMConfig
from .registry import (count_active_params, count_params, get_config,
                       list_archs, register)

__all__ = ["ModelConfig", "MoEConfig", "RWKVConfig", "SSMConfig",
           "count_active_params", "count_params", "get_config", "list_archs",
           "moe", "register", "transformer"]
