"""The optimizer: AdamW with global-norm clipping, LR schedules and int8
gradient compression, on nested dicts of tensors."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    opt_state_specs)
from .compression import compress_int8, decompress_int8
from .schedules import constant, cosine_warmup, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "opt_state_specs",
           "cosine_warmup", "linear_warmup", "constant",
           "compress_int8", "decompress_int8"]
