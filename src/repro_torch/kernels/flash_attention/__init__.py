from . import ops, ref  # noqa: F401
from .ops import attention_ref, flash_attention

__all__ = ["attention_ref", "flash_attention", "ops", "ref"]
