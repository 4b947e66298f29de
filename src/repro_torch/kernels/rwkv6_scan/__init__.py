"""The chunked RWKV6 WKV scan: ``ops.wkv6`` launches the CUDA kernel
(``csrc/wkv6.cu``) for CUDA tensors and takes the plain sequential
recurrence (``ref.wkv6_ref``) only for CPU tensors."""
from . import ops, ref  # noqa: F401
from .ops import wkv6
from .ref import wkv6_ref

__all__ = ["ops", "ref", "wkv6", "wkv6_ref"]
