"""The chunked Mamba2 SSD scan: ``ops.ssd`` launches the CUDA kernel
(``csrc/ssd.cu``) for CUDA tensors and takes the plain sequential
recurrence (``ref.ssd_ref``) only for CPU tensors."""
from . import ops, ref  # noqa: F401
from .ops import ssd
from .ref import ssd_ref

__all__ = ["ops", "ref", "ssd", "ssd_ref"]
