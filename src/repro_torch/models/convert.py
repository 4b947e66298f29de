"""Carry the reference's parameter and cache trees across.

The reference (``repro.models``) keeps its parameters as a nested dict
of arrays with the layer dimension stacked first (``blocks.attn.wq`` is
(L, d, H, hd)); the port uses the same keys and layouts, so a tree
converted here makes both packages compute the same function.  Leaves
may be numpy arrays or anything ``numpy.asarray`` takes (JAX arrays
included); this module itself imports no JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.kernels import resolve_device


def _tensor(a: Any, device: torch.device,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bf16: exact via f32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device: Any = None,
                    dtype: torch.dtype | None = None) -> Any:
    """A nested dict of arrays -> the same dict of tensors on ``device``
    (None: CUDA, raising without a card).  ``dtype`` casts the floating
    leaves; integer leaves (an int8 KV cache) keep their type.  Works for
    parameter trees and cache trees alike."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev, dtype) for k, v in tree.items()}
    return _tensor(tree, dev, dtype)
