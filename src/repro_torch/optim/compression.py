"""Gradient compression for the cross-pod all-reduce.

int8 block-quantization: per-block max-abs scale (block = trailing dim),
~4x fewer bytes on the slow inter-pod links.  Error feedback (residual
carried to the next step) keeps the quantization noise unbiased over
time.  Trees are nested dicts of tensors.  Nothing on the port's
training path calls these yet (it runs on one device).
"""
from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 payload, fp32 per-row scale). x: any shape.  ``round``
    rounds half to even, as the reference's does."""
    xf = x.float()
    flat = xf.reshape(-1, x.shape[-1]) if x.dim() > 1 else xf.reshape(1, -1)
    scale = flat.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    if x.dim() > 1:
        return q.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)
    return q.reshape(x.shape), scale.reshape(())


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: dict) -> dict:
    """Matrices -> (q, scale); vectors and scalars -> (g, None)."""
    return {k: compress_tree(g) if isinstance(g, dict)
            else compress_int8(g) if g.dim() >= 2 else (g, None)
            for k, g in grads.items()}


def decompress_tree(ctree: dict) -> dict:
    def dec(pair):
        q, s = pair
        return decompress_int8(q, s) if s is not None else q
    return {k: decompress_tree(v) if isinstance(v, dict) else dec(v)
            for k, v in ctree.items()}


def error_feedback_compress(g: torch.Tensor, residual: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Compress (g + residual); return (q, scale, new_residual)."""
    target = g.float() + residual
    q, scale = compress_int8(target)
    recon = decompress_int8(q, scale)
    return q, scale, target - recon

