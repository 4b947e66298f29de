"""Serving: prefill + decode steps and a batched greedy engine.

``make_prefill_step`` runs the full-sequence forward (flash attention on
the CUDA kernel when ``cfg.attn_impl == "flash"``, the SSD and WKV6 scans
on theirs when ``cfg.ssm_impl == "pallas"``); ``make_decode_step`` adds
one token against a KV cache of ``max_len`` slots (window-bounded ring
for SWA archs) and the SSM/WKV states.  Both run under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .. import spans
from ..core.kernels import resolve_device
from ..models import transformer
from ..models.config import ModelConfig

# leaves the reference reads in float32: the norm weights (``norm`` is
# both the Mamba block's and the inner Mamba norm; ``ln_x`` is RWKV6's
# group norm), the SSM decay parameters ``a_log``, ``dt_bias`` and
# ``w0``, and RWKV6's bonus ``u`` (read in float32 by decode; the kernel
# path casts it to cfg.dtype itself, as the reference does).  Every other
# floating leaf the reference casts to cfg.dtype at each use, the MoE
# router, shared router and expert leaves among them.
FP32_LEAVES = frozenset({"norm1", "norm2", "final_norm", "q_norm", "k_norm",
                         "norm", "ln_x", "a_log", "dt_bias", "w0", "u"})


def cache_max_len(cfg: ModelConfig, seq_len: int) -> int:
    """Physical KV length: window-bounded for SWA archs."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def cast_params(params: dict, cfg: ModelConfig,
                device: torch.device) -> dict:
    """The tree on ``device`` with each leaf the reference casts to
    ``cfg.dtype`` at use already cast, and ``FP32_LEAVES`` in float32."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = cast_params(v, cfg, device)
        elif not v.is_floating_point():
            out[k] = v.to(device)
        elif k in FP32_LEAVES:
            out[k] = v.to(device=device, dtype=torch.float32)
        else:
            out[k] = v.to(device=device, dtype=cfg.dtype)
    return out


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill(params, batch) -> logits: the full-sequence forward (cache
    writes are folded into decode, as in the reference), recorded under a
    profiler as ``serve.prefill`` with its rows and prompt tokens
    (``repro_torch.spans``)."""
    @torch.no_grad()
    def prefill(params: dict, batch: dict) -> torch.Tensor:
        rows, length = batch["tokens" if "tokens" in batch
                             else "features"].shape[:2]
        with spans.span("serve.prefill", rows=rows, tokens=rows * length):
            logits, _ = transformer.forward(params, cfg, batch)
        return logits
    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    """decode(params, cache, tokens, cache_len) -> (logits, cache); the
    cache is updated in place."""
    @torch.no_grad()
    def decode(params: dict, cache: dict, tokens: torch.Tensor,
               cache_len: int):
        return transformer.decode_step(params, cfg, cache, tokens,
                                       cache_len)
    return decode


class ServeEngine:
    """Batched greedy decoding for the end-to-end serving example.

    ``device`` None means CUDA and raises without a card.  The engine
    casts the weights to ``cfg.dtype`` once, at construction, where the
    reference casts them at each use: the same numbers, without re-reading
    the float32 weights on every step.  It keeps its own cast copy
    (``self.params``); drop the float32 tree after construction to free it,
    or hand it a tree initialised in ``cfg.dtype``
    (``init_params(cfg.replace(param_dtype=cfg.dtype), ...)``), whose
    leaves it keeps as they are, but for ``FP32_LEAVES``.
    """

    def __init__(self, cfg: ModelConfig, params: dict, max_len: int = 256,
                 device: Any = None):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only")
        self.cfg = cfg
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = cast_params(params, cfg, self.device)
        self._decode = make_decode_step(cfg)

    def generate(self, prompts: np.ndarray, n_new: int) -> np.ndarray:
        """prompts: (B, P) int -> (B, n_new) int32 greedy continuations.
        The prompt runs through the decode path token by token (exact,
        cache-consistent), as in the reference."""
        B, P = prompts.shape
        cache = transformer.init_cache(
            self.cfg, B, cache_max_len(self.cfg, self.max_len), self.device)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=self.device)
        logits = None
        for t in range(P):
            logits, cache = self._decode(self.params, cache,
                                         toks[:, t: t + 1], t)
        out = []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for t in range(P, P + n_new):
            out.append(tok[:, 0])
            if len(out) == n_new:
                break
            logits, cache = self._decode(self.params, cache, tok, t)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
