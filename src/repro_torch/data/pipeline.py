"""Deterministic synthetic LM data pipeline (copied from the reference).

Design goals mirrored from production input pipelines:
  * **host-sharded**: each host materializes only its slice of the global
    batch (``host_index / host_count``), sized for its addressable devices;
  * **deterministic & resumable**: batch ``i`` is a pure function of
    ``(seed, i)`` — restart at step ``k`` reproduces the exact stream, so a
    checkpoint restore replays no data and skips none;
  * **model-aware**: emits token, audio-frame, or vision-patch batches per
    the arch's ``input_specs`` contract.

The synthetic distribution is a Zipf-like unigram mix with a Markov blend,
enough structure that a ~100M model shows a cleanly decreasing loss (used
by the HOPAAS study objective).  Batches are numpy arrays drawn from
numpy's ``default_rng``, bit for bit the reference's; the trainer moves
each batch to its device once a step.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count


class SyntheticLMDataset:
    """Stateless batch factory: ``batch = ds[i]``."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig):
        self.cfg = cfg
        self.mcfg = model_cfg
        v = model_cfg.vocab_size
        rng = np.random.default_rng(cfg.seed)
        # fixed unigram (Zipf) + per-token Markov shift, shared across hosts
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._shift = rng.integers(1, v, size=257)           # Markov jumps

    def __getitem__(self, index: int) -> dict:
        c, m = self.cfg, self.mcfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + index) * 1_000_033 + c.host_index)
        B, S, V = c.host_batch, c.seq_len, m.vocab_size

        if m.frontend == "audio":
            feats = rng.standard_normal((B, S, m.frontend_dim),
                                        dtype=np.float32)
            mask = rng.random((B, S)) < 0.3
            labels = rng.integers(0, V, size=(B, S), dtype=np.int32)
            return {"features": feats, "frame_mask": mask, "labels": labels}

        toks = rng.choice(V, size=(B, S + 1), p=self._unigram).astype(np.int32)
        # Markov blend: half the tokens continue deterministically
        cont = rng.random((B, S)) < 0.5
        nxt = (toks[:, :-1] + self._shift[toks[:, :-1] % 257]) % V
        toks[:, 1:] = np.where(cont, nxt, toks[:, 1:])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if m.frontend == "vision":
            from ..configs.pixtral_12b import N_PATCHES
            batch["patch_embeds"] = rng.standard_normal(
                (B, N_PATCHES, m.frontend_dim)).astype(np.float32)
        return batch

    def iter_from(self, start: int):
        i = start
        while True:
            yield i, self[i]
            i += 1


class BatchSpec(NamedTuple):
    """Shape and type of one batch entry (the reference's
    ``jax.ShapeDtypeStruct`` stand-in)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def make_batch_specs(model_cfg: ModelConfig, global_batch: int, seq_len: int,
                     dtype: torch.dtype = torch.int32) -> dict:
    """Shape/dtype records for one *global* batch."""
    m = model_cfg
    if m.frontend == "audio":
        return {
            "features": BatchSpec((global_batch, seq_len, m.frontend_dim),
                                  torch.float32),
            "frame_mask": BatchSpec((global_batch, seq_len), torch.bool),
            "labels": BatchSpec((global_batch, seq_len), dtype),
        }
    specs = {"tokens": BatchSpec((global_batch, seq_len), dtype),
             "labels": BatchSpec((global_batch, seq_len), dtype)}
    if m.frontend == "vision":
        from ..configs.pixtral_12b import N_PATCHES
        specs["patch_embeds"] = BatchSpec(
            (global_batch, N_PATCHES, m.frontend_dim), torch.float32)
    return specs
