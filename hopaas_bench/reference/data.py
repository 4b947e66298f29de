"""The synthetic token stream the trainer feeds, worked out again.

A copy of the program's ``repro_torch.data.pipeline.SyntheticLMDataset``
arithmetic (a Zipf unigram over the vocabulary with a Markov blend,
numpy's ``default_rng`` seeded per batch), so the reference trains on
the same rows without taking them from the program; the harness also
holds the rows the program fed against these, token for token.
"""
from __future__ import annotations

import numpy as np


def batch(seed: int, index: int, global_batch: int, seq_len: int,
          vocab: int) -> dict[str, np.ndarray]:
    """Batch ``index`` of the stream of ``seed``: tokens and labels
    (global_batch, seq_len) int32."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
    shift = np.random.default_rng(seed).integers(1, vocab, size=257)
    rng = np.random.default_rng((seed * 1_000_003 + index) * 1_000_033)
    toks = rng.choice(vocab, size=(global_batch, seq_len + 1),
                      p=unigram).astype(np.int32)
    cont = rng.random((global_batch, seq_len)) < 0.5
    nxt = (toks[:, :-1] + shift[toks[:, :-1] % 257]) % vocab
    toks[:, 1:] = np.where(cont, nxt, toks[:, 1:])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
