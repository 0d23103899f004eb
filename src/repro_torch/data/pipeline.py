"""Deterministic synthetic token pipeline.

Counterpart of the reference package's ``data/pipeline.py``: an infinite,
seekable stream of token batches, each a pure function of (seed, step), so
a run restarted from a checkpoint at step N sees the batches an
uninterrupted run would have seen.  The distribution is the same: a Zipf
unigram over a seeded permutation of the vocabulary, with every odd
position replaced by ``(previous * 31 + 7) % vocab``.

The draws come from numpy's ``default_rng((seed, step))``, not from
``jax.random``, so the two packages give different tokens from one seed
(ROADMAP.md, difference P6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_alpha: float = 1.1


class SyntheticTokenPipeline:
    """Seekable synthetic LM data; batches are int64 tensors on
    ``device`` (the card unless the caller asks for the CPU, as every
    entry point of the port)."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks ** cfg.zipf_alpha
        probs /= probs.sum()
        rng = np.random.default_rng(cfg.seed)
        # the same permutation as the reference (it draws it with numpy too)
        self._perm = rng.permutation(cfg.vocab_size)
        self._cdf = np.cumsum(probs)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch for a global step -- a pure function of (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        u = rng.random((cfg.global_batch, cfg.seq_len))
        draws = np.minimum(np.searchsorted(self._cdf, u, side="right"),
                           cfg.vocab_size - 1)
        tokens = self._perm[draws]
        # Markov structure: every odd position follows its predecessor
        mix = (np.roll(tokens, 1, axis=1) * 31 + 7) % cfg.vocab_size
        odd = (np.arange(cfg.seq_len) % 2).astype(bool)
        tokens = np.where(odd[None, :], mix, tokens)
        t = torch.from_numpy(tokens.astype(np.int64)).to(self.device)
        return {"tokens": t, "labels": t}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
