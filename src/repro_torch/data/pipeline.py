"""Synthetic token data pipeline with elastic per-node batching.

BFTrainer semantics (paper §4.2): the per-node minibatch is FIXED; the
global batch is ``n_nodes * per_node_batch`` and changes when the Trainer
rescales (weak scaling).  The pipeline is seeded + step-indexed so a
rescaled Trainer resumes deterministically without data loss or repeats:
sample ids are assigned round-robin over a virtual epoch permutation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    per_node_batch: int = 8
    seed: int = 0
    n_virtual_samples: int = 1 << 20   # virtual epoch size


class TokenPipeline:
    """Deterministic synthetic LM batches (markov-ish token streams)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._consumed = 0   # global sample cursor (survives rescale)

    @property
    def samples_consumed(self) -> int:
        return self._consumed

    def state(self) -> Dict:
        return {"consumed": self._consumed}

    def restore(self, state: Dict) -> None:
        self._consumed = int(state["consumed"])

    def _gen_sample(self, idx: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 32) ^ idx)
        # cheap structured stream: random walk over the vocab so models can
        # actually reduce loss below uniform
        steps = rng.integers(-32, 33, size=cfg.seq_len)
        toks = np.cumsum(steps) + rng.integers(0, cfg.vocab_size)
        return np.mod(toks, cfg.vocab_size).astype(np.int32)

    def next_batch(self, n_nodes: int) -> Dict[str, np.ndarray]:
        """Global batch for the current step at the given scale."""
        cfg = self.cfg
        bsz = n_nodes * cfg.per_node_batch
        idx = (self._consumed + np.arange(bsz)) % cfg.n_virtual_samples
        toks = np.stack([self._gen_sample(int(i)) for i in idx])
        self._consumed += bsz
        return {"tokens": toks, "labels": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch(1)
